"""Config snapshot for reproducibility (port of
``ti5_isaacgym_tpu/scripts/record_config.py``): every run stores its full
resolved env and train configuration in the log dir."""
from __future__ import annotations

import json
import os

from ..utils.config import to_dict


def record_config(log_dir: str, env_cfg, train_cfg):
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "config.json"), "w") as f:
        json.dump({"env_cfg": to_dict(env_cfg), "train_cfg": to_dict(train_cfg)},
                  f, indent=1, default=str)
