"""The port's training CLI with the registered tasks cut to a 2x2 terrain
and 4 steps per env, for the data-parallel CLI tests
(``tests/test_torch_parallel.py``):

    python tests/torch_dp_cli.py --device cpu --n_devices 2 --task k1_dh_stand ...

The cut is made when this module is imported, so the ranks that the CLI
starts with ``spawn`` (which import the launching module again) train the
same cut tasks.  ``TI5_DP_TIMEOUT_S`` sets the ranks' rendezvous and
collective timeout (``train(timeout_s=...)``).  Imports no JAX.
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

from ti5_isaacgym_tpu_torch.parallel.trainer import DEFAULT_TIMEOUT_S  # noqa: E402
from ti5_isaacgym_tpu_torch.scripts import train  # noqa: E402
from ti5_isaacgym_tpu_torch.utils.helpers import get_args  # noqa: E402
from ti5_isaacgym_tpu_torch.utils.registry import task_registry  # noqa: E402

for _name in task_registry.task_names():
    _cls, _env_cfg, _train_cfg = task_registry._get(_name)
    task_registry.register(
        _name, _cls,
        dataclasses.replace(_env_cfg, terrain=dataclasses.replace(
            _env_cfg.terrain, num_rows=2, num_cols=2, border_size=2.0)),
        dataclasses.replace(_train_cfg, runner=dataclasses.replace(
            _train_cfg.runner, num_steps_per_env=4)))

if __name__ == "__mp_main__":
    # a rank that the CLI spawned: TensorBoard is imported here, before the
    # rank joins the group, so that the lead's import of it in its runner
    # (seconds) does not hold the other rank at its first collective under
    # the short ``TI5_DP_TIMEOUT_S`` a test gives
    import torch.utils.tensorboard  # noqa: E402, F401

if __name__ == "__main__":
    train.train(get_args(sys.argv[1:]),
                timeout_s=float(os.environ.get("TI5_DP_TIMEOUT_S", DEFAULT_TIMEOUT_S)))
