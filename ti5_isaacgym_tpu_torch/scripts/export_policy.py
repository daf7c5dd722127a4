"""Export a trained policy for deployment (port of
``ti5_isaacgym_tpu/scripts/export_policy.py``).

    python -m ti5_isaacgym_tpu_torch.scripts.export_policy --task k1_dh_stand \\
        [--log_root logs/k1_dh_stand] [--load_run -1] [--checkpoint -1] [--out exported]

Loads the params of a training checkpoint (the newest under the task's log
root unless ``--load_run`` / ``--checkpoint`` name one; ``--random_policy``
draws flax-style random weights from seed 0 instead) and writes into
``--out``: ``policy_dh.npz`` and its manifest ``policy_dh.json`` (read by
``native/ti5_infer``), ``policy_config.yaml`` (the controller's parameters)
and, for ``ActorCriticDH``, ``ti5_dh_policy.onnx``.  The JAX exporter's
StableHLO artifact has no counterpart in the port.  Runs on ``cuda`` unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..algo import networks as nets
from ..algo.runner import build_network
from ..export.onnx import export_onnx_dh
from ..export.policy import export_controller_yaml, export_npz, restore_policy_params
from ..utils.device import resolve_device
from ..utils.registry import resolve_load_path, task_registry


def get_export_args(argv=None):
    p = argparse.ArgumentParser("ti5 torch export")
    p.add_argument("--task", type=str, default="t1_dh_stand")
    p.add_argument("--load_run", type=str, default=None)
    p.add_argument("--checkpoint", type=int, default=None)
    p.add_argument("--log_root", type=str, default=None)
    p.add_argument("--out", type=str, default="exported")
    p.add_argument("--random_policy", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def export(args) -> dict:
    """Write the deployment files; returns {kind: path}."""
    device = resolve_device(args.device)
    env_cfg, train_cfg = task_registry.get_cfgs(args.task)
    network = build_network(train_cfg, env_cfg)
    if args.random_policy:
        nets.init_like_flax_(network, torch.Generator().manual_seed(0))
        params = {k: v.detach() for k, v in network.named_parameters()}
    else:
        root = args.log_root or task_registry.log_root(args.task)
        path = resolve_load_path(root, args.load_run or -1, args.checkpoint or -1)
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
        print(f"loading {path}")
        params, it = restore_policy_params(path)
        print(f"checkpoint iteration {it}")
    params = {k: v.to(device) for k, v in params.items()}
    out = {"npz": export_npz(network, params, args.out),
           "yaml": export_controller_yaml(env_cfg, args.out)}
    out["manifest"] = out["npz"][:-len(".npz")] + ".json"
    if train_cfg.runner.policy_class_name == "ActorCriticDH":
        out["onnx"] = export_onnx_dh(params, os.path.join(args.out, "ti5_dh_policy.onnx"))
    for path in out.values():
        print("wrote", path)
    print("StableHLO: no counterpart in the PyTorch port; not written")
    return out


def main(argv=None):
    return export(get_export_args(argv))


if __name__ == "__main__":
    main()
