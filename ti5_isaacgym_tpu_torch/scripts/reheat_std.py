"""Reheat the policy's exploration std in a checkpoint (port of
``tools/reheat_std.py``).

    python -m ti5_isaacgym_tpu_torch.scripts.reheat_std <model_N.pt> <out.pt> [--std 0.4]

By ~30k iterations the per-action std had annealed to 0.06-0.16 (init 1.0)
while the policy was still in the two-foot shuffle, so stepping could no
longer be discovered; the trained stander balances through scripted
stepping, so walking is reachable once exploration is back.  This writes the
checkpoint (full or slim) with ``std`` set to ``--std`` and that leaf's Adam
moments zeroed (``utils.checkpoint.reheat_std``); every other leaf is the
source's.  Tensors are read onto ``--device`` (``cuda`` unless ``cpu``;
without a card it raises).
"""
from __future__ import annotations

import argparse

import torch

from ..utils.checkpoint import reheat_std, save
from ..utils.device import resolve_device


def get_args(argv=None):
    p = argparse.ArgumentParser("ti5 torch reheat_std")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--std", type=float, default=0.4)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = get_args(argv)
    dev = resolve_device(args.device)
    payload = torch.load(args.src, map_location=dev, weights_only=True)
    print("old std:", payload["ts"]["params"]["std"].cpu().numpy())
    payload = reheat_std(payload, args.std)
    print("new std:", payload["ts"]["params"]["std"].cpu().numpy())
    print("zeroed ts/mu/std and ts/nu/std")
    path = save(payload, args.dst)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
