"""Slim a full training checkpoint for git persistence (port of
``tools/slim_checkpoint.py``).

    python -m ti5_isaacgym_tpu_torch.scripts.slim_checkpoint <model_N.pt> <out.pt> [--device cpu]

A full checkpoint holds the whole carry (~100 MB at 4096 envs: observation
histories, lag rings, physics state).  The slim one keeps the learning state,
the iteration, the run's generator and the five curriculum fields
(``utils.checkpoint.KEEP_ENV_FIELDS``); ``scripts/resume_migrate.py`` grafts
it onto a fresh carry.  The tensors are read onto ``--device`` (``cuda``
unless ``cpu``; without a card it raises) and written from there, as the
runner writes its own.
"""
from __future__ import annotations

import argparse

import torch

from ..utils.checkpoint import save, slim
from ..utils.device import resolve_device


def get_args(argv=None):
    p = argparse.ArgumentParser("ti5 torch slim_checkpoint")
    p.add_argument("src", help="a full checkpoint written by the runner (model_<N>.pt)")
    p.add_argument("dst", help="the slim checkpoint to write")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = get_args(argv)
    dev = resolve_device(args.device)
    payload = torch.load(args.src, map_location=dev, weights_only=True)
    if "env_state" not in payload:
        raise ValueError(f"{args.src} holds no env state (a data-parallel checkpoint?): "
                         "nothing to slim")
    path = save(slim(payload), args.dst)
    print(f"slimmed {args.src} -> {path}")
    return path


if __name__ == "__main__":
    main()
