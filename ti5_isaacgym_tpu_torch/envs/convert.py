"""Env state carried across from the JAX package.

:func:`state_from_numpy` turns a JAX ``EnvState`` whose leaves are numpy
arrays (``jax.tree.map(np.asarray, state)``) into this package's
:class:`~.types.EnvState`, so that both packages can start from one state.
Fields are read by name; the JAX PRNG key is replaced by a
``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from ..physics.dynamics import DynamicsParams
from ..physics.engine import PhysicsState
from .types import EnvParams, EnvState


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(cls, src, device):
    kw = {}
    for f in fields(cls):
        v = getattr(src, f.name)
        kw[f.name] = (_convert(DynamicsParams, v, device) if f.name == "dynamics"
                      else _tensor(v, device))
    return cls(**kw)


def params_from_numpy(params, device="cpu") -> EnvParams:
    """A JAX ``EnvParams`` with numpy leaves -> :class:`EnvParams`."""
    return _convert(EnvParams, params, torch.device(device))


def state_from_numpy(state, seed: int = 0, device="cpu") -> EnvState:
    """A JAX ``EnvState`` with numpy leaves -> :class:`EnvState`."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    kw = {"rng": gen, "phys": _convert(PhysicsState, state.phys, dev),
          "params": params_from_numpy(state.params, dev)}
    for f in fields(EnvState):
        if f.name not in kw:
            kw[f.name] = _tensor(getattr(state, f.name), dev)
    return EnvState(**kw)
