"""Weights carried across from the JAX package.

:func:`params_from_flat` maps flat flax keys (``actor/Dense_0/kernel`` ...,
the layout of ``ti5_isaacgym_tpu/export/policy.py:59-85`` and of the exported
``policy_dh.npz``) onto :class:`.networks.ActorCriticDH`'s ``state_dict``:

* ``Dense_i/kernel`` (in, out) -> ``layers.i.weight`` (out, in);
* ``Conv_i/kernel`` (k, in, out), channels last -> ``convs.i.weight``
  (out, in, k);
* the long-history head's ``Dense_0/1`` -> ``fc.layers.0/1``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _key(flax_key: str) -> tuple:
    parts = flax_key.split("/")
    if parts == ["std"]:
        return "std", None
    mod, layer, leaf = parts
    idx = int(layer.split("_")[1])
    if mod == "long_history":
        name = f"long_history.convs.{idx}" if layer.startswith("Conv") else f"long_history.fc.layers.{idx}"
    else:
        name = f"{mod}.layers.{idx}"
    return f"{name}.{'weight' if leaf == 'kernel' else 'bias'}", layer.split("_")[0]


def params_from_flat(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax params (e.g. ``dict(np.load('policy_dh.npz'))``) -> a
    ``state_dict`` for :class:`ActorCriticDH`."""
    out = {}
    for k, v in flat.items():
        name, kind = _key(k)
        a = np.asarray(v, np.float32)
        if name.endswith(".weight"):
            a = a.transpose(2, 1, 0) if kind == "Conv" else a.T
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def load_npz(path: str, net=None, device="cpu"):
    """Build (or fill) an ``ActorCriticDH`` from an exported npz."""
    from .networks import ActorCriticDH

    with np.load(path) as f:
        sd = params_from_flat({k: f[k] for k in f.files})
    if net is None:
        net = ActorCriticDH(num_critic_obs=sd["critic.layers.0.weight"].shape[1])
    net.load_state_dict(sd)
    return net.to(device)
