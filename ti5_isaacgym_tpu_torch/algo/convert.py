"""Weights and learning state carried across from the JAX package.

:func:`params_from_flat` maps flat flax keys (``actor/Dense_0/kernel`` ...,
the layout of ``ti5_isaacgym_tpu/export/policy.py:59-85`` and of the exported
``policy_dh.npz``) onto the ``state_dict`` of :class:`.networks.ActorCriticDH`
or :class:`.networks.ActorCritic`:

* ``Dense_i/kernel`` (in, out) -> ``layers.i.weight`` (out, in);
* ``Conv_i/kernel`` (k, in, out), channels last -> ``convs.i.weight``
  (out, in, k);
* the long-history head's ``Dense_0/1`` -> ``fc.layers.0/1``.

:func:`flat_from_params` is its inverse (for the export: the npz, the ONNX
file), with the keys in the order of an npz the JAX package exports.

:func:`train_state_from_jax` carries a whole JAX ``TrainState`` (params,
optax's Adam moments and count, the carried learning rate, the update count)
into a :class:`.ppo.TrainState` through the same mapping, so that a JAX
training run continues in the port.
"""
from __future__ import annotations

from typing import Any, Dict

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


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested flax param dict (with or without its ``params`` root) ->
    ``{"actor/Dense_0/kernel": array, ...}``."""
    if prefix == "" and set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def params_from_flat(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax params (e.g. ``dict(np.load('policy_dh.npz'))``) -> a
    ``state_dict`` for :class:`ActorCriticDH` or :class:`ActorCritic`."""
    out = {}
    for k, v in flat.items():
        name, kind = _key(k)
        a = np.asarray(v, np.float32)
        if name.endswith(".weight"):
            a = a.transpose(2, 1, 0) if kind == "Conv" else a.T
        out[name] = torch.from_numpy(np.array(a, order="C"))
    return out


def _flax_key(name: str) -> tuple:
    """The inverse of :func:`_key`: a ``state_dict`` name -> (flat flax key,
    its layer kind)."""
    if name == "std":
        return "std", None
    parts = name.split(".")
    leaf = "kernel" if parts[-1] == "weight" else "bias"
    if parts[:2] == ["long_history", "convs"]:
        return f"long_history/Conv_{parts[2]}/{leaf}", "Conv"
    if parts[:2] == ["long_history", "fc"]:
        return f"long_history/Dense_{parts[3]}/{leaf}", "Dense"
    return f"{parts[0]}/Dense_{parts[2]}/{leaf}", "Dense"


def flat_from_params(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's params (a ``state_dict`` of :class:`ActorCriticDH` or
    :class:`ActorCritic`, on any device) -> flat flax params in flax's
    layouts (``Dense_i/kernel`` (in, out), ``Conv_i/kernel`` (k, in, out)),
    keyed in the order of an npz the JAX package exports from a checkpoint
    (keys sorted level by level).  Only transposes and copies: the values
    round-trip through :func:`params_from_flat` bit for bit."""
    out = {}
    for name, v in params.items():
        key, kind = _flax_key(name)
        a = v.detach().to("cpu", torch.float32).numpy()
        if key.endswith("/kernel"):
            a = a.transpose(2, 1, 0) if kind == "Conv" else a.T
        out[key] = np.array(a, order="C")
    return {k: out[k] for k in sorted(out, key=lambda k: k.split("/"))}


def nest_flat(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``{"actor/Dense_0/kernel": a, ...}`` -> ``{"actor": {"Dense_0":
    {"kernel": a}}, ...}`` (flax's nested layout, without the ``params``
    root), in the order of ``flat``."""
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def train_state_from_jax(params, opt_state, lr, update_count, device="cpu"):
    """A JAX ``TrainState``'s fields, with numpy leaves (``jax.tree.map(
    np.asarray, ...)``), -> :class:`.ppo.TrainState`.  ``opt_state`` is the
    state of ``optax.chain(clip_by_global_norm, scale_by_adam)``: the clip's
    state is empty, and the Adam state's ``count``, ``mu`` and ``nu`` map onto
    the port's moments by the keys of :func:`params_from_flat`."""
    from .ppo import TrainState

    adam = next(s for s in opt_state if hasattr(s, "mu") and hasattr(s, "nu"))
    dev = torch.device(device)

    def tensors(tree):
        return {k: v.to(dev) for k, v in params_from_flat(flatten_tree(tree)).items()}

    return TrainState(
        params=tensors(params), mu=tensors(adam.mu), nu=tensors(adam.nu),
        count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32, device=dev),
        lr=torch.tensor(float(np.asarray(lr)), dtype=torch.float32, device=dev),
        update_count=torch.tensor(int(np.asarray(update_count)), dtype=torch.int32,
                                  device=dev))


def load_npz(path: str, net=None, device="cpu"):
    """Build (or fill) an ``ActorCriticDH`` from an exported npz."""
    from .networks import ActorCriticDH

    with np.load(path) as f:
        sd = params_from_flat({k: f[k] for k in f.files})
    if net is None:
        net = ActorCriticDH(num_critic_obs=sd["critic.layers.0.weight"].shape[1])
    net.load_state_dict(sd)
    return net.to(device)
