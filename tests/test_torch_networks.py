"""Port parity: ``params_from_flat`` on the exported round-5 walking policy
(eval_round5/final/exported/policy_dh.npz, flat flax keys) and the port's
``act_inference`` against the JAX network's on seeded observations.

Tolerance: float32 MLPs and two conv1d layers accumulated in another order
(torch vs XLA CPU), atol 1e-4 + rtol 1e-4 on actions of O(1).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti5_isaacgym_tpu.algo import networks as jnets
from ti5_isaacgym_tpu_torch.algo import networks as tnets
from ti5_isaacgym_tpu_torch.algo.convert import load_npz, params_from_flat

NPZ = os.path.join(os.path.dirname(__file__), "..", "eval_round5", "final", "exported",
                   "policy_dh.npz")


def _flat():
    with np.load(NPZ) as f:
        return {k: f[k] for k in f.files}


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return {"params": tree}


def test_params_from_flat_fills_every_parameter():
    net = tnets.ActorCriticDH()
    sd = params_from_flat(_flat())
    assert set(sd) == set(net.state_dict())
    for k, v in net.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    # flax Conv (k, in, out) -> torch Conv1d (out, in, k)
    np.testing.assert_array_equal(sd["long_history.convs.0.weight"].numpy(),
                                  _flat()["long_history/Conv_0/kernel"].transpose(2, 1, 0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_inference_matches_jax(dtype):
    flat = _flat()
    jnet = jnets.ActorCriticDH()
    params = _unflatten(flat)
    tnet = load_npz(NPZ)
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(7)
    obs = rng.normal(scale=0.5, size=(32, 66 * 47)).astype(np.float32)
    # the env's observation history is bf16; feed both the same rounded values
    jobs = jnp.asarray(obs).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(obs)
    tobs = torch.from_numpy(obs).to(getattr(torch, dtype))
    ja, je = jnet.apply(params, jobs, method="act_inference")
    with torch.no_grad():
        ta, te = tnet.act_inference(tobs)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-4, rtol=1e-4)
    jm, _ = jnet.apply(params, jobs, method="distribution")
    with torch.no_grad():
        tm, tstd = tnet.distribution(tobs)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tstd[0].detach().numpy(), flat["std"])
