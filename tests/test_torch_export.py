"""The port's deployment export against the JAX package's.

From the same weights (a flax init, its leaves as numpy the way a restored
checkpoint holds them), the port writes npz arrays with the same keys in
the same order, and manifest, ONNX and controller-YAML bytes (T1 and K1)
equal to the JAX exporter's.  ``flat_from_params`` inverts
``params_from_flat`` bit for bit.  The port's ONNX runs in its numpy runtime
and in ``native/ti5_infer`` (built with g++ into ``tmp_path``) within 2e-4
of the forward (tests/test_native.py:22-48,91-92).  ``restore_policy_params``
reads a runner checkpoint of another env count, and a full ``load`` of one
raises.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti5_isaacgym_tpu.algo.networks import ActorCriticDH as JNet
from ti5_isaacgym_tpu.configs.k1_dh_stand import k1_env_cfg as jk1_env_cfg
from ti5_isaacgym_tpu.configs.t1_dh_stand import T1EnvCfg as JEnvCfg
from ti5_isaacgym_tpu.export import onnx as jonnx
from ti5_isaacgym_tpu.export import policy as jpolicy
from ti5_isaacgym_tpu_torch.algo.convert import flat_from_params, load_npz, params_from_flat
from ti5_isaacgym_tpu_torch.algo.networks import ActorCriticDH
from ti5_isaacgym_tpu_torch.configs.k1_dh_stand import k1_env_cfg
from ti5_isaacgym_tpu_torch.configs.t1_dh_stand import T1EnvCfg
from ti5_isaacgym_tpu_torch.export import native, onnx_runtime
from ti5_isaacgym_tpu_torch.export.onnx import export_onnx_dh, parse_model_summary
from ti5_isaacgym_tpu_torch.export.policy import (export_controller_yaml, export_npz,
                                                  restore_policy_params, yaml_dump)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ROUND5 = os.path.join(ROOT, "eval_round5", "final", "exported")


@pytest.fixture(scope="module")
def weights():
    """(JAX params as numpy, the port's params, 4 seeded observations)."""
    net = JNet()
    params = net.init(jax.random.PRNGKey(42), jnp.zeros((1, 3102)), jnp.zeros((1, 219)))
    jparams = jax.tree.map(np.asarray, params)
    flat = jpolicy._flatten_params(jparams["params"])
    obs = np.random.default_rng(7).normal(size=(4, 3102)).astype(np.float32) * 0.3
    return net, jparams, params_from_flat(flat), obs


def test_flat_from_params_inverts_params_from_flat(weights):
    _, jparams, tparams, _ = weights
    for flat in (jpolicy._flatten_params(jparams["params"]),
                 dict(np.load(os.path.join(ROUND5, "policy_dh.npz")))):
        got = flat_from_params(params_from_flat(flat))
        assert list(got) == list(flat)
        for k, v in flat.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            assert got[k].tobytes() == v.tobytes(), k


def test_npz_and_manifest_match_jax(weights, tmp_path):
    jnet, jparams, tparams, _ = weights
    jpath = jpolicy.export_npz(jnet, jparams, str(tmp_path / "jax"))
    tpath = export_npz(ActorCriticDH(num_critic_obs=219), tparams, str(tmp_path / "port"))
    with np.load(jpath) as jf, np.load(tpath) as tf:
        assert tf.files == jf.files
        for k in jf.files:
            assert tf[k].dtype == jf[k].dtype and tf[k].tobytes() == jf[k].tobytes(), k
    with open(jpath[:-4] + ".json", "rb") as jf, open(tpath[:-4] + ".json", "rb") as tf:
        assert tf.read() == jf.read()


def test_onnx_bytes_match_jax_and_run(weights, tmp_path):
    jnet, jparams, tparams, obs = weights
    jpath = jonnx.export_onnx_dh(jparams, str(tmp_path / "jax.onnx"))
    tpath = export_onnx_dh(tparams, str(tmp_path / "port.onnx"))
    with open(jpath, "rb") as jf, open(tpath, "rb") as tf:
        assert tf.read() == jf.read()
    s = parse_model_summary(tpath)
    assert s["io"] == ["obs", "action_mean", "est_vel"] and s["opset"] == 11
    net = ActorCriticDH(num_critic_obs=219)
    net.load_state_dict(tparams)
    with torch.no_grad():
        act_t, est_t = (x.numpy() for x in net.act_inference(torch.from_numpy(obs[:1])))
    act_j, est_j = jnet.apply(jparams, jnp.asarray(obs[:1]), method="act_inference")
    out = onnx_runtime.run_file(tpath, {"obs": obs[:1]})
    for want in ((act_t, est_t), (np.asarray(act_j), np.asarray(est_j))):
        np.testing.assert_allclose(out["action_mean"], want[0], atol=2e-4)
        np.testing.assert_allclose(out["est_vel"], want[1], atol=2e-4)


@pytest.mark.parametrize("robot", ["t1", "k1"])
def test_controller_yaml_bytes_match_jax(robot, tmp_path):
    port_cfg, jax_cfg = (T1EnvCfg(), JEnvCfg()) if robot == "t1" else (k1_env_cfg(), jk1_env_cfg())
    jpath = jpolicy.export_controller_yaml(jax_cfg, str(tmp_path / "jax"))
    tpath = export_controller_yaml(port_cfg, str(tmp_path / "port"))
    with open(jpath, "rb") as jf, open(tpath, "rb") as tf:
        assert tf.read() == jf.read()


def test_yaml_emitter_spells_scalars_as_pyyaml():
    import yaml

    tree = {"a": {"f": 1.0e-05, "g": 1e17, "h": -0.0, "i": 3, "j": True, "k": False,
                  "l": 0.1, "m": 2.5e-12, "n": -7, "o": 123456789.0},
            "b": {"c": {"d": 0.85}}}
    assert yaml_dump(tree) == yaml.safe_dump(tree, sort_keys=False)
    for bad in ({"a": "needs: quoting"}, {"on": 1}, {"a": None}, {"a": float("inf")},
                {"a": {}}):
        with pytest.raises(TypeError):
            yaml_dump(bad)


def test_golden_round5_export(tmp_path):
    """The port's export of the committed round-5 npz reproduces the committed
    ONNX and manifest byte for byte, and T1's YAML the committed one."""
    tparams = params_from_flat(dict(np.load(os.path.join(ROUND5, "policy_dh.npz"))))
    paths = {"ti5_dh_policy.onnx": export_onnx_dh(tparams, str(tmp_path / "ti5_dh_policy.onnx")),
             "policy_dh.json": export_npz(ActorCriticDH(num_critic_obs=219), tparams,
                                          str(tmp_path))[:-4] + ".json",
             "policy_config.yaml": export_controller_yaml(T1EnvCfg(), str(tmp_path))}
    for name, path in paths.items():
        with open(path, "rb") as got, open(os.path.join(ROUND5, name), "rb") as want:
            assert got.read() == want.read(), name


def test_native_runtime_runs_the_ports_export(weights, tmp_path):
    """tests/test_native.py:22-48 and :126-150 on the port's files: the
    native runtime on the port's npz and on its ONNX bytes within 2e-4 of
    the JAX forward, and ``load_npz`` of the export equal to the params."""
    jnet, jparams, tparams, obs = weights
    npz = export_npz(ActorCriticDH(num_critic_obs=219), tparams, str(tmp_path))
    onnx_path = export_onnx_dh(tparams, str(tmp_path / "p.onnx"))
    binary = native.build(str(tmp_path / "bin"))
    act_j, est_j = (np.asarray(x) for x in jnet.apply(jparams, jnp.asarray(obs),
                                                       method="act_inference"))
    for model in (npz, onnx_path):
        got = native.run(binary, model, obs, str(tmp_path))
        assert got.shape == (4, 15)
        np.testing.assert_allclose(got[:, :12], act_j, atol=2e-4, err_msg=model)
        np.testing.assert_allclose(got[:, 12:], est_j, atol=2e-4, err_msg=model)
    loaded = load_npz(npz).state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in tparams.items())


def test_restore_policy_params_any_env_count(tmp_path):
    """A checkpoint of a 4-env runner: ``restore_policy_params`` returns its
    params and iteration; a 2-env runner loads the params only, and a full
    load raises naming both env counts."""
    from ti5_isaacgym_tpu_torch.algo.runner import OnPolicyRunner
    from ti5_isaacgym_tpu_torch.envs.t1_dh_stand import T1DHStandEnv
    from ti5_isaacgym_tpu_torch.utils.registry import task_registry

    env_cfg, train_cfg = task_registry.get_cfgs("t1_flat")

    def runner(n):
        cfg = dataclasses.replace(env_cfg, env=dataclasses.replace(env_cfg.env, num_envs=n))
        return OnPolicyRunner(T1DHStandEnv(cfg, seed=0, device="cpu"), cfg, train_cfg)

    r4 = runner(4)
    carry = r4.init_carry()
    r4.iteration_count = 7
    path = r4.save(carry, path=str(tmp_path / "model_7.pt"), keep_last=0)
    params, it = restore_policy_params(path)
    assert it == 7 and set(params) == set(carry.ts.params)
    assert all(torch.equal(params[k], v) for k, v in carry.ts.params.items())
    r2 = runner(2)
    c2 = r2.load(path, params_only=True)
    assert all(torch.equal(c2.ts.params[k], v) for k, v in params.items())
    assert c2.obs.shape[0] == 2 and r2.iteration_count == 7
    with pytest.raises(ValueError, match="holds 4 envs but the env has 2"):
        r2.load(path)
    with open(os.path.join(ROUND5, "policy_dh.json")) as f:
        assert json.load(f)["format"] == "ti5-npz-v1"
