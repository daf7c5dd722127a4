"""Card-only checks of the CUDA decimation kernel and training (marker ``gpu``).

They build ``csrc/decimation.cu`` and hold the kernel against its plain
version on one decimation of the full task at 16 and at 4096 envs, each also
with one env fewer (a ragged last block) and with a seeded external wrench,
both flag settings (the tolerances of chip_smoke.py); check that the plain
version divides as the kernel does; check that a rollout launches the kernel
once per policy step; run chip_smoke.py's training phase at 1024 envs;
run a K1 training iteration through the registry at 1024 envs (phase 7's
checks: 24 launches, the kernel bit-equal to its plain version, the cells
equal to ``gather_contact_cells``); export a checkpoint of the train CLI
and hold ``load_npz`` of it bit-equal to the runner's policy on the card;
and run chip_smoke.py's data-parallel phase at 1024 envs.
Without a card they skip; whether a card is present
is decided inside the fixture.  On the card:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("num_envs", [16, 4096])
def test_kernel_matches_plain_version(card, num_envs):
    env, policy, state, obs = chip_smoke.make_env(num_envs, card)
    worst = chip_smoke.phase_compare(env, state, obs, policy)
    assert worst < 2.0


def test_rollout_launches_kernel_once_per_step(card):
    env, policy, state, obs = chip_smoke.make_env(64, card, terrain_rows=4)
    state, obs, launches, _ = chip_smoke.phase_rollout(env, policy, state, obs, steps=5)
    assert launches == 5


def test_training_iteration_on_the_card(card, tmp_path):
    """One training iteration at 1024 envs (2x2 terrain, 24 steps) and the
    checks of chip_smoke.py phase 6: 24 kernel launches per iteration,
    finite and moved params, lr in range, a bit-exact save -> load round
    trip and iteration after it, the kernel against its plain version after
    the iteration."""
    runner = chip_smoke.make_runner(1024, card, terrain_rows=2)
    assert runner.env.use_kernel_path
    out = chip_smoke.phase_train(runner, checkpoint=str(tmp_path / "model.pt"))
    assert out["launches"] == [24] * 6 and out["peak_bytes"] > 0 and out["worst"] < 2.0


def test_plain_version_divides_like_the_kernel(card):
    """The plain version's divisions by and of model constants round as one
    IEEE float32 division on the card (as in the kernel), not as PyTorch's
    multiplication by a reciprocal."""
    import numpy as np

    from ti5_isaacgym_tpu_torch.physics.engine_core import _div, _over

    x = np.random.default_rng(0).normal(size=1 << 20).astype(np.float32)
    for c in (0.1, 0.001, 2.0e6, 22.0):
        got = _div(torch.from_numpy(x).to(card), c).cpu().numpy()
        np.testing.assert_array_equal(got, x / np.float32(c))
        got = _over(c, torch.from_numpy(x).to(card)).cpu().numpy()
        np.testing.assert_array_equal(got, np.float32(c) / x)


def test_k1_training_iteration_on_the_card(card, tmp_path):
    runner = chip_smoke.make_task_runner("k1_dh_stand", 1024, card, str(tmp_path))
    assert runner.env.use_kernel_path and runner.env.model.ncp == 16
    out = chip_smoke.phase_task("k1_dh_stand", runner, 1)
    assert out["launches"] == [24] * 3 and out["bit_equal_share"] == 1.0
    assert out["cells"]["same_cell"] == out["cells"]["points"] == 16 * 1024


def test_data_parallel_iteration_on_the_card(card, tmp_path):
    """chip_smoke.py phase 8 at 1024 global envs (2x2 terrain): world size 1
    over NCCL bit-equal to the plain runner; 2 ranks on the card (``cuda:0``
    twice, over gloo, or two cards over NCCL), 24 launches per rank in each
    iteration, the train state bit-equal across ranks, the full-batch update
    within its limits, the lead's checkpoint alone."""
    out = chip_smoke.phase_parallel(card, num_envs=1024, terrain_rows=2, root=str(tmp_path))
    assert out["world1"]["backend"] == "nccl" and out["world1"]["launches"] == 24
    for r in out["ranks"]:
        assert r["launches"] == [24] * 4 and r["replicated"] == [(0, 0.0)] * 4
        assert r["num_envs"] == 512 and r["device"].startswith("cuda")
    assert out["ranks"][0]["gaps"]["params"] <= 1e-5
    assert os.listdir(tmp_path) == ["model_4.pt"]


def test_export_round_trip_on_the_card(card, tmp_path):
    import torch

    from ti5_isaacgym_tpu_torch.scripts import train

    runner = train.main(["--task", "k1_dh_stand", "--num_envs", "256", "--max_iterations", "1",
                         "--log_root", str(tmp_path / "runs")])
    out = chip_smoke.phase_export(torch.device(card), str(tmp_path), runner)
    assert max(out["gaps"].values()) <= 2e-4
