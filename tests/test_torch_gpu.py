"""Card-only checks of the CUDA decimation kernel (marker ``gpu``).

They build ``csrc/decimation.cu`` and hold the kernel against its plain
version on one decimation of the full task at 16 and at 4096 envs (the
tolerances of chip_smoke.py), and check that a rollout launches the kernel
once per policy step.  Without a card they skip; whether a card is present
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
