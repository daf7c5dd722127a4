"""The CUDA decimation kernel's own source, compiled for the CPU, against its
plain version.

``csrc/decimation.cu`` is compiled with g++ (C++20) against
``tests/cuda_cpu_shim.h``: each CUDA thread of a block becomes a
``std::thread`` and ``__syncwarp``/``__syncthreads`` a barrier over the
block, so the kernel's lane split, schedule tables, shared-memory layout and
staging run as written, at the committed ``LANES``.  The constant block is
the wrapper's ``consts_bytes``.  Inputs: the seeded T1 case of the parity
tests at 16 envs and at a ragged 13 (the last block partly empty, envs
spread over several blocks), and the K1 model (the same tree, 16 points on
the feet), with a nonzero external wrench and both flag settings.
Tolerances are chip_smoke.py's.  The CPU's sin/cos differ from PyTorch's by
an ulp, so the comparison is not bit for bit.  Skips where g++ cannot build
C++20 with threads.
"""
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
import chip_smoke  # noqa: E402
from test_torch_megakernel import DEC, DEFAULT_Q, TL, _extra, torch_inputs  # noqa: E402
from ti5_isaacgym_tpu_torch.physics import engine_core as tec  # noqa: E402
from ti5_isaacgym_tpu_torch.physics import megakernel as mk  # noqa: E402
from ti5_isaacgym_tpu_torch.physics import model as tmodel  # noqa: E402
from ti5_isaacgym_tpu_torch.physics.contact import ContactOpts  # noqa: E402
from ti5_isaacgym_tpu_torch.physics.engine import SolverOpts  # noqa: E402
from torch_port_cases import HSCALE, make_case  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
K1_SPEC = os.path.join(HERE, "..", "ti5_isaacgym_tpu", "resources", "k1_model.json")
FEET, KNEES = [6, 12], [4, 10]

LAUNCHER = r'''
extern "C" {
int cpu_consts_size() { return (int)sizeof(DecimConsts); }
void cpu_set_consts(const void* host) { memcpy(&C, host, sizeof(DecimConsts)); }
void cpu_launch(const float* st, const float* an, const float* cl, const float* dy,
                const float* ct, const float* la, const float* no, const float* ew,
                const float* me, float* st_out, float* an_out, float* fo_out, float* tq_out,
                float* ds_out, float* is_out, float* cx_out, int n, int use_coulomb,
                int use_noise, int with_ctx) {
  Rows r = {st, an, cl, dy, ct, la, no, ew, me, st_out, an_out, fo_out, tq_out, ds_out, is_out,
            cx_out};
  std::vector<float> smem(EPB * ENV_STRIDE);
  for (int b = 0; b < (n + EPB - 1) / EPB; ++b) {
    std::fill(smem.begin(), smem.end(), NAN);   // nothing may read what it did not write
    std::barrier<> bar(BLOCK);
    std::vector<std::thread> threads;
    for (int t = 0; t < BLOCK; ++t)
      threads.emplace_back([&, t, b] {
        threadIdx.x = t; blockIdx.x = b;
        cpu_block_barrier = &bar; cpu_block_smem = smem.data();
        decimation_kernel(r, n, use_coulomb, use_noise, with_ctx);
      });
    for (auto& th : threads) th.join();
  }
}
}
'''


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    src = open(mk.SOURCE).read()
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_cpu_shim.h"')
    src = src.replace("extern __shared__ float smem[];", "float* smem = cpu_block_smem;")
    src = src[:src.index('extern "C" {')] + LAUNCHER
    out = tmp_path_factory.mktemp("cpu_kernel")
    cpp, lib = out / "decimation_cpu.cpp", out / "libdecimation_cpu.so"
    cpp.write_text(src)
    res = subprocess.run([gxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-pthread",
                          "-ffp-contract=off", "-w", "-I", HERE, "-o", str(lib), str(cpp)],
                         capture_output=True, text=True, timeout=600, stdin=subprocess.DEVNULL)
    if res.returncode != 0 and "barrier" in res.stderr and "error" in res.stderr:
        pytest.skip(f"g++ lacks C++20 std::barrier: {res.stderr[-300:]}")
    assert res.returncode == 0, res.stderr[-3000:]
    k = ctypes.CDLL(str(lib))
    k.cpu_consts_size.restype = ctypes.c_int
    k.cpu_set_consts.argtypes = [ctypes.c_void_p]
    k.cpu_launch.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4
    return k


def _t1_case(ncol):
    c, x = make_case(2), _extra(2)
    inputs, _ = torch_inputs(c, x)
    inputs = {k: v[:, :ncol].contiguous() for k, v in inputs.items()}
    return tec.model_consts(tmodel.load_t1()), c["cp_meff"], inputs


def _k1_case():
    """The T1 case's state, dynamics and controls on the K1 model: its 16
    foot points each get the frozen cell under the point, the T1 case's
    corner heights (+-1 cm around z = 0, the feet 12 mm deep) and an anchor
    3 mm off the point."""
    km = tmodel.load(K1_SPEC)
    c, x = make_case(3), _extra(3)
    inputs, _ = torch_inputs(c, x)
    ncp, n = km.ncp, inputs["state_rows"].shape[1]
    st = inputs["state_rows"]
    px, py = tec.contact_point_xy(km, type("Phys", (), dict(
        base_pos=st[0:3].T, base_quat=st[3:7].T, qpos=st[13:25].T))())
    cells = inputs["cell_rows"].reshape(6, 32, n)[:, :ncp].clone()
    cells[0] = torch.floor(px / HSCALE) * HSCALE
    cells[1] = torch.floor(py / HSCALE) * HSCALE
    rng = np.random.default_rng(3)
    off = torch.from_numpy(rng.normal(scale=0.003, size=(3, ncp, n)).astype(np.float32))
    anchors = torch.stack([px, py, torch.full_like(px, -0.005)]) + off
    inputs.update(cell_rows=cells.reshape(6 * ncp, n).contiguous(),
                  anchor_rows=anchors.reshape(3 * ncp, n).contiguous())
    return tec.model_consts(km), c["cp_meff"][:ncp], inputs


CASES = {"t1_16_envs": lambda: _t1_case(16), "t1_13_envs": lambda: _t1_case(13),
         "k1_16_envs": _k1_case}


@pytest.mark.parametrize("flags", [False, True], ids=["coulomb_noise_off", "coulomb_noise_on"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_source_on_cpu_matches_plain_version(cpu_kernel, case, flags):
    mc, cp_meff, inputs = CASES[case]()
    n = inputs["state_rows"].shape[1]
    assert bool((inputs["extw_rows"] != 0).all())
    args = dict(mc=mc, hscale=HSCALE, copts=ContactOpts(), sopts=SolverOpts(), decimation=DEC,
                default_q=DEFAULT_Q, torque_limits=TL, cp_meff=cp_meff, use_coulomb=flags,
                use_noise=flags, feet_bodies=FEET, knee_bodies=KNEES)
    want = mk.run_decimation_plain(**args, **inputs)
    blob = mk.consts_bytes(mc, HSCALE, ContactOpts(), SolverOpts(), DEC, DEFAULT_Q, TL,
                           FEET, KNEES)
    assert cpu_kernel.cpu_consts_size() == len(blob)
    cpu_kernel.cpu_set_consts(ctypes.create_string_buffer(blob, len(blob)))
    order = ("state_rows", "anchor_rows", "cell_rows", "dyn_rows", "ctrl_rows", "lagged_rows",
             "noise_rows", "extw_rows")
    ins = [inputs[k] for k in order] + [mk._default_meff(cp_meff, n, "cpu")]
    got = [torch.full((r, n), float("nan")) for r in mk._out_rows(mc, DEC, True, 2, 2)]
    cpu_kernel.cpu_launch(*[t.data_ptr() for t in ins + got], n, int(flags), int(flags), 1)
    # the case runs contact: most envs end the step on a loaded foot
    fz = want[2].reshape(mc.nb, 3, n)[FEET, 2]
    assert float((fz > 5.0).any(dim=0).float().mean()) >= 0.75
    for name, g, w in zip(chip_smoke.OUTPUTS, got, want):
        atol, rtol = chip_smoke.TOLERANCES[name]
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=atol, rtol=rtol, err_msg=name)
