"""The decimation megakernel: one policy step of physics in one launch.

Replaces the Pallas TPU kernel ``ti5_isaacgym_tpu/physics/megakernel.py::
run_decimation`` (``pl.pallas_call`` at :236) with the hand-written CUDA
kernel ``csrc/decimation.cu`` for Hopper (``sm_90a``), built with ``nvcc``
into a shared library with a C interface and called through ``ctypes``.

Data contract (float32, row-major ``[rows, N]``, env contiguous):

* inputs: state 37 (bp3 bq4 bw3 bv3 qpos12 qvel12), anchors 3*ncp
  (ax | ay | az), cells 6*ncp (x0|y0|h00|h10|h01|h11), dyn 13*nb+nd+2 (mass
  com inertia armature friction restitution), ctrl 5*nd (p d offs coul visc),
  lagged actions dec*nd (pre-scaled, lag-resolved), torque-noise multipliers
  dec*nd, external wrench 6 (world force+torque, substep 0 only), apparent
  contact masses 2*ncp;
* outputs: state 37, anchors 3*ncp, body contact forces 3*nb and torques nd
  of the last substep, dof snapshots dec*2*nd and IMU snapshots dec*7
  (angvel3 + quat4), newest last, and the 24 ``ctx_stack_rows`` rows.

:func:`run_decimation` launches the kernel for CUDA tensors (or raises) and
runs :func:`run_decimation_plain`, the same math as a torch loop over
:func:`.engine_core.substep_stacked`, for CPU tensors.

What bounds it on an H100: moving 1,396 float32 rows per env is 22.9 MB at
4096 envs (6.8 us at 3.35 TB/s); its ~210 k float32 operations per env take
12.8 us at 67 TFLOP/s, so operations bound it.  The kernel spreads each env
over ``ti5_decim_lanes()`` threads (dofs, bodies, contact points and tree
levels) with the body state in shared memory; the serial tree passes, not
the bound, set its time (see the source note and PERF.md).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from typing import Tuple

import numpy as np
import torch

from .contact import CellCache, ContactOpts
from .engine import SolverOpts
from .engine_core import ModelConsts, ctx_row_layout, ctx_stack_rows, substep_stacked

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "csrc", "decimation.cu")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "ti5_torch_kernels")

# array limits compiled into DecimConsts (csrc/decimation.cu)
MAXB, MAXD, MAXP, MAXK = 16, 15, 40, 4

# launches of the CUDA kernel; the plain version does not count
launches = 0
# calls of run_decimation with CPU tensors, which run the plain version (a
# CPU rehearsal of a launch count checks this one)
plain_runs = 0

_lib = None
_lib_lock = threading.Lock()
_consts_uploaded = {}          # device index -> bytes of the last upload
_consts_cache = {}             # static arguments -> DecimConsts bytes
last_build = {}                # seconds and ptxas report of this process's build


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA decimation kernel is built from csrc/decimation.cu at first use")


def build(source: str = None, info: dict = None) -> str:
    """Compile ``source`` (default ``csrc/decimation.cu``) into
    ``build/ti5_torch_kernels/`` unless a library built from the same source
    bytes is already there.  The seconds and the ptxas report go into
    ``info`` (default :data:`last_build`)."""
    import time

    source = SOURCE if source is None else source
    with open(source, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libti5_decimation_{tag}.so")
    info = last_build if info is None else info
    if os.path.exists(out):
        info.update(seconds=0.0, cached=True, ptxas="")
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           # unfused multiply-add keeps the kernel's rounding that of the
           # plain torch version it is held against
           "--fmad=false", "-o", tmp, os.path.abspath(source)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         stdin=subprocess.DEVNULL)
    secs = time.perf_counter() - t0
    print(res.stdout + res.stderr, file=sys.stderr, flush=True)   # ptxas -v report
    res.check_returncode()
    os.replace(tmp, out)
    info.update(seconds=secs, cached=False, ptxas=res.stderr)
    return out


def load_library(path: str) -> ctypes.CDLL:
    """A built kernel library with its C interface typed."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ti5_decim_consts_size, lib.ti5_decim_lanes):
        fn.argtypes = []
        fn.restype = ci
    lib.ti5_decim_set_consts.argtypes = [vp, ci, vp]
    lib.ti5_decim_set_consts.restype = ci
    lib.ti5_decim_launch.argtypes = [vp] * 16 + [ci, ci, ci, ci, vp]
    lib.ti5_decim_launch.restype = ci
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_library(build())
    return _lib


def schedule(mc: ModelConsts) -> dict:
    """The kernel's schedule tables for a tree with ``parent[i] < i``:

    * ``lev_body``/``lev_start``: the bodies by tree level (level ``l`` is
      ``lev_body[lev_start[l]:lev_start[l + 1]]``, ascending index), ``nlev``
      levels, the base alone on level 0;
    * ``ch_list``/``ch_start``: each body's children in the order the plain
      version folds them into it (``for i in range(nb - 1, 0, -1)``:
      descending index);
    * ``cp_order``/``cp_start``: each body's contact points in the order the
      plain version sums them (ascending index).
    """
    nb, ncp = mc.nb, mc.ncp
    level = [0] * nb
    for i in range(1, nb):
        p = int(mc.parent[i])
        if not 0 <= p < i:
            raise ValueError(f"body {i} has parent {p}: the kernel needs 0 <= parent[i] < i")
        level[i] = level[p] + 1
    nlev = max(level) + 1
    lev_body = sorted(range(nb), key=lambda i: (level[i], i))
    lev_start = [sum(1 for x in level if x < l) for l in range(nlev + 1)]
    ch_list, ch_start = [], [0]
    for p in range(nb):
        ch_list += [i for i in range(nb - 1, 0, -1) if mc.parent[i] == p]
        ch_start.append(len(ch_list))
    cp_order, cp_start = [], [0]
    for b in range(nb):
        cp_order += [c for c in range(ncp) if mc.cp_body[c] == b]
        cp_start.append(len(cp_order))
    return dict(nlev=nlev, lev_start=lev_start, lev_body=lev_body, ch_start=ch_start,
                ch_list=ch_list, cp_start=cp_start, cp_order=cp_order)


def consts_bytes(mc: ModelConsts, hscale: float, copts: ContactOpts, sopts: SolverOpts,
                 decimation: int, default_q, torque_limits, feet_bodies, knee_bodies) -> bytes:
    """The ``DecimConsts`` struct of ``csrc/decimation.cu`` as bytes: an int32
    block, then a float32 block, in declaration order."""
    nb, nd, ncp = mc.nb, mc.nd, mc.ncp
    feet, knees = list(feet_bodies or []), list(knee_bodies or [])
    if nb > MAXB or nd > MAXD or ncp > MAXP or len(feet) > MAXK or len(knees) > MAXK:
        raise ValueError(f"model exceeds the kernel's limits: nb={nb} nd={nd} ncp={ncp}")

    def pad(x, n):
        a = np.zeros(n, np.float64)
        x = np.asarray(x, np.float64).ravel()
        a[:x.size] = x
        return a

    sch = schedule(mc)
    ints = np.concatenate([
        [nb, nd, ncp, int(decimation), len(feet), len(knees), sch["nlev"]],
        pad(mc.parent, MAXB), pad([int(x) for x in mc.jrot_identity], MAXB),
        pad(mc.cp_body, MAXP), pad(feet, MAXK), pad(knees, MAXK),
        pad(sch["lev_start"], MAXB + 1), pad(sch["lev_body"], MAXB),
        pad(sch["ch_start"], MAXB + 1), pad(sch["ch_list"], MAXB),
        pad(sch["cp_start"], MAXB + 1), pad(sch["cp_order"], MAXP)]).astype(np.int32)
    kt_v = copts.kt * copts.dt + copts.kdt
    floats = np.concatenate([
        pad(mc.axis_c, MAXB * 3), pad(mc.jpos_c, MAXB * 3), pad(mc.jrot_c, MAXB * 9),
        pad(mc.cp_pos_c, MAXP * 3), pad(mc.dof_lower, MAXD), pad(mc.dof_upper, MAXD),
        pad(mc.dof_effort, MAXD), pad(default_q, MAXD), pad(torque_limits, MAXD),
        [hscale, copts.kp, copts.kd, copts.kt, copts.kp * copts.dt, kt_v, copts.dt * kt_v,
         copts.max_depth, copts.max_force, copts.dt, copts.max_depen_vel,
         sopts.dt, sopts.gravity, sopts.limit_kp, sopts.limit_kd, sopts.max_qvel],
    ]).astype(np.float32)
    return ints.tobytes() + floats.tobytes()


def _cached_consts(mc, hscale, copts, sopts, dec, default_q, torque_limits, feet, knees):
    """:func:`consts_bytes`, built once per set of static arguments (the env
    passes the same ones on every step)."""
    key = (id(mc), float(hscale), copts, sopts, dec,
           np.asarray(default_q, np.float32).tobytes(),
           np.asarray(torque_limits, np.float32).tobytes(),
           None if feet is None else tuple(feet), None if knees is None else tuple(knees))
    hit = _consts_cache.get(key)
    if hit is None or hit[0] is not mc:
        if len(_consts_cache) > 16:
            _consts_cache.clear()
        hit = _consts_cache[key] = (mc, consts_bytes(mc, hscale, copts, sopts, dec, default_q,
                                                     torque_limits, feet, knees))
    return hit[1]


def _out_rows(mc: ModelConsts, dec: int, with_ctx: bool, nf: int, nk: int):
    rows = (13 + 2 * mc.nd, 3 * mc.ncp, 3 * mc.nb, mc.nd, dec * 2 * mc.nd, dec * 7)
    if with_ctx:
        rows = rows + (ctx_row_layout(nf, nk)["total"],)
    return rows


_meff_cache = {}               # (masses, n, device) -> [2*ncp, n] rows


def _default_meff(cp_meff, n, device):
    """The model's apparent contact masses as [2*ncp, n] rows, made once per
    (masses, n, device).  Made anew, the copy from pageable host memory would
    wait for the stream to drain on every launch, and the host could never
    run ahead of the kernels."""
    col = np.asarray(cp_meff, np.float32).T.reshape(-1)
    key = (col.tobytes(), int(n), str(device))
    rows = _meff_cache.get(key)
    if rows is None:
        if len(_meff_cache) > 16:
            _meff_cache.clear()
        m = torch.as_tensor(col, device=device)
        rows = _meff_cache[key] = m[:, None].expand(-1, n).contiguous()
    return rows


def run_decimation(mc: ModelConsts, hscale: float, copts: ContactOpts, sopts: SolverOpts,
                   decimation: int, default_q, torque_limits, cp_meff,
                   use_coulomb: bool, use_noise: bool,
                   state_rows, anchor_rows, cell_rows, dyn_rows, ctrl_rows,
                   lagged_rows, noise_rows, extw_rows, meff_rows=None,
                   feet_bodies=None, knee_bodies=None) -> Tuple[torch.Tensor, ...]:
    """One launch for the whole decimation loop (see the module docstring for
    the row contract).  Returns (state 37, anchors 3*ncp, forces 3*nb,
    torques nd, dof snapshots, IMU snapshots[, ctx 24]), all [rows, N].

    CUDA tensors launch ``csrc/decimation.cu``; CPU tensors run
    :func:`run_decimation_plain`.
    """
    global launches, plain_runs
    dev = state_rows.device
    if dev.type == "cpu":
        plain_runs += 1
        return run_decimation_plain(
            mc, hscale, copts, sopts, decimation, default_q, torque_limits, cp_meff,
            use_coulomb, use_noise, state_rows, anchor_rows, cell_rows, dyn_rows,
            ctrl_rows, lagged_rows, noise_rows, extw_rows, meff_rows,
            feet_bodies, knee_bodies)
    if dev.type != "cuda":
        raise ValueError(f"run_decimation: unsupported device {dev}")
    nb, nd, ncp = mc.nb, mc.nd, mc.ncp
    dec = int(decimation)
    n = int(state_rows.shape[1])
    if meff_rows is None:
        meff_rows = _default_meff(cp_meff, n, dev)
    inputs = (state_rows, anchor_rows, cell_rows, dyn_rows, ctrl_rows, lagged_rows,
              noise_rows, extw_rows, meff_rows)
    want = (13 + 2 * nd, 3 * ncp, 6 * ncp, 13 * nb + nd + 2, 5 * nd, dec * nd, dec * nd, 6,
            2 * ncp)
    names = ("state", "anchor", "cell", "dyn", "ctrl", "lagged", "noise", "extw", "meff")
    for a, r, nm in zip(inputs, want, names):
        if a.device != dev or a.dtype != torch.float32 or tuple(a.shape) != (r, n) \
                or not a.is_contiguous():
            raise ValueError(f"run_decimation: {nm}_rows must be a contiguous float32 "
                             f"[{r}, {n}] tensor on {dev}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    with_ctx = feet_bodies is not None and knee_bodies is not None
    nf = len(feet_bodies) if with_ctx else 0
    nk = len(knee_bodies) if with_ctx else 0
    outs = tuple(torch.empty((r, n), dtype=torch.float32, device=dev)
                 for r in _out_rows(mc, dec, with_ctx, nf, nk))
    lib = _load()
    blob = _cached_consts(mc, hscale, copts, sopts, dec, default_q, torque_limits,
                          feet_bodies if with_ctx else None, knee_bodies if with_ctx else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if _consts_uploaded.get(dev.index) != blob:
        if lib.ti5_decim_consts_size() != len(blob):
            raise RuntimeError(f"DecimConsts is {lib.ti5_decim_consts_size()} bytes in the "
                               f"kernel, {len(blob)} in the wrapper")
        with torch.cuda.device(dev):
            buf = ctypes.create_string_buffer(blob, len(blob))
            err = lib.ti5_decim_set_consts(buf, len(blob), stream)
        if err != 0:
            raise RuntimeError(f"ti5_decim_set_consts failed: CUDA error {err}")
        _consts_uploaded[dev.index] = blob
    cx = outs[6].data_ptr() if with_ctx else None
    ptrs = [a.data_ptr() for a in inputs] + [o.data_ptr() for o in outs[:6]] + [cx]
    with torch.cuda.device(dev):
        err = lib.ti5_decim_launch(*ptrs, n, int(bool(use_coulomb)), int(bool(use_noise)),
                                   int(with_ctx), stream)
    if err != 0:
        raise RuntimeError(f"decimation kernel launch failed: CUDA error {err}")
    launches += 1
    return outs


def run_decimation_plain(mc: ModelConsts, hscale: float, copts: ContactOpts,
                         sopts: SolverOpts, decimation: int, default_q, torque_limits,
                         cp_meff, use_coulomb: bool, use_noise: bool,
                         state_rows, anchor_rows, cell_rows, dyn_rows, ctrl_rows,
                         lagged_rows, noise_rows, extw_rows, meff_rows=None,
                         feet_bodies=None, knee_bodies=None) -> Tuple[torch.Tensor, ...]:
    """The kernel's math as a torch loop over :func:`substep_stacked`."""
    nb, nd, ncp = mc.nb, mc.nd, mc.ncp
    dec = int(decimation)
    tl = [float(t) for t in np.asarray(torque_limits)]
    dq_c = [float(t) for t in np.asarray(default_q)]
    n = int(state_rows.shape[1])
    if meff_rows is None:
        meff_rows = _default_meff(cp_meff, n, state_rows.device)
    st, an, cl, dy, ct, ew, me = (state_rows, anchor_rows, cell_rows, dyn_rows, ctrl_rows,
                                  extw_rows, meff_rows)
    cells = CellCache(x0=cl[0:ncp], y0=cl[ncp:2 * ncp], h00=cl[2 * ncp:3 * ncp],
                      h10=cl[3 * ncp:4 * ncp], h01=cl[4 * ncp:5 * ncp],
                      h11=cl[5 * ncp:6 * ncp])
    mass = [dy[i] for i in range(nb)]
    com = [(dy[nb + 3 * i], dy[nb + 3 * i + 1], dy[nb + 3 * i + 2]) for i in range(nb)]
    o = 4 * nb
    inert = [tuple(tuple(dy[o + 9 * i + 3 * r + c] for c in range(3)) for r in range(3))
             for i in range(nb)]
    o += 9 * nb
    arma = [dy[o + j] for j in range(nd)]
    friction, restitution = dy[o + nd], dy[o + nd + 1]
    p_g = [ct[j] for j in range(nd)]
    d_g = [ct[nd + j] for j in range(nd)]
    offs = [ct[2 * nd + j] for j in range(nd)]
    coul = [ct[3 * nd + j] for j in range(nd)]
    visc = [ct[4 * nd + j] for j in range(nd)]

    bp, bq = (st[0], st[1], st[2]), (st[3], st[4], st[5], st[6])
    bw, bv = (st[7], st[8], st[9]), (st[10], st[11], st[12])
    qpos = [st[13 + j] for j in range(nd)]
    qvel = [st[13 + nd + j] for j in range(nd)]
    ax_, ay_, az_ = an[0:ncp], an[ncp:2 * ncp], an[2 * ncp:3 * ncp]
    ds, iss = [], []
    for k in range(dec):
        tau = []
        for j in range(nd):
            t = p_g[j] * (lagged_rows[k * nd + j] + dq_c[j] - qpos[j] + offs[j]) - d_g[j] * qvel[j]
            if use_coulomb:
                t = t - visc[j] * qvel[j] - coul[j] * torch.sign(qvel[j])
            if use_noise:
                t = t * noise_rows[k * nd + j]
            tau.append(torch.clamp(t, -tl[j], tl[j]))
        on = 1.0 if k == 0 else 0.0
        comps = dict(bp=bp, bq=bq, bw=bw, bv=bv, qpos=qpos, qvel=qvel, tau=tau,
                     mass=mass, com=com, inert=inert, arma=arma, friction=friction,
                     restitution=restitution, ax=ax_, ay=ay_, az=az_,
                     mn=me[0:ncp], mt=me[ncp:2 * ncp],
                     bf=(ew[0] * on, ew[1] * on, ew[2] * on),
                     bt=(ew[3] * on, ew[4] * on, ew[5] * on))
        out = substep_stacked(mc, hscale, copts, sopts, comps, cells=cells, cp_meff=cp_meff)
        bp, bq, bw, bv = out["bp"], out["bq"], out["bw"], out["bv"]
        qpos, qvel = list(out["qpos"]), list(out["qvel"])
        ax_, ay_, az_ = out["nax"], out["nay"], out["naz"]
        ds += qpos + qvel
        iss += [bw[0], bw[1], bw[2], bq[0], bq[1], bq[2], bq[3]]
        f_body = out["f_body"]
    outs = (
        torch.stack(list(bp) + list(bq) + list(bw) + list(bv) + qpos + qvel),
        torch.cat([ax_, ay_, az_], dim=0),
        torch.stack([c for f in f_body for c in f]),
        torch.stack(tau),
        torch.stack(ds),
        torch.stack(iss),
    )
    if feet_bodies is not None and knee_bodies is not None:
        outs = outs + (torch.stack(ctx_stack_rows(mc, list(feet_bodies), list(knee_bodies),
                                                  bp, bq, bw, bv, qpos, qvel)),)
    return outs


def count_float_ops(run, *args, **kw) -> int:
    """Elementwise float operations (one per output element of each
    arithmetic, comparison or transcendental op) that ``run(*args, **kw)``
    performs; used with :func:`run_decimation_plain` for the kernel's
    operations bound."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "mul", "div", "neg", "sqrt", "sin", "cos", "sign", "clamp",
             "clamp_min", "clamp_max", "maximum", "minimum", "where", "gt", "lt", "ge", "le",
             "bitwise_and", "bitwise_or", "logical_and", "logical_or", "reciprocal", "rsub"}

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__.split(".")[0].rstrip("_")
            if name in arith and isinstance(out, torch.Tensor):
                Count.total += out.numel()
            return out

    with Count():
        run(*args, **kw)
    return Count.total
