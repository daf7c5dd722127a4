"""Time the decimation kernel at each candidate lane count on the card.

    python -m ti5_isaacgym_tpu_torch.scripts.lanes_sweep [--num_envs 4096]

``csrc/decimation.cu`` fixes the threads per env at compile time
(``#define LANES``).  This script writes a copy of the source for each
candidate (8, 16, 32) under ``build/ti5_torch_kernels/lanes/``, builds them
in parallel with the kernel's own nvcc flags, and on the full task's real
inputs (as ``chip_smoke.py`` makes them) holds each against the plain version
(both flag settings) and times it at ``--num_envs`` and twice that, in the
order 8, 16, 32, 32, 16, 8.  Prints the ptxas report of each, one line per
timing, and last a JSON line with all of it.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..physics import megakernel as mk

CANDIDATES = (8, 16, 32)


def candidate_sources(out_dir: str) -> dict:
    """{lanes: path} of the source copies, the LANES line rewritten."""
    with open(mk.SOURCE) as f:
        src = f.read()
    line = re.search(r"^#define LANES (\d+)", src, re.M)
    if line is None:
        raise RuntimeError("no '#define LANES' line in csrc/decimation.cu")
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for g in CANDIDATES:
        path = os.path.join(out_dir, f"decimation_lanes{g}.cu")
        with open(path, "w") as f:
            f.write(src[:line.start()] + f"#define LANES {g}" + src[line.end():])
        paths[g] = path
    return paths


def build_all(paths: dict) -> dict:
    """Build every candidate at once (one nvcc each); {lanes: (lib, info)}.
    A failed build raises."""
    infos = {g: {} for g in paths}
    with ThreadPoolExecutor(len(paths)) as pool:
        futures = {g: pool.submit(mk.build, paths[g], infos[g]) for g in paths}
        return {g: (futures[g].result(), infos[g]) for g in paths}


def ptxas_summary(report: str) -> str:
    return "; ".join(ln.strip() for ln in report.splitlines()
                     if "registers" in ln or "spill" in ln or "stack frame" in ln)


def main(argv=None):
    p = argparse.ArgumentParser("time the decimation kernel per lane count")
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--reps", type=int, default=50)
    args = p.parse_args(argv)
    sys.path.insert(0, mk.REPO_ROOT)
    import chip_smoke

    if not torch.cuda.is_available():
        raise RuntimeError("lanes_sweep needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True,
                         stdin=subprocess.DEVNULL).stdout.strip().splitlines()[0]
    built = build_all(candidate_sources(os.path.join(mk.BUILD_DIR, "lanes")))
    result = {"card": smi, "num_envs": args.num_envs, "candidates": {}}
    for g, (path, info) in built.items():
        report = ptxas_summary(info.get("ptxas", ""))
        print(f"lanes {g}: build {info.get('seconds', 0.0):.1f} s, ptxas: {report}", flush=True)
        result["candidates"][g] = {"ptxas": report, "ms": [], "ms_wide": [], "host_us": [],
                                   "max_abs_err": 0.0}
    env, policy, state, obs = chip_smoke.make_env(args.num_envs, "cuda")
    inputs = chip_smoke.decimation_inputs(env, state, obs, policy)
    wide = {k: torch.cat([v, v], dim=1).contiguous() for k, v in inputs.items()}
    dargs = env.decimation_args()
    libs = {g: mk.load_library(path) for g, (path, _) in built.items()}
    for g in CANDIDATES + CANDIDATES[::-1]:
        # route run_decimation through this candidate; each library has its
        # own constant block, so upload it anew
        mk._lib = libs[g]
        mk._consts_uploaded.clear()
        if mk._lib.ti5_decim_lanes() != g:
            raise AssertionError(f"library for {g} lanes reports {mk._lib.ti5_decim_lanes()}")
        cand = result["candidates"][g]
        if not cand["ms"]:
            for flags in (False, True):
                cand["max_abs_err"] = max(cand["max_abs_err"], chip_smoke.compare(
                    env, inputs, flags, f"{g} lanes, {args.num_envs} envs"))
        ms, host_us, _ = chip_smoke.time_kernel(dargs, inputs, args.reps)
        ms_wide, _, _ = chip_smoke.time_kernel(dargs, wide, args.reps)
        cand["ms"].append(ms)
        cand["ms_wide"].append(ms_wide)
        cand["host_us"].append(host_us)
        print(f"lanes {g}: {ms:.4f} ms at {args.num_envs} envs, {ms_wide:.4f} ms at "
              f"{2 * args.num_envs} envs (mean of {args.reps}), host {host_us:.1f} us/launch "
              f"on {smi}", flush=True)
    mk._lib = None
    mk._consts_uploaded.clear()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
