"""Build and run the native deployment runtime (``native/ti5_infer.cc``) on
an exported policy.

The runtime reads the exported npz or the ONNX file and prints, for each
observation line of its input file, the 12 action means and the 3
estimated base velocities.  :func:`build` compiles the repo's source with
``g++ -O2 -std=c++17`` into a directory of the caller's choosing (never
into ``native/``).
"""
from __future__ import annotations

import os
import subprocess

import numpy as np

SOURCE = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native",
                                      "ti5_infer.cc"))


def build(out_dir: str, cxx: str = "g++") -> str:
    """Compile the runtime into ``out_dir/ti5_infer``; returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    binary = os.path.join(out_dir, "ti5_infer")
    res = subprocess.run([cxx, "-O2", "-std=c++17", "-o", binary, SOURCE],
                         capture_output=True, text=True, timeout=600, stdin=subprocess.DEVNULL)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed to build {SOURCE}:\n{res.stderr}")
    return binary


def run(binary: str, model_path: str, obs: np.ndarray, work_dir: str) -> np.ndarray:
    """The runtime's [B, 15] output (action means, then estimated base
    velocities) on ``obs`` [B, 3102], passed through a text file in
    ``work_dir``."""
    obs_file = os.path.join(work_dir, "ti5_infer_obs.txt")
    with open(obs_file, "w") as f:
        for row in np.asarray(obs, np.float32):
            f.write(" ".join(f"{v:.8g}" for v in row) + "\n")
    res = subprocess.run([binary, model_path, obs_file], capture_output=True, text=True,
                         timeout=600, stdin=subprocess.DEVNULL)
    if res.returncode != 0:
        raise RuntimeError(f"{binary} {model_path} failed:\n{res.stderr}")
    return np.array([[float(v) for v in line.split()]
                     for line in res.stdout.strip().splitlines()], np.float32)
