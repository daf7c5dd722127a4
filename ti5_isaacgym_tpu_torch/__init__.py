"""PyTorch/CUDA port of ``ti5_isaacgym_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; every module here keeps the
name and place of its JAX counterpart.  Plain tensor code is PyTorch; the one
TPU kernel of the rollout path (the decimation megakernel) is a hand-written
CUDA C++ kernel under ``csrc/``, built with ``nvcc`` at first use and bound
with ``ctypes`` (:mod:`ti5_isaacgym_tpu_torch.physics.megakernel`).

This package never imports ``jax`` or ``ti5_isaacgym_tpu``.
"""
from .utils.device import resolve_device  # noqa: F401
