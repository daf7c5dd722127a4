"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``.  Asking for
``cuda`` where no card is present raises: nothing falls back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
