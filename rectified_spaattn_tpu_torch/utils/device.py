"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to "cuda";
asking for CUDA on a machine without a GPU raises instead of silently
running on the CPU.  The CPU runs only when the caller asks for it."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
