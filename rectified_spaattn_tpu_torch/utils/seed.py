"""Determinism helpers (reference: utils/seed.py:8-24).

Seeds the host-side RNGs (python, numpy) and returns an explicit
``torch.Generator`` on the target device — the port draws every random
number from a generator it is handed, never from torch's global state."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int, device="cpu") -> torch.Generator:
    """Seed python + numpy and return a torch.Generator for ``device``."""
    random.seed(seed)
    np.random.seed(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
