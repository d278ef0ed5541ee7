"""Disk cache for Gilbert-curve index arrays and neighbor masks.

The curve build is a host-side precompute; at video scale it is the slowest
non-device step in pipeline setup, so results are cached to disk keyed by
(grid dims, axis order, block size, variant) — mirroring how the reference
precomputes once at startup (reference: scripts/main_hunyuan.py:23-42).
"""

from __future__ import annotations

import os
import hashlib

import numpy as np

from . import gilbert
from ..utils.build import BUILD_DIR

# inside the package's (gitignored) build directory, so a run reads and
# writes nothing outside its checkout; RSA_TORCH_CURVE_CACHE overrides
_DEFAULT_DIR = os.environ.get("RSA_TORCH_CURVE_CACHE",
                              os.path.join(BUILD_DIR, "curves"))


def _key(*parts) -> str:
    return hashlib.sha1("|".join(str(p) for p in parts).encode()).hexdigest()[:16]


def cached_curve(t: int, h: int, w: int, *, block_size: int = 128,
                 axis_order=("w", "h", "t"), variant: str = "full",
                 cache_dir: str | None = None):
    """Return (linear_to_hilbert, hilbert_to_linear, block_neighbor_mask),
    computing and caching to disk on first use.

    ``variant``: "full" (3-D curve), "sliced" (per-frame 2-D curves), or
    "linear" (identity permutation + empty neighbor mask — the reference's
    commented-out ablation config, scripts/main_hunyuan.py:35-38).
    """
    if variant == "linear":
        n = t * h * w
        nb = (n + block_size - 1) // block_size
        eye = np.arange(n, dtype=np.int64)
        return eye, eye.copy(), np.zeros((nb, nb), dtype=bool)

    cache_dir = cache_dir or _DEFAULT_DIR
    key = _key("v1", variant, t, h, w, block_size, tuple(axis_order or ()))
    path = os.path.join(cache_dir, f"curve_{key}.npz")
    if os.path.exists(path):
        data = np.load(path)
        return data["l2h"], data["h2l"], data["neighbors"]

    if variant == "full":
        l2h, h2l = gilbert.gilbert_mapping(t, h, w, axis_order=axis_order)
        neighbors = gilbert.gilbert_block_neighbor_mask(
            t, h, w, block_size=block_size, axis_order=axis_order)
    elif variant == "sliced":
        l2h, h2l = gilbert.sliced_gilbert_mapping(t, h, w)
        neighbors = gilbert.sliced_gilbert_block_neighbor_mask(
            t, h, w, block_size=block_size)
    else:
        raise ValueError(f"unknown curve variant: {variant!r}")

    try:
        os.makedirs(cache_dir, exist_ok=True)
        # write-then-rename: concurrent processes never read a torn file
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez_compressed(tmp, l2h=l2h, h2l=h2l, neighbors=neighbors)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only filesystems: skip caching
    return l2h, h2l, neighbors
