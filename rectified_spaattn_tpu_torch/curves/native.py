"""ctypes bridge to the native curve walker (csrc/gilbert.cpp).

Builds the shared library into the package's ``build/`` directory on first
use if a C++ toolchain is available; callers fall back to the pure-Python
walker when it isn't (host precompute only — both walkers give identical
curves).  ``walker()`` says which one ran.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..utils.build import BUILD_DIR

_CSRC = os.path.join(os.path.dirname(__file__), "..", "csrc")
_LIB_PATH = os.path.join(BUILD_DIR, "libgilbert.so")
_lib = None
_tried = False

_AXIS_DIGIT = {"w": 1, "h": 2, "t": 3}


def _build() -> bool:
    # build to a private name and rename: concurrent test workers may
    # race on the first build, and a rename is atomic
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-C", _CSRC, "-s", f"OUT={tmp}"],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.gilbert3d_path.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.gilbert3d_path.restype = None
    lib.block_neighbors.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
    lib.block_neighbors.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def walker() -> str:
    """Which curve walker this process uses: "native" or "python"."""
    return "native" if available() else "python"


def gilbert3d_path(width: int, height: int, depth: int,
                   axis_order=None) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    code = 0
    if axis_order is not None:
        code = (_AXIS_DIGIT[axis_order[0]] * 100
                + _AXIS_DIGIT[axis_order[1]] * 10
                + _AXIS_DIGIT[axis_order[2]])
    out = np.empty((width * height * depth, 3), dtype=np.int64)
    lib.gilbert3d_path(width, height, depth, code,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def block_neighbors(colors: np.ndarray, num_blocks: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    t, h, w = colors.shape
    colors64 = np.ascontiguousarray(colors, dtype=np.int64)
    adj = np.zeros((num_blocks, num_blocks), dtype=np.uint8)
    lib.block_neighbors(
        colors64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        t, h, w, num_blocks,
        adj.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return adj.astype(bool)
