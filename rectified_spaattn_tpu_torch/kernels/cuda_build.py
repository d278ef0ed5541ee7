"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` (``SOURCES``) is compiled by its own nvcc
run for sm_90a into a shared library with a plain C interface, in the
package's ``build/`` directory (listed in .gitignore), and loaded with
ctypes.  A library's file name carries a hash of its source, the shared
headers and the flags, so an edit rebuilds it.  ``build_kernels`` starts
one nvcc per source, all at once; a wrapper's first launch builds (if
needed) and loads only its own library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..utils.build import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
SOURCES = ("block_sparse", "dense_flash", "int8_probe", "variants")
# K1/K1s/K2/K1q/K1q-s, K3, S1, S3/S2
# included by the sources
HEADERS = ("attn_common.cuh", "hopper_attn.cuh", "sparse_tiles.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_libs: dict = {}
_lock = threading.Lock()


def _source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def _nvcc() -> str:
    # PATH first, then the toolkit's conventional home (as torch's own
    # extension builder does)
    path = shutil.which("nvcc")
    home = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if path is None and os.path.exists(home):
        path = home
    if path is None:
        raise RuntimeError(f"nvcc not found: the CUDA kernels are built from "
                           f"{CSRC} at first use and need the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` lives for the current
    sources and flags."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in (_source(name), *(os.path.join(CSRC, h) for h in HEADERS)):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:12]}.so")


def build_library(name: str, extra_flags: tuple = ()) -> tuple[str, str]:
    """Compile ``csrc/<name>.cu`` (if not built yet) and return (library
    path, compiler output).  ``extra_flags`` such as ("-Xptxas", "-v") are
    passed to nvcc and force a rebuild."""
    out = library_path(name)
    if os.path.exists(out) and not extra_flags:
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp,
                           _source(name)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_source(name)}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def build_kernels(extra_flags: tuple = ()) -> dict[str, tuple[str, str]]:
    """Build every source, one nvcc each, all started together; returns
    {name: (library path, compiler output)} or raises the first failure."""
    results, errors = {}, {}

    def one(name):
        try:
            results[name] = build_library(name, extra_flags)
        except RuntimeError as e:      # nvcc's own failure, reported below
            errors[name] = e

    threads = [threading.Thread(target=one, args=(n,)) for n in SOURCES]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise next(iter(errors.values()))
    return results


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use);
    ``declare(lib)`` sets its functions' argtypes and restypes once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_library(name)[0])
            declare(lib)
            lib.rsa_error_string.argtypes = [ctypes.c_int]
            lib.rsa_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib
