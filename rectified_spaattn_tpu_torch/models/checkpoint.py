"""Converted-weights cache (port of rectified_spaattn_tpu/models/
checkpoint.py): a converted ``state_dict`` saved once in the safetensors
format (models/safetensors_io.py) and mapped back on later loads, so a
pipeline's start-up skips the conversion.  The JAX package caches orbax
trees; this cache has its own directory name (models/pretrained.py), so
neither package ever reads the other's.
"""

from __future__ import annotations

import os

import torch

from .safetensors_io import load_file, save_file

PARAMS_FILE = "params.safetensors"


def save_params(state_dict: dict[str, torch.Tensor], path: str) -> str:
    """Write ``state_dict`` (tensors on any device, written one at a time)
    into the directory ``path``; returns the directory."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    save_file(state_dict, os.path.join(path, PARAMS_FILE))
    return path


def has_params(path: str) -> bool:
    return os.path.isfile(os.path.join(path, PARAMS_FILE))


def load_params(path: str, use_mmap: bool = True) -> dict[str, torch.Tensor]:
    """The state dict saved by save_params (host tensors)."""
    return load_file(os.path.join(os.path.abspath(path), PARAMS_FILE),
                     use_mmap)


def convert_and_cache(family: str, snapshot_dir: str, cache_dir: str,
                      **convert_kwargs) -> dict[str, torch.Tensor]:
    """The converted state dict of ``snapshot_dir`` from ``cache_dir`` if
    it holds one; otherwise run the strict converter for ``family`` and
    cache the result."""
    from .weights import convert_strict, load_safetensors_dir
    if has_params(cache_dir):
        return load_params(cache_dir)
    sd = load_safetensors_dir(snapshot_dir)
    state = convert_strict(family, sd, **convert_kwargs)
    save_params(state, cache_dir)
    return state
