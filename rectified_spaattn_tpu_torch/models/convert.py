"""The weight bridge: a Flax parameter tree of the JAX package, given as
nested dicts of numpy arrays, into the port's ``state_dict``.

  * Flax ``Dense`` kernels are [in, out]; ``nn.Linear`` weights [out, in].
  * Flax ``Conv`` kernels are [*k, in, out]; ``nn.Conv{2,3}d`` weights
    [out, in, *k] (the VAE's convolutions).
  * Quantized ``QDense`` nodes (models/quant.py::quantize_params) carry
    across as the port's ``QLinear`` layouts: ``kernel_q`` [in, out] int8
    becomes ``weight_q`` [out, in], ``kernel_q4`` [in // 2, out] uint8
    becomes ``weight_q4`` [out, in // 2] (the nibble pairs run along the
    input dim in both), ``kernel_scale`` becomes ``scale`` as it is ([out]
    int8, [groups, out] int4).
  * Norm ``scale`` becomes ``weight``.
  * Flax names blocks ``dual_{i}`` / ``single_{i}`` (HunyuanVideo) and
    ``block_{i}`` (Wan); the port holds them in ``dual_blocks`` /
    ``single_blocks`` / ``blocks`` module lists.
  * Parameters that are no module's (Wan's ``scale_shift_table`` and
    ``scale_shift_table_out``) keep their names, and so do the VAE's
    modules (``conv_in``, ``up0_res1``, ``mid_attn`` ..., models/vae.py
    names them as Flax does).

Loading is strict: every source key is consumed, every target key is
filled, and shapes must agree.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn

from .quant import adopt_layout

_BLOCK = re.compile(r"^(?:(dual|single)_|block_)(\d+)$")
_LEAF = {"kernel": "weight", "scale": "weight", "kernel_q": "weight_q",
         "kernel_q4": "weight_q4", "kernel_scale": "scale"}
_TRANSPOSED = ("kernel", "kernel_q", "kernel_q4")


def _flatten(tree, prefix=()):
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _flatten(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def _torch_key(path) -> str:
    parts = []
    for seg in path[:-1]:
        m = _BLOCK.match(seg)
        if m:
            seg = (f"{m.group(1)}_blocks.{m.group(2)}" if m.group(1)
                   else f"blocks.{m.group(2)}")
        parts.append(seg)
    leaf = path[-1]
    parts.append(_LEAF.get(leaf, leaf))
    return ".".join(parts)


def _tensor(arr, transpose: bool) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable copy
    if not transpose:
        return t
    if t.ndim > 2:                          # conv: [*k, in, out]
        return t.permute(t.ndim - 1, t.ndim - 2,
                         *range(t.ndim - 2)).contiguous()
    return t.T.contiguous()


def flax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """Map a Flax tree ({"params": {...}} or its inner dict) to port keys."""
    if set(params) == {"params"}:
        params = params["params"]
    sd = {}
    for path, leaf in _flatten(params):
        key = _torch_key(path)
        if key in sd:
            raise KeyError(f"two Flax leaves map to {key!r}")
        sd[key] = _tensor(leaf, transpose=path[-1] in _TRANSPOSED)
    return sd


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Strictly load a Flax tree into ``model`` (values are cast to the
    model's parameter dtype and device; quantized nodes switch their
    QLinear to the quantized layout first)."""
    sd = flax_to_state_dict(params)
    adopt_layout(model, sd)
    target = model.state_dict()
    missing = sorted(set(target) - set(sd))
    extra = sorted(set(sd) - set(target))
    if missing or extra:
        raise KeyError(f"Flax tree does not match the model: missing "
                       f"{missing[:8]}, unconsumed {extra[:8]}")
    for key, t in sd.items():
        if tuple(t.shape) != tuple(target[key].shape):
            raise ValueError(f"{key}: source shape {tuple(t.shape)} != "
                             f"target {tuple(target[key].shape)}")
    model.load_state_dict(sd, strict=True)
    return model
