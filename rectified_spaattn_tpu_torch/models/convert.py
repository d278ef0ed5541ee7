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
  * Pre-stacked trees of the scan execution mode (models/scan.py), as the
    JAX pipelines hold them: ``{"params", "scan_dual", "scan_single"}``
    (HunyuanVideo, Flux) or ``{"params", "scan_blocks"}`` (Wan,
    CogVideoX).  A stacked leaf keeps its leading [L] axis under the
    list's name and no block index (``dual_blocks.attn.to_q.weight``
    [L, out, in], as ``scan.BlockStack.state_dict`` keys it); transposes
    apply to the trailing axes, and quantized stacked leaves convert as
    ``quantize_params`` writes them (``kernel_q`` [L, in, out] ->
    ``weight_q`` [L, out, in], ``kernel_scale`` as it is).
    ``load_flax_params`` loads them into the per-block modules.

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
# the JAX pipelines' stacked collections -> the port's block lists
_STACKED = {"scan_dual": "dual_blocks", "scan_single": "single_blocks",
            "scan_blocks": "blocks"}


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


def _tensor(arr, transpose: bool, stacked: bool = False) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable copy
    if not transpose:
        return t
    lead = 1 if stacked else 0              # a stack's [L] axis stays first
    nd = t.ndim - lead
    if nd > 2:                              # conv: [*k, in, out]
        return t.permute(*range(lead), t.ndim - 1, t.ndim - 2,
                         *range(lead, t.ndim - 2)).contiguous()
    return t.transpose(-1, -2).contiguous()


def flax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """Map a Flax tree ({"params": {...}} or its inner dict, or a
    pre-stacked tree: the module docstring) to port keys."""
    stacks = {}
    if "params" in params and set(params) - {"params"} <= set(_STACKED):
        stacks = {_STACKED[c]: params[c] for c in params if c != "params"}
        params = params["params"]
    sd = {}

    def put(key, t):
        if key in sd:
            raise KeyError(f"two Flax leaves map to {key!r}")
        sd[key] = t

    for path, leaf in _flatten(params):
        put(_torch_key(path), _tensor(leaf, path[-1] in _TRANSPOSED))
    for name, tree in stacks.items():
        for path, leaf in _flatten(tree):
            put(f"{name}.{_torch_key(path)}",
                _tensor(leaf, path[-1] in _TRANSPOSED, stacked=True))
    return sd


def _unstacked(sd: dict, model: nn.Module) -> dict:
    """``sd`` with the stacked leaves of ``model``'s block lists
    (``{list}.{name}`` [L, ...]) as per-block views
    (``{list}.{i}.{name}``)."""
    from .scan import unstack_block_params
    out = dict(sd)
    for name in set(_STACKED.values()):
        head = name + "."
        stacked = {k[len(head):]: v for k, v in sd.items()
                   if k.startswith(head)
                   and not k[len(head):].split(".", 1)[0].isdigit()}
        if stacked and isinstance(getattr(model, name, None), nn.ModuleList):
            for k in stacked:
                del out[head + k]
            out.update(unstack_block_params(stacked, head))
    return out


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Strictly load a Flax tree into ``model`` (values are cast to the
    model's parameter dtype and device; quantized nodes switch their
    QLinear to the quantized layout first; a pre-stacked tree's stacks
    fill the per-block modules)."""
    sd = _unstacked(flax_to_state_dict(params), model)
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
