"""The weight bridge: a Flax parameter tree of the JAX package, given as
nested dicts of numpy arrays, into the port's ``state_dict``.

  * Flax ``Dense`` kernels are [in, out]; ``nn.Linear`` weights [out, in].
  * Norm ``scale`` becomes ``weight``.
  * Flax names blocks ``dual_{i}`` / ``single_{i}``; the port holds them in
    ``dual_blocks`` / ``single_blocks`` module lists.

Loading is strict: every source key is consumed, every target key is
filled, and shapes must agree.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn

_BLOCK = re.compile(r"^(dual|single)_(\d+)$")


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
        parts.append(f"{m.group(1)}_blocks.{m.group(2)}" if m else seg)
    leaf = path[-1]
    parts.append({"kernel": "weight", "scale": "weight"}.get(leaf, leaf))
    return ".".join(parts)


def _tensor(arr, transpose: bool) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable copy
    return t.T.contiguous() if transpose else t


def flax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """Map a Flax tree ({"params": {...}} or its inner dict) to port keys."""
    if set(params) == {"params"}:
        params = params["params"]
    sd = {}
    for path, leaf in _flatten(params):
        key = _torch_key(path)
        if key in sd:
            raise KeyError(f"two Flax leaves map to {key!r}")
        sd[key] = _tensor(leaf, transpose=path[-1] == "kernel")
    return sd


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Strictly load a Flax tree into ``model`` (values are cast to the
    model's parameter dtype and device)."""
    sd = flax_to_state_dict(params)
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
