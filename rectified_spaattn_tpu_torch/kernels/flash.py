"""Dense attention (port of rectified_spaattn_tpu/kernels/flash.py).

  "vanilla" — explicit softmax attention in fp32, the numerical oracle
              (reference: attn.py:121-149).
  "flash"   — in the JAX package, the stock Pallas TPU flash kernel (K3),
              used only where there is no visual/text window
              (``visual_len=None``, e.g. Wan-I2V's CLIP cross-attention).
              Off the HunyuanVideo path: its hand-written Hopper kernel is
              a later slice, so the mode raises NotImplementedError.
"""

from __future__ import annotations

import math

import torch

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _vanilla_attention(q, k, v, kv_valid=None, sm_scale=None):
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if kv_valid is not None:
        scores = torch.where(kv_valid[:, None, None, :], scores,
                             torch.tensor(MASK_VALUE, device=scores.device))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def dense_attention(q, k, v, kv_valid=None, *, mode: str = "flash",
                    sm_scale: float | None = None):
    """Exact attention of every query over all (valid) keys."""
    if mode == "vanilla":
        return _vanilla_attention(q, k, v, kv_valid, sm_scale)
    if mode in ("flash", "torch"):
        raise NotImplementedError(
            "dense_attention(mode='flash') is kernel K3, not ported yet; "
            "windowed dense attention runs through K1 "
            "(attention/modes.py::_windowed_dense_flash)")
    raise ValueError(f"unknown dense attention mode: {mode!r}")
