"""Attention mode dispatch (port of rectified_spaattn_tpu/attention/modes.py;
reference: rectified_hunyuan_attn.py:506-524, attn.py:60-154).

  "sparse"          rectified block-sparse attention (K1 / K2)
  "flash", "torch"  exact attention with the [visual | pad | text | pad]
                    key window, through K1 with full index lists
                    (``_windowed_dense_flash``); without a window
                    (``visual_len=None``: Wan's cross-attention) it is the
                    dense flash kernel K3
  "vanilla"         explicit fp32 softmax attention, the oracle
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..sparse import SparseConfig
from ..kernels import dense_attention, block_sparse_flash_attention
from .rectified import rectified_sparse_attention, kv_validity

DENSE_MODES = ("flash", "torch", "vanilla")


def _windowed_dense_flash(q, k, v, *, visual_len, text_start, tlen,
                          block: int = 128, block_m: Optional[int] = None,
                          kv_packed=None):
    """Exact attention with [visual | pad | text | pad] key validity via
    the gather kernel K1 with full index lists.  Every row shares the full
    list, so the MASK row height ``block_m`` defaults to the widest of
    1024/512/256/128 that fits the sequence (q is padded to it
    independently of KV, Sq != S); the CUDA tile is its own (128 rows)."""
    b, h, s_orig, d = q.shape
    s = s_orig
    pad = (-s) % block
    if pad:
        if kv_packed is not None:
            raise ValueError("kv_packed requires a block-aligned sequence")
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        s += pad
    nb = s // block
    bm = block_m or max(m for m in (1024, 512, 256, 128) if m <= s or m == 128)
    qpad = (-s) % bm
    if qpad:
        q = F.pad(q, (0, 0, 0, qpad))
    nq = (s + qpad) // bm
    idx = torch.arange(nb, dtype=torch.int32, device=q.device).expand(
        b, h, nq, nb)
    counts = torch.full((b, h, nq), nb, dtype=torch.int32, device=q.device)
    out = block_sparse_flash_attention(
        q, k, v, idx, counts, tlen, visual_len=visual_len,
        text_start=text_start, block_m=bm, block_n=block, packed_kv=kv_packed)
    return out[:, :, :s_orig] if (pad or qpad) else out


def attention(
    q: torch.Tensor,                 # [B, H, S, D]
    k: torch.Tensor,
    v: torch.Tensor,
    mode: str = "sparse",
    *,
    cfg: Optional[SparseConfig] = None,
    neighbor_mask: Optional[torch.Tensor] = None,
    visual_len: Optional[int] = None,
    text_len_rt: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Unified attention entry point for model layers; returns [B,H,S,D]."""
    if mode == "sparse":
        if cfg is None or visual_len is None:
            raise ValueError("sparse attention needs cfg and visual_len")
        return rectified_sparse_attention(
            q, k, v, cfg, neighbor_mask, visual_len=visual_len,
            text_len_rt=text_len_rt)
    if mode not in DENSE_MODES:
        raise ValueError(f"unknown attention mode: {mode!r}")
    b, h, s, d = q.shape
    hc = cfg.head_chunk if cfg is not None else 0
    if hc and 0 < hc < h:
        # head-tiled dense execution (the sparse path's head_chunk lever)
        if h % hc:
            raise ValueError(f"head_chunk ({hc}) must divide the head "
                             f"count ({h})")
        sub = dataclasses.replace(cfg, head_chunk=0)
        out = torch.empty_like(q)
        for i in range(0, h, hc):
            sl = slice(i, i + hc)
            out[:, sl] = attention(q[:, sl], k[:, sl], v[:, sl], mode,
                                   cfg=sub, neighbor_mask=neighbor_mask,
                                   visual_len=visual_len,
                                   text_len_rt=text_len_rt)
        return out
    text_start = None
    tlen = torch.zeros((b,), dtype=torch.int32, device=q.device)
    if cfg is not None and cfg.layout == "joint" and visual_len is not None:
        text_start = s - cfg.text_len
        tlen = (text_len_rt.to(device=q.device, dtype=torch.int32)
                if text_len_rt is not None
                else torch.full((b,), cfg.text_len, dtype=torch.int32,
                                device=q.device))
    if mode == "vanilla":
        valid = None
        if visual_len is not None:
            valid = kv_validity(b, s, visual_len, text_start,
                                tlen if text_start is not None else None,
                                cfg.text_len if cfg else 0, device=q.device)
        return dense_attention(q, k, v, valid, mode="vanilla")
    if visual_len is None:
        return dense_attention(q, k, v, None, mode="flash")
    return _windowed_dense_flash(q, k, v, visual_len=visual_len,
                                 text_start=text_start, tlen=tlen)
