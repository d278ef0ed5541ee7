"""Rectified block-sparse attention — the public attention entry point
(port of rectified_spaattn_tpu/attention/rectified.py; reference:
rectified_hunyuan_attn.py:283-417 for the joint flavour,
rectified_wan21_attn.py:276-386 for the visual-only one):

  1. visual-query rows run the block-sparse kernel (K1, K2 with
     ``group_rows`` > 1, or K1q on an int8 K|V payload with ``kv_quant``)
     and are rectified:  out = sparse_out * R + comp
  2. text-query rows (joint layout) get exact attention over all keys
     through K1 with full index lists
  3. key/value positions outside the valid windows are zeroed before any
     pooling (rectified_hunyuan_attn.py:306-308)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..sparse import SparseConfig, build_sparse_plan
from ..sparse.ops import group_rows, quantize_kv_blocks
from ..kernels import (block_sparse_flash_attention,
                       block_sparse_flash_attention_grouped)
from ..utils.timing import span


def kv_validity(batch: int, seq_len: int, visual_len: int,
                text_start: Optional[int], text_len_rt: Optional[torch.Tensor],
                text_len_max: int = 0, device=None) -> torch.Tensor:
    """[B, S] bool — True at attendable key positions for the padded
    [visual | visual-pad | text | text-pad] layout."""
    if device is None and text_len_rt is not None:
        device = text_len_rt.device
    pos = torch.arange(seq_len, device=device)[None, :]
    valid = pos < visual_len
    if text_start is not None:
        if text_len_rt is None:
            text_len_rt = torch.full((batch,), text_len_max, dtype=torch.int32,
                                     device=device)
        valid = valid | ((pos >= text_start)
                         & (pos < text_start + text_len_rt[:, None]))
    return valid.expand(batch, seq_len)


def plan_density(counts: torch.Tensor, key_blocks: int) -> torch.Tensor:
    """The executed mask density of a plan: its mean per-row key-block
    count over ``key_blocks`` key blocks (0-d fp32, on counts' device)."""
    return counts.float().mean() / key_blocks


def _head_chunked(q, k, v, cfg, neighbor_mask, *, visual_len, text_len_rt,
                  kv_packed, q_text, density_only):
    """Head-tiled execution of the whole site (SparseConfig.head_chunk):
    every stage is per-head independent, so tiles of ``head_chunk`` heads
    run one after another into one output buffer."""
    b, h, s, d = q.shape
    hc = cfg.head_chunk
    if h % hc:
        raise ValueError(f"head_chunk ({hc}) must divide the head "
                         f"count ({h})")
    sub = dataclasses.replace(cfg, head_chunk=0)
    ntiles = h // hc

    def call(i):
        sl = lambda x: None if x is None else x[:, i * hc:(i + 1) * hc]
        return rectified_sparse_attention(
            sl(q), sl(k), sl(v), sub, neighbor_mask, visual_len=visual_len,
            text_len_rt=text_len_rt, kv_packed=sl(kv_packed),
            q_text=sl(q_text), density_only=density_only)

    if density_only:
        # mean density over equal-size head tiles = the global mean
        return sum(call(i) for i in range(ntiles)) / ntiles
    out_s = s + cfg.text_len if q_text is not None else s
    out = torch.empty((b, h, out_s, d), dtype=q.dtype, device=q.device)
    for i in range(ntiles):
        out[:, i * hc:(i + 1) * hc] = call(i)
    return out


def rectified_sparse_attention(
    q: torch.Tensor,                    # [B, H, S, D] (visual[+text], padded)
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: SparseConfig,
    neighbor_mask: Optional[torch.Tensor] = None,  # [NB, NB] bool
    *,
    visual_len: int,                    # true visual token count
    text_len_rt: Optional[torch.Tensor] = None,    # [B] int32 (joint layout)
    kv_packed: Optional[torch.Tensor] = None,      # [B,H,S,2D] producer-packed
    q_text: Optional[torch.Tensor] = None,         # [B,H,text_len,D] split q
    density_only: bool = False,
):
    """Returns [B, H, S, D] in q.dtype (padded rows are garbage and are
    dropped by the caller), or with ``density_only`` the plan's mean
    executed density as a 0-d fp32 tensor.

    ``kv_packed``: the caller holds KV packed as [..., K|V]; k/v must be
    the matching slices.  ``q_text``: the caller holds q split at the
    visual/text seam (joint layout); ``q`` is then visual-only.

    Under a running profiler the call is the host range ``rsa.site``,
    holding ``rsa.plan``, ``rsa.group``, ``rsa.attn``, ``rsa.rectify``
    and ``rsa.text`` (utils/timing.py::span); what the site launches
    outside them (pad inserts, validity zeroing, the KV pack, the text
    join, the pad removal) is the site's own."""
    with span("rsa.site"):
        return _site(q, k, v, cfg, neighbor_mask, visual_len=visual_len,
                     text_len_rt=text_len_rt, kv_packed=kv_packed,
                     q_text=q_text, density_only=density_only)


def _site(q, k, v, cfg, neighbor_mask, *, visual_len, text_len_rt,
          kv_packed, q_text, density_only):
    b, h, s, d = q.shape
    if cfg.head_chunk and 0 < cfg.head_chunk < h:
        return _head_chunked(q, k, v, cfg, neighbor_mask,
                             visual_len=visual_len, text_len_rt=text_len_rt,
                             kv_packed=kv_packed, q_text=q_text,
                             density_only=density_only)
    bm = cfg.block_m
    dev = q.device
    if q_text is not None:
        if cfg.layout != "joint":
            raise ValueError("q_text is a joint-layout split")
        sv_true = s
        s = sv_true + cfg.text_len
    else:
        sv_true = s - cfg.text_len if cfg.layout == "joint" else s
    pad = (-sv_true) % bm
    if kv_packed is not None and pad != 0:
        raise ValueError("kv_packed requires a block-aligned visual region")
    if q_text is not None and pad != 0:
        raise ValueError("q_text requires a block-aligned visual region")
    if pad:
        # zero tokens between visual and text pad the visual region to a
        # block multiple (rectified_wan21_attn.py:299-304)
        def ins(x):
            z = torch.zeros((b, h, pad, d), dtype=x.dtype, device=dev)
            return torch.cat([x[:, :, :sv_true], z, x[:, :, sv_true:]], dim=2)
        q, k, v = ins(q), ins(k), ins(v)
        s += pad
    if cfg.layout == "joint":
        sv_pad = s - cfg.text_len
        text_start = sv_pad
    else:
        sv_pad = s
        text_start = None
    nq = sv_pad // bm

    if text_len_rt is None and cfg.layout == "joint":
        text_len_rt = torch.full((b,), cfg.text_len, dtype=torch.int32,
                                 device=dev)
    tlen = (text_len_rt.to(device=dev, dtype=torch.int32)
            if text_len_rt is not None
            else torch.zeros((b,), dtype=torch.int32, device=dev))

    if kv_packed is None and cfg.kv_pack:
        # cfg-driven pack after the pad insert: the kernels read K and V
        # from one [B,H,S,2D] stream
        kv_packed = torch.cat([k, v], dim=-1)
        k, v = kv_packed[..., :d], kv_packed[..., d:]
    valid = kv_validity(b, s, visual_len, text_start, tlen, device=dev)
    if kv_packed is None:
        zero = torch.zeros((), dtype=k.dtype, device=dev)
        k = torch.where(valid[:, None, :, None], k, zero)
        v = torch.where(valid[:, None, :, None], v, zero)

    text_valid = None
    if cfg.layout == "joint":
        text_valid = (torch.arange(cfg.text_len, device=dev)[None, :]
                      < tlen[:, None])

    q_vis = q if q_text is not None else q[:, :, :sv_pad]
    with span("rsa.plan"):
        plan = build_sparse_plan(
            q_vis, k, v, cfg,
            neighbor_mask=(neighbor_mask.to(dev) if neighbor_mask is not None
                           else None),
            text_valid=text_valid, kv_packed=kv_packed,
            kv_valid=valid if kv_packed is not None else None)
    if density_only:
        return plan_density(plan.counts, plan.block_mask.shape[-1])

    if kv_packed is not None and cfg.kv_quant != "none":
        # validity zeroing of k/v is skipped under kv_packed, and the
        # quantized payload is built from the zeroed k/v
        raise ValueError("kv_packed does not compose with kv_quant")
    if cfg.group_rows > 1:
        # G query blocks per union list; a non-multiple NQ pads empty rows
        # whose outputs are dropped
        gr = cfg.group_rows
        row_pad = (-nq) % gr
        pmask, q_kern = plan.block_mask, q_vis
        if row_pad:
            pmask = F.pad(pmask, (0, 0, 0, row_pad))
            q_kern = F.pad(q_vis, (0, 0, 0, row_pad * bm))
        with span("rsa.group"):
            u_idx, u_counts, rowbits, u_clean = group_rows(
                pmask, gr, clean_blocks=visual_len // cfg.block_n)
        with span("rsa.attn"):
            sparse_out = block_sparse_flash_attention_grouped(
                q_kern, k, v, u_idx, u_counts, rowbits, u_clean, tlen,
                group=gr, visual_len=visual_len, text_start=text_start,
                block_m=bm, block_n=cfg.block_n,
                chunk_blocks=cfg.kernel_chunk_blocks, packed_kv=kv_packed)
        if row_pad:
            sparse_out = sparse_out[:, :, :sv_pad]
    else:
        with span("rsa.attn"):
            kv_quant = None
            if cfg.kv_quant != "none":
                kv_quant = quantize_kv_blocks(k, v, cfg.block_n)
            sparse_out = block_sparse_flash_attention(
                q_vis, k, v, plan.indices, plan.counts, tlen,
                visual_len=visual_len, text_start=text_start, block_m=bm,
                block_n=cfg.block_n, chunk_blocks=cfg.kernel_chunk_blocks,
                kv_quant=kv_quant,
                quant_mode=None if kv_quant is None else cfg.kv_quant,
                packed_kv=kv_packed)
        del kv_quant      # the payload is not held through rectification

    # R/comp broadcast at block granularity (the reference
    # repeat_interleaves to tokens, rectified_hunyuan_attn.py:352,357),
    # IN PLACE over the kernel output and, with plan_row_chunk, in row
    # tiles, so the fp32 temporaries stay tile-sized
    so_blocks = sparse_out.reshape(b, h, nq, bm, d)
    chunk = cfg.plan_row_chunk if 0 < cfg.plan_row_chunk < nq else nq
    with span("rsa.rectify"):
        for r0 in range(0, nq, chunk):
            rows = slice(r0, min(r0 + chunk, nq))
            so_blocks[:, :, rows] = (
                so_blocks[:, :, rows].float()
                * plan.r_factor[:, :, rows, None, None]
                + plan.comp[:, :, rows, None, :]).to(q.dtype)
    out_vis = so_blocks.reshape(b, h, sv_pad, d)

    if cfg.layout == "joint":
        # text-query rows: exact attention over ALL keys through bf16 K1
        # with full index lists, also under kv_quant (reference:
        # rectified_hunyuan_attn.py:369-383)
        nb_total = s // cfg.block_n
        nq_text = cfg.text_blocks
        with span("rsa.text"):
            full_idx = torch.arange(nb_total, dtype=torch.int32, device=dev
                                    ).expand(b, h, nq_text, nb_total)
            full_counts = torch.full((b, h, nq_text), nb_total,
                                     dtype=torch.int32, device=dev)
            qt = q_text if q_text is not None else q[:, :, sv_pad:]
            out_text = block_sparse_flash_attention(
                qt, k, v, full_idx, full_counts, tlen, visual_len=visual_len,
                text_start=text_start, block_m=bm, block_n=cfg.block_n,
                packed_kv=kv_packed)
        out = torch.cat([out_vis, out_text.to(q.dtype)], dim=2)
    else:
        out = out_vis
    if pad:
        out = torch.cat([out[:, :, :sv_true], out[:, :, sv_pad:]], dim=2)
    return out
