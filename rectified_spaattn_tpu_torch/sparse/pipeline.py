"""End-to-end sparse-plan construction (port of
rectified_spaattn_tpu/sparse/pipeline.py): pooled scores → IPAR → GAPR →
top-p/top-k selection → force-includes → rectification factors.

Two layout flavours:

  joint  — Hunyuan / Flux / CogVideoX: text tokens trail the visual tokens;
           visual queries are sparse over visual blocks + always see all
           text; IPAR renormalises pooled visual probabilities against
           un-pooled text probabilities
           (reference: rectified_hunyuan_attn.py:171-280).
  visual — Wan 2.1 / 2.2 self-attention: keys are visual-only, no IPAR,
           optional first-frame block retention
           (reference: rectified_wan21_attn.py:171-273).

Every plan stage is row-separable, so ``cfg.plan_row_chunk`` tiles the
build over query-block rows and ``cfg.plan_kv_tile`` tiles the column
statistics over key blocks; both are Python loops here (the tail tile is
clamped and overlaps its neighbour, recomputing identical values).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels import plan_select
from ..utils.timing import span
from .config import SparseConfig
from . import ops

NEG_INF = float(torch.finfo(torch.float32).min) * 0.5


class SparsePlan(NamedTuple):
    """Everything the sparse kernel + rectification need for one call.

    block_mask: [B,H,NQ,NB_total] bool — kernel-visible key-block mask
      (includes forced text columns for the joint layout).
    indices:    [B,H,NQ,NB_total] int32 — compacted column indices.
    counts:     [B,H,NQ] int32 — number of selected key blocks per row.
    r_factor:   [B,H,NQ] fp32 — critical-token rectification scale R.
    comp:       [B,H,NQ,D] fp32 — non-critical pooled-value compensation.
    """

    block_mask: torch.Tensor
    indices: torch.Tensor
    counts: torch.Tensor
    r_factor: torch.Tensor
    comp: torch.Tensor


def _blockify(x: torch.Tensor, block: int) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.reshape(b, h, s // block, block, d)


def _plan_rows(q_blocks, row_ids, *, cfg, nq, k_pool_vis, dk_vis, key_text,
               text_valid, neighbor_rows, value_pool, sm_scale):
    """Build the plan for one tile of query-block rows.

    q_blocks: [B,H,T,bm,D]; row_ids: [T] global row indices;
    neighbor_rows: [T, NB_vis] bool or None.  Column-side arrays are
    full-width per-key-block fp32 statistics (``_column_stats``)."""
    b, h = q_blocks.shape[:2]
    t = q_blocks.shape[2]
    dev = q_blocks.device
    q_pool = q_blocks.float().mean(dim=-2)                     # [B,H,T,D]

    if cfg.layout == "joint":
        k_cols = torch.cat([k_pool_vis, key_text], dim=-2)
        scores_unscaled = ops.pooled_scores(q_pool, k_cols)   # [B,H,T,NQ+Tt]
        scores = scores_unscaled * sm_scale
        if text_valid is not None:
            pad = torch.cat(
                [torch.ones((b, nq), dtype=torch.bool, device=dev),
                 text_valid.to(torch.bool)], dim=-1)[:, None, None, :]
            # a scalar from pageable host memory: the copy waits for the
            # device's queue to drain
            with span("rsa.sync.plan"):
                neg = torch.tensor(NEG_INF, dtype=scores.dtype, device=dev)
            scores = torch.where(pad, scores, neg)
        probs_tok = F.softmax(scores, dim=-1)
        nogapr = ops.gapr_from_stats(
            q_blocks, q_pool, k_pool_vis, dk_vis,
            scores_unscaled[..., :nq], jk=cfg.block_n)
        probs = ops.ipar_reallocate(probs_tok, nq, cfg.block_n)
    else:
        scores_unscaled = ops.pooled_scores(q_pool, k_pool_vis)
        probs = F.softmax(scores_unscaled * sm_scale, dim=-1)
        nogapr = ops.gapr_from_stats(
            q_blocks, q_pool, k_pool_vis, dk_vis, scores_unscaled,
            jk=cfg.block_n)

    select = (plan_select.topp_select
              if cfg.topp_impl == "bisect" else ops.topp_threshold_onehot)
    onehot_sel = select(probs, cfg.p_remain, cfg.top_k_floor)

    vis_cols = onehot_sel[..., :nq] if cfg.layout == "joint" else onehot_sel
    if neighbor_rows is not None:
        vis_cols = vis_cols | neighbor_rows[None, None, :, :vis_cols.shape[-1]]
    if cfg.first_frame_blocks > 0:
        vis_cols = vis_cols | ops.ff_force_mask(
            row_ids, vis_cols.shape[-1], cfg.first_frame_blocks)[None, None]
    if cfg.layout == "joint":
        text_cols = torch.ones((b, h, t, cfg.text_blocks), dtype=torch.bool,
                               device=dev)
        block_mask = torch.cat([vis_cols, text_cols], dim=-1)
        # the aggregated-text column is always critical (its kernel
        # blocks are force-included)
        partial = torch.cat(
            [vis_cols | nogapr,
             torch.ones((b, h, t, 1), dtype=torch.bool, device=dev)], dim=-1)
    else:
        block_mask = vis_cols
        partial = block_mask | nogapr

    r_factor, comp = ops.rectification(probs, partial, value_pool)
    indices, counts = ops.mask_to_indices(block_mask)
    return block_mask, indices, counts, r_factor, comp


def _column_stats(key, value, cfg, nq, d, *, kv_packed=None, kv_valid=None):
    """Per-key-block fp32 statistics shared by every query row: pooled
    keys, GAPR key deviations, raw text keys, pooled values.

    Sources: unpacked ``key``/``value`` (already zeroed at invalid
    positions by the caller) or producer-packed ``kv_packed`` [B,H,S,2D]
    with ``kv_valid`` [B,S] applied per tile."""
    bn = cfg.block_n
    src = kv_packed if kv_packed is not None else key
    b, h, s_total = src.shape[:3]
    nb_total = s_total // bn
    nkv = nq if cfg.layout == "joint" else nb_total     # k-stat blocks
    npool = min(nq + 1, nb_total) if cfg.layout == "joint" else nb_total

    def tok(which, t0, ntok):
        """[B,H,ntok,D] token slice of K or V, validity-zeroed."""
        if kv_packed is not None:
            tile = kv_packed[:, :, t0:t0 + ntok]
            t = tile[..., :d] if which == "k" else tile[..., d:]
            if kv_valid is not None:
                vv = kv_valid[:, t0:t0 + ntok]
                t = torch.where(vv[:, None, :, None], t,
                                torch.zeros((), dtype=t.dtype,
                                            device=t.device))
            return t
        x = key if which == "k" else value
        return x[:, :, t0:t0 + ntok]

    def k_stats(t0, nblk):
        kb = tok("k", t0 * bn, nblk * bn).reshape(b, h, nblk, bn, d).float()
        kp = kb.mean(dim=-2)
        return kp, ops.block_abs_dev(kb, kp)

    def v_pool(t0, nblk):
        vb = tok("v", t0 * bn, nblk * bn).reshape(b, h, nblk, bn, d).float()
        return vb.mean(dim=-2)

    tile = cfg.plan_kv_tile
    if not tile or tile >= nkv:
        k_pool_vis, dk_vis = k_stats(0, nkv)
    else:
        k_pool_vis = torch.zeros((b, h, nkv, d), dtype=torch.float32,
                                 device=src.device)
        dk_vis = torch.zeros_like(k_pool_vis)
        for i in range(-(-nkv // tile)):
            r0 = min(i * tile, nkv - tile)   # clamped tail overlaps
            kp_t, dk_t = k_stats(r0, tile)
            k_pool_vis[:, :, r0:r0 + tile] = kp_t
            dk_vis[:, :, r0:r0 + tile] = dk_t

    if not tile or tile >= npool:
        value_pool = v_pool(0, npool)
    else:
        value_pool = torch.zeros((b, h, npool, d), dtype=torch.float32,
                                 device=src.device)
        for i in range(-(-npool // tile)):
            r0 = min(i * tile, npool - tile)
            value_pool[:, :, r0:r0 + tile] = v_pool(r0, tile)

    key_text = None
    if cfg.layout == "joint":
        key_text = tok("k", nq * bn, cfg.text_len).float()
    return k_pool_vis, dk_vis, key_text, value_pool, nb_total


def build_sparse_plan(
    query: torch.Tensor,            # [B,H,Sv,D] visual queries (Sv % block == 0)
    key: Optional[torch.Tensor],    # [B,H,S,D] keys (zeroed at invalid positions)
    value: Optional[torch.Tensor],  # [B,H,S,D] values (zeroed at invalid positions)
    cfg: SparseConfig,
    neighbor_mask: Optional[torch.Tensor] = None,   # [NB,NB] bool
    text_valid: Optional[torch.Tensor] = None,      # [B,text_len] bool (joint)
    *,
    kv_packed: Optional[torch.Tensor] = None,       # [B,H,S,2D] packed [K|V]
    kv_valid: Optional[torch.Tensor] = None,        # [B,S] bool (packed source)
) -> SparsePlan:
    """Build the dynamic block mask and rectification terms for one call.
    With ``kv_packed``, ``key``/``value`` may be None: all key/value
    statistics are read from the packed tensor, validity-zeroed per tile
    through ``kv_valid``."""
    b, h, sv, d = query.shape
    bm = cfg.block_m
    nq = sv // bm
    sm_scale = d ** -0.5

    q_blocks = _blockify(query, bm)                       # [B,H,NQ,bm,D]
    k_pool_vis, dk_vis, key_text, value_pool, nb_total = _column_stats(
        key, value, cfg, nq, d, kv_packed=kv_packed, kv_valid=kv_valid)

    shared = dict(cfg=cfg, nq=nq, k_pool_vis=k_pool_vis, dk_vis=dk_vis,
                  key_text=key_text, text_valid=text_valid,
                  value_pool=value_pool, sm_scale=sm_scale)
    nb_mask = neighbor_mask[:nq] if neighbor_mask is not None else None
    rows = torch.arange(nq, dtype=torch.int32, device=query.device)

    chunk = cfg.plan_row_chunk
    if not chunk or chunk >= nq:
        parts = _plan_rows(q_blocks, rows, neighbor_rows=nb_mask, **shared)
        assert parts[0].shape[-1] == nb_total, (parts[0].shape, nb_total)
        return SparsePlan(*parts)

    # row-chunked build: the clamped tail tile overlaps the previous one;
    # every stage is row-separable and deterministic, so the overlapped
    # rows are rewritten with identical values
    outs = None
    for i in range(-(-nq // chunk)):
        r0 = min(i * chunk, nq - chunk)
        parts = _plan_rows(
            q_blocks[:, :, r0:r0 + chunk], rows[r0:r0 + chunk],
            neighbor_rows=(nb_mask[r0:r0 + chunk] if nb_mask is not None
                           else None), **shared)
        if outs is None:
            outs = [torch.empty((*p.shape[:2], nq, *p.shape[3:]),
                                dtype=p.dtype, device=p.device)
                    for p in parts]
        for o, p in zip(outs, parts):
            o[:, :, r0:r0 + chunk] = p
    return SparsePlan(*outs)
