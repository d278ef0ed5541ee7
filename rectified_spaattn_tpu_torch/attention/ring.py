"""Ring sequence-parallel rectified sparse attention (port of
rectified_spaattn_tpu/attention/ring.py).

The visual tokens are split over the ranks of a sequence group.  The pooled
per-block statistics (K/V means and GAPR deltas, NB x D per head) are
all-gathered, so every rank builds the exact global block mask for its own
query rows; then the K/V shards rotate around the ring and each rank runs
only ITS selected blocks of whichever shard it holds, through K1s, merging
the partial softmaxes exactly from their row max m and sum l.

Layouts:
  * "visual" (Wan-style self-attention): S == visual_len, and S / n a
    multiple of the block size; every token is valid.
  * "joint" (Hunyuan): the text tail (<= 512 tokens) is REPLICATED on
    every rank.  Visual-query rows run the ring over the visual shards plus
    ONE local text pass (text blocks are always included, so they need no
    plan); text-query rows get exact attention by ring-merging full-list
    passes over every visual shard plus a local text-text pass.  IPAR, GAPR
    and rectification come from the all-gathered pooled statistics and the
    resident text keys, as the single-device joint plan computes them.

The per-rank body is written once, as a generator that yields its
collectives (parallel/mesh.py); a ``DistGroup`` (NCCL or gloo) and an
``InProcessGroup`` (ranks in turn on one device) both drive it, with the
same global-in / global-out contract.  The shift
waits for its transfer before the next step's K1s: overlapping the two is
later work.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import block_sparse_flash_attention
from ..parallel.mesh import AllGather, Shift
from ..sparse import SparseConfig
from ..sparse import ops

NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)


def _merge(o, m, l, o_p, m_p, l_p):
    """Exact merge of two normalised partial attentions over disjoint key
    sets (the online-softmax correction across shards)."""
    m_new = torch.maximum(m, m_p)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    a_old = torch.where(l > 0, torch.exp(m - m_safe), 0.0)
    a_new = torch.where(l_p > 0, torch.exp(m_p - m_safe), 0.0)
    l_new = a_old * l + a_new * l_p
    w_old = (a_old * l)[..., None]
    w_new = (a_new * l_p)[..., None]
    denom = torch.where(l_new > 0, l_new, 1.0)[..., None]
    o_new = (o.float() * w_old + o_p.float() * w_new) / denom
    return o_new, m_new, l_new


def _row_tiled(plan_tile, nq_l: int, chunk: int):
    """Run a row-separable plan tile over all local query rows, in tiles of
    ``chunk`` rows under cfg.plan_row_chunk; the tail tile is clamped and
    overlaps its neighbour (identical values, as sparse/pipeline.py)."""
    if not chunk or chunk >= nq_l:
        return plan_tile(0, nq_l)
    outs = None
    for i in range(-(-nq_l // chunk)):
        r0 = min(i * chunk, nq_l - chunk)
        parts = plan_tile(r0, chunk)
        if outs is None:
            outs = [torch.empty((*p.shape[:2], nq_l, *p.shape[3:]),
                                dtype=p.dtype, device=p.device)
                    for p in parts]
        for o, p in zip(outs, parts):
            o[:, :, r0:r0 + chunk] = p
    return outs


def _gapr(qb, qp, kp, dk, scores_u, iq, jk):
    """The GAPR "no gain" mask from pooled stats, in the JAX ring's order
    of operations."""
    dq = ops.block_abs_dev(qb, qp)
    err = (torch.einsum("bhqd,bhkd->bhqk", dq, kp).abs() * iq * jk
           + torch.einsum("bhqd,bhkd->bhqk", qp, dk).abs() * iq * jk)
    return ~((iq * jk) * scores_u.abs() > err)


def rank_plan(me: int, n: int, qs, kp, vp, dk, nbm, cfg: SparseConfig,
              text_keys=None, text_valid=None):
    """The global plan for the query rows of rank ``me`` (qs [B,H,s_l,D])
    from the all-gathered pooled statistics kp, vp, dk [B,H,NB,D] fp32:
    (mask [B,H,NB_l,NB] bool, r_factor [B,H,NB_l], comp [B,H,NB_l,D]).
    Joint layout: ``text_keys`` [B,H,T,D] fp32 (zeroed where invalid) and
    ``text_valid`` [B,T] bool; IPAR over [NB visual | T text] columns."""
    b, h, s_l, d = qs.shape
    bn, bm = cfg.block_n, cfg.block_m
    nb_l = s_l // bn
    nb = nb_l * n
    dev = qs.device
    sm_scale = d ** -0.5
    joint = text_keys is not None
    qb_all = qs.reshape(b, h, nb_l, bm, d)

    def plan_tile(r0, rows):
        qb = qb_all[:, :, r0:r0 + rows]
        qp = qb.float().mean(dim=-2)
        scores_u = ops.pooled_scores(qp, kp)                # [B,H,rows,NB]
        nogapr = _gapr(qb, qp, kp, dk, scores_u, bm, bn)
        row_ids = me * nb_l + r0 + torch.arange(rows, device=dev)
        nb_rows = nbm[me * nb_l + r0:me * nb_l + r0 + rows, :nb]
        if joint:
            scores_txt = torch.einsum("bhqd,bhkd->bhqk", qp, text_keys)
            scores = torch.cat([scores_u, scores_txt], dim=-1) * sm_scale
            pad = torch.cat([torch.ones((b, nb), dtype=torch.bool,
                                        device=dev), text_valid], dim=-1)
            scores = torch.where(pad[:, None, None, :], scores, NEG_BIG)
            probs = ops.ipar_reallocate(torch.softmax(scores, dim=-1), nb,
                                        bn)                 # [.., NB+1]
        else:
            probs = torch.softmax(scores_u * sm_scale, dim=-1)
        onehot = ops.topp_threshold_onehot(probs, cfg.p_remain,
                                           cfg.top_k_floor)
        mask = onehot[..., :nb] | nb_rows[None, None]
        if cfg.first_frame_blocks > 0:
            mask = mask | ops.ff_force_mask(row_ids, nb,
                                            cfg.first_frame_blocks)[None, None]
        partial = mask | nogapr
        if joint:
            # the aggregated text column is always critical
            partial = torch.cat([partial, torch.ones(
                (b, h, rows, 1), dtype=torch.bool, device=dev)], dim=-1)
        r_factor = torch.where(partial, probs, 0.0).sum(dim=-1)
        comp = torch.einsum("bhqk,bhkd->bhqd",
                            torch.where(partial[..., :nb], 0.0,
                                        probs[..., :nb]), vp)
        return mask, r_factor, comp

    return _row_tiled(plan_tile, nb_l, cfg.plan_row_chunk)


def pooled_stats(k, v, block_n: int):
    """(pooled K, pooled V, GAPR key deviations) [B,H,NB,D] fp32 of K/V
    [B,H,S,D]: what the ring all-gathers."""
    b, h, s, d = k.shape
    kp = ops.block_pool(k, block_n)
    return (kp, ops.block_pool(v, block_n),
            ops.block_abs_dev(k.reshape(b, h, s // block_n, block_n, d), kp))


def _rank_body(me: int, n: int, qs, kv, nbm, cfg: SparseConfig, text=None):
    """One rank of the ring.  qs [B,H,s_l,D]; ``kv`` = (k, v) [B,H,s_l,D]
    each, or one packed [B,H,s_l,2D] tensor; nbm [NB,NB] the global
    neighbour mask; ``text`` = (q_text, k_text, v_text, text_len) in the
    joint layout.  Yields its collectives; returns the global visual output
    [B,H,S,D] (joint: and rank 0's text output [B,H,T,D])."""
    b, h, s_l, d = qs.shape
    bn, bm = cfg.block_n, cfg.block_m
    nb_l = s_l // bn
    packed = kv if isinstance(kv, torch.Tensor) else None
    ks, vs = (packed[..., :d], packed[..., d:]) if packed is not None else kv
    dev = qs.device
    joint = text is not None
    text_keys = tvalid = None
    if joint:
        qt, kt, vt, tlen = text
        t = qt.shape[2]
        tb = t // bn
        # zero invalid text keys before any pooling or scoring
        tvalid = torch.arange(t, device=dev)[None, :] < tlen[:, None]
        zero = torch.zeros((), dtype=kt.dtype, device=dev)
        kt = torch.where(tvalid[:, None, :, None], kt, zero)
        vt = torch.where(tvalid[:, None, :, None], vt, zero)
        text_keys = kt.float()

    # ---- global pooled stats from small all-gathers, then the plan ----
    kp, vp, dk = yield AllGather(pooled_stats(ks, vs, bn), dim=2)
    mask, r_factor, comp = rank_plan(me, n, qs, kp, vp, dk, nbm, cfg,
                                     text_keys, tvalid)

    # ---- ring execution over the K/V shards ----
    k1s = dict(block_m=bm, block_n=bn, return_stats=True)
    tlen0 = torch.zeros((b,), dtype=torch.int32, device=dev)
    o = torch.zeros((b, h, s_l, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, s_l), -torch.inf, device=dev)
    l = torch.zeros((b, h, s_l), device=dev)
    if joint:
        # text rows: exact attention, ring-merged over the same shards
        ot = torch.zeros((b, h, t, d), dtype=torch.float32, device=dev)
        mt = torch.full((b, h, t), -torch.inf, device=dev)
        lt = torch.zeros((b, h, t), device=dev)
        full_vis = torch.arange(nb_l, dtype=torch.int32, device=dev).expand(
            b, h, tb, nb_l)
        full_vis_cnt = torch.full((b, h, tb), nb_l, dtype=torch.int32,
                                  device=dev)
    kvb, kb, vb = packed, ks, vs
    for step in range(n):
        src = (me - step) % n                  # owner of the resident shard
        idx, cnt = ops.mask_to_indices(mask[..., src * nb_l:(src + 1) * nb_l])
        if kvb is not None:
            kb, vb = kvb[..., :d], kvb[..., d:]
        # scores are on one scale on every shard, so m / l merge directly
        o, m, l = _merge(o, m, l, *block_sparse_flash_attention(
            qs, kb, vb, idx, cnt, tlen0, visual_len=s_l, text_start=None,
            packed_kv=kvb, **k1s))
        if joint:
            ot, mt, lt = _merge(ot, mt, lt, *block_sparse_flash_attention(
                qt, kb, vb, full_vis, full_vis_cnt, tlen0, visual_len=s_l,
                text_start=None, packed_kv=kvb, **k1s))
        if step < n - 1:
            if kvb is not None:
                # ONE rotation of the packed buffer instead of two
                kvb = yield Shift(kvb)
            else:
                kb = yield Shift(kb)
                vb = yield Shift(vb)

    if joint:
        # local text passes (text K/V replicated, always included)
        full_txt = torch.arange(tb, dtype=torch.int32, device=dev)
        txt_kw = dict(visual_len=0, text_start=0, **k1s)
        o, m, l = _merge(o, m, l, *block_sparse_flash_attention(
            qs, kt, vt, full_txt.expand(b, h, nb_l, tb),
            torch.full((b, h, nb_l), tb, dtype=torch.int32, device=dev),
            tlen, **txt_kw))
        ot, _, _ = _merge(ot, mt, lt, *block_sparse_flash_attention(
            qt, kt, vt, full_txt.expand(b, h, tb, tb),
            torch.full((b, h, tb), tb, dtype=torch.int32, device=dev),
            tlen, **txt_kw))

    # rectification at block granularity: out = o * R + comp
    ob = o.reshape(b, h, nb_l, bm, d)
    out = (ob * r_factor[..., None, None] + comp[:, :, :, None, :]).reshape(
        b, h, s_l, d).to(qs.dtype)
    # the global output on every rank; the text output is rank 0's (each
    # rank merges the shards in its own ring order, so the copies differ
    # by fp32 rounding)
    (out,) = yield AllGather((out,), dim=2)
    if joint:
        (ot,) = yield AllGather((ot.to(qt.dtype)[None],), dim=0)
        return out, ot[0]
    return out


def ring_rectified_sparse_attention(
    mesh,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: SparseConfig,
    neighbor_mask: Optional[torch.Tensor] = None,    # [NB, NB] bool, global
    *,
    seq_axis: str = "sp",
    q_text: Optional[torch.Tensor] = None,           # [B,H,T,D] replicated
    k_text: Optional[torch.Tensor] = None,
    v_text: Optional[torch.Tensor] = None,
    text_len_rt: Optional[torch.Tensor] = None,      # [B] int32
    kv_packed: Optional[torch.Tensor] = None,        # [B,H,S,2D]
):
    """Ring attention over the ``seq_axis`` group of ``mesh`` (a
    parallel.Mesh), on either transport.

    q/k/v (and ``kv_packed``) are the GLOBAL [B,H,S,D] tensors, as in the
    JAX package; rank r runs tokens [r*S/n, (r+1)*S/n).  The result is
    global on every rank: [B,H,S,D] (visual), or (out_visual [B,H,S,D],
    out_text [B,H,T,D]) in the joint layout, the text output being rank
    0's.

    ``cfg.plan_row_chunk`` row-tiles each rank's plan; ``kv_packed``
    rotates ONE packed [K|V] buffer around the ring, and ``k``/``v`` must
    be its slices.  The selection is the sort-based top-p of the JAX ring
    (``ops.topp_threshold_onehot``) whatever ``cfg.topp_impl`` says."""
    group = mesh.group(seq_axis)
    n = group.size
    joint = cfg.layout == "joint"
    b, h, s, d = q.shape
    s_l = s // n
    if s_l * n != s or s_l % cfg.block_m:
        raise ValueError(f"the visual sequence ({s} tokens) must split into "
                         f"{n} shards of whole {cfg.block_m}-token blocks")
    nb = s // cfg.block_n
    nbm = (torch.zeros((nb, nb), dtype=torch.bool, device=q.device)
           if neighbor_mask is None else neighbor_mask.to(q.device))
    text = None
    if joint:
        if q_text is None or k_text is None or v_text is None:
            raise ValueError("the joint ring needs the text tail")
        t = q_text.shape[2]
        if t % cfg.block_n or t != cfg.text_len:
            raise ValueError(f"text tail {t} must equal cfg.text_len "
                             f"({cfg.text_len}), a multiple of block_n")
        tlen = (torch.full((b,), t, dtype=torch.int32, device=q.device)
                if text_len_rt is None
                else text_len_rt.to(device=q.device, dtype=torch.int32))
        text = (q_text, k_text, v_text, tlen)

    def shard(x, r):
        return x[:, :, r * s_l:(r + 1) * s_l].contiguous()

    def kv(r):
        if kv_packed is not None:
            return shard(kv_packed, r)
        return shard(k, r), shard(v, r)

    return group.run([_rank_body(r, n, shard(q, r), kv(r), nbm, cfg, text)
                      for r in group.local_ranks])[0]
