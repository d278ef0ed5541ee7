"""Core tensor math for the sparse-mask pipeline (port of
rectified_spaattn_tpu/sparse/ops.py).

Plain torch ops on static shapes with no host synchronisation, replacing
the reference's torch pipeline (rectified_hunyuan_attn.py:171-280) 1:1 in
semantics.  The integer outputs (masks, index lists, counts, rowbits) match
the JAX package bit for bit; the float ones agree to fp32 rounding (sums
are taken in another order).

``quantize_kv_blocks`` is not ported yet: it feeds the int8 kernel K1q,
which belongs to a later slice.
"""

from __future__ import annotations

import torch


def block_pool(x: torch.Tensor, block: int) -> torch.Tensor:
    """Mean-pool [..., S, D] into [..., S//block, D] blocks (fp32 accum)."""
    s, d = x.shape[-2], x.shape[-1]
    assert s % block == 0, (s, block)
    xb = x.reshape(*x.shape[:-2], s // block, block, d)
    return xb.float().mean(dim=-2)


def pooled_scores(q_pool: torch.Tensor, k_pool: torch.Tensor) -> torch.Tensor:
    """Unscaled pooled attention scores [B,H,NQ,NK] in fp32
    (reference: rectified_hunyuan_attn.py:196-205)."""
    return torch.einsum("bhqd,bhkd->bhqk", q_pool.float(), k_pool.float())


def estimate_pr_gain(q_blocks, k_blocks, q_pools, k_pools, scores_unscaled):
    """GAPR — gain-aware pooling rectification mask
    (reference: rectified_spaattn/gapr_mask.py:4-42).

    q_blocks [B,H,NQ,IQ,D], k_blocks [B,H,NK,JK,D], q_pools [B,H,NQ,D],
    k_pools [B,H,NK,D], scores_unscaled [B,H,NQ,NK] (no sm_scale).
    Returns bool [B,H,NQ,NK]: True where the pooled correction is NOT
    trustworthy (the reference's ``nogapr_mask``)."""
    k_pools = k_pools.float()
    dk = block_abs_dev(k_blocks, k_pools)
    return gapr_from_stats(q_blocks, q_pools, k_pools, dk, scores_unscaled,
                           jk=k_blocks.shape[-2])


def block_abs_dev(blocks: torch.Tensor, pools: torch.Tensor) -> torch.Tensor:
    """Mean |block − pool| per block: [..., N, J, D] → [..., N, D] fp32."""
    return (blocks.float() - pools[..., None, :]).abs().mean(dim=-2)


def gapr_from_stats(q_blocks, q_pools, k_pools, dk, scores_unscaled,
                    jk: int) -> torch.Tensor:
    """GAPR from precomputed k-side stats (``k_pools``/``dk`` fp32
    [B,H,NK,D], ``jk`` = tokens per key block)."""
    iq = q_blocks.shape[-2]
    q_pools = q_pools.float()
    dq = block_abs_dev(q_blocks, q_pools)                      # [B,H,NQ,D]
    err_q = torch.einsum("bhqd,bhkd->bhqk", dq, k_pools).abs() * (iq * jk)
    err_k = torch.einsum("bhqd,bhkd->bhqk", q_pools, dk).abs() * (iq * jk)
    gain = (iq * jk) * scores_unscaled.abs()
    return ~(gain > (err_q + err_k))


def ipar_reallocate(probs: torch.Tensor, num_visual: int,
                    block_n: int) -> torch.Tensor:
    """IPAR — implicit full-attention reallocation (joint layout,
    reference: rectified_hunyuan_attn.py:216-223).

    probs [B,H,NQ,NK] with NK = num_visual + text tokens →
    [B,H,NQ,num_visual+1] (text aggregated into one tail column)."""
    visual = probs[..., :num_visual]
    visual_sum = visual.sum(dim=-1, keepdim=True)
    text_sum = probs[..., num_visual:].sum(dim=-1, keepdim=True)
    denom = visual_sum * block_n + text_sum
    return torch.cat([visual * block_n / denom, text_sum / denom], dim=-1)


def topp_topk_counts(probs: torch.Tensor, p_remain: float, top_k_floor: int):
    """Per-row block budget: top-p with a top-k floor
    (reference: rectified_hunyuan_attn.py:226-235).  Returns (counts
    int32, order int64 descending-prob column indices; ties in column
    order, as jnp's stable argsort)."""
    order = torch.argsort(-probs, dim=-1, stable=True)
    sorted_probs = torch.gather(probs, -1, order)
    csum = torch.cumsum(sorted_probs, dim=-1)
    counts = (csum <= p_remain).sum(dim=-1).to(torch.int32) + 1
    counts = torch.clamp(counts, min=top_k_floor)
    return counts, order


def topp_threshold_onehot(probs: torch.Tensor, p_remain: float,
                          top_k_floor: int) -> torch.Tensor:
    """Top-p/top-k via a per-row probability threshold (exact ties at the
    cut are all kept) — the sort oracle of the bisection below."""
    nk = probs.shape[-1]
    sorted_desc = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sorted_desc, dim=-1)
    counts = (csum <= p_remain).sum(dim=-1).to(torch.int64) + 1
    counts = torch.clamp(counts, max(top_k_floor, 1), nk)
    thresh = torch.gather(sorted_desc, -1, (counts - 1)[..., None])
    return probs >= thresh


def topp_threshold_onehot_bisect(probs: torch.Tensor, p_remain: float,
                                 top_k_floor: int,
                                 iters: int = 32) -> torch.Tensor:
    """Sort-free top-p/top-k selection via threshold bisection on the fp32
    BIT PATTERN (non-negative float bits are order-isomorphic to their
    values, so the halvings resolve adjacent floats at every magnitude).
    keep = probs >= t* with t* = min(t_p, t_k); ties are kept (>=)."""
    if p_remain >= 1.0:
        return torch.ones(probs.shape, dtype=torch.bool, device=probs.device)
    floor = float(max(top_k_floor, 1))
    pf = probs.float().contiguous()
    bits = lambda x: x.contiguous().view(torch.int32)
    lo = bits(torch.clamp(pf.amin(dim=-1, keepdim=True), min=0.0))
    hi = bits(pf.amax(dim=-1, keepdim=True)) + 1
    zero = torch.zeros((), dtype=pf.dtype, device=pf.device)
    for _ in range(iters):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        t = mid.view(torch.float32)
        ge = pf >= t
        mass = torch.where(ge, pf, zero).sum(dim=-1, keepdim=True)
        cnt = ge.sum(dim=-1, keepdim=True).float()
        ok = (mass > p_remain) & (cnt >= floor)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return pf >= lo.view(torch.float32)


def counts_to_onehot(counts: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Select the first ``counts`` columns of each row's descending order
    (scatter-free: a column is kept iff its rank is below the count)."""
    rank = torch.argsort(order, dim=-1)                    # inverse permutation
    return rank < counts[..., None].to(rank.dtype)


def mask_to_indices(mask: torch.Tensor):
    """Compact a [..., NB] bool mask into (indices [..., NB] int32, counts
    [...] int32): the first ``counts`` entries are the True columns in
    ascending order, the rest repeat the LAST valid index, and everything
    is clamped to nb-1 (a zero-count row points at column nb-1)."""
    nb = mask.shape[-1]
    counts = mask.sum(dim=-1).to(torch.int32)
    col = torch.arange(nb, dtype=torch.int32, device=mask.device)
    key = torch.where(mask, col, col + nb)
    indices = torch.sort(key, dim=-1).values
    last_valid = torch.gather(
        indices, -1, torch.clamp(counts - 1, min=0)[..., None].long())
    indices = torch.where(col < counts[..., None], indices, last_valid)
    return torch.clamp(indices, max=nb - 1).to(torch.int32), counts


def ff_force_mask(row_idx: torch.Tensor, n_cols: int, ffb: int) -> torch.Tensor:
    """First-frame force-include mask (Wan retention, reference:
    rectified_wan21_attn.py:270-271): True where q-block row < ffb AND
    k-block col < ffb.  Returns [len(row_idx), n_cols] bool."""
    col = torch.arange(n_cols, device=row_idx.device)
    return (row_idx[:, None] < ffb) & (col[None, :] < ffb)


def group_rows(mask: torch.Tensor, group: int, clean_blocks: int = 0):
    """Group ``group`` adjacent query-block rows for the grouped kernel K2.

    Union slots are partitioned [clean | tail], each part ascending, where
    clean = selected by ALL group rows ∧ block < ``clean_blocks``.

    mask: [B, H, NQ, NB] bool (NQ % group == 0).
    Returns (indices [B,H,NQ/G,NB] int32, counts [B,H,NQ/G] int32,
    rowbits [B,H,NQ/G,NB] int32, clean [B,H,NQ/G] int32); bit r of
    rowbits says whether the slot's block is in row r's planned set.
    """
    b, h, nq, nb = mask.shape
    assert nq % group == 0, (nq, group)
    assert 1 <= group <= 8, group
    # the packed sort key [category*nb + col | bits] needs
    # group + log2(4*nb) bits of an int32 — fail loudly past that
    if nb >= (1 << (31 - group)) // 4:
        raise ValueError(
            f"group_rows={group} packed sort key overflows int32 at "
            f"nb={nb} (needs nb < {(1 << (31 - group)) // 4})")
    dev = mask.device
    mg = mask.reshape(b, h, nq // group, group, nb)
    union = mg.any(dim=-2)
    allm = mg.all(dim=-2)
    col = torch.arange(nb, dtype=torch.int32, device=dev)
    clean_col = union & allm & (col < clean_blocks)
    counts = union.sum(dim=-1).to(torch.int32)
    clean = clean_col.sum(dim=-1).to(torch.int32)
    weights = (1 << torch.arange(group, dtype=torch.int32, device=dev))[:, None]
    bits = (mg.to(torch.int32) * weights).sum(dim=-2).to(torch.int32)
    # category: clean ascending, then dirty-selected ascending, then
    # unselected; the category-column prefix is unique per column, so the
    # low membership bits ride along the one sort for free
    catcol = torch.where(clean_col, col,
                         torch.where(union, col + nb, col + 3 * nb))
    skey = torch.sort((catcol << group) | bits, dim=-1).values
    indices = torch.remainder(skey >> group, nb).to(torch.int32)
    rowbits = (skey & ((1 << group) - 1)).to(torch.int32)
    # padding slots repeat the last valid block (their scores are masked
    # by slot < count, so rowbits there are dead)
    last_valid = torch.gather(
        indices, -1, torch.clamp(counts - 1, min=0)[..., None].long())
    indices = torch.where(col < counts[..., None], indices, last_valid)
    return indices, counts, rowbits, clean


def pair_rows(mask: torch.Tensor, clean_blocks: int = 0):
    """group_rows with group=2 (the round-1 name)."""
    return group_rows(mask, 2, clean_blocks)


def rectification(probs: torch.Tensor, partial_mask: torch.Tensor,
                  value_pool: torch.Tensor):
    """Rectification factors (reference: rectified_hunyuan_attn.py:347-357).

    probs [B,H,NQ,NP] implicit-full-attention probabilities,
    partial_mask [B,H,NQ,NP] bool, value_pool [B,H,NP,D] fp32.
    Returns (R [B,H,NQ] fp32, comp [B,H,NQ,D] fp32) at block granularity.
    """
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
    r = torch.where(partial_mask, probs, zero).sum(dim=-1)
    dropped = torch.where(partial_mask, zero, probs)
    comp = torch.einsum("bhqk,bhkd->bhqd", dropped, value_pool.float())
    return r, comp
