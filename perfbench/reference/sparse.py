"""Rectified block-sparse attention, joint layout, worked out again in
plain float32 for the yardstick (the semantics of the port's
attention/rectified.py and sparse/pipeline.py, written independently:
the top-p cut is taken by sorting, not by the program's bisection, and
the attention over each query block's kept keys is a gather and a plain
softmax, not a kernel).

Per head, over the [visual | zero pad to a block | text] token layout:

  plan      pooled q / K blocks -> pooled scores (text keys unpooled) ->
            softmax -> IPAR (text folded into one column) -> top-p with a
            top-k floor -> neighbour blocks added -> block mask; GAPR marks
            the pairs whose pooled estimate is not trusted
  attention visual query blocks: softmax over the valid keys of their kept
            blocks (all text blocks kept), then out * R + comp, with R the
            kept (or untrusted) probability mass and comp the dropped
            mass times the pooled values; text query rows: softmax over
            every valid key
"""

from __future__ import annotations

import torch

BLOCK = 128
NEG = float(torch.finfo(torch.float32).min) * 0.5


def _topp(probs: torch.Tensor, p_remain: float, floor: int) -> torch.Tensor:
    """keep = probs >= the value of the k-th largest, k the fewest columns
    whose mass passes ``p_remain``, at least ``floor``."""
    srt = torch.sort(probs, dim=-1, descending=True).values
    k = (torch.cumsum(srt, dim=-1) <= p_remain).sum(dim=-1) + 1
    k = k.clamp(min=max(floor, 1), max=probs.shape[-1])
    return probs >= torch.gather(srt, -1, (k - 1)[..., None])


def plan(q, k, v, *, nq: int, text_len: int, tlen: int, neighbors,
         p_remain: float, floor: int):
    """The block plan of one call.  q [H, NQ*128, D] visual queries; k, v
    [H, S, D] zeroed at invalid keys (S = NQ*128 + text_len).  Returns
    (mask [H, NQ, S/128] bool, r [H, NQ], comp [H, NQ, D])."""
    h, _, d = q.shape
    qb = q.reshape(h, nq, BLOCK, d)
    kb = k[:, :nq * BLOCK].reshape(h, nq, BLOCK, d)
    q_pool, k_pool = qb.mean(dim=2), kb.mean(dim=2)
    key_text = k[:, nq * BLOCK:nq * BLOCK + text_len]
    raw = torch.einsum("hqd,hkd->hqk", q_pool,
                       torch.cat([k_pool, key_text], dim=1))
    scores = raw * d ** -0.5
    col_ok = torch.ones(nq + text_len, dtype=torch.bool, device=q.device)
    col_ok[nq + tlen:] = False
    probs_tok = torch.softmax(torch.where(col_ok, scores, NEG), dim=-1)
    # GAPR: the pooled estimate of a pair is trusted where its gain beats
    # the pooling error of either side
    dq = (qb - q_pool[:, :, None]).abs().mean(dim=2)
    dk = (kb - k_pool[:, :, None]).abs().mean(dim=2)
    n2 = BLOCK * BLOCK
    err = (torch.einsum("hqd,hkd->hqk", dq, k_pool).abs()
           + torch.einsum("hqd,hkd->hqk", q_pool, dk).abs()) * n2
    untrusted = ~(n2 * raw[..., :nq].abs() > err)
    # IPAR: block probabilities against the text tokens, text as one column
    vis = probs_tok[..., :nq]
    txt = probs_tok[..., nq:].sum(dim=-1, keepdim=True)
    denom = vis.sum(dim=-1, keepdim=True) * BLOCK + txt
    probs = torch.cat([vis * BLOCK / denom, txt / denom], dim=-1)
    keep = _topp(probs, p_remain, floor)[..., :nq] | neighbors[:nq, :nq]
    text_blocks = text_len // BLOCK
    mask = torch.cat([keep, keep.new_ones((h, nq, text_blocks))], dim=-1)
    trusted_drop = ~torch.cat([keep | untrusted,
                               keep.new_ones((h, nq, 1))], dim=-1)
    v_pool = v[:, :(nq + 1) * BLOCK].reshape(h, nq + 1, BLOCK, d).mean(dim=2)
    r = torch.where(trusted_drop, 0.0, probs).sum(dim=-1)
    comp = torch.einsum("hqk,hkd->hqd", torch.where(trusted_drop, probs, 0.0),
                        v_pool)
    return mask, r, comp


def _block_attention(q, k, v, mask, key_ok, rows_per_step: int):
    """Each query block's softmax over the valid keys of its kept blocks.
    q [H, NQ*128, D]; mask [H, NQ, NB]; key_ok [S] bool.  Lists of
    (head, query block) run in steps of ``rows_per_step``, taken in the
    order of their lengths, their kept blocks gathered and padded to the
    step's longest list."""
    h, sq, d = q.shape
    nq, nb = mask.shape[1:]
    s = k.shape[1]
    counts = mask.sum(dim=-1).reshape(-1)                      # [L]
    by_length = torch.argsort(counts)
    widths = counts[by_length].tolist()
    col = torch.arange(nb, device=q.device)
    # kept block ids first, ascending; the rest after
    order = torch.sort(torch.where(mask, col, col + nb), dim=-1).values
    order = order.reshape(h * nq, nb) % nb
    kf, vf = k.reshape(h * s, d), v.reshape(h * s, d)
    qf = q.reshape(h * nq, BLOCK, d)
    tok = torch.arange(BLOCK, device=q.device)
    neg = torch.tensor(float("-inf"), device=q.device)
    out = torch.empty_like(qf)
    for l0 in range(0, h * nq, rows_per_step):
        lists = by_length[l0:l0 + rows_per_step]
        width = widths[min(l0 + rows_per_step, h * nq) - 1]
        keys = (order[lists, :width, None] * BLOCK + tok).reshape(
            len(lists), -1)
        ok = (key_ok[keys]
              & (torch.arange(width, device=q.device)[None, :, None]
                 < counts[lists][:, None, None]).expand(
                     -1, -1, BLOCK).reshape(len(lists), -1))
        gather = (lists // nq)[:, None] * s + keys
        sc = torch.bmm(qf[lists], kf[gather].transpose(1, 2))
        sc.mul_(d ** -0.5).add_(torch.where(ok, 0.0, neg)[:, None])
        out[lists] = torch.bmm(torch.softmax(sc, -1), vf[gather])
    return out.reshape(h, sq, d)


def rectified_attention(q, k, v, numerics, *, visual_len: int,
                        text_len: int, tlen: int, neighbors, p_remain: float,
                        floor: int, rows_per_step: int = 64):
    """The site on one call.  q, k, v [H, Sv + text_len, D] float32 in the
    stream's layout (visual tokens, then the text slots).  Returns (out
    [H, Sv + text_len, D], mask [H, NQ, NB])."""
    h, _, d = q.shape
    pad = (-visual_len) % BLOCK
    nq = (visual_len + pad) // BLOCK

    def lay(x):
        z = x.new_zeros((h, pad, d))
        return torch.cat([x[:, :visual_len], z, x[:, visual_len:]], dim=1)

    q, k, v = (lay(numerics.operand(x)) for x in (q, k, v))
    s = q.shape[1]
    pos = torch.arange(s, device=q.device)
    key_ok = (pos < visual_len) | ((pos >= nq * BLOCK)
                                   & (pos < nq * BLOCK + tlen))
    k = torch.where(key_ok[:, None], k, 0.0)
    v = torch.where(key_ok[:, None], v, 0.0)
    mask, r, comp = plan(q[:, :nq * BLOCK], k, v, nq=nq, text_len=text_len,
                         tlen=tlen, neighbors=neighbors, p_remain=p_remain,
                         floor=floor)
    vis = _block_attention(q[:, :nq * BLOCK], k, v, mask, key_ok,
                           rows_per_step)
    vis = (vis.reshape(h, nq, BLOCK, d) * r[..., None, None]
           + comp[:, :, None]).reshape(h, nq * BLOCK, d)
    txt = []
    for i in range(h):
        sc = q[i, nq * BLOCK:] @ k[i].t() * d ** -0.5
        p = torch.softmax(sc.masked_fill(~key_ok, float("-inf")), -1)
        txt.append(p @ v[i])
    out = torch.cat([vis[:, :visual_len], torch.stack(txt)], dim=1)
    return out, mask


def dense_attention(q, k, v, key_ok):
    """Plain softmax attention [H, S, D] over the keys where ``key_ok``."""
    sc = torch.einsum("hqd,hkd->hqk", q, k) * q.shape[-1] ** -0.5
    return torch.softmax(sc.masked_fill(~key_ok, float("-inf")), -1) @ v
