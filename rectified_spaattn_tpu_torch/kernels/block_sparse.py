"""Block-sparse gather attention: the CUDA kernels K1/K1s/K2/K1q and their
plain PyTorch versions (port of rectified_spaattn_tpu/kernels/block_sparse.py).

  K1   ``block_sparse_flash_attention``          replaces the Pallas kernel
       ``_sparse_attn_kernel`` (JAX kernels/block_sparse.py:89, launched at
       :746): one index list per ``block_m`` query rows.
  K1s  the same entry point with ``return_stats`` (the same Pallas kernel
       with ``return_stats=True``, :311-314): K1's output plus the online
       softmax's row max m and row sum l, so partial attentions over
       disjoint key sets merge exactly (attention/ring.py).
  K1q  the same entry point with ``kv_quant`` (the same Pallas kernel with
       ``quant="int8"`` / ``"mxu8"``, :176-253): an int8 K|V payload with
       per-(head, key block) scales (sparse/ops.py::quantize_kv_blocks).
       "int8" dequantizes K and V to bf16 before bf16 dots; "mxu8"
       quantizes q per row and p per row and chunk, and runs both dots as
       int8 x int8 -> int32.
  K1q-s ``kv_quant`` with ``return_stats`` (the JAX wrapper takes both,
       :606-781): K1q's output plus m (score units after every scale is
       folded) and l (the sum of the unquantized p).
  K2   ``block_sparse_flash_attention_grouped``  replaces
       ``_sparse_attn_kernel_grouped`` (:317, launched at :560): one UNION
       index list per ``group * block_m`` rows, membership in ``rowbits``;
       ``block_sparse_flash_attention_paired`` is its group-2 alias (the
       JAX package's name, :593).

The kernels are hand-written CUDA C++ for sm_90a in ``csrc/block_sparse.cu``
(its header gives the designs and what bounds them on the H100).  All of
them run on the Hopper mainloop of ``csrc/hopper_attn.cuh`` (128-row CTAs,
TMA copies into an mbarrier ring, wgmma): K2 walks only its row block's
member slots; K1q converts its int8 tiles in the producer warpgroup and,
for "mxu8", runs QK^T on the int8 wgmma.  So ``block_m`` must be a
multiple of 128 on the card.  Every kernel here takes head_dim 128 or 64
(CogVideoX), each width its own instantiation of the mainloop
(``_HEAD_DIMS``), and bf16, fp16 or fp32 inputs (``_DTYPE_CODE``): fp32 q,
K and V run the mainloop's split route (bf16 hi and lo parts, three
products each, fp32-accurate; csrc/hopper_attn.cuh), and K1q takes a q of
any of the three types, its output in q's type, as the JAX kernel does
(:176-192, :810).  The library is built with nvcc at first use into the
package's ``build/`` directory and loaded with ctypes
(kernels/cuda_build.py).

Key split.  A K1/K1s launch with fewer 128-row tiles than the card has
SMs (``_split_plan``: Hunyuan's 256 text rows, a ring step's text rows)
splits each index list's slots into ``n_split`` contiguous ranges that
start on ``chunk_blocks`` boundaries; each range's fp32 partial (o, m, l)
is merged by a second kernel as attention/ring.py::_merge merges
(``merge_splits``; ``merge_splits.launches`` counts it).
``block_sparse_flash_attention_split_torch`` is the plain version of the
split: the same ranges through the plain K1s, then the same merge.

Each wrapper keeps the JAX signature (minus ``interpret``).  A CPU tensor
runs the plain PyTorch version in this module — the tests' path; a CUDA
tensor launches the kernel or raises; nothing falls back.  Each wrapper
counts its kernel launches in a plain attribute ``launches`` (K1q: a dict
per mode, ``block_sparse_flash_attention.quant_launches``; K1s:
``block_sparse_flash_attention.stats_launches``; K1q-s: a dict per mode,
``block_sparse_flash_attention.quant_stats_launches``).

The plain version replays the JAX kernel's arithmetic chunk by chunk: the
index list is padded to a multiple of ``chunk_blocks`` slots (pad slots
gather block 0, with K1q scale 0), each chunk of ``chunk_blocks`` slots is
one online-softmax update, masked scores are MASK_VALUE (finite) and the
running max starts at -inf.  So a row whose every gathered key is masked
while its count is above 0 averages V uniformly over every lane of its
``ceil(count / chunk_blocks)`` chunks (the slots past ``count`` included);
a K2 non-member tile scores MASK_VALUE (the JAX kernel adds MASK_VALUE,
which absorbs any real score in fp32), so a row block with no unmasked own
key gets the same average over its union's lanes, and a count of 0 gives
exact zeros.  The CUDA kernels walk units of keys instead.  K1 adds the
chunk-padding lanes after the walk only for such degenerate rows (a split
list: in the range that holds its last slot); K2 and K1q decide
degeneracy from the list before the walk and then walk every lane of
those chunks, every score masked.  The stats follow: a
count-0 row has m = -inf and l = 0, a degenerate row m = MASK_VALUE and
l = the number of lanes it averaged.

``prefetch_next`` is a TPU DMA knob: accepted and ignored.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils.timing import span
from . import cuda_build

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# the input types the CUDA kernels take (csrc's dtype codes)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_QUANT_CODE = {"int8": 0, "mxu8": 1}
_CTA_ROWS = 128       # query rows per CTA of every kernel here (csrc HA_ROWS)
_HEAD_DIMS = (64, 128)  # the head_dims every kernel here is built for


def _declare(lib):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.rsa_k1_launch.argtypes = [p] * 11 + [ll, ll] + [i] * 13 + [f, i, i,
                                                                   i, p]
    lib.rsa_k1_launch.restype = i
    lib.rsa_k1_merge_launch.argtypes = [p] * 6 + [ll, i, i, i, p]
    lib.rsa_k1_merge_launch.restype = i
    lib.rsa_k2_launch.argtypes = [p, p, p, p, p, p, p, p, p, ll, ll, i, i, i,
                                  i, i, i, i, i, i, i, i, i, f, i, i, p]
    lib.rsa_k2_launch.restype = i
    lib.rsa_k1q_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, p, ll, i,
                                   i, i, i, i, i, i, i, i, i, i, f, f, i, i,
                                   i, p]
    lib.rsa_k1q_launch.restype = i


def _load():
    return cuda_build.load("block_sparse", _declare)


# ----------------------------------------------------------- plain version ---

# elements of the gathered K/V tiles and scores per step of the plain
# version (2 GiB of fp32): bounds its memory so it runs at the main path's
# full shapes on the card
_PLAIN_CHUNK_ELEMS = 1 << 29


def _pad_slots(arrs, chunk_blocks: int):
    """Pad the slot axis of (indices, ...) with zeros to a multiple of
    ``chunk_blocks`` (JAX ``_pad_slots``: pad slots gather block 0)."""
    pad = (-arrs[0].shape[-1]) % chunk_blocks
    if not pad:
        return arrs
    return tuple(torch.nn.functional.pad(a, (0, pad)) for a in arrs)


def _inv127(x):
    """127 / max(x, 1e-30), divided element by element (a Python number
    over a tensor is the tensor's reciprocal times the number in PyTorch,
    one rounding more than the JAX kernel's and the CUDA kernel's
    division, which moves int8 rounding ties)."""
    return torch.full_like(x, 127.0) / torch.clamp(x, min=1e-30)


def _quantize_q_rows(q, sm_scale):
    """mxu8: q per row -> (int8 values as float64, row scale fp32
    qmax * sm_scale / 127), as the JAX kernel quantizes it."""
    qf = q.float()
    qmax = qf.abs().amax(dim=-1, keepdim=True)
    q8 = torch.round(qf * _inv127(qmax))
    return q8.double(), qmax * (sm_scale / 127.0)


def _simulate(q, k, v, bh, idx, counts, rowbits, tlen, ksc, vsc, *, group,
              visual_len, text_start, block_m, block_n, chunk_blocks,
              sm_scale, quant):
    """The JAX kernel's chunk loop on a set of index lists.

    q [L, rows, D] (rows = group * block_m); k, v [BH, S, D]; bh [L] each
    list's (batch*head); idx [L, NBp] (NBp a multiple of chunk_blocks),
    counts [L], rowbits [L, NBp] (K2) or None, tlen [L] (the list's batch
    text length), ksc / vsc [L, NBp] (K1q) or None.  Returns (out [L, rows,
    D], m [L, rows], l [L, rows]) fp32: the normalised output and the
    online softmax's row max (score units of q * sm_scale) and row sum."""
    n, rows, d = q.shape
    g, bn = chunk_blocks, block_n
    dev = q.device
    if quant == "mxu8":
        qs, row_scale = _quantize_q_rows(q, sm_scale)
    else:
        qs = (q.float() * sm_scale).to(
            torch.bfloat16 if quant else k.dtype).float()
    m = torch.full((n, rows), -math.inf, device=dev)
    l = torch.zeros((n, rows), device=dev)
    acc = torch.zeros((n, rows, d), device=dev)
    nchunks = (counts.long() + g - 1) // g
    lane = torch.arange(g * bn, device=dev)
    mask_t = torch.tensor(MASK_VALUE, device=dev)
    for c in range(int(nchunks.max()) if n else 0):
        active = c < nchunks                                       # [L]
        blocks = idx[:, c * g:(c + 1) * g].long()                  # [L, g]
        cols = (blocks[:, :, None] * bn + torch.arange(bn, device=dev)
                ).reshape(n, g * bn)
        kc, vc = k[bh[:, None], cols], v[bh[:, None], cols]        # [L,gbn,D]
        slot = c * g + lane // bn
        valid = (slot[None, :] < counts[:, None]) & (cols < visual_len)
        if text_start is not None:
            valid = valid | ((slot[None, :] < counts[:, None])
                             & (cols >= text_start)
                             & (cols < text_start + tlen[:, None]))
        valid = valid[:, None, :].expand(n, rows, g * bn)
        if rowbits is not None:
            bits = rowbits[:, c * g:(c + 1) * g].repeat_interleave(bn, dim=1)
            member = torch.stack([(bits >> r) & 1 == 1 for r in range(group)],
                                 dim=1)                            # [L,G,gbn]
            valid = valid & member.repeat_interleave(block_m, dim=1)
        if quant == "mxu8":
            s = torch.einsum("lrd,lkd->lrk", qs, kc.double()).float()
        else:
            s = torch.einsum("lrd,lkd->lrk", qs, kc.float())
        if quant:
            ks = ksc[:, c * g:(c + 1) * g].repeat_interleave(bn, dim=1)
            if quant == "mxu8":
                s = s * row_scale
            s = s * ks[:, None, :]
        s = torch.where(valid, s, mask_t)
        m_next = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next[..., None])
        l_next = alpha * l + p.sum(dim=-1)
        if quant:
            vs = vsc[:, c * g:(c + 1) * g].repeat_interleave(bn, dim=1)
            pq = p * vs[:, None, :]
        if quant == "mxu8":
            pm = pq.amax(dim=-1, keepdim=True)
            p8 = torch.round(pq * _inv127(pm))
            pv = torch.einsum("lrk,lkd->lrd", p8.double(), vc.double())
            acc_next = acc * alpha[..., None] + pv.float() * (pm / 127.0)
        else:
            pv = (pq.to(torch.bfloat16) if quant else p.to(v.dtype)).float()
            acc_next = acc * alpha[..., None] + torch.einsum(
                "lrk,lkd->lrd", pv, vc.float())
        m = torch.where(active[:, None], m_next, m)
        l = torch.where(active[:, None], l_next, l)
        acc = torch.where(active[:, None, None], acc_next, acc)
    return (acc * torch.where(l == 0, torch.ones_like(l), 1.0 / l)[..., None],
            m, l)


def _plain(q, k, v, indices, counts, rowbits, text_len, *, group, visual_len,
           text_start, block_m, block_n, chunk_blocks, sm_scale, packed_kv,
           quant=None, ksc=None, vsc=None, return_stats=False,
           out_dtype=None):
    """Run ``_simulate`` over steps of index lists whose gathered tiles and
    scores stay within _PLAIN_CHUNK_ELEMS; with ``return_stats`` also the
    row max m and row sum l, [B,H,Sq] fp32.  The output is in
    ``out_dtype`` (default q's)."""
    b, h, sq, d = q.shape
    if packed_kv is not None:
        k, v = packed_kv[..., :d], packed_kv[..., d:]
    s = k.shape[2]
    rows = group * block_m
    n = b * h * indices.shape[2]
    # per-list slot arrays, padded to whole chunks: [n, NBp] (or None)
    slots = [None if a is None else a.reshape(n, -1)
             for a in (indices, rowbits, ksc, vsc)]
    slots = [None if a is None else _pad_slots((a,), chunk_blocks)[0]
             for a in slots]
    kf, vf = k.reshape(b * h, s, d), v.reshape(b * h, s, d)
    qf = q.reshape(n, rows, d)
    cnt = counts.reshape(-1).to(torch.int32)
    bh_of = torch.arange(n, device=q.device) // indices.shape[2]
    tl = text_len.to(q.device).to(torch.int32)[bh_of // h]
    step = max(1, _PLAIN_CHUNK_ELEMS // (chunk_blocks * block_n
                                         * (2 * d + rows)))
    out = torch.empty((n, rows, d), dtype=out_dtype or q.dtype,
                      device=q.device)
    m = torch.empty((n, rows), device=q.device)
    l = torch.empty((n, rows), device=q.device)
    for l0 in range(0, n, step):
        sl = slice(l0, l0 + step)
        idx, rb, ks, vs = (None if a is None else a[sl] for a in slots)
        o_s, m[sl], l[sl] = _simulate(
            qf[sl], kf, vf, bh_of[sl], idx, cnt[sl], rb, tl[sl], ks, vs,
            group=group, visual_len=visual_len, text_start=text_start,
            block_m=block_m, block_n=block_n, chunk_blocks=chunk_blocks,
            sm_scale=sm_scale, quant=quant)
        out[sl] = o_s.to(out.dtype)
    out = out.reshape(b, h, sq, d)
    if return_stats:
        return out, m.reshape(b, h, sq), l.reshape(b, h, sq)
    return out


def _row_scales(scale, indices):
    """Per-(batch, head) block scales [B,H,NBt] gathered to the slots of
    each index list: [B,H,NQ,NB] fp32."""
    b, h, nq, _ = indices.shape
    return torch.take_along_dim(
        scale.float()[:, :, None, :].expand(b, h, nq, scale.shape[-1]),
        indices.long(), dim=-1)


def block_sparse_flash_attention_torch(
        q, k, v, indices, counts, text_len, *, visual_len, text_start,
        block_m=128, block_n=128, chunk_blocks=16, sm_scale=None,
        packed_kv=None, kv_quant=None, quant_mode=None, return_stats=False):
    """Plain PyTorch version of K1, of K1s with ``return_stats`` (returns
    (o, m, l)), and of K1q with ``kv_quant`` (the quantized payload of
    sparse/ops.py::quantize_kv_blocks; ``k``/``v`` then only give
    shapes), K1q-s with both."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    kw = dict(group=1, visual_len=visual_len, text_start=text_start,
              block_m=block_m, block_n=block_n, chunk_blocks=chunk_blocks,
              sm_scale=sm_scale)
    if kv_quant is None:
        return _plain(q, k, v, indices, counts, None, text_len,
                      packed_kv=packed_kv, return_stats=return_stats, **kw)
    kv, scale_k, scale_v = kv_quant
    b, h, _, d = q.shape
    kv = kv.reshape(b, h, kv.shape[1], 2 * d)
    return _plain(q, None, None, indices, counts, None, text_len,
                  packed_kv=kv, quant=quant_mode or "int8",
                  ksc=_row_scales(scale_k, indices),
                  vsc=_row_scales(scale_v, indices),
                  return_stats=return_stats, **kw)


def _split_plan(tiles: int, nb_slots: int, chunk_blocks: int,
                sms: int) -> tuple[int, int]:
    """(n_split, split_slots) of a K1/K1s launch of ``tiles`` 128-row CTAs
    on a card of ``sms`` SMs.  With at least as many tiles as SMs: (1,
    nb_slots).  Otherwise each list's ceil(nb_slots / chunk_blocks) chunks
    are split into n_split ranges of split_slots slots (whole chunks), the
    fewest that fill the last wave of tiles * n_split CTAs to 90 % or more
    (Hunyuan's 256 text rows, 48 tiles on 132 SMs: 5 ranges, 240 CTAs in
    two waves of 132), never more ranges than chunks, and no empty range."""
    chunks = -(-nb_slots // chunk_blocks)
    if tiles >= sms or chunks < 2:
        return 1, nb_slots
    n = -(-sms // tiles)
    while n < chunks and tiles * n < 0.9 * sms * -(-(tiles * n) // sms):
        n += 1
    per = -(-chunks // min(n, chunks))
    return -(-chunks // per), per * chunk_blocks


def _merge_splits(os, ms, ls):
    """Fold n partial attentions over disjoint key ranges (o normalised,
    row max m, row sum l) as attention/ring.py::_merge does, in its closed
    form: (o fp32, m, l)."""
    m = torch.stack(ms).amax(dim=0)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    o = torch.zeros_like(os[0], dtype=torch.float32)
    l = torch.zeros_like(ls[0])
    for o_p, m_p, l_p in zip(os, ms, ls):
        w = torch.where(l_p > 0, torch.exp(m_p - m_safe), 0.0) * l_p
        o = o + o_p.float() * w[..., None]
        l = l + w
    return o / torch.where(l > 0, l, 1.0)[..., None], m, l


def block_sparse_flash_attention_split_torch(
        q, k, v, indices, counts, text_len, *, n_split, visual_len,
        text_start, block_m=128, block_n=128, chunk_blocks=16,
        sm_scale=None, packed_kv=None, return_stats=False):
    """Plain version of K1 (K1s with ``return_stats``) under the key split
    of ``n_split`` ranges (``_split_plan``'s range length for that count):
    each range's slots run through the plain K1s with the list's count
    clipped to the range, fp32 partials, then ``_merge_splits``.  Ranges
    start on chunk boundaries, so the one holding a list's last slot pads
    its chunk as the whole list does."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    chunks = -(-indices.shape[-1] // chunk_blocks)
    span = -(-chunks // n_split) * chunk_blocks
    parts = []
    for i in range(n_split):
        s0 = i * span
        idx = indices[..., s0:s0 + span]
        if idx.shape[-1] == 0:                 # past the list: count 0
            idx = indices[..., :1]
        cnt = (counts - s0).clamp(0, span)
        parts.append(_plain(
            q, k, v, idx, cnt, None, text_len, group=1,
            visual_len=visual_len, text_start=text_start, block_m=block_m,
            block_n=block_n, chunk_blocks=chunk_blocks, sm_scale=sm_scale,
            packed_kv=packed_kv, return_stats=True, out_dtype=torch.float32))
    o, m, l = _merge_splits(*zip(*parts))
    o = o.to(q.dtype)
    return (o, m, l) if return_stats else o


def block_sparse_flash_attention_grouped_torch(
        q, k, v, indices, counts, rowbits, clean, text_len, *, group,
        visual_len, text_start, block_m=128, block_n=128, chunk_blocks=16,
        sm_scale=None, packed_kv=None):
    """Plain PyTorch version of K2.  ``clean`` (clamped by the K2 wrapper
    to all-member, window-clean slots) only marks where the kernels may
    skip the masks; it changes no value, so the plain version ignores it."""
    del clean
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _plain(q, k, v, indices, counts, rowbits, text_len, group=group,
                  visual_len=visual_len, text_start=text_start,
                  block_m=block_m, block_n=block_n, chunk_blocks=chunk_blocks,
                  sm_scale=sm_scale, packed_kv=packed_kv)


def block_sparse_attention_reference(q, k, v, block_mask, kv_valid, *,
                                     block_m=128, block_n=128, sm_scale=None):
    """O(S²) oracle with the JAX reference's semantics: a dense block mask
    expanded to tokens, AND token validity, masked scores MASK_VALUE, plain
    softmax (small shapes / tests only)."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    tok = block_mask.repeat_interleave(block_m, dim=2).repeat_interleave(
        block_n, dim=3)
    tok = tok & kv_valid[:, None, None, :]
    scores = torch.where(tok, scores, torch.tensor(MASK_VALUE,
                                                   device=scores.device))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# ---------------------------------------------------------------- wrappers ---

def _clean_prefix(indices, counts, clean_blocks, rowbits=None, group=1):
    """Leading mask-free slot count per list: slots inside ``count`` whose
    block lies wholly in the visual window (and, grouped, that every row
    of the group selects), taken as a strict prefix."""
    slot = torch.arange(indices.shape[-1], device=indices.device)
    dirty = (indices >= clean_blocks) | (slot >= counts[..., None])
    if rowbits is not None:
        dirty = dirty | (rowbits != (1 << group) - 1)
    return (torch.cumsum(dirty.to(torch.int32), dim=-1) == 0).sum(
        dim=-1).to(torch.int32)


def _quant_args(kv_quant, quant_mode, packed_kv):
    """The JAX wrapper's rules: a payload without a mode means "int8", a
    mode needs a payload, and the payload excludes ``packed_kv``."""
    if kv_quant is not None and packed_kv is not None:
        raise ValueError("kv_quant already carries a packed payload")
    if kv_quant is not None and quant_mode is None:
        quant_mode = "int8"
    if (kv_quant is None) != (quant_mode is None):
        raise ValueError("kv_quant payload and quant_mode must be given "
                         "together")
    if quant_mode is not None and quant_mode not in _QUANT_CODE:
        raise ValueError(f"quant_mode must be int8|mxu8, got {quant_mode!r}")
    return quant_mode


def _operands(q, k, v, packed_kv):
    """(q, out, k base, v base, per-bh stride, row stride, keep) for a
    launch: the packed [K|V] stream is read in place, else K and V
    separately; ``keep`` holds the tensors behind the pointers."""
    d = q.shape[-1]
    q = q.contiguous()
    out = torch.empty_like(q)
    if packed_kv is not None:
        kv = packed_kv.contiguous()
        kp, vp = kv.data_ptr(), kv.data_ptr() + d * kv.element_size()
        strides, keep = (kv.shape[2] * 2 * d, 2 * d), (kv,)
    else:
        k, v = k.contiguous(), v.contiguous()
        kp, vp = k.data_ptr(), v.data_ptr()
        strides, keep = (k.shape[2] * d, d), (k, v)
    # the kernels move 16 bytes per copy
    if any(ptr % 16 for ptr in (q.data_ptr(), out.data_ptr(), kp, vp)):
        raise ValueError("q/k/v must start on a 16-byte boundary")
    return q, out, kp, vp, *strides, keep


def _cuda_checks(q, k, v, packed_kv, block_m, block_n, *ints,
                 head_dims=_HEAD_DIMS):
    """What the CUDA kernels take (a CUDA launch's gate; the tests run it
    on meta tensors): q/k/v in one of ``_DTYPE_CODE``'s types (K1q's q in
    any of them, its payload int8), head_dim in ``head_dims`` (the S3 / S2
    variants: 128), block_n 128 and block_m a multiple of 128, every
    operand on q's device."""
    kvt = packed_kv if packed_kv is not None else k
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA kernels take bf16, fp16 or fp32, got "
                        f"{q.dtype}")
    if kvt is not None and (kvt.dtype != q.dtype or (
            packed_kv is None and v.dtype != q.dtype)):
        raise TypeError("q, k and v must share one dtype")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"the CUDA kernels take head_dim "
                         f"{' or '.join(map(str, head_dims))}, got "
                         f"{q.shape[-1]}")
    if block_n != 128 or block_m % _CTA_ROWS:
        raise ValueError(f"the CUDA kernels need block_n == 128 and block_m a "
                         f"multiple of {_CTA_ROWS} (got {block_m}, {block_n})")
    for t in (q, kvt, v, *ints):
        if t is not None and t.device != q.device:
            raise ValueError("all operands must be on one CUDA device")


def _check_lists(indices, counts, n_lists: int):
    """The kernels read list ``bh * n_lists + row`` and its first ``count``
    slots: a list count or a count that does not fit would read another
    head's lists or past the buffers."""
    if indices.shape[:2] != counts.shape[:2] or indices.shape[2] != n_lists \
            or counts.shape[2] != n_lists:
        raise ValueError(f"indices {tuple(indices.shape)} / counts "
                         f"{tuple(counts.shape)} must hold {n_lists} lists "
                         "per (batch, head)")
    if not counts.numel():
        return
    with span("rsa.sync.lists"):
        top = int(counts.max())        # a device-to-host readback
    if top > indices.shape[3]:
        raise ValueError(f"a count exceeds the {indices.shape[3]} slots of "
                         "its index list")


def _int32(x):
    return x.to(torch.int32).contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_k1q(q, kv_quant, quant_mode, indices, counts, clean, text_len, *,
                visual_len, text_start, block_m, block_n, chunk_blocks,
                sm_scale, return_stats):
    """K1q (K1q-s with ``return_stats``) on the card: the wrapper gathers
    the per-slot scales to row order and pads the slots to a multiple of
    ``chunk_blocks`` (index 0, scale 0), as the JAX wrapper does.  q may be
    bf16, fp16 or fp32 (the kernel rounds q * sm_scale to bf16 for "int8"
    and quantizes q's own values for "mxu8"); the output is in q's type."""
    kv, scale_k, scale_v = kv_quant
    b, h, sq, d = q.shape
    _cuda_checks(q, None, None, None, block_m, block_n, kv, scale_k, scale_v,
                 indices, counts, text_len)
    s = kv.shape[1]
    if kv.dtype != torch.int8 or tuple(kv.shape) != (b * h, s, 2 * d):
        raise ValueError(f"kv_quant payload must be int8 [B*H, S, 2D], got "
                         f"{kv.dtype} {tuple(kv.shape)}")
    idx, ksc, vsc = _pad_slots((indices, _row_scales(scale_k, indices),
                                _row_scales(scale_v, indices)), chunk_blocks)
    lib = _load()
    q = q.contiguous()
    out = torch.empty_like(q)
    kv = kv.contiguous()
    # the kernel's tensor maps read 16-byte-aligned bases
    if q.data_ptr() % 16 or kv.data_ptr() % 16:
        raise ValueError("q and the kv_quant payload must start on a "
                         "16-byte boundary")
    idx, cnt, cln, tl = _int32(idx), _int32(counts), _int32(clean), \
        _int32(text_len)
    ksc, vsc = ksc.contiguous(), vsc.contiguous()
    # K1q-s: the row stats in fp32 (null pointers select K1q)
    stats = [torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
             for _ in range(2)] if return_stats else []
    m_ptr, l_ptr = (t.data_ptr() for t in stats) if stats else (None, None)
    rc = lib.rsa_k1q_launch(
        q.data_ptr(), kv.data_ptr(), out.data_ptr(), idx.data_ptr(),
        cnt.data_ptr(), cln.data_ptr(), ksc.data_ptr(), vsc.data_ptr(),
        tl.data_ptr(), m_ptr, l_ptr, s * 2 * d, b * h, h, sq, idx.shape[2],
        idx.shape[3], s // block_n, block_m, chunk_blocks, visual_len,
        -1 if text_start is None else text_start, int(text_start is not None),
        float(sm_scale), float(sm_scale / 127.0), d, _QUANT_CODE[quant_mode],
        _DTYPE_CODE[q.dtype], _stream(q))
    name = "K1q-s" if return_stats else "K1q"
    if rc:
        raise RuntimeError(
            f"{name} launch failed: {lib.rsa_error_string(rc).decode()}")
    if return_stats:
        block_sparse_flash_attention.quant_stats_launches[quant_mode] += 1
        return out, *stats
    block_sparse_flash_attention.quant_launches[quant_mode] += 1
    return out


def block_sparse_flash_attention(
        q, k, v, indices, counts, text_len, *, visual_len, text_start,
        block_m=128, block_n=128, chunk_blocks=16, sm_scale=None,
        return_stats=False, kv_quant=None, quant_mode=None,
        prefetch_next=True, packed_kv=None):
    """K1: masked flash attention of each ``block_m`` query rows over the
    key blocks in the first ``counts`` slots of their index list; K1q with
    ``kv_quant`` = (kv_int8 [B*H,S,2D], scale_k, scale_v [B,H,NBt]) and
    ``quant_mode`` "int8" (the default with a payload) or "mxu8".

    q [B,H,Sq,D] (Sq % block_m == 0); k/v [B,H,S,D] (S % block_n == 0) or
    ``packed_kv`` [B,H,S,2D]; indices [B,H,NQ,NB] int32; counts [B,H,NQ];
    text_len [B].  Returns [B,H,Sq,D] in q.dtype; K1s with
    ``return_stats``: (o, m, l) with m and l [B,H,Sq] fp32 (m in score
    units of q * sm_scale, natural exp; a count-0 row has m = -inf and
    l = 0); K1q-s with both ``kv_quant`` and ``return_stats``."""
    quant_mode = _quant_args(kv_quant, quant_mode, packed_kv)
    b, h, sq, d = q.shape
    s = (kv_quant[0].shape[1] if kv_quant is not None else
         (packed_kv if packed_kv is not None else k).shape[2])
    if s % block_n or sq % block_m:
        raise ValueError(f"S={s} / Sq={sq} must be multiples of "
                         f"block_n={block_n} / block_m={block_m}")
    _check_lists(indices, counts, sq // block_m)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kw = dict(visual_len=visual_len, text_start=text_start, block_m=block_m,
              block_n=block_n, chunk_blocks=chunk_blocks, sm_scale=sm_scale)
    if q.device.type == "cpu":
        return block_sparse_flash_attention_torch(
            q, k, v, indices, counts, text_len, packed_kv=packed_kv,
            kv_quant=kv_quant, quant_mode=quant_mode,
            return_stats=return_stats, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    clean = _clean_prefix(indices, counts, visual_len // block_n)
    if kv_quant is not None:
        return _launch_k1q(q, kv_quant, quant_mode, indices, counts, clean,
                           text_len, return_stats=return_stats, **kw)
    _cuda_checks(q, k, v, packed_kv, block_m, block_n, indices, counts,
                 text_len)
    lib = _load()
    q, out, kp, vp, bh_stride, row_stride, keep = _operands(q, k, v,
                                                            packed_kv)
    idx, cnt, cln, tl = (_int32(indices), _int32(counts), _int32(clean),
                         _int32(text_len))
    rows = b * h * sq
    n_split, split_slots = _split_plan(
        rows // _CTA_ROWS, idx.shape[3], chunk_blocks,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    f32 = dict(dtype=torch.float32, device=q.device)
    if n_split > 1:
        # the ranges' partials (o, m, l), merged below
        part = [torch.empty((n_split, rows, d), **f32),
                torch.empty((n_split, rows), **f32),
                torch.empty((n_split, rows), **f32)]
        ptrs = [t.data_ptr() for t in part]
    else:
        # K1s: the row stats in fp32 (null pointers select K1)
        stats = [torch.empty((b, h, sq), **f32)
                 for _ in range(2)] if return_stats else []
        ptrs = [None, *(t.data_ptr() for t in stats)] if stats else [None] * 3
    name = "K1s" if return_stats else "K1"
    rc = lib.rsa_k1_launch(
        q.data_ptr(), kp, vp, out.data_ptr(), *ptrs,
        idx.data_ptr(), cnt.data_ptr(), cln.data_ptr(), tl.data_ptr(),
        bh_stride, row_stride, b * h, h, sq, idx.shape[2], idx.shape[3],
        s // block_n, block_m, chunk_blocks, visual_len,
        -1 if text_start is None else text_start,
        int(text_start is not None), n_split, split_slots, float(sm_scale),
        d, _DTYPE_CODE[q.dtype], int(return_stats), _stream(q))
    if rc:
        raise RuntimeError(
            f"{name} launch failed: {lib.rsa_error_string(rc).decode()}")
    if return_stats:
        block_sparse_flash_attention.stats_launches += 1
    else:
        block_sparse_flash_attention.launches += 1
    if n_split > 1:
        merged = merge_splits(*part, q.dtype, return_stats=return_stats)
        if not return_stats:
            return merged.reshape(b, h, sq, d)
        return (merged[0].reshape(b, h, sq, d),
                *(t.reshape(b, h, sq) for t in merged[1:]))
    return (out, *stats) if return_stats else out


def merge_splits(o_part, m_part, l_part, out_dtype, *, return_stats=False):
    """The key split's merge: n partial attentions of the same rows over
    disjoint key ranges, o_part [n, rows, D] (normalised) and m_part /
    l_part [n, rows], all fp32, folded as attention/ring.py::_merge folds
    them; returns o [rows, D] in ``out_dtype`` (bf16, fp16 or fp32),
    with ``return_stats`` (o, m, l).  On the card a CUDA kernel
    (``merge_splits_kernel`` in csrc/block_sparse.cu, one warp a row;
    ``merge_splits.launches`` counts it); on the CPU ``_merge_splits``."""
    n, rows, d = o_part.shape
    if o_part.device.type == "cpu":
        o, m, l = _merge_splits(list(o_part), list(m_part), list(l_part))
        o = o.to(out_dtype)
        return (o, m, l) if return_stats else o
    _merge_checks(out_dtype, d)
    parts = (o_part, m_part, l_part)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.device != o_part.device for t in parts) \
            or m_part.shape != (n, rows) or l_part.shape != (n, rows):
        raise ValueError("o_part [n, rows, D], m_part and l_part [n, rows] "
                         "must be contiguous fp32 on one device")
    out = torch.empty((rows, d), dtype=out_dtype, device=o_part.device)
    stats = [torch.empty((rows,), dtype=torch.float32, device=out.device)
             for _ in range(2)] if return_stats else []
    m_ptr, l_ptr = (t.data_ptr() for t in stats) if stats else (None, None)
    lib = _load()
    rc = lib.rsa_k1_merge_launch(
        *(t.data_ptr() for t in parts), out.data_ptr(), m_ptr, l_ptr, rows,
        n, d, _DTYPE_CODE[out_dtype], _stream(out))
    if rc:
        raise RuntimeError(f"split merge launch failed: "
                           f"{lib.rsa_error_string(rc).decode()}")
    merge_splits.launches += 1
    return (out, *stats) if return_stats else out


def _merge_checks(out_dtype, d):
    """The merge kernel writes rows of ``_HEAD_DIMS`` in ``_DTYPE_CODE``'s
    types."""
    if out_dtype not in _DTYPE_CODE or d not in _HEAD_DIMS:
        raise TypeError(f"the merge kernel writes bf16, fp16 or fp32 rows of "
                        f"64 or 128, got {out_dtype} and {d}")


merge_splits.launches = 0


block_sparse_flash_attention.launches = 0
block_sparse_flash_attention.stats_launches = 0
block_sparse_flash_attention.quant_launches = {"int8": 0, "mxu8": 0}
block_sparse_flash_attention.quant_stats_launches = {"int8": 0, "mxu8": 0}


def block_sparse_flash_attention_grouped(
        q, k, v, indices, counts, rowbits, clean, text_len, *, group,
        visual_len, text_start, block_m=128, block_n=128, chunk_blocks=16,
        sm_scale=None, packed_kv=None):
    """K2: ``group`` adjacent query blocks per union index list (see
    sparse/ops.py::group_rows).  q [B,H,NQ*bm,D] with NQ % group == 0;
    indices/rowbits [B,H,NQ/G,NB]; counts/clean [B,H,NQ/G].  The caller's
    ``clean`` is clamped to what the slot data supports (all-member ∧
    fully inside the visual window ∧ within count)."""
    b, h, sq, d = q.shape
    s = (packed_kv if packed_kv is not None else k).shape[2]
    ngrp = indices.shape[2]
    if sq != ngrp * group * block_m or not 1 <= group <= 8:
        raise ValueError(f"Sq={sq} must equal lists({ngrp}) x group({group}) "
                         f"x block_m({block_m}), group in [1, 8]")
    if s % block_n:
        raise ValueError(f"S={s} must be a multiple of block_n={block_n}")
    _check_lists(indices, counts, ngrp)
    if rowbits.shape != indices.shape or clean.shape != counts.shape:
        raise ValueError("rowbits must have the shape of indices, and clean "
                         "that of counts")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    clean = torch.minimum(
        clean.to(torch.int32),
        _clean_prefix(indices, counts, visual_len // block_n, rowbits, group))
    if q.device.type == "cpu":
        return block_sparse_flash_attention_grouped_torch(
            q, k, v, indices, counts, rowbits, clean, text_len, group=group,
            visual_len=visual_len, text_start=text_start, block_m=block_m,
            block_n=block_n, chunk_blocks=chunk_blocks, sm_scale=sm_scale,
            packed_kv=packed_kv)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _cuda_checks(q, k, v, packed_kv, block_m, block_n, indices, counts,
                 rowbits, text_len)
    lib = _load()
    q, out, kp, vp, bh_stride, row_stride, keep = _operands(q, k, v,
                                                            packed_kv)
    idx, cnt, cln, bits, tl = (_int32(indices), _int32(counts), _int32(clean),
                               _int32(rowbits), _int32(text_len))
    rc = lib.rsa_k2_launch(
        q.data_ptr(), kp, vp, out.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
        cln.data_ptr(), bits.data_ptr(), tl.data_ptr(), bh_stride, row_stride,
        b * h, h, sq, ngrp, idx.shape[3], s // block_n, block_m, group,
        chunk_blocks, visual_len, -1 if text_start is None else text_start,
        int(text_start is not None), float(sm_scale), d,
        _DTYPE_CODE[q.dtype], _stream(q))
    if rc:
        raise RuntimeError(
            f"K2 launch failed: {lib.rsa_error_string(rc).decode()}")
    block_sparse_flash_attention_grouped.launches += 1
    return out


block_sparse_flash_attention_grouped.launches = 0


def block_sparse_flash_attention_paired(q, k, v, indices, counts, rowbits,
                                        clean, text_len, **kw):
    """K2 with two row blocks per union list: the group = 2 case under the
    name the JAX package exports (kernels/block_sparse.py:593); its
    launches count as K2's."""
    return block_sparse_flash_attention_grouped(
        q, k, v, indices, counts, rowbits, clean, text_len, group=2, **kw)
