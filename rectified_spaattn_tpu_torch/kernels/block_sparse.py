"""Block-sparse gather attention: the CUDA kernels K1/K2 and their plain
PyTorch versions (port of rectified_spaattn_tpu/kernels/block_sparse.py).

  K1  ``block_sparse_flash_attention``          replaces the Pallas kernel
      ``_sparse_attn_kernel`` (JAX kernels/block_sparse.py:89, launched at
      :746): one index list per ``block_m`` query rows.
  K2  ``block_sparse_flash_attention_grouped``  replaces
      ``_sparse_attn_kernel_grouped`` (:317, launched at :560): one UNION
      index list per ``group * block_m`` rows, membership in ``rowbits``.
      The JAX kernel adds MASK_VALUE to a non-member tile's scores; the
      port skips the tile, which gives the same output whenever a row has
      one unmasked key and makes K2 equal K1 row by row in every case.

Both kernels are hand-written CUDA C++ for sm_90a in ``csrc/block_sparse.cu``
(mma.sync bf16/fp16 with fp32 accumulation; its header gives the design
and what bounds it on the H100).  The library is built with nvcc at first
use into the package's ``build/`` directory and loaded with ctypes
(kernels/cuda_build.py).

Each wrapper keeps the JAX signature (minus ``interpret``).  A CPU tensor
runs the plain PyTorch version in this module — the tests' path; a CUDA
tensor launches the kernel or raises; nothing falls back.  Each wrapper
counts its kernel launches in a plain integer attribute ``launches``.

Semantics shared by kernel and plain version (the JAX kernel's contract):
masked scores are MASK_VALUE (finite), the running max starts at -inf, so a
row whose gathered keys are all masked averages its gathered values
uniformly and a row with count 0 is exactly 0.  The JAX kernel also
averages over its chunk-padding slots in that degenerate case; the port
averages over the ``count`` listed slots only (index lists from
mask_to_indices / group_rows hold distinct blocks).

Not ported yet (raise NotImplementedError): ``return_stats`` (K1s, ring
attention), ``kv_quant``/``quant_mode`` (K1q).  ``prefetch_next`` and
``chunk_blocks`` are TPU DMA/VMEM knobs: accepted and ignored.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}
_TILE_M = 64          # query rows per CUDA thread block (csrc TILE_M)


def _declare(lib):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.rsa_k1_launch.argtypes = [p, p, p, p, p, p, p, p, ll, ll, i, i, i, i,
                                  i, i, i, i, i, i, f, i, i, p]
    lib.rsa_k1_launch.restype = i
    lib.rsa_k2_launch.argtypes = [p, p, p, p, p, p, p, p, p, ll, ll, i, i, i,
                                  i, i, i, i, i, i, i, i, f, i, i, p]
    lib.rsa_k2_launch.restype = i


def _load():
    return cuda_build.load("block_sparse", _declare)


# ----------------------------------------------------------- plain version ---

def _window(s: int, visual_len: int, text_start, text_len, device):
    """[B, S] bool key validity: col < visual_len, or inside the runtime
    text window [text_start, text_start + text_len[b])."""
    col = torch.arange(s, device=device)[None, :]
    valid = col < visual_len
    if text_start is not None:
        valid = valid | ((col >= text_start)
                         & (col < text_start + text_len.to(device)[:, None]))
    return valid


def _scatter_blocks(indices, flags, nbt):
    """Per (row list, key block): does any slot with ``flags`` list it."""
    acc = torch.zeros((*indices.shape[:-1], nbt), dtype=torch.int32,
                      device=indices.device)
    acc.scatter_add_(-1, indices.long().clamp(0, nbt - 1), flags.to(torch.int32))
    return acc > 0


def _masked_softmax_av(q, k, v, gathered, dirty, valid, sm_scale):
    """The kernels' arithmetic on dense scores: q*scale rounded to the K/V
    type, masked scores MASK_VALUE, keys that are not gathered -inf, P
    rounded to the K/V type before PV, 0 where l == 0.  ``gathered`` and
    ``dirty`` (gathered past the clean prefix) are [B,H,Sq,S] bool."""
    qs = (q.float() * sm_scale).to(k.dtype).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qs, k.float())
    mask = torch.tensor(MASK_VALUE, dtype=torch.float32, device=q.device)
    s = torch.where(dirty & ~valid[:, None, None, :], mask, s)
    s = torch.where(gathered, s, torch.tensor(-math.inf, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (o * torch.where(l == 0, torch.ones_like(l), 1.0 / l)).to(q.dtype)


def _expand(blk, rows_per_list: int, block_n: int):
    """[B,H,NL,NBt] block flags -> [B,H,NL*rows,NBt*block_n] token flags."""
    return blk.repeat_interleave(rows_per_list, dim=2).repeat_interleave(
        block_n, dim=3)


def _plain_lists(q, k, v, indices, counts, clean, rowbits, text_len, *,
                 group, visual_len, text_start, block_m, block_n, sm_scale):
    """The plain version on one chunk of index lists: dense scores under
    the token masks the lists imply.  With ``rowbits`` (K2) a row block
    gathers the union slots it is a member of (the clean prefix is
    all-member)."""
    b, h = q.shape[:2]
    nbt = k.shape[2] // block_n
    slot = torch.arange(indices.shape[-1], device=q.device)
    listed = slot < counts[..., None]
    past_clean = slot >= clean[..., None]
    if rowbits is None:
        members = [listed]
    else:
        members = [listed & (~past_clean | ((rowbits >> r) & 1 == 1))
                   for r in range(group)]

    def tokens(flags):
        # [B,H,NL,NB] slot flags -> [B,H,NL*G*block_m,S] token flags
        blk = torch.stack([_scatter_blocks(indices, f, nbt) for f in flags],
                          dim=3).reshape(b, h, -1, nbt)
        return _expand(blk, block_m, block_n)

    valid = _window(k.shape[2], visual_len, text_start, text_len, q.device)
    return _masked_softmax_av(q, k, v, tokens(members),
                              tokens([f & past_clean for f in members]),
                              valid, sm_scale)


# dense score elements per chunk of the plain version (2 GiB of fp32):
# bounds its memory so it runs at the main path's full shapes on the card
_PLAIN_CHUNK_ELEMS = 1 << 29


def _plain(q, k, v, indices, counts, clean, rowbits, text_len, *, group,
           visual_len, text_start, block_m, block_n, sm_scale, packed_kv):
    """Run ``_plain_lists`` over chunks of heads and index lists."""
    b, h, sq, d = q.shape
    if packed_kv is not None:
        k, v = packed_kv[..., :d], packed_kv[..., d:]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    rows = group * block_m
    nl = indices.shape[2]
    per_list_head = b * rows * k.shape[2]
    hc = max(1, min(h, _PLAIN_CHUNK_ELEMS // per_list_head))
    lc = max(1, min(nl, _PLAIN_CHUNK_ELEMS // (per_list_head * hc)))
    kw = dict(group=group, visual_len=visual_len, text_start=text_start,
              block_m=block_m, block_n=block_n, sm_scale=sm_scale)
    if hc == h and lc == nl:
        return _plain_lists(q, k, v, indices, counts, clean, rowbits,
                            text_len, **kw)
    out = torch.empty_like(q)
    for h0 in range(0, h, hc):
        hs = slice(h0, h0 + hc)
        for l0 in range(0, nl, lc):
            ls, qs = slice(l0, l0 + lc), slice(l0 * rows, (l0 + lc) * rows)
            out[:, hs, qs] = _plain_lists(
                q[:, hs, qs], k[:, hs], v[:, hs], indices[:, hs, ls],
                counts[:, hs, ls], clean[:, hs, ls],
                None if rowbits is None else rowbits[:, hs, ls], text_len,
                **kw)
    return out


def block_sparse_flash_attention_torch(
        q, k, v, indices, counts, text_len, *, visual_len, text_start,
        block_m=128, block_n=128, sm_scale=None, packed_kv=None, clean=None):
    """Plain PyTorch version of K1 (dense scores, in chunks of heads and
    index lists).  ``clean`` defaults to what the K1 wrapper computes."""
    if clean is None:
        clean = _clean_prefix(indices, counts, visual_len // block_n)
    return _plain(q, k, v, indices, counts, clean, None, text_len, group=1,
                  visual_len=visual_len, text_start=text_start,
                  block_m=block_m, block_n=block_n, sm_scale=sm_scale,
                  packed_kv=packed_kv)


def block_sparse_flash_attention_grouped_torch(
        q, k, v, indices, counts, rowbits, clean, text_len, *, group,
        visual_len, text_start, block_m=128, block_n=128, sm_scale=None,
        packed_kv=None):
    """Plain PyTorch version of K2 (``clean`` as given: the K2 wrapper
    clamps it before calling either path)."""
    return _plain(q, k, v, indices, counts, clean, rowbits, text_len,
                  group=group, visual_len=visual_len, text_start=text_start,
                  block_m=block_m, block_n=block_n, sm_scale=sm_scale,
                  packed_kv=packed_kv)


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


def _check_unported(return_stats=False, kv_quant=None, quant_mode=None):
    if return_stats:
        raise NotImplementedError(
            "return_stats (K1s, ring attention) is not ported yet")
    if kv_quant is not None or quant_mode is not None:
        raise NotImplementedError(
            "kv_quant / quant_mode (K1q, int8 KV) is not ported yet")


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


def _cuda_checks(q, k, v, packed_kv, block_m, block_n, *ints):
    kvt = packed_kv if packed_kv is not None else k
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA kernels take bf16 or fp16, got {q.dtype} "
                        "(fp32 inputs are not supported yet)")
    if kvt.dtype != q.dtype or (packed_kv is None and v.dtype != q.dtype):
        raise TypeError("q, k and v must share one dtype")
    if q.shape[-1] != 128:
        raise ValueError(f"the CUDA kernels take head_dim 128, got "
                         f"{q.shape[-1]}")
    if block_n != 128 or block_m % _TILE_M:
        raise ValueError(f"the CUDA kernels need block_n == 128 and block_m a "
                         f"multiple of {_TILE_M} (got {block_m}, {block_n})")
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
    if counts.numel() and int(counts.max()) > indices.shape[3]:
        raise ValueError(f"a count exceeds the {indices.shape[3]} slots of "
                         "its index list")


def _int32(x):
    return x.to(torch.int32).contiguous()


def block_sparse_flash_attention(
        q, k, v, indices, counts, text_len, *, visual_len, text_start,
        block_m=128, block_n=128, chunk_blocks=16, sm_scale=None,
        return_stats=False, kv_quant=None, quant_mode=None,
        prefetch_next=True, packed_kv=None):
    """K1: masked flash attention of each ``block_m`` query rows over the
    key blocks in the first ``counts`` slots of their index list.

    q [B,H,Sq,D] (Sq % block_m == 0); k/v [B,H,S,D] (S % block_n == 0) or
    ``packed_kv`` [B,H,S,2D]; indices [B,H,NQ,NB] int32; counts [B,H,NQ];
    text_len [B].  Returns [B,H,Sq,D] in q.dtype."""
    _check_unported(return_stats, kv_quant, quant_mode)
    b, h, sq, d = q.shape
    s = (packed_kv if packed_kv is not None else k).shape[2]
    if s % block_n or sq % block_m:
        raise ValueError(f"S={s} / Sq={sq} must be multiples of "
                         f"block_n={block_n} / block_m={block_m}")
    _check_lists(indices, counts, sq // block_m)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    clean = _clean_prefix(indices, counts, visual_len // block_n)
    if q.device.type == "cpu":
        return block_sparse_flash_attention_torch(
            q, k, v, indices, counts, text_len, visual_len=visual_len,
            text_start=text_start, block_m=block_m, block_n=block_n,
            sm_scale=sm_scale, packed_kv=packed_kv, clean=clean)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _cuda_checks(q, k, v, packed_kv, block_m, block_n, indices, counts,
                 text_len)
    lib = _load()
    q, out, kp, vp, bh_stride, row_stride, keep = _operands(q, k, v,
                                                            packed_kv)
    idx, cnt, cln, tl = (_int32(indices), _int32(counts), _int32(clean),
                         _int32(text_len))
    rc = lib.rsa_k1_launch(
        q.data_ptr(), kp, vp, out.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
        cln.data_ptr(), tl.data_ptr(), bh_stride, row_stride, b * h, h, sq,
        idx.shape[2], idx.shape[3], s // block_n, block_m, visual_len,
        -1 if text_start is None else text_start, int(text_start is not None),
        float(sm_scale), d, _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(
            f"K1 launch failed: {lib.rsa_error_string(rc).decode()}")
    block_sparse_flash_attention.launches += 1
    return out


block_sparse_flash_attention.launches = 0


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
            block_n=block_n, sm_scale=sm_scale, packed_kv=packed_kv)
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
        visual_len, -1 if text_start is None else text_start,
        int(text_start is not None), float(sm_scale), d,
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(
            f"K2 launch failed: {lib.rsa_error_string(rc).decode()}")
    block_sparse_flash_attention_grouped.launches += 1
    return out


block_sparse_flash_attention_grouped.launches = 0

