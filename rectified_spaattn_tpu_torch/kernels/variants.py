"""S3 and S2: ablation variants of the gather kernels K1 and K2, as CUDA
kernels with their plain PyTorch versions (port of the Pallas kernels of
scripts/bench_kernelvars.py and scripts/bench_groupedvars.py).

  S3a ``kernel_variant``   replaces ``build_variant_kernel``
      (scripts/bench_kernelvars.py:56, launched at :587): ``base``,
      ``dma``, ``dmahalf``, ``dmabig``, ``compute``, ``computeclean``,
      ``computenomask``, ``computenoexp``, ``nomask``, ``noexp``; a
      trailing ``3`` runs the same variant on a three-stage ring
      (``base3``).  (The script's name tests match the bare names only,
      so there "dma3" or "nomask3" ran base's body with three buffers.)
  S3b ``twophase``         replaces ``build_twophase_kernel`` (:205,
      launched at :442): whole clean chunks unmasked, then the masked tail.
  S3c ``runs``             replaces ``build_runs_kernel`` (:316, launched at
      :517): K1 whose producer walks the run pieces of ``piece_lengths``
      (:23-53, ported bit for bit), one index read a piece, copying each
      unit in two 128-row boxes a tensor.
  S2  ``grouped_variant``  replaces ``build_grouped_variant``
      (scripts/bench_groupedvars.py:39, launched at :224): ``full``,
      ``dma``, ``compute``, ``computeclean``, ``nobias``, ``prefetch``
      (a CTA walks 4 consecutive row tiles, ``SPAN`` in the source).

The kernels are in ``csrc/variants.cu`` (its header says what each variant
is on Hopper).  Every variant is a policy of the Hopper mainloop that K1
and K2 run (``csrc/hopper_attn.cuh``, K1's and K2's policies in
``csrc/sparse_tiles.cuh``), with one part taken out or changed: S3b is
S3a ``base`` with its whole clean chunks unmasked, S3c K1 with the run
pieces' producer.  Each wrapper takes the K1 (S3) or K2 (S2) arguments;
a CPU tensor runs the plain version here, a CUDA tensor launches the
kernel or raises.  Each wrapper counts its launches per variant in
``launches`` (a Counter).

What the plain versions return (the scripts' semantics, which the TPU
kernels computed on real data or, where noted, did not define):
  base, base3             K1's chunk loop over lists whose slots past the
                          list read its last index (the scripts do not pad)
  twophase                base's output (the kernel's, bit for bit): on
                          ascending lists (as mask_to_indices and the
                          plans give them) its unmasked chunks hold only
                          keys base's mask keeps
  nomask                  the same loop with no count or window mask: the
                          count raised to whole chunks, the window to all
                          keys
  noexp                   the loop with exp replaced by the scripts' linear
                          form: NaN on every row with count > 0 (it starts
                          from m = -inf), 0 elsewhere
  dma, dmahalf, dmabig    per chunk the first K row of its first block
                          (dmabig: of block min(idx, NBtot - chunk_blocks)),
                          summed in fp32 over the chunks, in every row
  compute*                the TPU read stale buffers; the kernels fill their
                          ring once with the head's first 64 keys, so each
                          is its counterpart (compute: base, computeclean
                          and computenomask: nomask, computenoexp: noexp;
                          S2 compute: full, computeclean: full without the
                          window) over K and V whose every 64-key unit is
                          that tile
  runs                    K1's output (the kernel's bit for bit where K1
                          does not split its key range)
  S2 full, prefetch       K2's output; nobias: attention over the union
                          list with the count and window masks; dma as above
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from . import cuda_build
from .block_sparse import (MASK_VALUE, _clean_prefix, _cuda_checks, _int32,
                           _operands, _plain, _stream,
                           block_sparse_flash_attention_torch,
                           block_sparse_flash_attention_grouped_torch)

S3A = ("base", "dma", "dmahalf", "dmabig", "compute", "computeclean",
       "computenomask", "computenoexp", "nomask", "noexp")
S2 = ("full", "dma", "compute", "computeclean", "nobias", "prefetch")
LOAD_ONLY = ("dma", "dmahalf", "dmabig")
# csrc/variants.cu's Variant enum
_CODE = {**{n: i for i, n in enumerate(S3A)}, "twophase": 10, "runs": 11,
         **{f"g_{n}": 12 + i for i, n in enumerate(S2)}}
BLOCK = 128           # the scripts' block_m and block_n
UNIT = 64             # the compute-only variants' tile: keys 0-63


def _declare(lib):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.rsa_variant_launch.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, ll,
                                       ll, i, i, i, i, i, i, i, i, i, i, i,
                                       f, p]
    lib.rsa_variant_launch.restype = i


def parse_s3(variant: str) -> tuple[str, int]:
    """("base", 2) for "base", ("base", 3) for "base3"."""
    name, stages = variant, 2
    if variant.endswith("3") and variant[:-1] in S3A:
        name, stages = variant[:-1], 3
    if name not in S3A:
        raise ValueError(f"unknown S3 variant {variant!r}: one of {S3A}, "
                         "with or without a trailing 3")
    return name, stages


# ------------------------------------------------------------------ plain ---

def _last_padded(indices, chunk_blocks: int):
    """The scripts' slot reads: slot s of a chunk reads indices[min(s,
    nb - 1)], so pad the slots to whole chunks with the last index."""
    pad = (-indices.shape[-1]) % chunk_blocks
    if not pad:
        return indices
    return torch.cat([indices, indices[..., -1:].expand(
        *indices.shape[:-1], pad)], dim=-1)


def _load_only(q, k, indices, counts, *, chunk_blocks, rows, big=False):
    """The load-only variants' output: per list, the sum in fp32 over its
    chunks c < ceil(count / g) of K row 0 of block indices[c * g] (dmabig:
    of block min(that, NBtot - g)), in every one of its ``rows`` rows."""
    b, h, nl, nb = indices.shape
    g = chunk_blocks
    nch = (counts.long() + g - 1) // g
    bh = torch.arange(b * h, device=q.device).reshape(b, h, 1)
    kf = k.reshape(b * h, k.shape[2], k.shape[3])
    acc = torch.zeros((b, h, nl, q.shape[-1]), device=q.device)
    for c in range(int(nch.max()) if nch.numel() else 0):
        blk = indices[..., min(c * g, nb - 1)].long()
        if big:
            blk = torch.clamp(blk, max=k.shape[2] // BLOCK - g)
        row = kf[bh.expand(b, h, nl), blk * BLOCK].float()
        acc = torch.where((c < nch)[..., None], acc + row, acc)
    out = acc[:, :, :, None, :].expand(b, h, nl, rows, q.shape[-1])
    return out.reshape(q.shape).to(q.dtype)


def _tiled(t):
    """K or V [B,H,S,D] whose every 64-key unit is the head's first: what
    the compute-only kernels read from their once-filled ring."""
    return t[:, :, :UNIT].repeat(1, 1, t.shape[2] // UNIT, 1)


def _linear(q, k, v, indices, counts, text_len, *, visual_len, text_start,
            chunk_blocks, sm_scale):
    """noexp's chunk loop, one head at a time: K1's masked scores and
    online update with exp replaced by the scripts' linear form (alpha =
    m_prev - m_next + 1, p = s - m_next; bench_kernelvars.py:187-189)."""
    b, h, sq, d = q.shape
    g, nl = chunk_blocks, indices.shape[2]
    idx = indices.reshape(b * h, nl, -1).long()
    cnt = counts.reshape(b * h, nl).long()
    qs = (q.float() * sm_scale).to(k.dtype).float().reshape(b * h, nl,
                                                            BLOCK, d)
    kf, vf = k.reshape(b * h, -1, d), v.reshape(b * h, -1, d)
    tl = text_len.to(q.device).long().repeat_interleave(h)
    lane = torch.arange(g * BLOCK, device=q.device)
    out = torch.empty_like(qs)
    for i in range(b * h):
        m = torch.full((nl, BLOCK), -math.inf, device=q.device)
        l = torch.zeros((nl, BLOCK), device=q.device)
        acc = torch.zeros((nl, BLOCK, d), device=q.device)
        nch = (cnt[i] + g - 1) // g
        for c in range(int(nch.max()) if nl else 0):
            cols = (idx[i, :, c * g:(c + 1) * g, None] * BLOCK
                    + torch.arange(BLOCK, device=q.device)).reshape(nl, -1)
            live = (c * g + lane // BLOCK)[None] < cnt[i, :, None]
            ok = cols < visual_len
            if text_start is not None:
                ok = ok | ((cols >= text_start) & (cols < text_start + tl[i]))
            s = torch.einsum("lrd,lkd->lrk", qs[i], kf[i][cols].float())
            s = torch.where((live & ok)[:, None], s,
                            torch.tensor(MASK_VALUE, device=q.device))
            m_next = torch.maximum(m, s.amax(dim=-1))
            alpha, p = m - m_next + 1.0, s - m_next[..., None]
            pv = torch.einsum("lrk,lkd->lrd", p.to(v.dtype).float(),
                              vf[i][cols].float())
            upd = (c < nch)[:, None]
            l = torch.where(upd, alpha * l + p.sum(dim=-1), l)
            acc = torch.where(upd[..., None], acc * alpha[..., None] + pv,
                              acc)
            m = torch.where(upd, m_next, m)
        inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
        out[i] = acc * inv[..., None]
    return out.reshape(q.shape).to(q.dtype)


def _plain_s3(name, q, k, v, indices, counts, text_len, *, visual_len,
              text_start, chunk_blocks, sm_scale, packed_kv=None):
    d = q.shape[-1]
    if packed_kv is not None:
        k, v = packed_kv[..., :d], packed_kv[..., d:]
    if name in LOAD_ONLY:
        return _load_only(q, k, indices, counts, chunk_blocks=chunk_blocks,
                          rows=BLOCK, big=name == "dmabig")
    if name.startswith("compute"):
        # no copies: every unit is the ring's tile.  Without a mask, and on
        # one tile repeated, the walk's length changes no value, so
        # computeclean (count slots) is nomask (the chunk extent)
        k, v = _tiled(k), _tiled(v)
        name = {"compute": "base", "computeclean": "nomask",
                "computenomask": "nomask", "computenoexp": "noexp"}[name]
    indices = _last_padded(indices, chunk_blocks)
    kw = dict(visual_len=visual_len, text_start=text_start,
              chunk_blocks=chunk_blocks, sm_scale=sm_scale)
    if name == "noexp":
        return _linear(q, k, v, indices, counts, text_len, **kw)
    if name == "nomask":
        # every lane of the chunks under count valid
        counts = (counts + chunk_blocks - 1) // chunk_blocks * chunk_blocks
        kw.update(visual_len=k.shape[2], text_start=None)
    return _plain(q, k, v, indices, counts, None, text_len, group=1,
                  block_m=BLOCK, block_n=BLOCK, packed_kv=None, **kw)


def twophase_clean(indices, counts, visual_len: int):
    """The twophase script's clean count: slots within count whose block
    lies below the visual window's last whole block (not a prefix: the
    kernel trusts the ascending lists to put them first)."""
    slot = torch.arange(indices.shape[-1], device=indices.device)
    return ((indices < visual_len // BLOCK)
            & (slot < counts[..., None])).sum(dim=-1).to(torch.int32)


def piece_lengths(indices, counts, chunk: int, max_run: int):
    """Per-slot copy piece lengths for run-coalesced gathering (port of
    scripts/bench_kernelvars.py:23-53, bit for bit).

    A piece starts where the list breaks contiguity, at chunk boundaries,
    and every ``max_run`` slots within a run; its length covers the
    contiguous slots it spans (0 on covered and invalid slots)."""
    nb = indices.shape[-1]
    dev = indices.device
    s = torch.arange(nb, dtype=torch.int32, device=dev)
    valid = s < counts[..., None]
    adj = torch.cat([torch.zeros((*indices.shape[:-1], 1), dtype=torch.bool,
                                 device=dev),
                     indices[..., 1:] == indices[..., :-1] + 1], dim=-1)
    adj = adj & ((s % chunk) != 0) & valid
    is_start = valid & ~adj
    neg = torch.full_like(indices, -1, dtype=torch.int32)
    run_start = torch.cummax(torch.where(is_start, s, neg), dim=-1).values
    pos = s - run_start
    piece_start = valid & (pos % max_run == 0)
    far = torch.full_like(indices, 2 * nb, dtype=torch.int32)
    starts_pos = torch.where(is_start, s, far)
    nxt = torch.flip(torch.cummin(torch.flip(starts_pos, [-1]), dim=-1).values,
                     [-1])
    nxt_after = torch.cat([nxt[..., 1:], far[..., :1]], dim=-1)
    run_end = torch.minimum(nxt_after, counts[..., None].to(torch.int32))
    # a chunk boundary also ends a piece
    run_end = torch.minimum(run_end, (s // chunk + 1) * chunk)
    return torch.where(piece_start, torch.clamp(run_end - s, max=max_run),
                       torch.zeros_like(s)).to(torch.int32)


# ----------------------------------------------------------------- launch ---

def _launch(code, stages, q, k, v, indices, counts, text_len, *,
            visual_len, text_start, chunk_blocks, sm_scale, packed_kv=None,
            group=1, clean=None, rowbits=None, plen=None):
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the variant kernels take bf16, got {q.dtype}")
    _cuda_checks(q, k, v, packed_kv, BLOCK, BLOCK, indices, counts,
                 text_len, *(t for t in (clean, rowbits, plen)
                             if t is not None), head_dims=(128,))
    lib = cuda_build.load("variants", _declare)
    b, h, sq, _ = q.shape
    s = (packed_kv if packed_kv is not None else k).shape[2]
    q, out, kp, vp, bh_stride, row_stride, keep = _operands(q, k, v,
                                                            packed_kv)
    ints = [None if t is None else _int32(t)
            for t in (indices, counts, clean, rowbits, text_len, plen)]
    ptr = [None if t is None else t.data_ptr() for t in ints]
    rc = lib.rsa_variant_launch(
        code, stages, q.data_ptr(), kp, vp, out.data_ptr(), ptr[0], ptr[1],
        ptr[2], ptr[3], ptr[4], ptr[5], bh_stride, row_stride, b * h, h, sq,
        indices.shape[2], indices.shape[3], s // BLOCK, group, chunk_blocks,
        visual_len, -1 if text_start is None else text_start,
        int(text_start is not None), float(sm_scale), _stream(q))
    if rc:
        raise RuntimeError(f"variant launch failed: "
                           f"{lib.rsa_error_string(rc).decode()}")
    return out


def _check_s3(q, k, packed_kv, indices, counts, chunk_blocks):
    b, h, sq, _ = q.shape
    s = (packed_kv if packed_kv is not None else k).shape[2]
    if sq % BLOCK or s % BLOCK:
        raise ValueError(f"Sq={sq} and S={s} must be multiples of {BLOCK}")
    if tuple(indices.shape[:3]) != (b, h, sq // BLOCK) \
            or tuple(counts.shape) != (b, h, sq // BLOCK):
        raise ValueError("indices / counts must hold one list per 128 rows")
    if counts.numel() and int(counts.max()) > indices.shape[3]:
        raise ValueError("a count exceeds its index list")
    if chunk_blocks < 1:
        raise ValueError("chunk_blocks must be positive")


def _device(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type == "cpu"


def kernel_variant_torch(variant, q, k, v, indices, counts, text_len, *,
                         visual_len, text_start, chunk_blocks=16,
                         sm_scale=None, packed_kv=None):
    """Plain PyTorch version of S3a (any device)."""
    name, _ = parse_s3(variant)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _plain_s3(name, q, k, v, indices, counts, text_len,
                     visual_len=visual_len, text_start=text_start,
                     chunk_blocks=chunk_blocks, sm_scale=sm_scale,
                     packed_kv=packed_kv)


def kernel_variant(variant, q, k, v, indices, counts, text_len, *,
                   visual_len, text_start, chunk_blocks=16, sm_scale=None,
                   packed_kv=None):
    """S3a: one ablation of K1 (see the module docstring).  K1's arguments
    with block_m = block_n = 128; ``variant`` one of S3A, optionally with
    a trailing "3" (three ring stages)."""
    name, stages = parse_s3(variant)
    _check_s3(q, k, packed_kv, indices, counts, chunk_blocks)
    if name == "dmabig":
        s = (packed_kv if packed_kv is not None else k).shape[2]
        if s // BLOCK < chunk_blocks:
            raise ValueError("dmabig streams chunk_blocks whole blocks: S "
                             f"holds only {s // BLOCK}")
    kw = dict(visual_len=visual_len, text_start=text_start,
              chunk_blocks=chunk_blocks, packed_kv=packed_kv)
    if _device(q):
        return kernel_variant_torch(variant, q, k, v, indices, counts,
                                    text_len, sm_scale=sm_scale, **kw)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    # S3a masks every unit: no clean prefix
    out = _launch(_CODE[name], stages, q, k, v, indices, counts, text_len,
                  clean=torch.zeros_like(counts, dtype=torch.int32),
                  sm_scale=sm_scale, **kw)
    kernel_variant.launches[variant] += 1
    return out


kernel_variant.launches = collections.Counter()


def twophase_torch(q, k, v, indices, counts, text_len, *, visual_len,
                   text_start, chunk_blocks=16, sm_scale=None,
                   packed_kv=None):
    """Plain PyTorch version of S3b (any device): base's.  The lists
    ascend within count (mask_to_indices' order), so the clean chunks the
    kernel leaves unmasked hold only keys in the visual window, which
    base's mask keeps."""
    return kernel_variant_torch("base", q, k, v, indices, counts, text_len,
                                visual_len=visual_len, text_start=text_start,
                                chunk_blocks=chunk_blocks, sm_scale=sm_scale,
                                packed_kv=packed_kv)


def twophase(q, k, v, indices, counts, text_len, *, visual_len, text_start,
             chunk_blocks=16, sm_scale=None, packed_kv=None):
    """S3b: K1 whose first ``clean // chunk_blocks`` chunks run unmasked
    (``clean`` as ``twophase_clean`` counts it), then the masked tail."""
    _check_s3(q, k, packed_kv, indices, counts, chunk_blocks)
    kw = dict(visual_len=visual_len, text_start=text_start,
              chunk_blocks=chunk_blocks, packed_kv=packed_kv)
    if _device(q):
        return twophase_torch(q, k, v, indices, counts, text_len,
                              sm_scale=sm_scale, **kw)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    out = _launch(_CODE["twophase"], 2, q, k, v, indices, counts, text_len,
                  clean=twophase_clean(indices, counts, visual_len),
                  sm_scale=sm_scale, **kw)
    twophase.launches["twophase"] += 1
    return out


twophase.launches = collections.Counter()


def runs_torch(q, k, v, indices, counts, text_len, *, visual_len,
               text_start, max_run=4, chunk_blocks=16, sm_scale=None,
               packed_kv=None):
    """Plain PyTorch version of S3c (any device): K1's."""
    del max_run
    return block_sparse_flash_attention_torch(
        q, k, v, indices, counts, text_len, visual_len=visual_len,
        text_start=text_start, chunk_blocks=chunk_blocks, sm_scale=sm_scale,
        packed_kv=packed_kv)


def runs(q, k, v, indices, counts, text_len, *, visual_len, text_start,
         max_run=4, chunk_blocks=16, sm_scale=None, packed_kv=None):
    """S3c: K1 whose producer walks the run pieces of
    ``piece_lengths(indices, counts, chunk_blocks, max_run)`` (one index
    read a piece) and copies each unit in two 128-row boxes a tensor; its
    output is K1's."""
    _check_s3(q, k, packed_kv, indices, counts, chunk_blocks)
    if max_run < 1:
        raise ValueError("max_run must be positive")
    kw = dict(visual_len=visual_len, text_start=text_start,
              chunk_blocks=chunk_blocks, packed_kv=packed_kv)
    if _device(q):
        return runs_torch(q, k, v, indices, counts, text_len,
                          sm_scale=sm_scale, **kw)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    out = _launch(_CODE["runs"], 2, q, k, v, indices, counts, text_len,
                  clean=_clean_prefix(indices, counts, visual_len // BLOCK),
                  plen=piece_lengths(indices, counts, chunk_blocks, max_run),
                  sm_scale=sm_scale, **kw)
    runs.launches[f"runs{max_run}"] += 1
    return out


runs.launches = collections.Counter()


def _check_s2(variant, q, indices, counts, rowbits, clean, group):
    if variant not in S2:
        raise ValueError(f"unknown S2 variant {variant!r}: one of {S2}")
    b, h, sq, _ = q.shape
    ngrp = indices.shape[2]
    if sq != ngrp * group * BLOCK or not 1 <= group <= 8:
        raise ValueError(f"Sq={sq} must equal lists({ngrp}) x group({group})"
                         f" x {BLOCK}, group in [1, 8]")
    if rowbits.shape != indices.shape or clean.shape != counts.shape \
            or tuple(counts.shape) != (b, h, ngrp):
        raise ValueError("rowbits must have the shape of indices, clean and "
                         "counts one entry per list")
    if counts.numel() and int(counts.max()) > indices.shape[3]:
        raise ValueError("a count exceeds its index list")


def grouped_variant_torch(variant, q, k, v, indices, counts, rowbits, clean,
                          text_len, *, group, visual_len, text_start,
                          chunk_blocks=16, sm_scale=None, packed_kv=None):
    """Plain PyTorch version of S2 (any device)."""
    d = q.shape[-1]
    if packed_kv is not None:
        k, v = packed_kv[..., :d], packed_kv[..., d:]
    kw = dict(visual_len=visual_len, text_start=text_start,
              chunk_blocks=chunk_blocks,
              sm_scale=1.0 / math.sqrt(d) if sm_scale is None else sm_scale)
    if variant == "dma":
        return _load_only(q, k, indices, counts, chunk_blocks=chunk_blocks,
                          rows=group * BLOCK)
    if variant.startswith("compute"):
        k, v = _tiled(k), _tiled(v)
    if variant == "computeclean":
        # the member walk without the window mask
        kw.update(visual_len=k.shape[2], text_start=None)
    if variant in ("nobias", "computeclean"):
        return _plain(q, k, v, indices, counts,
                      rowbits if variant == "computeclean" else None,
                      text_len, group=group, block_m=BLOCK, block_n=BLOCK,
                      packed_kv=None, **kw)
    return block_sparse_flash_attention_grouped_torch(
        q, k, v, indices, counts, rowbits, clean, text_len, group=group, **kw)


def grouped_variant(variant, q, k, v, indices, counts, rowbits, clean,
                    text_len, *, group, visual_len, text_start,
                    chunk_blocks=16, sm_scale=None, packed_kv=None):
    """S2: one ablation of K2 (see the module docstring), on K2's
    arguments (the lists of sparse/ops.py::group_rows)."""
    _check_s2(variant, q, indices, counts, rowbits, clean, group)
    # as K2's wrapper: the clean prefix the slot data supports
    clean = torch.minimum(clean.to(torch.int32), _clean_prefix(
        indices, counts, visual_len // BLOCK, rowbits, group))
    kw = dict(group=group, visual_len=visual_len, text_start=text_start,
              chunk_blocks=chunk_blocks, packed_kv=packed_kv)
    if _device(q):
        return grouped_variant_torch(variant, q, k, v, indices, counts,
                                     rowbits, clean, text_len,
                                     sm_scale=sm_scale, **kw)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    out = _launch(_CODE[f"g_{variant}"], 2, q, k, v, indices, counts,
                  text_len, clean=clean, rowbits=rowbits,
                  sm_scale=sm_scale, **kw)
    grouped_variant.launches[f"g{group}_{variant}"] += 1
    return out


grouped_variant.launches = collections.Counter()
