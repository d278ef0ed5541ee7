"""The port's kernel-diagnostic path against the JAX package on the CPU:
the S3 variants of K1 (kernels/variants.py: kernel_variant, twophase,
runs, piece_lengths) against the Pallas kernels of
scripts/bench_kernelvars.py, the S2 variants of K2 (grouped_variant)
against scripts/bench_groupedvars.py, K1q with stats against the JAX
kernel, the benchmarks' input makers, and the headline and variant
benchmarks run at a tiny grid.

The scripts are loaded from their files; each of their ``build_*``
kernels runs through ``pl.pallas_call(..., interpret=True)`` with the
script's own specs.  Tolerances: fp32 rtol 2e-4 / atol 2e-5 and bf16 2e-2
(tests/test_kernels.py:44,101); the load-only variants and piece_lengths
bit for bit; K1q-s's o as K1q's test, m within 2e-2, l within 1 %
(PERF.md §2).

In interpret mode, scratch memory that was never written reads as NaN.
So the compute-only variants (no copies) and the runs kernel (slots past
a list's count are never copied, and p = 0 times NaN is NaN) have no JAX
output to compare with: the compute-only plain versions are checked
against what the card's kernels compute on a ring filled once with the
head's first 64 keys, and runs against the production K1 (its output on
the TPU).
"""

import ast
import functools
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rectified_spaattn_tpu import kernels as jk
from rectified_spaattn_tpu.kernels.block_sparse import _pad_slots as j_pad_slots
from rectified_spaattn_tpu.sparse import ops as jops
from rectified_spaattn_tpu_torch import kernels as tk
from rectified_spaattn_tpu_torch.bench import (groupedvars, headline, inputs,
                                               kernelvars)
from rectified_spaattn_tpu_torch.bench.common import median
from rectified_spaattn_tpu_torch.kernels import variants
from rectified_spaattn_tpu_torch.sparse import ops

torch.set_num_threads(1)
BM = BN = 128
F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    """scripts/<name>.py, loaded from its file (it is a script)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def kernelvars_script():
    return _script("bench_kernelvars")


@functools.lru_cache(maxsize=None)
def groupedvars_script():
    return _script("bench_groupedvars")


def arr(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def case(seed, nq=2, nb=6, d=32, group=1):
    """B=2, one head, ``nq`` 128-row blocks over ``nb`` key blocks: [nb-1
    visual blocks (the last 30 tokens padding) | 1 text block], text
    lengths 70 and 0; a random mask with the first and the text block, and
    in batch 1 a row block whose only block is its masked text block."""
    b, h = 2, 1
    q, k, v = arr(seed, b, h, nq * BM, d), arr(seed + 1, b, h, nb * BN, d), \
        arr(seed + 2, b, h, nb * BN, d)
    mask = np.random.default_rng(seed + 3).uniform(size=(b, h, nq, nb)) < 0.5
    mask[..., 0] = mask[..., -1] = True
    mask[1, 0, nq - 1] = False
    mask[1, 0, nq - 1, -1] = True               # degenerate (K/V not zeroed)
    tlen = np.array([70, 0], np.int32)
    return q, k, v, mask, tlen, dict(visual_len=(nb - 1) * BN - 30,
                                     text_start=(nb - 1) * BN)


def t(x):
    return torch.from_numpy(np.asarray(x))


def jax_s3(builder, q, k, v, indices, counts, tlen, chunk, nbuf=2,
           big=False, clean=None):
    """A bench_kernelvars kernel through pl.pallas_call in interpret mode,
    with the specs of the script's run_variant (run_twophase_variant with
    ``clean``)."""
    b, h, sq, d = q.shape
    s = k.shape[2]
    nq, nb, bh = sq // BM, indices.shape[-1], b * h
    qf = jnp.asarray(q).reshape(bh, sq, d)
    kv = jnp.concatenate([jnp.asarray(k).reshape(bh, s, d),
                          jnp.asarray(v).reshape(bh, s, d)], axis=2)
    smem4 = pl.BlockSpec((1, 1, 1, 1), lambda i, j: (i, j, 0, 0),
                         memory_space=pltpu.SMEM)
    specs = [smem4] + ([smem4] if clean is not None else []) + [
        pl.BlockSpec((1, 1, 1), lambda i, j: (i, 0, 0),
                     memory_space=pltpu.SMEM),
        pl.BlockSpec((1, 1, 1, nb), lambda i, j: (i, j, 0, 0),
                     memory_space=pltpu.SMEM),
        pl.BlockSpec((1, BM, d), lambda i, j: (i, j, 0),
                     memory_space=pltpu.VMEM),
        pl.BlockSpec(memory_space=pl.ANY)]
    buf = ((nbuf, chunk * BN, 2 * d) if big else (nbuf, chunk, BN, 2 * d))
    ops_ = [jnp.asarray(counts).reshape(bh, nq, 1, 1)]
    if clean is not None:
        ops_.append(jnp.asarray(clean).reshape(bh, nq, 1, 1))
    ops_ += [jnp.repeat(jnp.asarray(tlen), h).reshape(bh, 1, 1),
             jnp.asarray(indices).reshape(bh, nq, 1, nb), qf, kv]
    return np.asarray(pl.pallas_call(
        builder, out_shape=jax.ShapeDtypeStruct((bh, sq, d), qf.dtype),
        grid=(bh, nq), in_specs=specs,
        out_specs=pl.BlockSpec((1, BM, d), lambda i, j: (i, j, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM(buf, kv.dtype),
                        pltpu.SemaphoreType.DMA((nbuf, chunk))],
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("parallel", "arbitrary")),
        interpret=True)(*ops_)).reshape(q.shape)


def jax_variant(variant, q, k, v, mask, tlen, kw, chunk):
    """S3a through the script's build_variant_kernel."""
    jidx, jcnt = jops.mask_to_indices(jnp.asarray(mask))
    kern = kernelvars_script().build_variant_kernel(
        variant, BN, chunk, q.shape[-1] ** -0.5, kw["visual_len"],
        kw["text_start"])
    return jax_s3(kern, q, k, v, jidx, jcnt, tlen, chunk,
                  nbuf=3 if variant.endswith("3") else 2,
                  big=variant == "dmabig")


def port_s3(variant, q, k, v, mask, tlen, kw, chunk, dtype=torch.float32):
    idx, cnt = ops.mask_to_indices(t(mask))
    args = [t(x).to(dtype) for x in (q, k, v)] + [idx, cnt, t(tlen)]
    kw = dict(kw, chunk_blocks=chunk)
    if variant == "twophase":
        return variants.twophase(*args, **kw)
    if variant.startswith("runs"):
        return variants.runs(*args, max_run=int(variant[4:]), **kw)
    return variants.kernel_variant(variant, *args, **kw)


# ------------------------------------------------------------------ S3 ---

@pytest.mark.parametrize("variant", ["base", "base3", "nomask", "twophase"])
@pytest.mark.parametrize("chunk", [2, 4])
def test_s3_value_variants_match_jax(variant, chunk):
    """The value-defined S3 variants, fp32: the port's plain version
    against the script's kernel in interpret mode, the degenerate row
    (its slots past the list read the list's last index) included."""
    q, k, v, mask, tlen, kw = case(10 + chunk)
    got = port_s3(variant, q, k, v, mask, tlen, kw, chunk).numpy()
    if variant == "twophase":
        jidx, jcnt = jops.mask_to_indices(jnp.asarray(mask))
        clean = jnp.sum((jidx < kw["visual_len"] // BN)
                        & (jnp.arange(jidx.shape[-1]) < jcnt[..., None]),
                        axis=-1).astype(jnp.int32)
        np.testing.assert_array_equal(variants.twophase_clean(
            *ops.mask_to_indices(t(mask)), kw["visual_len"]).numpy(),
            np.asarray(clean))
        kern = kernelvars_script().build_twophase_kernel(
            BN, chunk, q.shape[-1] ** -0.5, kw["visual_len"],
            kw["text_start"])
        want = jax_s3(kern, q, k, v, jidx, jcnt, tlen, chunk, clean=clean)
    else:
        want = jax_variant(variant, q, k, v, mask, tlen, kw, chunk)
    np.testing.assert_allclose(got, want, **F32)
    assert np.abs(want[1, 0, BM:]).max() > 1e-3      # the degenerate rows


@pytest.mark.parametrize("variant", ["base", "twophase"])
def test_s3_bf16_matches_jax(variant):
    """bf16 inputs on both sides: within the repo's bf16 tolerance."""
    q, k, v, mask, tlen, kw = case(20)
    got = port_s3(variant, q, k, v, mask, tlen, kw, 2, dtype=torch.bfloat16)
    jq, jkk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    if variant == "twophase":
        jidx, jcnt = jops.mask_to_indices(jnp.asarray(mask))
        clean = variants.twophase_clean(*ops.mask_to_indices(t(mask)),
                                        kw["visual_len"]).numpy()
        kern = kernelvars_script().build_twophase_kernel(
            BN, 2, q.shape[-1] ** -0.5, kw["visual_len"], kw["text_start"])
        want = jax_s3(kern, jq, jkk, jv, jidx, jcnt, tlen, 2, clean=clean)
    else:
        want = jax_variant(variant, jq, jkk, jv, mask, tlen, kw, 2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("variant", ["dma", "dmahalf", "dmabig"])
@pytest.mark.parametrize("chunk", [2, 4])
def test_s3_load_only_bit_exact(variant, chunk):
    """The load-only variants, fp32: per chunk the first K row of its
    first block (dmabig: of its contiguous span), summed over the chunks,
    bit for bit.  Their three-stage forms give the same values (the
    script's name tests match only the bare names, so its "dma3" runs
    base with three buffers: not compared)."""
    q, k, v, mask, tlen, kw = case(30 + chunk)
    got = port_s3(variant, q, k, v, mask, tlen, kw, chunk).numpy()
    want = jax_variant(variant, q, k, v, mask, tlen, kw, chunk)
    np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(
        port_s3(variant + "3", q, k, v, mask, tlen, kw, chunk).numpy(), got)


@pytest.mark.parametrize("chunk", [2, 4])
def test_s3_noexp_nan_positions(chunk):
    """noexp is NaN by construction on every row with count > 0 (m starts
    at -inf, so the first alpha is -inf and -inf * 0 is NaN) on any
    device; rows with count 0 are 0."""
    q, k, v, mask, tlen, kw = case(40 + chunk)
    mask[0, 0, 0] = False                               # a count-0 row block
    got = port_s3("noexp", q, k, v, mask, tlen, kw, chunk).numpy()
    want = jax_variant("noexp", q, k, v, mask, tlen, kw, chunk)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[1]).all()
    np.testing.assert_array_equal(got[0, 0, :BM], 0.0)
    np.testing.assert_array_equal(want[0, 0, :BM], 0.0)


def tiled(x):
    """x [B,H,S,D] with every 64-key unit replaced by the head's first."""
    return np.tile(x[:, :, :64], (1, 1, x.shape[2] // 64, 1))


def one_tile_attention(q, k, v):
    """Softmax attention of every row over the head's first 64 keys."""
    s = np.einsum("bhqd,bhkd->bhqk", q, k[:, :, :64]) / np.sqrt(q.shape[-1])
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True),
                     v[:, :, :64])


@pytest.mark.parametrize("variant", ["compute", "computeclean",
                                     "computenomask", "computenoexp",
                                     "compute3"])
def test_s3_compute_only_plain(variant):
    """The compute-only variants make no copies.  No JAX comparison: in
    interpret mode their never-written scratch reads as NaN (on the TPU it
    was stale but finite).  The card's kernels fill their ring once with
    the head's first 64 keys, so every walked unit is that tile: compute
    is the JAX-checked base on K and V so tiled; without a mask the
    softmax over copies of one tile is attention over the tile itself
    (count-0 rows 0); computenoexp is NaN where noexp is."""
    q, k, v, mask, tlen, kw = case(50)
    mask[0, 0, 1] = False
    got = port_s3(variant, q, k, v, mask, tlen, kw, 2).numpy()
    live = ops.mask_to_indices(t(mask))[1].numpy() > 0
    rows = np.repeat(live, BM, axis=-1)
    if variant == "computenoexp":
        assert np.isnan(got[rows]).all() and (got[~rows] == 0).all()
        return
    if variant in ("compute", "compute3"):
        want = port_s3("base", q, tiled(k), tiled(v), mask, tlen, kw,
                       2).numpy()
        np.testing.assert_allclose(got, want, **F32)
        assert np.abs(got[1, 0, BM:]).max() > 1e-3      # degenerate rows
    else:
        want = np.where(rows[..., None], one_tile_attention(q, k, v), 0.0)
        np.testing.assert_allclose(got, want, **F32)
    assert np.abs(got).max() > 1e-2


@pytest.mark.parametrize("max_run", [1, 2, 4])
def test_s3_runs_matches_jax_k1(max_run):
    """runs: the production K1's output (the JAX runs kernel reads NaN
    scratch in interpret mode past a list's count), against the JAX K1 in
    interpret mode at fp32."""
    q, k, v, mask, tlen, kw = case(60 + max_run, nb=8)
    got = port_s3(f"runs{max_run}", q, k, v, mask, tlen, kw, 4).numpy()
    jidx, jcnt = jops.mask_to_indices(jnp.asarray(mask))
    want = np.asarray(jk.block_sparse_flash_attention(
        *map(jnp.asarray, (q, k, v)), jidx, jcnt, jnp.asarray(tlen),
        chunk_blocks=4, interpret=True, **kw))
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("chunk,max_run", [(2, 1), (4, 2), (4, 4), (16, 4),
                                           (16, 3)])
def test_piece_lengths_bit_exact(chunk, max_run):
    """piece_lengths against the script's on lists with long runs, breaks,
    count-0 and full lists."""
    rng = np.random.default_rng(chunk * 10 + max_run)
    nb = 40
    mask = np.zeros((2, 3, 5, nb), bool)
    for i in np.ndindex(mask.shape[:3]):
        start = rng.integers(0, nb)
        mask[i][start:start + rng.integers(1, 20)] = True
        mask[i] |= rng.uniform(size=nb) < 0.2
    mask[0, 0, 0] = False
    mask[1, 2, 4] = True
    idx, cnt = ops.mask_to_indices(t(mask))
    got = variants.piece_lengths(idx, cnt, chunk, max_run).numpy()
    jidx, jcnt = jops.mask_to_indices(jnp.asarray(mask))
    want = np.asarray(kernelvars_script().piece_lengths(jidx, jcnt, chunk,
                                                        max_run))
    np.testing.assert_array_equal(got, want)
    # the pieces partition each list's first count slots
    assert (got.sum(-1) == cnt.numpy()).all()


@pytest.mark.parametrize("max_run", [1, 2, 4])
@pytest.mark.parametrize("chunk", [2, 4, 16])
def test_piece_lengths_walk_invariant(chunk, max_run):
    """What S3c's producer relies on when it reads one block index a
    piece: on ascending lists with runs, the pieces of piece_lengths cover
    [0, count) exactly once, each is contiguous (idx[s + j] == idx[s] +
    j), none crosses a chunk or is longer than max_run, and slots past
    count start none."""
    rng = np.random.default_rng(100 * chunk + max_run)
    nb = 48
    mask = np.zeros((2, 3, 6, nb), bool)
    for i in np.ndindex(mask.shape[:3]):
        for _ in range(rng.integers(0, 4)):
            start = rng.integers(0, nb)
            mask[i][start:start + rng.integers(1, 24)] = True
        mask[i] |= rng.uniform(size=nb) < 0.15
    mask[0, 0, 0] = False
    mask[1, 2, 5] = True
    idx, cnt = (x.numpy() for x in ops.mask_to_indices(t(mask)))
    plen = variants.piece_lengths(t(idx), t(cnt), chunk, max_run).numpy()
    for i in np.ndindex(cnt.shape):
        covered = np.zeros(nb, int)
        for s in np.flatnonzero(plen[i]):
            n = plen[i][s]
            assert s < cnt[i] and 1 <= n <= max_run
            assert s // chunk == (s + n - 1) // chunk
            np.testing.assert_array_equal(idx[i][s:s + n],
                                          idx[i][s] + np.arange(n))
            covered[s:s + n] += 1
        np.testing.assert_array_equal(covered, np.arange(nb) < cnt[i])


def test_unknown_variants_raise():
    q, k, v, mask, tlen, kw = case(70)
    with pytest.raises(ValueError, match="unknown S3"):
        port_s3("bogus", q, k, v, mask, tlen, kw, 2)
    ui, uc, rb, cl = ops.group_rows(t(mask), 2, clean_blocks=4)
    with pytest.raises(ValueError, match="unknown S2"):
        variants.grouped_variant("bogus", *(t(x) for x in (q, k, v)), ui, uc,
                                 rb, cl, t(tlen), group=2, **kw)
    with pytest.raises(ValueError, match="device"):
        variants.kernel_variant("base", t(q).to("meta"), t(k), t(v),
                                *ops.mask_to_indices(t(mask)), t(tlen), **kw)


# ------------------------------------------------------------------ S2 ---

def jax_s2(variant, q, k, v, mask, tlen, kw, group, chunk):
    """S2 through the script's build_grouped_variant with the specs of
    run_grouped_variant, in interpret mode."""
    b, h, sq, d = q.shape
    s = k.shape[2]
    bh = b * h
    qf = jnp.asarray(q).reshape(bh, sq, d)
    kv = jnp.concatenate([jnp.asarray(k).reshape(bh, s, d),
                          jnp.asarray(v).reshape(bh, s, d)], axis=2)
    indices, counts, rowbits, clean = jops.group_rows(
        jnp.asarray(mask), group, clean_blocks=kw["visual_len"] // BN)
    (indices, rowbits), nb = j_pad_slots((indices, rowbits), chunk)
    ngrp = indices.shape[2]
    idx_f = indices.reshape(bh, ngrp, 1, nb)
    kern = groupedvars_script().build_grouped_variant(
        variant, group, BN, chunk, d ** -0.5, kw["visual_len"],
        kw["text_start"])
    rows = group * BM
    smem4 = pl.BlockSpec((1, 1, 1, 1), lambda i, j: (i, j, 0, 0),
                         memory_space=pltpu.SMEM)
    lst = pl.BlockSpec((1, 1, 1, nb), lambda i, j: (i, j, 0, 0),
                       memory_space=pltpu.SMEM)
    out = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((bh, sq, d), qf.dtype),
        grid=(bh, ngrp),
        in_specs=[smem4, smem4,
                  pl.BlockSpec((1, 1, 1), lambda i, j: (i, 0, 0),
                               memory_space=pltpu.SMEM),
                  lst, lst,
                  pl.BlockSpec((1, ngrp, 1, chunk), lambda i, j: (i, 0, 0, 0),
                               memory_space=pltpu.SMEM),
                  pl.BlockSpec((1, rows, d), lambda i, j: (i, j, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, rows, d), lambda i, j: (i, j, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, chunk * BN, 2 * d), kv.dtype),
                        pltpu.SemaphoreType.DMA((2, chunk))],
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("parallel", "arbitrary")),
        interpret=True)(
            counts.reshape(bh, ngrp, 1, 1),
            clean.astype(jnp.int32).reshape(bh, ngrp, 1, 1),
            jnp.repeat(jnp.asarray(tlen), h).reshape(bh, 1, 1), idx_f,
            rowbits.reshape(bh, ngrp, 1, nb), idx_f[..., :chunk], qf, kv)
    return np.asarray(out).reshape(q.shape)


def port_s2(variant, q, k, v, mask, tlen, kw, group, chunk,
            dtype=torch.float32):
    lists = ops.group_rows(t(mask), group,
                           clean_blocks=kw["visual_len"] // BN)
    return variants.grouped_variant(
        variant, *(t(x).to(dtype) for x in (q, k, v)), *lists, t(tlen),
        group=group, chunk_blocks=chunk, **kw)


def s2_case(seed):
    q, k, v, mask, tlen, kw = case(seed, nq=4, nb=8)
    mask[0, 0, 1] = False                # a row block with no block of its own
    return q, k, v, mask, tlen, kw


@pytest.mark.parametrize("variant", ["full", "prefetch", "nobias"])
@pytest.mark.parametrize("group", [2, 4])
def test_s2_value_variants_match_jax(variant, group):
    """full and prefetch (K2's output) and nobias (attention over the
    union) at fp32, degenerate row blocks included."""
    q, k, v, mask, tlen, kw = s2_case(80 + group)
    got = port_s2(variant, q, k, v, mask, tlen, kw, group, 2).numpy()
    want = jax_s2(variant, q, k, v, mask, tlen, kw, group, 2)
    np.testing.assert_allclose(got, want, **F32)


def test_s2_bf16_matches_jax():
    q, k, v, mask, tlen, kw = s2_case(85)
    got = port_s2("full", q, k, v, mask, tlen, kw, 2, 4,
                  dtype=torch.bfloat16).float().numpy()
    want = jax_s2("full", *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                  mask, tlen, kw, 2, 4)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("group", [2, 4])
def test_s2_dma_bit_exact(group):
    q, k, v, mask, tlen, kw = s2_case(90 + group)
    got = port_s2("dma", q, k, v, mask, tlen, kw, group, 2).numpy()
    want = jax_s2("dma", q, k, v, mask, tlen, kw, group, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", ["compute", "computeclean"])
def test_s2_compute_only_plain(variant):
    """No copies: no JAX comparison (NaN scratch in interpret mode).  On
    the ring's repeated tile, compute is full (checked against JAX above)
    on K and V so tiled; computeclean (no window mask) is attention over
    the tile on every row block with a block of its own, and the tile's
    mean V (the degenerate average) on the one without."""
    q, k, v, mask, tlen, kw = s2_case(95)
    got = port_s2(variant, q, k, v, mask, tlen, kw, 2, 2).numpy()
    if variant == "compute":
        want = port_s2("full", q, tiled(k), tiled(v), mask, tlen, kw, 2,
                       2).numpy()
    else:
        own = np.repeat(mask.any(-1), BM, axis=-1)[..., None]
        want = np.where(own, one_tile_attention(q, k, v),
                        v[:, :, None, :64].mean(axis=3))
        assert not own.all()
    np.testing.assert_allclose(got, want, **F32)
    assert np.abs(got).max() > 1e-2


# ---------------------------------------------------------------- K1q-s ---

@pytest.mark.parametrize("mode", ["int8", "mxu8"])
@pytest.mark.parametrize("chunk_blocks", [2, 16])
def test_k1q_stats_matches_jax(mode, chunk_blocks):
    """K1q with return_stats against the JAX kernel in interpret mode: o
    at fp32 2e-4 / 2e-5 (as K1q's test), m within 2e-2 absolute, l within
    1 %; a count-0 row has m = -inf and l = 0 exactly."""
    # tests/test_torch_quant.py's K1q case (no p8 rounding tie flips on
    # these inputs): 3 row blocks, d = 64, row 2 of batch 0 count 0, row 1
    # of batch 1 degenerate
    seed = 31 + chunk_blocks
    q, k, v = arr(seed, 2, 1, 3 * BM, 64), arr(seed + 1, 2, 1, 6 * BN, 64), \
        arr(seed + 2, 2, 1, 6 * BN, 64)
    mask = np.random.default_rng(seed + 3).uniform(size=(2, 1, 3, 6)) < 0.6
    mask[..., 0] = True
    mask[0, 0, 2] = False
    mask[1, 0, 1] = False
    mask[1, 0, 1, 5] = True
    tlen = np.array([70, 0], np.int32)
    kw = dict(visual_len=5 * BN - 40, text_start=5 * BN)
    payload = ops.quantize_kv_blocks(t(k), t(v), BN)
    idx, cnt = ops.mask_to_indices(t(mask))
    o, m, l = tk.block_sparse_flash_attention(
        *map(t, (q, k, v)), idx, cnt, t(tlen), chunk_blocks=chunk_blocks,
        kv_quant=payload, quant_mode=mode, return_stats=True, **kw)
    jidx, jcnt = jops.mask_to_indices(jnp.asarray(mask))
    wo, wm, wl = (np.asarray(x) for x in jk.block_sparse_flash_attention(
        *map(jnp.asarray, (q, k, v)), jidx, jcnt, jnp.asarray(tlen),
        chunk_blocks=chunk_blocks, interpret=True, return_stats=True,
        kv_quant=tuple(jnp.asarray(x.numpy()) for x in payload),
        quant_mode=mode, **kw))
    np.testing.assert_allclose(o.numpy(), wo, **F32)
    zero = np.zeros(m.shape, bool)
    zero[0, 0, 2 * BM:] = True
    assert (m.numpy()[zero] == -np.inf).all() and (l.numpy()[zero] == 0).all()
    np.testing.assert_array_equal(wm[zero], m.numpy()[zero])
    np.testing.assert_allclose(m.numpy()[~zero], wm[~zero], rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(l.numpy()[~zero], wl[~zero], rtol=1e-2,
                               atol=0)
    # the same o as K1q without stats
    o1 = tk.block_sparse_flash_attention(
        *map(t, (q, k, v)), idx, cnt, t(tlen), chunk_blocks=chunk_blocks,
        kv_quant=payload, quant_mode=mode, **kw)
    torch.testing.assert_close(o, o1, rtol=0, atol=0)


def test_mxu8_quantization_divides_as_jax():
    """The mxu8 plain version quantizes q (and p) with 127 / max, divided
    as the JAX kernel divides: PyTorch's ``127.0 / tensor`` is the
    reciprocal times 127, one rounding more, and at this row it moved q8
    from 2 to 1 (an int8 step of the score, which shifted K1q-s's m on the
    card by ~0.01 and l by ~1 %)."""
    from rectified_spaattn_tpu_torch.kernels.block_sparse import (
        _quantize_q_rows)
    q = np.zeros((1, 1, 8), np.float32)
    q[0, 0, :2] = [3.0532379150390625, 0.03606186434626579]
    want = np.asarray(jnp.round(jnp.asarray(q) * (127.0 / jnp.maximum(
        jnp.max(jnp.abs(jnp.asarray(q)), axis=-1, keepdims=True), 1e-30))))
    got = _quantize_q_rows(t(q), 1.0)[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0, 0, 1] == 2.0


# ---------------------------------------------------------- input makers ---

def test_smooth_field_matches_bench_formula():
    """The smooth field for given w, phase and mix against bench.py's
    formula (bench.py:64-67) in jnp, fp32 1e-5."""
    rng = np.random.default_rng(5)
    coords = rng.uniform(size=(300, 3)).astype(np.float32)
    w = (rng.normal(size=(3, 16)) * 3.0).astype(np.float32)
    phase = (rng.uniform(size=16) * 2 * np.pi).astype(np.float32)
    mix = (rng.normal(size=(4, 32, 8)) / np.sqrt(32)).astype(np.float32)
    proj = jnp.asarray(coords) @ jnp.asarray(w) + jnp.asarray(phase)
    basis = jnp.concatenate([jnp.sin(proj), jnp.cos(proj)], -1)
    want = np.asarray(jnp.einsum("sf,hfd->hsd", basis, jnp.asarray(mix)))
    got = inputs.smooth_field(*map(t, (coords, w, phase, mix))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # curve coordinates: (t/T, h/H, w/W) of each linear index
    grid = (3, 4, 5)
    h2l = np.random.default_rng(6).permutation(60)
    tt, hh, ww = np.unravel_index(h2l, grid)
    np.testing.assert_allclose(
        inputs.curve_coords(t(h2l), grid).numpy(),
        np.stack([tt / 3, hh / 4, ww / 5], -1), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("coarse,grid", [((2, 3, 4), (8, 24, 32)),
                                         ((2, 2, 2), (5, 7, 3)),
                                         ((4, 3, 6), (4, 9, 13))])
def test_upsample_matches_jax_resize(coarse, grid):
    """realistic_qkv's trilinear upsampling against jax.image.resize
    "linear" on the same coarse field (edges included), fp32 1e-5."""
    x = arr(7, 1, 2, *coarse, 8)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 2, *grid, 8),
                                       "linear"))
    got = inputs.upsample_field(t(x), grid).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_input_makers_shapes():
    gen = torch.Generator().manual_seed(0)
    grid = (2, 8, 16)
    h2l = torch.randperm(256, generator=gen)
    q, k, v = inputs.realistic_qkv(gen, 1, 2, grid, 128, 32, h2l)
    assert q.shape == (1, 2, 384, 32) and q.dtype == torch.bfloat16
    assert torch.equal(q[..., 256:, :], k[..., 256:, :])   # shared text
    qs, ks, vs = inputs.smooth_qkv(gen, 2, 128, 32, h2l, grid)
    assert qs.shape == (1, 2, 384, 32) and not torch.equal(qs, ks)
    qr = inputs.random_inputs(gen, 2, 384, 32)[0]
    assert qr.shape == (1, 2, 384, 32)


# ------------------------------------------------------------ the benches ---

def _bench_py_keys():
    """The key paths of bench.py's printed JSON line (its json.dumps)."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps")

    def keys(node, prefix=""):
        out = set()
        for kn, vn in zip(node.keys, node.values):
            out.add(prefix + kn.value)
            if isinstance(vn, ast.Dict):
                out |= keys(vn, prefix + kn.value + ".")
        return out
    return keys(call.args[0])


def _keys(d, prefix=""):
    out = set()
    for key, val in d.items():
        out.add(prefix + key)
        if isinstance(val, dict):
            out |= _keys(val, prefix + key + ".")
    return out


def test_headline_on_cpu_prints_bench_keys():
    """The headline at a tiny grid on the CPU: one JSON line with every
    key bench.py prints, finite times, and the device named."""
    line = headline.run(grid=(2, 8, 16), heads=2, device="cpu", loop=1,
                        reps=3, oneshot_n=1)
    want = _bench_py_keys()
    assert len(want) > 20 and want <= _keys(line)
    assert line["detail"]["device"] == "cpu"
    assert np.isfinite(line["value"]) and line["detail"]["median_of"] == 3


def test_variant_benches_on_cpu():
    """kernelvars and groupedvars at a tiny grid on the CPU: every
    requested variant timed, and the checked ones equal to K1."""
    res = kernelvars.run(["base", "dma", "twophase", "runs2", "k1"],
                         grid=(2, 8, 16), heads=2, device="cpu", check=True,
                         iters=1, verbose=False)
    assert set(res["ms"]) == {"base", "dma", "twophase", "runs2", "k1"}
    for name in ("base", "twophase", "runs2"):
        assert res["check"][name]["max_abs_err"] == 0.0
    assert res["check"]["twophase"]["ref"] == "base"
    assert res["check"]["twophase"]["equal"] and res["check"]["runs2"]["equal"]
    # the profiler's kernel times exist only on the card
    assert res["kernel_ms"] == dict.fromkeys(res["ms"])
    assert res["kernel_ms_each"] == {n: [None] for n in res["ms"]}
    res = groupedvars.run([2], ["full", "prefetch", "dma"], grid=(2, 8, 16),
                          heads=2, device="cpu", check=True, iters=1,
                          verbose=False)
    assert set(res["ms"]) == {"g1", "g2_full", "g2_prefetch", "g2_dma"}
    assert res["check"]["g2_full"]["rms_err"] < 1e-3


def test_bench_median_of_turns():
    """The benches' kernel times: the median of the turns whose trace
    holds the kernel, None off the card (no turn has a kernel time)."""
    assert median([3.0, 1.0, 2.0]) == 2.0
    assert median([4.0, 1.0, 3.0, 2.0]) == 2.5
    assert median([4.0, None, 1.0]) == 2.5
    assert median([None, None]) is None
