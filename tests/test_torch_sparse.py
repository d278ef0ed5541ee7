"""The port's sparse ops and plan build against the JAX package on the same
numpy inputs: integer outputs (masks, index lists, counts, rowbits,
clean) bit for bit; floats to fp32 rounding (rtol 2e-4 / atol 2e-5 — sums
are taken in another order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rectified_spaattn_tpu.sparse import (SparseConfig as JConfig,
                                          build_sparse_plan as j_plan)
from rectified_spaattn_tpu.sparse import ops as jops
from rectified_spaattn_tpu_torch.sparse import (SparseConfig,
                                                build_sparse_plan, ops)

torch.set_num_threads(1)
F32 = dict(rtol=2e-4, atol=2e-5)
BM = 16


def rng(seed):
    return np.random.default_rng(seed)


def probs_of(seed, shape, peaked):
    logits = rng(seed).normal(size=shape).astype(np.float32)
    if peaked:
        logits *= 6.0          # a few dominant blocks, a long tiny tail
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def same(got, want, exact=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **F32)


def test_pool_scores_gapr_ipar_rectification():
    g = rng(0)
    q = g.normal(size=(2, 3, 4 * BM, 8)).astype(np.float32)
    k = g.normal(size=(2, 3, 5 * BM, 8)).astype(np.float32)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    same(ops.block_pool(tq, BM), jops.block_pool(jnp.asarray(q), BM))
    qp, kp = ops.block_pool(tq, BM), ops.block_pool(tk, BM)
    jqp, jkp = jops.block_pool(jnp.asarray(q), BM), jops.block_pool(
        jnp.asarray(k), BM)
    scores = ops.pooled_scores(qp, kp)
    same(scores, jops.pooled_scores(jqp, jkp))
    qb, kb = q.reshape(2, 3, 4, BM, 8), k.reshape(2, 3, 5, BM, 8)
    same(ops.estimate_pr_gain(torch.from_numpy(qb), torch.from_numpy(kb),
                              qp, kp, scores),
         jops.estimate_pr_gain(jnp.asarray(qb), jnp.asarray(kb), jqp, jkp,
                               jops.pooled_scores(jqp, jkp)), exact=True)
    probs = probs_of(1, (2, 3, 4, 7), False)
    same(ops.ipar_reallocate(torch.from_numpy(probs), 5, BM),
         jops.ipar_reallocate(jnp.asarray(probs), 5, BM))
    pm = rng(2).uniform(size=(2, 3, 4, 7)) < 0.5
    vp = g.normal(size=(2, 3, 7, 8)).astype(np.float32)
    r, comp = ops.rectification(torch.from_numpy(probs), torch.from_numpy(pm),
                                torch.from_numpy(vp))
    jr, jcomp = jops.rectification(jnp.asarray(probs), jnp.asarray(pm),
                                   jnp.asarray(vp))
    same(r, jr)
    same(comp, jcomp)


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("p_remain,floor", [(0.3, 1), (0.6, 3), (1.0, 1)])
def test_topp_selection_bit_exact(peaked, p_remain, floor):
    probs = probs_of(3 + peaked, (2, 3, 6, 40), peaked)
    tp, jp = torch.from_numpy(probs), jnp.asarray(probs)
    same(ops.topp_threshold_onehot_bisect(tp, p_remain, floor),
         jops.topp_threshold_onehot_bisect(jp, p_remain, floor), exact=True)
    if p_remain >= 1.0:
        # the sort paths compare a cumulative sum with 1.0 itself, which
        # rounds differently with the summation order: only the bisection
        # (which keeps every block) is defined there
        return
    same(ops.topp_threshold_onehot(tp, p_remain, floor),
         jops.topp_threshold_onehot(jp, p_remain, floor), exact=True)
    counts, order = ops.topp_topk_counts(tp, p_remain, floor)
    jcounts, jorder = jops.topp_topk_counts(jp, p_remain, floor)
    same(counts, jcounts, exact=True)
    same(order, jorder, exact=True)
    same(ops.counts_to_onehot(counts, order),
         jops.counts_to_onehot(jcounts, jorder), exact=True)


def test_mask_to_indices_group_rows_ff_force():
    mask = rng(5).uniform(size=(2, 2, 8, 11)) < 0.35
    mask[0, 0, 3] = False                  # a zero-count row
    tm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    for got, want in zip(ops.mask_to_indices(tm), jops.mask_to_indices(jm)):
        same(got, want, exact=True)
    for grp in (1, 2, 4, 8):
        for got, want in zip(ops.group_rows(tm, grp, clean_blocks=7),
                             jops.group_rows(jm, grp, clean_blocks=7)):
            same(got, want, exact=True)
    for got, want in zip(ops.pair_rows(tm, 5), jops.pair_rows(jm, 5)):
        same(got, want, exact=True)
    rows = np.array([0, 2, 5, 7], np.int32)
    same(ops.ff_force_mask(torch.from_numpy(rows), 9, 3),
         jops.ff_force_mask(jnp.asarray(rows), 9, 3), exact=True)
    with pytest.raises(ValueError, match="overflows int32"):
        ops.group_rows(torch.zeros((1, 1, 8, 1 << 21), dtype=torch.bool), 8)


def plan_inputs(seed, layout, nq=6, text_blocks=1, d=16, b=2, h=2):
    g = rng(seed)
    text_len = text_blocks * BM if layout == "joint" else 0
    s = nq * BM + text_len
    q = g.normal(size=(b, h, nq * BM, d)).astype(np.float32)
    k = g.normal(size=(b, h, s, d)).astype(np.float32)
    v = g.normal(size=(b, h, s, d)).astype(np.float32)
    nbr = g.uniform(size=(nq, nq)) < 0.3
    tv = None
    if layout == "joint":
        tv = np.arange(text_len)[None, :] < np.array([[11], [5]])[:b]
    return q, k, v, nbr, tv, text_len


def check_plan(cfg_kw, seed, layout, packed=False):
    q, k, v, nbr, tv, text_len = plan_inputs(seed, layout)
    kw = dict(top_k_floor=2, p_remain=0.4, layout=layout, text_len=text_len,
              block_m=BM, block_n=BM, **cfg_kw)
    if packed:
        kv = np.concatenate([k, v], axis=-1)
        valid = np.ones(kv.shape[0:1] + kv.shape[2:3], bool)
        want = j_plan(jnp.asarray(q), None, None, JConfig(**kw),
                      jnp.asarray(nbr), None if tv is None else jnp.asarray(tv),
                      kv_packed=jnp.asarray(kv), kv_valid=jnp.asarray(valid))
        got = build_sparse_plan(
            torch.from_numpy(q), None, None, SparseConfig(**kw),
            torch.from_numpy(nbr), None if tv is None else torch.from_numpy(tv),
            kv_packed=torch.from_numpy(kv), kv_valid=torch.from_numpy(valid))
    else:
        want = j_plan(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      JConfig(**kw), jnp.asarray(nbr),
                      None if tv is None else jnp.asarray(tv))
        got = build_sparse_plan(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            SparseConfig(**kw), torch.from_numpy(nbr),
            None if tv is None else torch.from_numpy(tv))
    for name in ("block_mask", "indices", "counts"):
        same(getattr(got, name), getattr(want, name), exact=True)
    same(got.r_factor, want.r_factor)
    same(got.comp, want.comp)
    return got


@pytest.mark.parametrize("layout,cfg_kw", [
    ("joint", {}),
    ("joint", {"topp_impl": "sort"}),
    ("joint", {"plan_row_chunk": 4, "plan_kv_tile": 4}),
    ("visual", {"first_frame_blocks": 2}),
    ("visual", {"first_frame_blocks": 2, "plan_row_chunk": 4,
                "plan_kv_tile": 5}),
])
def test_build_sparse_plan_matches_jax(layout, cfg_kw):
    check_plan(cfg_kw, 11, layout)


@pytest.mark.parametrize("layout", ["joint", "visual"])
def test_build_sparse_plan_packed_source(layout):
    check_plan({}, 12, layout, packed=True)


def test_sparse_config_checks():
    SparseConfig(top_k_floor=1, text_len=128, group_rows=8)
    for bad in (dict(layout="x"), dict(text_len=100), dict(block_m=64),
                dict(group_rows=9), dict(kv_quant="int4"),
                dict(kv_quant="int8", group_rows=2),
                dict(kv_pack=True, kv_quant="int8"), dict(head_chunk=-1)):
        with pytest.raises(ValueError):
            SparseConfig(top_k_floor=1, **bad)
    cfg = SparseConfig(top_k_floor=1, group_rows=2)
    assert cfg.kernel_chunk_blocks == JConfig(top_k_floor=1,
                                              group_rows=2).kernel_chunk_blocks
