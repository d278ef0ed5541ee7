"""The port's attention site (``rectified_sparse_attention``) and mode
dispatch (``attention``) against the JAX package on the same numpy inputs,
within 2e-3 (tests/test_attention.py:71).  Each JAX call runs the Pallas
kernels in interpret mode, so several port variants (kv_pack, head_chunk,
row-chunked plan and rectification) are held against one JAX output."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rectified_spaattn_tpu.attention import (
    attention as j_attention, rectified_sparse_attention as j_rsa)
from rectified_spaattn_tpu.sparse import SparseConfig as JConfig
from rectified_spaattn_tpu_torch.attention import (
    attention, kv_validity, rectified_sparse_attention)
from rectified_spaattn_tpu_torch.sparse import SparseConfig

torch.set_num_threads(1)
BM = 128
TOL = dict(rtol=2e-3, atol=2e-3)


def make(seed, b, h, s, d):
    g = np.random.default_rng(seed)
    return [g.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(3)]


def run(q, k, v, kw, nbr, tlen, vis, **extra):
    """(port output, JAX output) for one config."""
    jextra = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
              for n, x in extra.items()}
    want = np.asarray(j_rsa(
        *map(jnp.asarray, (q, k, v)), JConfig(**kw),
        None if nbr is None else jnp.asarray(nbr), visual_len=vis,
        text_len_rt=None if tlen is None else jnp.asarray(tlen),
        interpret=True, **jextra))
    return port(q, k, v, kw, nbr, tlen, vis, **extra), want


def port(q, k, v, kw, nbr, tlen, vis, **extra):
    textra = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
              for n, x in extra.items()}
    out = rectified_sparse_attention(
        *map(torch.from_numpy, (q, k, v)), SparseConfig(**kw),
        None if nbr is None else torch.from_numpy(nbr), visual_len=vis,
        text_len_rt=None if tlen is None else torch.from_numpy(tlen),
        **textra)
    return out.numpy() if isinstance(out, torch.Tensor) and out.ndim else out



@pytest.mark.parametrize("group", [1, 2])
def test_joint_unaligned_b2_matches_jax(group):
    """Joint layout, a visual length that is not a block multiple (zero pad
    between visual and text), B=2 with different runtime text lengths;
    variants of the same site agree with the one JAX output."""
    b, h, d, nq = 2, 2, 64, 3
    vis = nq * BM - 50
    kw = dict(top_k_floor=1, p_remain=0.3, layout="joint", text_len=BM,
              group_rows=group)
    q, k, v = make(group, b, h, vis + BM, d)
    nbr = np.random.default_rng(5).uniform(size=(nq, nq)) < 0.3
    tlen = np.array([100, 37], np.int32)
    got, want = run(q, k, v, kw, nbr, tlen, vis)
    np.testing.assert_allclose(got, want, **TOL)
    variants = [dict(kv_pack=True), dict(head_chunk=1)]
    if group == 1:
        variants.append(dict(plan_row_chunk=2, plan_kv_tile=2))
    for var in variants:
        np.testing.assert_allclose(port(q, k, v, {**kw, **var}, nbr, tlen, vis),
                                   want, err_msg=str(var), **TOL)


def test_visual_layout_first_frame_matches_jax():
    b, h, d, nq = 1, 2, 64, 4
    vis = nq * BM
    kw = dict(top_k_floor=1, p_remain=0.3, layout="visual",
              first_frame_blocks=1)
    q, k, v = make(7, b, h, vis, d)
    got, want = run(q, k, v, kw, None, None, vis)
    np.testing.assert_allclose(got, want, **TOL)


def test_packed_kv_and_split_q_match_jax():
    """Caller-packed [K|V] and a q split at the visual/text seam."""
    b, h, d, nq = 1, 2, 64, 2
    sv = nq * BM
    kw = dict(top_k_floor=1, p_remain=0.3, layout="joint", text_len=BM)
    q, k, v = make(9, b, h, sv + BM, d)
    kv = np.concatenate([k, v], axis=-1)
    tlen = np.array([60], np.int32)
    got, want = run(q[:, :, :sv], kv[..., :d], kv[..., d:], kw, None, tlen,
                    sv, kv_packed=kv, q_text=np.ascontiguousarray(q[:, :, sv:]))
    np.testing.assert_allclose(got, want, **TOL)
    base = port(q, k, v, kw, None, tlen, sv)
    np.testing.assert_allclose(got, base, **TOL)


def test_density_only_matches_jax():
    b, h, d, nq = 1, 2, 64, 4
    vis = nq * BM - 20
    kw = dict(top_k_floor=1, p_remain=0.3, layout="joint", text_len=BM)
    q, k, v = make(11, b, h, vis + BM, d)
    tlen = np.array([50], np.int32)
    got, want = run(q, k, v, kw, None, tlen, vis, density_only=True)
    assert float(got) == pytest.approx(float(want), abs=1e-7)
    hc = port(q, k, v, {**kw, "head_chunk": 1}, None, tlen, vis,
              density_only=True)
    assert float(hc) == pytest.approx(float(want), abs=1e-6)


@pytest.mark.parametrize("mode", ["vanilla", "flash", "sparse"])
def test_attention_dispatch_matches_jax(mode):
    """``attention`` per mode; the JAX package in interpret mode runs
    "flash" as the vanilla oracle, the port through K1 with full lists."""
    b, h, d, nq = 1, 2, 32, 2
    cfg_kw = dict(top_k_floor=1, p_remain=0.5, layout="joint", text_len=BM)
    sv = nq * BM - 30
    q, k, v = make(13, b, h, sv + BM, d)
    tlen = np.array([40], np.int32)
    want = np.asarray(j_attention(
        *map(jnp.asarray, (q, k, v)), mode, cfg=JConfig(**cfg_kw),
        visual_len=sv, text_len_rt=jnp.asarray(tlen), interpret=True))
    got = attention(*map(torch.from_numpy, (q, k, v)), mode,
                    cfg=SparseConfig(**cfg_kw), visual_len=sv,
                    text_len_rt=torch.from_numpy(tlen)).numpy()
    # rows past the valid text are padding (garbage in both packages)
    rows = sv + int(tlen[0])
    np.testing.assert_allclose(got[:, :, :rows], want[:, :, :rows], **TOL)
    if mode != "sparse":
        hc = attention(*map(torch.from_numpy, (q, k, v)), mode,
                       cfg=SparseConfig(**cfg_kw, head_chunk=1),
                       visual_len=sv, text_len_rt=torch.from_numpy(tlen))
        np.testing.assert_allclose(hc.numpy()[:, :, :rows],
                                   want[:, :, :rows], **TOL)


def test_kv_validity_and_unported_options():
    valid = kv_validity(2, 10, 4, 6, torch.tensor([2, 0], dtype=torch.int32))
    want = np.zeros((2, 10), bool)
    want[:, :4] = True
    want[0, 6:8] = True
    np.testing.assert_array_equal(valid.numpy(), want)
    # kv_quant (K1q) is ported; as in JAX it refuses a caller-packed stream
    cfg = SparseConfig(top_k_floor=1, layout="visual", kv_quant="int8")
    x = torch.zeros((1, 1, BM, 32))
    with pytest.raises(ValueError, match="kv_packed does not compose"):
        rectified_sparse_attention(x, x, x, cfg, visual_len=BM,
                                   kv_packed=torch.zeros((1, 1, BM, 64)))
    joint = SparseConfig(top_k_floor=1, text_len=BM)
    y = torch.zeros((1, 1, 100 + BM, 32))          # 100 visual tokens
    with pytest.raises(ValueError, match="block-aligned"):
        rectified_sparse_attention(y, y, y, joint, visual_len=100,
                                   kv_packed=torch.zeros((1, 1, 100 + BM, 64)))
