"""The key split of K1/K1s on the CPU: the plain split-and-merge path
(``block_sparse_flash_attention_split_torch``) against the unsplit plain
K1/K1s and against the JAX kernel with ``return_stats`` (interpret mode),
at fp32 rtol 2e-4 / atol 2e-5 (tests/test_kernels.py), with m == -inf and
l == 0 exactly on count-0 rows; and the function that picks the number of
ranges from the launch shape.  The CUDA split is held to the plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectified_spaattn_tpu import kernels as jk
from rectified_spaattn_tpu.sparse import ops as jops
from rectified_spaattn_tpu_torch import kernels as tk
from rectified_spaattn_tpu_torch.kernels import block_sparse as bs
from rectified_spaattn_tpu_torch.sparse import ops

torch.set_num_threads(1)
BM = BN = 128
F32 = dict(rtol=2e-4, atol=2e-5)


def arr(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def split_case(case):
    """(q, k, v, mask, text_len, kwargs) of one case; lists of 6-8 blocks
    at chunk_blocks 2, so 3-4 chunks to split."""
    if case == "count0":
        q, k, v = arr(1, 1, 2, 3 * BM, 32), arr(2, 1, 2, 7 * BN, 32), \
            arr(3, 1, 2, 7 * BN, 32)
        mask = np.random.default_rng(4).uniform(size=(1, 2, 3, 7)) < 0.6
        mask[0, 0, 1] = False                           # count 0
        mask[0, 1, 2] = False
        mask[0, 1, 2, 0] = True                         # count 1: one range
        return q, k, v, mask, [0], dict(visual_len=7 * BN, text_start=None,
                                        chunk_blocks=2)
    if case == "text_window_b2":
        q, k, v = arr(5, 2, 2, 2 * BM, 32), arr(6, 2, 2, 8 * BN, 32), \
            arr(7, 2, 2, 8 * BN, 32)
        mask = np.random.default_rng(8).uniform(size=(2, 2, 2, 8)) < 0.7
        mask[..., -1] = True
        return q, k, v, mask, [100, 37], dict(visual_len=7 * BN - 40,
                                              text_start=7 * BN,
                                              chunk_blocks=2)
    if case == "packed_kv":
        q, k, v = arr(9, 1, 2, 2 * BM, 32), arr(10, 1, 2, 6 * BN, 32), \
            arr(11, 1, 2, 6 * BN, 32)
        mask = np.random.default_rng(12).uniform(size=(1, 2, 2, 6)) < 0.8
        mask[0, 1, 0] = False                           # count 0
        return q, k, v, mask, [0], dict(visual_len=6 * BN, text_start=None,
                                        chunk_blocks=2, packed=True)
    assert case == "degenerate"
    # row block 1 of head 1: every listed block is masked (the text block
    # of a batch with no valid text, and visual blocks past visual_len),
    # count 5 at chunk_blocks 2 over ranges of one chunk: V averaged over
    # the 6 lanes of its 3 chunks, padding included
    q, k, v = arr(13, 1, 2, 2 * BM, 32), arr(14, 1, 2, 8 * BN, 32), \
        arr(15, 1, 2, 8 * BN, 32)
    mask = np.random.default_rng(16).uniform(size=(1, 2, 2, 8)) < 0.5
    mask[..., 0] = True
    mask[0, 1, 1] = False
    mask[0, 1, 1, 3:8] = True
    return q, k, v, mask, [0], dict(visual_len=3 * BN, text_start=7 * BN,
                                    chunk_blocks=2)


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("n_split", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["count0", "text_window_b2", "packed_kv",
                                  "degenerate"])
def test_split_plain_matches_unsplit_and_jax(case, n_split):
    """o, m and l of the plain split path against the unsplit plain K1s
    and the JAX kernel with return_stats; K1's o equals K1s's; count-0
    rows give m == -inf and l == 0 exactly; a degenerate list split over
    ranges reproduces the JAX chunk average (m == MASK_VALUE, l == its
    lanes)."""
    q, k, v, mask, tlen, kw = split_case(case)
    packed = kw.pop("packed", False)
    idx, cnt = ops.mask_to_indices(t(mask))
    jidx, jcnt = jops.mask_to_indices(jnp.asarray(mask))
    tl = torch.tensor(tlen, dtype=torch.int32)
    tkv = t(np.concatenate([k, v], -1)) if packed else None
    jkv = jnp.asarray(np.concatenate([k, v], -1)) if packed else None
    args = (t(q), t(k), t(v), idx, cnt, tl)
    got = tk.block_sparse_flash_attention_split_torch(
        *args, n_split=n_split, return_stats=True, packed_kv=tkv, **kw)
    o1 = tk.block_sparse_flash_attention_split_torch(
        *args, n_split=n_split, packed_kv=tkv, **kw)
    unsplit = tk.block_sparse_flash_attention_torch(
        *args, return_stats=True, packed_kv=tkv, **kw)
    want = jk.block_sparse_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jidx, jcnt,
        jnp.asarray(tlen, jnp.int32), interpret=True, return_stats=True,
        packed_kv=jkv, **kw)
    assert torch.equal(o1, got[0])
    for g, u, w, name in zip(got, unsplit, want, "oml"):
        assert g.dtype == torch.float32 and g.shape == u.shape, name
        np.testing.assert_allclose(g.numpy(), u.numpy(), err_msg=name, **F32)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **F32)
    o, m, l = (x.numpy() for x in got)
    zero = np.repeat(cnt.numpy() == 0, BM, axis=-1)
    if case in ("count0", "packed_kv"):
        assert zero.any()
    np.testing.assert_array_equal(m[zero], -np.inf)
    np.testing.assert_array_equal(l[zero], 0.0)
    np.testing.assert_array_equal(o[zero], 0.0)
    if case == "degenerate":
        rows = slice(BM, 2 * BM)
        assert (m[0, 1, rows] == bs.MASK_VALUE).all()
        assert (l[0, 1, rows] == 6 * BN).all()
        lanes = np.concatenate([v[0, 1, b * BN:(b + 1) * BN]
                                for b in idx[0, 1, 1, :6].tolist()])
        np.testing.assert_allclose(
            o[0, 1, rows], np.broadcast_to(lanes.mean(0), (BM, 32)), **F32)


@pytest.mark.parametrize("tiles,nb_slots,chunk,sms,want", [
    (48, 902, 16, 132, (5, 192)),     # Hunyuan's 256 text rows
    (48, 225, 16, 132, (5, 48)),      # a ring step's text rows, sp = 4
    (48, 902, 16, 114, (7, 144)),     # another SM count: 336 CTAs
    (64, 12, 2, 132, (3, 4)),         # more ranges than 3-chunk ranges fit
    (64, 12, 16, 132, (1, 12)),       # one chunk: nothing to split
    (132, 902, 16, 132, (1, 902)),    # a full wave
    (5400, 902, 16, 132, (1, 902)),   # Hunyuan's visual rows
    (1, 4, 1, 132, (4, 1)),           # capped at the chunk count
])
def test_split_plan_from_launch_shape(tiles, nb_slots, chunk, sms, want):
    """n_split follows the launch shape: none with a wave of tiles, else
    the fewest ranges that fill the last wave to 90 %, whole chunks per
    range, no empty range."""
    n, span = bs._split_plan(tiles, nb_slots, chunk, sms)
    assert (n, span) == want
    if n == 1:
        assert span == nb_slots
    else:
        assert span % chunk == 0 and (n - 1) * span < nb_slots <= n * span


def test_merge_splits_is_ring_merge():
    """The closed-form merge equals attention/ring.py::_merge folded over
    the ranges, -inf / 0 partials included."""
    from rectified_spaattn_tpu_torch.attention.ring import _merge
    g = torch.Generator().manual_seed(3)
    os = [torch.randn((2, 5, 8), generator=g) for _ in range(3)]
    ms = [torch.randn((2, 5), generator=g) for _ in range(3)]
    ls = [torch.rand((2, 5), generator=g) + 0.5 for _ in range(3)]
    ms[1][0, 2], ls[1][0, 2] = -torch.inf, 0.0
    for x in (ms, ls):
        x[0][1, 1] = x[1][1, 1] = x[2][1, 1] = (-torch.inf if x is ms
                                                else 0.0)
    for x in os:
        x[1, 1] = 0.0
    o, m, l = bs._merge_splits(os, ms, ls)
    wo, wm, wl = os[0], ms[0], ls[0]
    for i in (1, 2):
        wo, wm, wl = _merge(wo, wm, wl, os[i], ms[i], ls[i])
    torch.testing.assert_close(o, wo, **F32)
    torch.testing.assert_close(m, wm, rtol=0, atol=0)
    torch.testing.assert_close(l, wl, **F32)


@pytest.mark.parametrize("variant", ["stages3", "pingpong", "compute",
                                     "load"])
def test_mainloop_variant_edits_apply(tmp_path, variant):
    """Each ablation of bench/mainloop_variants.py edits its copy of
    csrc/hopper_attn.cuh where the mainloop has the text it replaces (the
    variants are built and timed on the card only)."""
    from rectified_spaattn_tpu_torch.bench import mainloop_variants as mv
    root = mv.make_copy(variant, str(tmp_path))
    path = tmp_path / variant / "rectified_spaattn_tpu_torch" / mv.HEADER
    src = path.read_text()
    for old, new in mv.EDITS[variant]:
        assert new in src and old not in src.replace(new, "")
    assert root == str(tmp_path / variant)
