"""The port's plain K1/K2 (the CPU path of its kernel wrappers) against the
JAX package's Pallas kernels run in interpret mode, on the same numpy
inputs — the cases of tests/test_kernels.py that the HunyuanVideo slice
covers.  fp32: rtol 2e-4 / atol 2e-5; bf16: 2e-2 (tests/test_kernels.py).

The CUDA kernels themselves run only on a GPU: tests/test_torch_cuda.py
holds them against the plain versions there."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rectified_spaattn_tpu import kernels as jk
from rectified_spaattn_tpu.attention.modes import (
    _windowed_dense_flash as j_windowed)
from rectified_spaattn_tpu.attention.rectified import kv_validity as j_valid
from rectified_spaattn_tpu.sparse import ops as jops
from rectified_spaattn_tpu_torch import kernels as tk
from rectified_spaattn_tpu_torch.attention.modes import _windowed_dense_flash
from rectified_spaattn_tpu_torch.kernels import block_sparse
from rectified_spaattn_tpu_torch.sparse import ops

torch.set_num_threads(1)
BM = BN = 128
F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def make_inputs(seed, b, h, nq, nb, d, dtype=np.float32):
    g = np.random.default_rng(seed)
    return [g.normal(size=(b, h, n * BM, d)).astype(dtype)
            for n in (nq, nb, nb)]


def run_both(q, k, v, mask, tlen, visual_len, text_start, jdtype=None):
    """(port plain K1, JAX K1 interpret) on the same arrays."""
    tq = [torch.from_numpy(x) for x in (q, k, v)]
    jq = [jnp.asarray(x) for x in (q, k, v)]
    if jdtype is not None:
        tq = [x.to(torch.bfloat16) for x in tq]
        jq = [x.astype(jdtype) for x in jq]
    idx, cnt = ops.mask_to_indices(torch.from_numpy(mask))
    got = tk.block_sparse_flash_attention(
        *tq, idx, cnt, torch.tensor(tlen, dtype=torch.int32),
        visual_len=visual_len, text_start=text_start)
    jidx, jcnt = jops.mask_to_indices(jnp.asarray(mask))
    want = jk.block_sparse_flash_attention(
        *jq, jidx, jcnt, jnp.asarray(tlen, jnp.int32), visual_len=visual_len,
        text_start=text_start, interpret=True)
    return got.float().numpy(), np.asarray(want, np.float32)


def random_mask(seed, shape, p, first=True):
    m = np.random.default_rng(seed).uniform(size=shape) < p
    if first:
        m[..., 0] = True
    return m


def test_full_mask_equals_dense():
    q, k, v = make_inputs(0, 1, 2, 2, 3, 64)
    mask = np.ones((1, 2, 2, 3), bool)
    got, want = run_both(q, k, v, mask, [0], 3 * BN, None)
    np.testing.assert_allclose(got, want, **F32)
    dense = tk.dense_attention(*map(torch.from_numpy, (q, k, v)),
                               mode="vanilla").numpy()
    np.testing.assert_allclose(got, dense, **F32)


@pytest.mark.parametrize("case", ["random", "window", "single", "long"])
def test_plain_k1_matches_jax_k1(case):
    if case == "random":
        q, k, v = make_inputs(1, 2, 2, 3, 5, 64)
        mask = random_mask(2, (2, 2, 3, 5), 0.5)
        args = ([0, 0], 5 * BN, None)
    elif case == "window":
        # [3 visual blocks (last 40 tokens padding) | 1 text block (100 valid)]
        q, k, v = make_inputs(3, 1, 2, 3, 4, 64)
        mask = random_mask(4, (1, 2, 3, 4), 0.6, first=False)
        mask[..., -1] = True
        args = ([100], 3 * BN - 40, 3 * BN)
    elif case == "single":
        q, k, v = make_inputs(7, 1, 1, 2, 4, 64)
        mask = np.zeros((1, 1, 2, 4), bool)
        mask[..., 0, 2] = mask[..., 1, 0] = True
        args = ([0], 4 * BN, None)
    else:   # long contiguous runs across several JAX chunks
        q, k, v = make_inputs(11, 1, 2, 2, 40, 64)
        mask = np.zeros((1, 2, 2, 40), bool)
        mask[0, 0, 0, 0:19] = mask[0, 0, 0, 21:24] = True
        mask[0, 0, 1, 5:37] = mask[0, 1, 0, :] = True
        mask[0, 1, 1, 39] = True
        args = ([0], 40 * BN, None)
    got, want = run_both(q, k, v, mask, *args)
    np.testing.assert_allclose(got, want, **F32)


def test_bf16_matches_jax_bf16():
    q, k, v = make_inputs(5, 1, 1, 2, 3, 64)
    mask = random_mask(6, (1, 1, 2, 3), 0.7)
    got, want = run_both(q, k, v, mask, [0], 3 * BN, None,
                         jdtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, **BF16)


def test_zero_count_rows_are_exactly_zero():
    q, k, v = make_inputs(13, 1, 2, 3, 4, 64)
    mask = np.zeros((1, 2, 3, 4), bool)
    mask[:, :, 0, :2] = True
    got, want = run_both(q, k, v, mask, [0], 4 * BN, None)
    np.testing.assert_allclose(got[:, :, :BM], want[:, :, :BM], **F32)
    np.testing.assert_array_equal(got[:, :, BM:], 0.0)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_plain_k2_matches_reference(group):
    """K2 equals the masked-dense reference (JAX's) and, at G=2 (the
    paired kernel) and G=4, JAX's grouped kernel in interpret mode."""
    q, k, v = make_inputs(21, 1, 2, 8, 6, 64)
    mask = random_mask(22, (1, 2, 8, 6), 0.4)
    visual_len = 6 * BN - 50
    idx, cnt, bits, clean = ops.group_rows(torch.from_numpy(mask), group,
                                           clean_blocks=visual_len // BN)
    got = tk.block_sparse_flash_attention_grouped(
        *map(torch.from_numpy, (q, k, v)), idx, cnt, bits, clean,
        torch.zeros(1, dtype=torch.int32), group=group,
        visual_len=visual_len, text_start=None).numpy()
    jq = [jnp.asarray(x) for x in (q, k, v)]
    kv_valid = np.zeros((1, 6 * BN), bool)
    kv_valid[:, :visual_len] = True
    want = np.asarray(jk.block_sparse_attention_reference(
        *jq, jnp.asarray(mask), jnp.asarray(kv_valid)))
    np.testing.assert_allclose(got, want, **F32)
    ref = tk.block_sparse_attention_reference(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(mask),
        torch.from_numpy(kv_valid)).numpy()
    np.testing.assert_allclose(ref, want, **F32)
    if group in (2, 4):
        ji, jc, jb, jcl = jops.group_rows(jnp.asarray(mask), group,
                                          clean_blocks=visual_len // BN)
        jout = np.asarray(jk.block_sparse_flash_attention_grouped(
            *jq, ji, jc, jb, jcl, jnp.zeros((1,), jnp.int32), group=group,
            visual_len=visual_len, text_start=None, interpret=True))
        np.testing.assert_allclose(got, jout, **F32)


@pytest.mark.parametrize("text", [False, True])
def test_paired_alias_matches_jax_paired(text):
    """block_sparse_flash_attention_paired (K2 at G = 2 under the JAX
    package's exported name) against JAX's paired kernel in interpret
    mode, fp32, with and without the text window."""
    q, k, v = make_inputs(81 + text, 1, 2, 4, 6, 64)
    mask = random_mask(83 + text, (1, 2, 4, 6), 0.45)
    visual_len = 5 * BN - 40 if text else 6 * BN - 50
    text_start = 5 * BN if text else None
    if text:
        mask[..., -1] = True
    tlen = [70 if text else 0]
    idx, cnt, bits, clean = ops.group_rows(torch.from_numpy(mask), 2,
                                           clean_blocks=visual_len // BN)
    got = tk.block_sparse_flash_attention_paired(
        *map(torch.from_numpy, (q, k, v)), idx, cnt, bits, clean,
        torch.tensor(tlen, dtype=torch.int32), visual_len=visual_len,
        text_start=text_start).numpy()
    ji, jc, jb, jcl = jops.group_rows(jnp.asarray(mask), 2,
                                      clean_blocks=visual_len // BN)
    want = np.asarray(jk.block_sparse_flash_attention_paired(
        *(jnp.asarray(x) for x in (q, k, v)), ji, jc, jb, jcl,
        jnp.asarray(tlen, jnp.int32), visual_len=visual_len,
        text_start=text_start, interpret=True))
    np.testing.assert_allclose(got, want, **F32)


def _lane_mean(v, idx, count, chunk_blocks=16):
    """V averaged over every lane of a list's ceil(count / chunk_blocks)
    chunks: slots past the list read their padding (block 0)."""
    nslots = -(-int(count) // chunk_blocks) * chunk_blocks
    blocks = [int(idx[s]) if s < idx.shape[0] else 0 for s in range(nslots)]
    return torch.stack([v[b * BN:(b + 1) * BN] for b in blocks]).reshape(
        -1, v.shape[-1]).mean(0)


@pytest.mark.parametrize("group", [2, 4])
def test_plain_k2_equals_k1_row_by_row(group):
    """K2 equals K1 on the same plan in every row that has an unmasked key
    of its own.  A row with no block of its own gets 0 from K1 (count 0)
    and, from K2 as from the JAX kernel, V averaged over every lane of its
    union list; a row whose only block is masked by the text window
    averages over its own list's lanes (K1) or its union's (K2)."""
    q, k, v = (torch.from_numpy(x) for x in make_inputs(41, 2, 2, 8, 6, 32))
    mask = torch.from_numpy(random_mask(42, (2, 2, 8, 6), 0.4))
    mask[0, 0, 1] = False                          # no block of its own
    mask[1, 1, 2] = False
    mask[1, 1, 2, 5] = True                        # only the text block
    tl = torch.tensor([60, 0], dtype=torch.int32)  # batch 1: no valid text
    kw = dict(visual_len=5 * BN - 30, text_start=5 * BN)
    idx, cnt = ops.mask_to_indices(mask)
    k1 = tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl, **kw)
    ui, uc, rb, cl = ops.group_rows(mask, group, clean_blocks=4)
    k2 = tk.block_sparse_flash_attention_grouped(q, k, v, ui, uc, rb, cl, tl,
                                                 group=group, **kw)
    rows = lambda r: slice(r * BM, (r + 1) * BM)
    degenerate = {(0, 0, 1), (1, 1, 2)}
    for b, h, r in np.ndindex(2, 2, 8):
        if (b, h, r) not in degenerate:
            torch.testing.assert_close(k2[b, h, rows(r)], k1[b, h, rows(r)],
                                       **F32)
    assert k1[0, 0, rows(1)].abs().max() == 0
    torch.testing.assert_close(k1[1, 1, rows(2)], _lane_mean(
        v[1, 1], idx[1, 1, 2], cnt[1, 1, 2]).expand(BM, -1), **F32)
    for b, h, r in degenerate:
        u = r // group
        torch.testing.assert_close(k2[b, h, rows(r)], _lane_mean(
            v[b, h], ui[b, h, u], uc[b, h, u]).expand(BM, -1), **F32)


def test_dense_attention_vanilla_masks_invalid_keys():
    g = np.random.default_rng(8)
    q, k, v = (g.normal(size=(1, 2, 256, 64)).astype(np.float32)
               for _ in range(3))
    valid = np.ones((1, 256), bool)
    valid[:, 200:] = False
    got = tk.dense_attention(*map(torch.from_numpy, (q, k, v)),
                             torch.from_numpy(valid), mode="vanilla").numpy()
    want = np.asarray(jk.dense_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(valid), mode="vanilla"))
    np.testing.assert_allclose(got, want, **F32)
    # "flash" (K3) on CPU tensors runs the plain version, the same oracle
    flash = tk.dense_attention(*map(torch.from_numpy, (q, k, v)),
                               torch.from_numpy(valid), mode="flash").numpy()
    np.testing.assert_array_equal(flash, got)


def test_degenerate_rows_match_jax():
    """Rows whose every gathered key is masked while their count is above
    0 agree with the JAX kernels at fp32 like every other row.  K1: a row
    block whose only listed block is the text block of a batch with
    text_len 0 (V averaged over its whole chunk, padding slots included),
    at chunk_blocks 2 and 16.  K2 at G=2: a row block with no block of its
    own in a union that has blocks (V averaged over the union's lanes)."""
    q, k, v = make_inputs(51, 1, 2, 3, 4, 64)
    mask = random_mask(52, (1, 2, 3, 4), 0.5)
    mask[0, 1, 1] = False
    mask[0, 1, 1, 3] = True
    tq = [torch.from_numpy(x) for x in (q, k, v)]
    jq = [jnp.asarray(x) for x in (q, k, v)]
    tl = torch.zeros(1, dtype=torch.int32)
    idx, cnt = ops.mask_to_indices(torch.from_numpy(mask))
    jidx, jcnt = jops.mask_to_indices(jnp.asarray(mask))
    kw = dict(visual_len=3 * BN, text_start=3 * BN)
    for cb in (2, 16):
        got = tk.block_sparse_flash_attention(*tq, idx, cnt, tl,
                                              chunk_blocks=cb, **kw)
        want = jk.block_sparse_flash_attention(
            *jq, jidx, jcnt, jnp.zeros((1,), jnp.int32), chunk_blocks=cb,
            interpret=True, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        # the degenerate row is V's mean over its chunk's lanes, not 0
        assert np.abs(np.asarray(want)[0, 1, BM:2 * BM]).max() > 0.01

    q, k, v = make_inputs(53, 1, 2, 4, 5, 64)
    mask = random_mask(54, (1, 2, 4, 5), 0.5)
    mask[0, 0, 2] = False                          # no block of its own
    mask[0, 0, 3, 1] = True
    visual_len = 5 * BN - 40
    ui, uc, rb, cl = ops.group_rows(torch.from_numpy(mask), 2,
                                    clean_blocks=visual_len // BN)
    got = tk.block_sparse_flash_attention_grouped(
        *map(torch.from_numpy, (q, k, v)), ui, uc, rb, cl, tl, group=2,
        visual_len=visual_len, text_start=None).numpy()
    ji, jc, jb, jcl = jops.group_rows(jnp.asarray(mask), 2,
                                      clean_blocks=visual_len // BN)
    want = np.asarray(jk.block_sparse_flash_attention_grouped(
        *map(jnp.asarray, (q, k, v)), ji, jc, jb, jcl,
        jnp.zeros((1,), jnp.int32), group=2, visual_len=visual_len,
        text_start=None, interpret=True))
    np.testing.assert_allclose(got, want, **F32)
    assert np.abs(want[0, 0, 2 * BM:3 * BM]).max() > 0.01


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("case", ["fp32", "fp32_mask_b2", "fp32_scale",
                                  "bf16_mask_b2"])
def test_dense_flash_plain_matches_jax(case, head_dim):
    """K3's plain version (the CPU path of dense_attention "flash")
    against JAX dense_attention(mode="flash"), which runs its vanilla path
    off the TPU, at head_dim 64 and 128 (the widths K3 takes on the card):
    Sq 200 and Sk 257 (off every tile), a kv_valid mask at B=2 with a row
    of no valid key; fp32 rtol 2e-4 / atol 2e-5, bf16 2e-2."""
    b = 2 if "b2" in case else 1
    g = np.random.default_rng(61)
    q, k, v = (g.normal(size=(b, 3, n, head_dim)).astype(np.float32)
               for n in (200, 257, 257))
    valid, kw = None, {}
    if "mask" in case:
        valid = g.uniform(size=(b, 257)) < 0.6
        valid[1] = False
    if case == "fp32_scale":
        kw["sm_scale"] = 0.05
    tq = [torch.from_numpy(x) for x in (q, k, v)]
    jq = [jnp.asarray(x) for x in (q, k, v)]
    tol = F32
    if case.startswith("bf16"):
        tq = [x.to(torch.bfloat16) for x in tq]
        jq = [x.astype(jnp.bfloat16) for x in jq]
        tol = BF16
    got = tk.dense_attention(*tq, None if valid is None
                             else torch.from_numpy(valid), mode="flash", **kw)
    want = jk.dense_attention(*jq, None if valid is None
                              else jnp.asarray(valid), mode="flash", **kw)
    assert got.shape == (b, 3, 200, head_dim) and got.dtype == tq[0].dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    if valid is not None:          # no valid key: V averaged over all keys
        np.testing.assert_allclose(
            got[1].float().numpy(),
            np.broadcast_to(tq[2][1].float().mean(1, keepdim=True).numpy(),
                            (3, 200, head_dim)), **tol)


@pytest.mark.parametrize("bm", [128, 256, 512])
def test_windowed_dense_padded_q_tiles(bm):
    """Every mask row height pads q independently of KV and equals the
    vanilla oracle (bf16 2e-2); at bm 128 also JAX's windowed path."""
    b, h, d = 1, 2, 32
    sv, text_slot, tl = 300, 64, 40          # s = 364: no bm divides it
    s = sv + text_slot
    g = np.random.default_rng(3)
    q, k, v = (g.normal(size=(b, h, s, d)).astype(np.float32)
               for _ in range(3))
    tlen = np.array([tl], np.int32)
    valid = np.asarray(j_valid(b, s, sv, sv, jnp.asarray(tlen), text_slot))
    want = np.asarray(jk.dense_attention(*map(jnp.asarray, (q, k, v)),
                                         jnp.asarray(valid), mode="vanilla"))
    tq = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = _windowed_dense_flash(*tq, visual_len=sv, text_start=sv,
                                tlen=torch.from_numpy(tlen), block_m=bm)
    assert got.shape == (b, h, s, d)
    got = got.float().numpy()
    np.testing.assert_allclose(got[:, :, :sv + tl], want[:, :, :sv + tl],
                               **BF16)
    if bm == 128:
        jw = np.asarray(j_windowed(
            *[jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)],
            visual_len=sv, text_start=sv, tlen=jnp.asarray(tlen),
            block_m=bm, interpret=True), np.float32)
        np.testing.assert_allclose(got, jw, **BF16)


def test_windowed_dense_kv_packed_bit_exact():
    g = np.random.default_rng(9)
    sv, text_slot, tl = 256, 128, 40
    q, k, v = (torch.from_numpy(g.normal(size=(1, 2, sv + text_slot, 32))
                                .astype(np.float32)) for _ in range(3))
    tlen = torch.tensor([tl], dtype=torch.int32)
    want = _windowed_dense_flash(q, k, v, visual_len=sv, text_start=sv,
                                 tlen=tlen, block_m=128)
    kv = torch.cat([k, v], dim=-1)
    got = _windowed_dense_flash(q, kv[..., :32], kv[..., 32:], visual_len=sv,
                                text_start=sv, tlen=tlen, block_m=128,
                                kv_packed=kv)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_plain_chunking_is_exact(monkeypatch):
    """The plain versions split large inputs over heads and index lists;
    the chunked result equals the one-shot result bit for bit."""
    q, k, v = (torch.from_numpy(x) for x in make_inputs(31, 2, 3, 4, 5, 32))
    mask = torch.from_numpy(random_mask(32, (2, 3, 4, 5), 0.5))
    idx, cnt = ops.mask_to_indices(mask)
    ui, uc, rb, cl = ops.group_rows(mask, 2, clean_blocks=4)
    tl = torch.tensor([0, 0], dtype=torch.int32)
    kw = dict(visual_len=5 * BN - 20, text_start=None)

    def both():
        return (tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl, **kw),
                tk.block_sparse_flash_attention_grouped(
                    q, k, v, ui, uc, rb, cl, tl, group=2, **kw))

    one = both()
    monkeypatch.setattr(block_sparse, "_PLAIN_CHUNK_ELEMS", 2 * BM * 5 * BN)
    for a, b in zip(both(), one):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_unported_options_raise():
    q, k, v = (torch.from_numpy(x) for x in make_inputs(0, 1, 1, 1, 1, 32))
    idx, cnt = ops.mask_to_indices(torch.ones((1, 1, 1, 1), dtype=torch.bool))
    tl = torch.zeros(1, dtype=torch.int32)
    kw = dict(visual_len=BN, text_start=None)
    # K1s (tests/test_torch_parallel.py) and K1q with stats
    # (tests/test_torch_variants.py) are ported; K1q is ported, and a mode
    # still needs its payload, as in JAX
    with pytest.raises(ValueError, match="together"):
        tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl,
                                        quant_mode="mxu8", **kw)
    with pytest.raises(ValueError, match="device"):
        tk.block_sparse_flash_attention(q.to("meta"), k, v, idx, cnt, tl,
                                        **kw)


def test_mismatched_lists_raise():
    """The wrappers refuse index lists the kernels would read past: a list
    count other than Sq / block_m (K1) or NQ / group (K2), a count larger
    than the list, and K2 rowbits / clean of another shape."""
    q, k, v = (torch.from_numpy(x) for x in make_inputs(0, 1, 2, 2, 3, 32))
    mask = torch.ones((1, 2, 2, 3), dtype=torch.bool)
    idx, cnt = ops.mask_to_indices(mask)
    ui, uc, rb, cl = ops.group_rows(mask, 2, clean_blocks=3)
    tl = torch.zeros(1, dtype=torch.int32)
    kw = dict(visual_len=3 * BN, text_start=None)
    k1 = lambda i, c: tk.block_sparse_flash_attention(q, k, v, i, c, tl, **kw)
    k2 = lambda i, c, r, cln: tk.block_sparse_flash_attention_grouped(
        q, k, v, i, c, r, cln, tl, group=2, **kw)
    with pytest.raises(ValueError, match="lists"):
        k1(idx[:, :, :1], cnt[:, :, :1])
    with pytest.raises(ValueError, match="lists"):
        k1(idx, cnt[:, :1])
    with pytest.raises(ValueError, match="exceeds"):
        k1(idx, cnt + 1)
    with pytest.raises(ValueError, match="exceeds"):
        k2(ui, uc + 1, rb, cl)
    with pytest.raises(ValueError, match="rowbits"):
        k2(ui, uc, rb[..., :2], cl)
    # the matching lists run
    k1(idx, cnt)
    k2(ui, uc, rb, cl)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("head_dim", [64, 128, 96])
def test_cuda_gates_admit_fp32_and_head_dim_64(dtype, head_dim):
    """The CUDA launches' gates (pure Python, run here on meta tensors):
    K1/K1s and K2, K1q (its q of any of the three types), K3 and the split
    merge admit bf16, fp16 and fp32 at head_dim 64 and 128, the widths and
    types their kernels are built for, and refuse 96; the S3 / S2 variants
    stay at bf16 and 128."""
    from rectified_spaattn_tpu_torch.kernels import flash
    q = torch.empty((1, 1, BM, head_dim), dtype=dtype, device="meta")
    ints = torch.empty((1, 1, 1, 1), dtype=torch.int32, device="meta")
    gates = {
        "k1_k2": lambda: block_sparse._cuda_checks(q, q, q, None, BM, BN,
                                                   ints),
        "k1q": lambda: block_sparse._cuda_checks(q, None, None, None, BM, BN,
                                                 ints),
        "k3": lambda: flash._cuda_checks(q, q, q, None),
        "merge": lambda: block_sparse._merge_checks(dtype, head_dim),
    }
    for name, gate in gates.items():
        if head_dim == 96:
            with pytest.raises((ValueError, TypeError), match="64 or 128"):
                gate()
        else:
            gate()
    assert set(block_sparse._DTYPE_CODE) == set(flash._DTYPE_CODE) == {
        torch.bfloat16, torch.float16, torch.float32}
    if head_dim == 64:                         # the variants' gate
        with pytest.raises(ValueError, match="head_dim 128, got 64"):
            block_sparse._cuda_checks(q, q, q, None, BM, BN, ints,
                                      head_dims=(128,))
