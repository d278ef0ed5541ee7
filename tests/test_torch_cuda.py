"""The port's CUDA kernels K1/K1s/K2/K1q/K1q-s/K3, the S1 probe and the
S3/S2 ablation variants against their plain PyTorch versions, on a CUDA
GPU (bf16, 2e-2: the repo's bf16 tolerance, tests/test_kernels.py; K1s's
and K1q-s's l within 1 %; S1's int8 result, the load-only variants and S2
full / prefetch against K2 bit for bit).
Marked ``cuda``; each test skips without a GPU.  This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from rectified_spaattn_tpu_torch import kernels as tk
from rectified_spaattn_tpu_torch.kernels import int8_probe, variants
from rectified_spaattn_tpu_torch.sparse import ops

torch.set_num_threads(1)
BM = BN = 128
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("group,block_m,chunk_blocks", [
    (1, 128, 2), (1, 128, 16), (1, 1024, 2), (1, 1024, 16), (2, 128, 16),
    (4, 128, 16), (2, 256, 2), (2, 256, 16)])
def test_cuda_kernels_match_plain(cuda, group, block_m, chunk_blocks):
    """K1 and K1s (block_m 128 and 1024; at chunk_blocks 2 their lists
    split into key ranges, at 16 they do not) and K2 (G = 2, 4; block_m
    256: two 128-row CTAs per row block) against their plain versions;
    K1s's m within 2e-2, l within 1 %."""
    g = torch.Generator(device=cuda)
    g.manual_seed(group)
    b, h, nq, nb, d = 2, 4, 8, 12, 128
    q, k, v = (torch.randn((b, h, n * BM, d), generator=g, device=cuda
                           ).to(torch.bfloat16) for n in (nq, nb, nb))
    mask = torch.rand((b, h, nq * BM // block_m, nb), generator=g,
                      device=cuda) < 0.35
    mask[..., 0] = mask[..., -1] = True
    tl = torch.tensor([90, 17], dtype=torch.int32, device=cuda)
    kw = dict(visual_len=(nb - 1) * BN - 50, text_start=(nb - 1) * BN,
              block_m=block_m, chunk_blocks=chunk_blocks)
    if group == 1:
        idx, cnt = ops.mask_to_indices(mask)
        got = tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl, **kw)
        want = tk.block_sparse_flash_attention_torch(q, k, v, idx, cnt, tl,
                                                     **kw)
        o, m, l = tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl,
                                                  return_stats=True, **kw)
        _, wm, wl = tk.block_sparse_flash_attention_torch(
            q, k, v, idx, cnt, tl, return_stats=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(o, got)
        torch.testing.assert_close(m, wm, rtol=0, atol=2e-2)
        torch.testing.assert_close(l, wl, rtol=1e-2, atol=0)
    else:
        ui, uc, rb, cl = ops.group_rows(mask, group,
                                        clean_blocks=kw["visual_len"] // BN)
        got = tk.block_sparse_flash_attention_grouped(
            q, k, v, ui, uc, rb, cl, tl, group=group, **kw)
        want = tk.block_sparse_flash_attention_grouped_torch(
            q, k, v, ui, uc, rb, cl, tl, group=group, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 4])
def test_cuda_degenerate_rows_match_plain(cuda, group):
    """Rows whose every gathered key is masked while their count is above
    0: K1 (a row whose only block is the text block of a batch with
    text_len 0) averages V over its chunk's lanes, padding included; K2 at
    G=2 and 4 (that row block, and a row block with no block of its own in
    a union list with count > 0) over its union's lanes."""
    g = torch.Generator(device=cuda)
    g.manual_seed(21 + group)
    b, h, nq, nb, d = 2, 2, 4, 6, 128
    q, k, v = (torch.randn((b, h, n * BM, d), generator=g, device=cuda
                           ).to(torch.bfloat16) for n in (nq, nb, nb))
    mask = torch.rand((b, h, nq, nb), generator=g, device=cuda) < 0.5
    mask[..., 0] = True
    mask[1, 0, 1] = False
    mask[1, 0, 1, -1] = True                   # only the text block
    mask[0, 1, 2] = False                      # no block of its own
    tl = torch.tensor([60, 0], dtype=torch.int32, device=cuda)
    kw = dict(visual_len=(nb - 1) * BN - 20, text_start=(nb - 1) * BN)
    for cb in (2, 16):
        if group == 1:
            idx, cnt = ops.mask_to_indices(mask)
            args = (idx, cnt, tl)
            got = tk.block_sparse_flash_attention(q, k, v, *args,
                                                  chunk_blocks=cb, **kw)
            want = tk.block_sparse_flash_attention_torch(
                q, k, v, *args, chunk_blocks=cb, **kw)
        else:
            ui, uc, rb, cl = ops.group_rows(
                mask, group, clean_blocks=kw["visual_len"] // BN)
            got = tk.block_sparse_flash_attention_grouped(
                q, k, v, ui, uc, rb, cl, tl, group=group, chunk_blocks=cb,
                **kw)
            want = tk.block_sparse_flash_attention_grouped_torch(
                q, k, v, ui, uc, rb, cl, tl, group=group, chunk_blocks=cb,
                **kw)
        torch.cuda.synchronize()
        assert want[1, 0, BM:2 * BM].float().abs().max() > 0.01
        if group > 1:                          # the row block without own
            assert want[0, 1, 2 * BM:3 * BM].float().abs().max() > 0.01
        torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_k1s_matches_plain(cuda, packed):
    """K1s against its plain version: random masks, the text window at
    B=2, a count-0 row (m == -inf and l == 0 exactly) and a degenerate row
    (its only block the text block of a batch with no valid text) at
    chunk_blocks 2 and 16; o equals K1's bit for bit."""
    g = torch.Generator(device=cuda)
    g.manual_seed(31 + packed)
    b, h, nq, nb, d = 2, 3, 6, 12, 128
    q, k, v = (torch.randn((b, h, n * BM, d), generator=g, device=cuda
                           ).to(torch.bfloat16) for n in (nq, nb, nb))
    mask = torch.rand((b, h, nq, nb), generator=g, device=cuda) < 0.4
    mask[..., 0] = mask[..., -1] = True
    mask[0, 1, 3] = False                      # count 0
    mask[1, 2, 4] = False
    mask[1, 2, 4, -1] = True                   # only the text block
    tl = torch.tensor([90, 0], dtype=torch.int32, device=cuda)
    kv = torch.cat([k, v], dim=-1) if packed else None
    idx, cnt = ops.mask_to_indices(mask)
    for cb in (2, 16):
        kw = dict(visual_len=(nb - 1) * BN - 50, text_start=(nb - 1) * BN,
                  chunk_blocks=cb, packed_kv=kv)
        o, m, l = tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl,
                                                  return_stats=True, **kw)
        wo, wm, wl = tk.block_sparse_flash_attention_torch(
            q, k, v, idx, cnt, tl, return_stats=True, **kw)
        k1 = tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl, **kw)
        torch.cuda.synchronize()
        assert m.dtype == l.dtype == torch.float32 and m.shape == (b, h,
                                                                   nq * BM)
        assert torch.equal(o, k1)
        zero = (cnt == 0).repeat_interleave(BM, dim=2)
        assert zero.any() and bool((m[zero] == -torch.inf).all())
        assert bool((l[zero] == 0).all()) and o[zero].abs().max() == 0
        rows = slice(4 * BM, 5 * BM)           # the degenerate row block
        assert bool((m[1, 2, rows] == wm[1, 2, rows]).all())
        torch.testing.assert_close(o.float(), wo.float(), **BF16)
        live = ~zero
        torch.testing.assert_close(m[live], wm[live], rtol=0, atol=2e-2)
        torch.testing.assert_close(l[live], wl[live], rtol=1e-2, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "mxu8"])
@pytest.mark.parametrize("chunk_blocks", [2, 16, 24])
def test_cuda_k1q_matches_plain(cuda, mode, chunk_blocks):
    """K1q against its plain version: random masks, the text window at
    B=2, a zero-count row and a row whose only block is masked."""
    g = torch.Generator(device=cuda)
    g.manual_seed(7 + chunk_blocks)
    b, h, nq, nb, d = 2, 3, 6, 12, 128
    q, k, v = (torch.randn((b, h, n * BM, d), generator=g, device=cuda
                           ).to(torch.bfloat16) for n in (nq, nb, nb))
    mask = torch.rand((b, h, nq, nb), generator=g, device=cuda) < 0.4
    mask[..., 0] = mask[..., -1] = True
    mask[0, 1, 3] = False                      # count 0
    mask[1, 2, 4] = False
    mask[1, 2, 4, -1] = True                   # only the text block
    tl = torch.tensor([90, 0], dtype=torch.int32, device=cuda)
    vis = (nb - 1) * BN - 50
    kw = dict(visual_len=vis, text_start=(nb - 1) * BN,
              chunk_blocks=chunk_blocks)
    valid = torch.arange(nb * BN, device=cuda)[None, :] < vis
    valid = valid | ((torch.arange(nb * BN, device=cuda)[None, :]
                      >= (nb - 1) * BN)
                     & (torch.arange(nb * BN, device=cuda)[None, :]
                        < (nb - 1) * BN + tl[:, None]))
    kz = torch.where(valid[:, None, :, None], k, torch.zeros_like(k))
    vz = torch.where(valid[:, None, :, None], v, torch.zeros_like(v))
    payload = ops.quantize_kv_blocks(kz, vz, BN)
    idx, cnt = ops.mask_to_indices(mask)
    got = tk.block_sparse_flash_attention(q, kz, vz, idx, cnt, tl,
                                          kv_quant=payload, quant_mode=mode,
                                          **kw)
    want = tk.block_sparse_flash_attention_torch(
        q, kz, vz, idx, cnt, tl, kv_quant=payload, quant_mode=mode, **kw)
    torch.cuda.synchronize()
    assert got[0, 1, 3 * BM:4 * BM].abs().max() == 0
    torch.testing.assert_close(got.float(), want.float(), **BF16)
    # and within int8 noise of bf16 K1 on the rows with a valid key
    ref = tk.block_sparse_flash_attention(q, kz, vz, idx, cnt, tl, **kw)
    keep = torch.ones((b, h, nq), dtype=torch.bool, device=cuda)
    keep[1, 2, 4] = False
    keep = keep.repeat_interleave(BM, dim=2)
    err = (got.float() - ref.float())[keep].abs().max()
    assert float(err) < 0.1, float(err)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k2", "int8", "mxu8"])
def test_cuda_short_row_launches_match_plain(cuda, kernel):
    """K2 (G = 2) and K1q (both modes, chunk_blocks 24) at a launch of
    fewer 128-row tiles than SMs (8 CTAs; these kernels take no key split)
    against their plain versions, with a degenerate list among them."""
    g = torch.Generator(device=cuda)
    g.manual_seed(71)
    b, h, nq, nb, d = 2, 1, 4, 30, 128
    q, k, v = (torch.randn((b, h, n * BM, d), generator=g, device=cuda
                           ).to(torch.bfloat16) for n in (nq, nb, nb))
    mask = torch.rand((b, h, nq, nb), generator=g, device=cuda) < 0.5
    mask[..., -1] = True
    mask[1, 0, 1] = False
    mask[1, 0, 1, -1] = True                   # only the text block
    tl = torch.tensor([90, 0], dtype=torch.int32, device=cuda)
    kw = dict(visual_len=(nb - 1) * BN - 40, text_start=(nb - 1) * BN)
    if kernel == "k2":
        args = (*ops.group_rows(mask, 2, clean_blocks=kw["visual_len"] // BN),
                tl)
        got = tk.block_sparse_flash_attention_grouped(
            q, k, v, *args, group=2, chunk_blocks=4, **kw)
        want = tk.block_sparse_flash_attention_grouped_torch(
            q, k, v, *args, group=2, chunk_blocks=4, **kw)
    else:
        idx, cnt = ops.mask_to_indices(mask)
        kw.update(chunk_blocks=24, kv_quant=ops.quantize_kv_blocks(k, v, BN),
                  quant_mode=kernel)
        got = tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl, **kw)
        want = tk.block_sparse_flash_attention_torch(q, k, v, idx, cnt, tl,
                                                     **kw)
    torch.cuda.synchronize()
    assert want[1, 0, BM:2 * BM].float().abs().max() > 0.01
    torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.cuda
def test_cuda_rejects_block_m_off_the_row_tile(cuda):
    """K2 and K1q raise for block_m not a multiple of 128 on the card."""
    q = torch.zeros((1, 1, 128, 128), dtype=torch.bfloat16, device=cuda)
    tl = torch.zeros(1, dtype=torch.int32, device=cuda)
    idx = torch.zeros((1, 1, 2, 1), dtype=torch.int32, device=cuda)
    cnt = torch.ones((1, 1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        tk.block_sparse_flash_attention_grouped(
            q, q, q, idx[:, :, :1], cnt[:, :, :1], idx[:, :, :1],
            cnt[:, :, :1] * 0, tl, group=2, block_m=64, visual_len=BN,
            text_start=None)
    with pytest.raises(ValueError, match="multiple of 128"):
        tk.block_sparse_flash_attention(
            q, q, q, idx, cnt, tl, block_m=64, visual_len=BN, text_start=None,
            kv_quant=ops.quantize_kv_blocks(q, q, BN), quant_mode="int8")


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", ["1", "4", "2*SMs+1"])
def test_cuda_int8_probe_matches_plain(cuda, pairs):
    """S1 on 1, 4 and 2 * SMs + 1 pairs (the persistent grid's tail: one
    CTA walks three pairs): int8 bit for bit, bf16 within 1e-4 of its
    scale."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = 2 * sms + 1 if pairs == "2*SMs+1" else int(pairs)
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    for kind in ("int8", "bf16"):
        a, b = int8_probe.random_pairs(kind, n, g, cuda)
        got = int8_probe.loop_dots(a, b)
        want = int8_probe.loop_dots_torch(a, b)
        torch.cuda.synchronize()
        if kind == "int8":
            assert torch.equal(got, want)
        else:
            err = (got - want).abs().max() / want.abs().max()
            assert float(err) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tails", "mask_b2", "scale_fp16",
                                  "strided", "keys512", "persistent"])
def test_cuda_dense_flash_matches_plain(cuda, case):
    """K3 against its plain version: Sq and Sk off the 128-row/128-key
    tiles (257 keys), 512 keys, a kv_valid mask at B=2 with a row that has
    no valid key (V averaged over all keys), a given sm_scale in fp16, a
    head-split [B,S,H,D] projection read and written in place, and more
    row tiles than SMs (each persistent CTA walks several)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(11)
    dt = torch.float16 if case == "scale_fp16" else torch.bfloat16
    b, h, sq, sk, d = (2 if case == "mask_b2" else 1), 3, 200, 257, 128
    if case == "keys512":
        sk = 512
    if case == "persistent":
        h, sq, sk = 8, 5000, 300
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dt)
    q, k, v = rnd(b, h, sq, d), rnd(b, h, sk, d), rnd(b, h, sk, d)
    valid, kw = None, {}
    if case == "mask_b2":
        valid = torch.rand((b, sk), generator=g, device=cuda) < 0.6
        valid[1] = False
    if case == "scale_fp16":
        kw["sm_scale"] = 0.05
    if case == "strided":
        q = rnd(b, sq, h, d).transpose(1, 2)
    got = tk.dense_attention(q, k, v, valid, mode="flash", **kw)
    want = tk.flash._vanilla_attention(q, k, v, valid, kw.get("sm_scale"))
    torch.cuda.synchronize()
    assert got.stride() == q.stride()
    torch.testing.assert_close(got.float(), want.float(), **BF16)
    if case == "mask_b2":
        torch.testing.assert_close(
            got[1].float(), v[1].float().mean(1, keepdim=True).expand(
                h, sq, d), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_k1_split_matches_plain(cuda, packed):
    """The key split at a short-row shape (16 row tiles, lists of 40
    blocks at chunk_blocks 4): K1 and K1s against the plain unsplit and
    split versions, the text window at B=2, a count-0 row (m == -inf,
    l == 0) and a degenerate list; K1s's o equals K1's bit for bit; each
    call merges once."""
    g = torch.Generator(device=cuda)
    g.manual_seed(41 + packed)
    b, h, nq, nb, d = 2, 4, 2, 40, 128
    q, k, v = (torch.randn((b, h, n * BM, d), generator=g, device=cuda
                           ).to(torch.bfloat16) for n in (nq, nb, nb))
    mask = torch.rand((b, h, nq, nb), generator=g, device=cuda) < 0.5
    mask[..., -1] = True
    mask[0, 1, 0] = False                      # count 0
    mask[1, 2, 1] = False
    mask[1, 2, 1, -1] = True                   # only the text block
    tl = torch.tensor([90, 0], dtype=torch.int32, device=cuda)
    idx, cnt = ops.mask_to_indices(mask)
    kw = dict(visual_len=(nb - 1) * BN - 40, text_start=(nb - 1) * BN,
              chunk_blocks=4,
              packed_kv=torch.cat([k, v], dim=-1) if packed else None)
    merges = tk.block_sparse.merge_splits.launches
    o, m, l = tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl,
                                              return_stats=True, **kw)
    k1 = tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl, **kw)
    torch.cuda.synchronize()
    assert tk.block_sparse.merge_splits.launches == merges + 2
    assert torch.equal(o, k1)
    n_split, _ = tk.block_sparse._split_plan(
        b * h * nq, nb, 4,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    wo, wm, wl = tk.block_sparse_flash_attention_torch(
        q, k, v, idx, cnt, tl, return_stats=True, **kw)
    so, sm, sl = tk.block_sparse_flash_attention_split_torch(
        q, k, v, idx, cnt, tl, n_split=n_split, return_stats=True, **kw)
    zero = (cnt == 0).repeat_interleave(BM, dim=2)
    assert zero.any() and bool((m[zero] == -torch.inf).all())
    assert bool((l[zero] == 0).all()) and o[zero].abs().max() == 0
    live = ~zero
    for want_o, want_m, want_l in ((wo, wm, wl), (so, sm, sl)):
        torch.testing.assert_close(o.float(), want_o.float(), **BF16)
        torch.testing.assert_close(m[live], want_m[live], rtol=0, atol=2e-2)
        torch.testing.assert_close(l[live], want_l[live], rtol=1e-2, atol=0)
    rows = slice(BM, 2 * BM)                   # the degenerate list
    assert bool((m[1, 2, rows] == tk.block_sparse.MASK_VALUE).all())


@pytest.mark.cuda
def test_cuda_rejects_fp32(cuda):
    q = torch.zeros((1, 1, BM, 128), device=cuda)
    idx = torch.zeros((1, 1, 1, 1), dtype=torch.int32, device=cuda)
    cnt = torch.ones((1, 1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        tk.block_sparse_flash_attention(
            q, q, q, idx, cnt, torch.zeros(1, dtype=torch.int32, device=cuda),
            visual_len=BN, text_start=None)
    with pytest.raises(TypeError, match="bf16"):
        tk.dense_attention(q, q, q, mode="flash")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "mxu8"])
def test_cuda_k1q_stats_matches_plain(cuda, mode):
    """K1q-s against its plain version at chunk_blocks 2, 16 and 24: o
    equals K1q's bit for bit, m within 2e-2, l within 1 %, a count-0 row
    has m == -inf and l == 0 exactly, and a degenerate list (its only
    block the text block of a batch with no valid text) m == MASK_VALUE."""
    g = torch.Generator(device=cuda)
    g.manual_seed(41)
    b, h, nq, nb, d = 2, 3, 6, 12, 128
    q, k, v = (torch.randn((b, h, n * BM, d), generator=g, device=cuda
                           ).to(torch.bfloat16) for n in (nq, nb, nb))
    mask = torch.rand((b, h, nq, nb), generator=g, device=cuda) < 0.4
    mask[..., 0] = mask[..., -1] = True
    mask[0, 1, 3] = False                      # count 0
    mask[1, 2, 4] = False
    mask[1, 2, 4, -1] = True                   # only the text block
    tl = torch.tensor([90, 0], dtype=torch.int32, device=cuda)
    payload = ops.quantize_kv_blocks(k, v, BN)
    idx, cnt = ops.mask_to_indices(mask)
    for cb in (2, 16, 24):
        kw = dict(visual_len=(nb - 1) * BN - 50, text_start=(nb - 1) * BN,
                  chunk_blocks=cb, kv_quant=payload, quant_mode=mode)
        o, m, l = tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl,
                                                  return_stats=True, **kw)
        wo, wm, wl = tk.block_sparse_flash_attention_torch(
            q, k, v, idx, cnt, tl, return_stats=True, **kw)
        k1q = tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl, **kw)
        torch.cuda.synchronize()
        assert torch.equal(o, k1q)
        zero = (cnt == 0).repeat_interleave(BM, dim=2)
        assert bool((m[zero] == -torch.inf).all()) and bool((l[zero] == 0).all())
        rows = slice(4 * BM, 5 * BM)           # the degenerate list
        assert bool((m[1, 2, rows] == tk.block_sparse.MASK_VALUE).all())
        torch.testing.assert_close(o.float(), wo.float(), **BF16)
        torch.testing.assert_close(m[~zero], wm[~zero], rtol=0, atol=2e-2)
        torch.testing.assert_close(l[~zero], wl[~zero], rtol=1e-2, atol=0)


def variant_inputs(cuda, seed, nq=4, nb=12, group=1):
    """bf16 q/k/v, a mask with text blocks, a count-0 row block and a
    degenerate one (its only block the text block of a batch with
    text_len 0), the text window at B=2."""
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    b, h, d = 2, 2, 128
    q, k, v = (torch.randn((b, h, n * BM, d), generator=g, device=cuda
                           ).to(torch.bfloat16) for n in (nq, nb, nb))
    mask = torch.rand((b, h, nq, nb), generator=g, device=cuda) < 0.45
    mask[..., 0] = mask[..., -1] = True
    mask[0, 1, 1] = False                       # count 0
    mask[1, 0, 2] = False
    mask[1, 0, 2, -1] = True                    # only the masked text block
    if group > 1:
        mask[0, 0, 1] = False                   # no block of its own
    tl = torch.tensor([70, 0], dtype=torch.int32, device=cuda)
    kw = dict(visual_len=(nb - 1) * BN - 30, text_start=(nb - 1) * BN)
    return q, k, v, mask, tl, kw


def assert_variant_close(got, want, exact):
    if exact:
        assert torch.equal(got, want)             # the same fp32 sums
    else:
        torch.testing.assert_close(got.float(), want.float(), equal_nan=True,
                                   **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [*variants.S3A, "base3", "dma3",
                                     "compute3", "twophase", "runs1",
                                     "runs2", "runs4"])
@pytest.mark.parametrize("chunk_blocks", [2, 4])
def test_cuda_s3_variants_match_plain(cuda, variant, chunk_blocks):
    """Each S3 variant against its plain version: bf16 2e-2 (NaN where the
    plain version has NaN), the load-only variants bit for bit.  twophase
    equals base bit for bit; runs1/2/4 equal K1 bit for bit at 34 row
    tiles a head (136 CTAs: K1 does not split its key range) and, at 4
    (16 CTAs, split by K1), K1's output within bf16 2e-2 off the
    degenerate list, as base does."""
    for nq in (4, 34) if variant.startswith("runs") else (4,):
        q, k, v, mask, tl, kw = variant_inputs(cuda, 51 + chunk_blocks,
                                               nq=nq)
        idx, cnt = ops.mask_to_indices(mask)
        kw["chunk_blocks"] = chunk_blocks
        if variant == "twophase":
            call = lambda x: variants.twophase(*x, **kw)
        elif variant.startswith("runs"):
            call = lambda x: variants.runs(*x, max_run=int(variant[4:]),
                                           **kw)
        else:
            call = lambda x: variants.kernel_variant(variant, *x, **kw)
        args = (q, k, v, idx, cnt, tl)
        got = call(args)
        want = call(tuple(t.cpu() for t in args)).to(cuda)
        torch.cuda.synchronize()
        assert_variant_close(got, want,
                             variant.rstrip("3") in variants.LOAD_ONLY)
        if variant == "twophase":
            assert torch.equal(got, variants.kernel_variant("base", *args,
                                                            **kw))
        if variant.startswith("runs") or variant == "base":
            # K1's output on these ascending lists
            k1 = tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl, **kw)
            if nq * q.shape[0] * q.shape[1] >= 132:
                assert torch.equal(got, k1)
                continue
            live = (cnt > 0).repeat_interleave(BM, dim=2)
            live[1, 0, 2 * BM:3 * BM] = False    # degenerate: pads differ
            torch.testing.assert_close(got[live].float(), k1[live].float(),
                                       **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", variants.S2)
@pytest.mark.parametrize("group", [2, 4])
def test_cuda_s2_variants_match_plain(cuda, variant, group):
    """Each S2 variant against its plain version (dma bit for bit); full
    and prefetch also equal K2's output bit for bit (full is K2's mainloop
    policy, prefetch runs the same arithmetic per row tile).  At G = 2 the
    14 row tiles are not a multiple of the 4 a prefetch CTA walks."""
    for nq in (12, 20, 14) if group == 2 else (12, 20):
        q, k, v, mask, tl, kw = variant_inputs(cuda, 61 + group + nq, nq=nq,
                                               group=group)
        kw["chunk_blocks"] = 4
        args = (*ops.group_rows(mask, group,
                                clean_blocks=kw["visual_len"] // BN), tl)
        got = variants.grouped_variant(variant, q, k, v, *args, group=group,
                                       **kw)
        want = variants.grouped_variant(variant, q.cpu(), k.cpu(), v.cpu(),
                                        *(t.cpu() for t in args),
                                        group=group, **kw).to(cuda)
        torch.cuda.synchronize()
        assert_variant_close(got, want, variant == "dma")
        if variant in ("full", "prefetch"):
            k2 = tk.block_sparse_flash_attention_grouped(
                q, k, v, *args, group=group, **kw)
            assert torch.equal(got, k2)
