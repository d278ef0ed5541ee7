"""The port's CUDA kernels K1/K1s/K2/K1q/K1q-s/K3 and the split merge (at
head_dim 128 and 64), the S1 probe and the S3/S2 ablation variants
against their plain PyTorch versions, on a CUDA GPU (bf16, 2e-2: the
repo's bf16 tolerance, tests/test_kernels.py; K1s's and K1q-s's l within
1 %; fp32 inputs at fp32 rtol 2e-4 / atol 2e-5 with TF32 off; K1q with
fp16 and fp32 q; S1's int8 result, the load-only variants and S2
full / prefetch against K2 bit for bit); the safetensors codec on device
tensors (bit for bit), the full-width HunyuanVideo VAE decode on the
GPU against the CPU (fp32 rtol 2e-4 / atol 2e-5, TF32 off), Wan2.2
A14B's host_swap against its co-resident run (bit for bit), and the tiny
Flux upscale with a ControlNet (bf16 against the CPU's fp32, 5 % of the
output's scale) and its bicubic resize (fp32 2e-4 / 2e-5), the eval
diff metrics in float64 on the card against the CPU (rtol 1e-10), and
the stacked block execution (scan_blocks, dispatch_segments) of the
HunyuanVideo and Wan pipelines against their unrolled runs (bit for
bit); the plan's top-p selection kernel P1 against the plain bisection
(a row apart only where its fp64 mass at the cut lies within 1e-5 of
p_remain) and against the plain model of its summation order (bit for
bit).
Marked ``cuda``; each test skips without a GPU.  This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from rectified_spaattn_tpu_torch import kernels as tk
from rectified_spaattn_tpu_torch.bench.inputs import TOPP_KINDS, topp_rows
from rectified_spaattn_tpu_torch.kernels import (int8_probe, plan_select,
                                                 variants)
from rectified_spaattn_tpu_torch.sparse import ops

torch.set_num_threads(1)
BM = BN = 128
BF16 = dict(rtol=2e-2, atol=2e-2)
F32 = dict(rtol=2e-4, atol=2e-5)


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
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", ["tails", "mask_b2", "scale_fp16",
                                  "strided", "keys512", "persistent"])
def test_cuda_dense_flash_matches_plain(cuda, case, d):
    """K3 at head_dim 128 and 64 against its plain version: Sq and Sk off
    the 128-row/128-key tiles (257 keys), 512 keys, a kv_valid mask at B=2
    with a row that has no valid key (V averaged over all keys), a given
    sm_scale in fp16, a head-split [B,S,H,D] projection read and written
    in place, and more row tiles than SMs (each persistent CTA walks
    several)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(11)
    dt = torch.float16 if case == "scale_fp16" else torch.bfloat16
    b, h, sq, sk = (2 if case == "mask_b2" else 1), 3, 200, 257
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


@pytest.fixture
def no_tf32():
    """fp32 products in full fp32 on the card for the plain versions."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kernel", ["k1", "k1s", "k1_split", "dense1024",
                                    "k2g2", "k2g4", "k3", "k3_mask",
                                    "merge"])
def test_cuda_fp32_matches_plain(cuda, no_tf32, kernel, d):
    """fp32 q, K and V on the mainloop's split route (bf16 hi and lo parts,
    three products each) against the plain versions at fp32 rtol 2e-4 /
    atol 2e-5: K1 and K1s (the text window at B=2, a degenerate row and a
    count-0 row), K1 split into key ranges and merged (16 row tiles), K1
    with full lists at block_m 1024, K2 at G = 2 and 4, K3 with Sq and Sk
    off the tiles and with a kv_valid mask at B=2, and the merge kernel
    writing fp32 rows; K1s's m and l at the same tolerance."""
    g = torch.Generator(device=cuda)
    g.manual_seed(320 + d)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=cuda)
    tl = torch.tensor([90, 0], dtype=torch.int32, device=cuda)
    if kernel == "merge":
        n, rows = 3, 4 * BM
        part = (rnd(n, rows, d), rnd(n, rows), rnd(n, rows).abs() * 50)
        part[1][1, :7] = -torch.inf            # a range without keys
        part[2][1, :7] = 0
        before = tk.block_sparse.merge_splits.launches
        o, m, l = tk.block_sparse.merge_splits(*part, torch.float32,
                                                return_stats=True)
        wo, wm, wl = tk.block_sparse._merge_splits(*(list(t) for t in part))
        torch.cuda.synchronize()
        assert tk.block_sparse.merge_splits.launches == before + 1
        assert o.dtype == torch.float32
        for got, want in ((o, wo), (m, wm), (l, wl)):
            torch.testing.assert_close(got, want, **F32)
        return
    if kernel.startswith("k3"):
        b = 2 if kernel == "k3_mask" else 1
        q, k, v = rnd(b, 3, 200, d), rnd(b, 3, 257, d), rnd(b, 3, 257, d)
        valid = None
        if kernel == "k3_mask":
            valid = torch.rand((b, 257), generator=g, device=cuda) < 0.6
            valid[1] = False                   # no valid key: V averaged
        before = tk.dense_flash_attention.launches
        got = tk.dense_attention(q, k, v, valid, mode="flash")
        want = tk.flash._vanilla_attention(q, k, v, valid)
        torch.cuda.synchronize()
        assert tk.dense_flash_attention.launches == before + 1
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, **F32)
        return
    b, h, nq, nb, cb, bm = 2, 3, 4, 10, 16, BM
    if kernel == "k1_split":
        h, nq, nb, cb = 4, 2, 40, 4            # 16 row tiles: key ranges
    if kernel == "dense1024":
        nq, bm = 8, 1024
    q, k, v = rnd(b, h, nq * BM, d), rnd(b, h, nb * BN, d), rnd(b, h, nb * BN, d)
    mask = torch.rand((b, h, nq * BM // bm, nb), generator=g,
                      device=cuda) < 0.4
    if kernel == "dense1024":
        mask[:] = True
    mask[..., 0] = mask[..., -1] = True
    if kernel != "dense1024":
        mask[0, 1, 0] = False                  # count 0
        mask[1, 2, 1] = False
        mask[1, 2, 1, -1] = True               # only the text block
    kw = dict(visual_len=(nb - 1) * BN - 50, text_start=(nb - 1) * BN,
              chunk_blocks=cb, block_m=bm)
    if kernel.startswith("k2"):
        group = int(kernel[-1])
        args = (*ops.group_rows(mask, group,
                                clean_blocks=kw["visual_len"] // BN), tl)
        got = tk.block_sparse_flash_attention_grouped(q, k, v, *args,
                                                      group=group, **kw)
        want = tk.block_sparse_flash_attention_grouped_torch(
            q, k, v, *args, group=group, **kw)
    else:
        idx, cnt = ops.mask_to_indices(mask)
        merges = tk.block_sparse.merge_splits.launches
        stats = kernel == "k1s"
        got = tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl,
                                              return_stats=stats, **kw)
        want = tk.block_sparse_flash_attention_torch(
            q, k, v, idx, cnt, tl, return_stats=stats, **kw)
        torch.cuda.synchronize()
        if kernel == "k1_split":
            assert tk.block_sparse.merge_splits.launches == merges + 1
        if stats:
            (got, m, l), (want, wm, wl) = got, want
            live = l > 0
            torch.testing.assert_close(m[live], wm[live], **F32)
            torch.testing.assert_close(l, wl, **F32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    if kernel != "dense1024":
        assert want[1, 2, BM:2 * BM].abs().max() > 0.01   # degenerate
    torch.testing.assert_close(got, want, **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "mxu8"])
@pytest.mark.parametrize("d,q_dtype", [
    (64, torch.bfloat16), (64, torch.float16), (64, torch.float32),
    (128, torch.float16), (128, torch.float32)])
def test_cuda_k1q_widths_and_q_types_match_plain(cuda, no_tf32, mode, d,
                                                  q_dtype):
    """K1q and K1q-s at head_dim 64 (the payload's K and V in one 128-byte
    row) and with an fp16 or fp32 q (read from global memory; the output
    in q's type, as the JAX wrapper gives it) against their plain versions
    at chunk_blocks 2 and 24: the text window at B=2, a count-0 row (exact
    zeros, m == -inf, l == 0) and a degenerate list; K1q-s's o equals
    K1q's bit for bit, m within 2e-2, l within 1 %."""
    g = torch.Generator(device=cuda)
    g.manual_seed(90 + d)
    b, h, nq, nb = 2, 3, 6, 12
    q, k, v = (torch.randn((b, h, n * BM, d), generator=g, device=cuda)
               for n in (nq, nb, nb))
    q = q.to(q_dtype)
    mask = torch.rand((b, h, nq, nb), generator=g, device=cuda) < 0.4
    mask[..., 0] = mask[..., -1] = True
    mask[0, 1, 3] = False                      # count 0
    mask[1, 2, 4] = False
    mask[1, 2, 4, -1] = True                   # only the text block
    tl = torch.tensor([90, 0], dtype=torch.int32, device=cuda)
    payload = ops.quantize_kv_blocks(k.to(torch.bfloat16),
                                     v.to(torch.bfloat16), BN)
    idx, cnt = ops.mask_to_indices(mask)
    zero = (cnt == 0).repeat_interleave(BM, dim=2)
    for cb in (2, 24):
        kw = dict(visual_len=(nb - 1) * BN - 50, text_start=(nb - 1) * BN,
                  chunk_blocks=cb, kv_quant=payload, quant_mode=mode)
        before = dict(tk.block_sparse_flash_attention.quant_launches)
        got = tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl, **kw)
        o, m, l = tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl,
                                                  return_stats=True, **kw)
        want, wm, wl = tk.block_sparse_flash_attention_torch(
            q, k, v, idx, cnt, tl, return_stats=True, **kw)
        torch.cuda.synchronize()
        assert tk.block_sparse_flash_attention.quant_launches[mode] == \
            before[mode] + 1
        assert got.dtype == q_dtype and torch.equal(o, got)
        assert got[zero].abs().max() == 0
        assert bool((m[zero] == -torch.inf).all()) and bool((l[zero] == 0).all())
        rows = slice(4 * BM, 5 * BM)           # the degenerate list
        assert bool((m[1, 2, rows] == tk.block_sparse.MASK_VALUE).all())
        torch.testing.assert_close(got.float(), want.float(), **BF16)
        torch.testing.assert_close(m[~zero], wm[~zero], rtol=0, atol=2e-2)
        torch.testing.assert_close(l[~zero], wl[~zero], rtol=1e-2, atol=0)


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


@pytest.mark.cuda
def test_cuda_codec_round_trip(cuda, tmp_path):
    """Device tensors of every dtype written (copied to the host one at a
    time) and read back bit for bit."""
    from rectified_spaattn_tpu_torch.models import safetensors_io as sio
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    sd = {}
    for name, dt in sio.DTYPES.items():
        x = torch.randn((5, 7), generator=g, device=cuda) * 50
        sd[name] = x > 0 if dt == torch.bool else x.to(dt)
    sd["empty"] = torch.zeros((0, 3), device=cuda)
    path = sio.save_file(sd, str(tmp_path / "x.safetensors"))
    for use_mmap in (True, False):
        back = sio.load_file(path, use_mmap)
        assert sorted(back) == sorted(sd)
        for k, v in sd.items():
            assert back[k].dtype == v.dtype and torch.equal(back[k],
                                                            v.cpu()), k


@pytest.mark.cuda
def test_cuda_vae_full_width_matches_cpu(cuda):
    """The HunyuanVideo VAE decoder at its published widths (vae/
    config.json of tencent/HunyuanVideo, diffusers format), seeded
    N(0, 1/fan_in) weights: a [1, 16, 2, 8, 8] latent on the GPU against
    the CPU in fp32 with TF32 off."""
    from rectified_spaattn_tpu_torch.models.pretrained import (
        vae_config_from_json)
    from rectified_spaattn_tpu_torch.models.vae import VAEDecoder
    cfg = vae_config_from_json(
        {"latent_channels": 16, "block_out_channels": [128, 256, 512, 512],
         "layers_per_block": 2, "temporal_compression_ratio": 4,
         "spatial_compression_ratio": 8, "scaling_factor": 0.476986,
         "mid_block_add_attention": True}, video=True)
    dec = VAEDecoder(cfg).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in dec.named_parameters():
            if p.ndim > 1:
                p.copy_(torch.randn(p.shape, generator=g)
                        * (p[0].numel() ** -0.5))
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)
    lat = torch.randn((1, 16, 2, 8, 8), generator=g)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = dec(lat)
            got = dec.to(cuda)(lat.to(cuda)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert got.shape == (1, 3, 5, 64, 64)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_cuda_a14b_host_swap_equals_co_resident(cuda):
    """Wan2.2 A14B on the card (head_dim 128, bf16): host_swap (pinned
    host trees, one on the card at a time) equals the co-resident run bit
    for bit, twice in a row; the freed tree holds no device tensor."""
    from rectified_spaattn_tpu_torch.models import (
        WanConfig, WanDiT, init_random_weights)
    from rectified_spaattn_tpu_torch.pipelines import (Wan22A14BPipeline,
                                                       WanPipeline)
    cfg = WanConfig(hidden_dim=256, heads=2, num_blocks=2, ffn_dim=512,
                    text_dim=64)
    models = []
    for seed in (0, 1):
        g = torch.Generator(device=cuda)
        g.manual_seed(seed)
        with torch.device(cuda):
            m = WanDiT(cfg)
        models.append(init_random_weights(m.to(torch.bfloat16), g))
    g = torch.Generator(device=cuda)
    g.manual_seed(2)
    text = torch.randn((1, 32, cfg.text_dim), generator=g, device=cuda)
    neg = torch.zeros_like(text)
    kw = dict(height=192, width=240, frames=5, num_steps=4, mode="sparse",
              sa_drop_rate=0.5, p_remain_rates=0.5, warm_layers=1,
              scheduler="euler", device=cuda)
    pipes = [WanPipeline(model=m, **kw) for m in models]
    init = torch.randn((1, 16, *pipes[0].grid), generator=g, device=cuda)
    co = Wan22A14BPipeline(high=pipes[0], low=pipes[1], boundary_ratio=0.7)
    want = co(text, neg, init_latents=init)
    for m in models:
        m.to("cpu")
    swap = Wan22A14BPipeline(
        high=WanPipeline(model=models[0], defer_device=True, **kw),
        low=WanPipeline(model=models[1], defer_device=True, **kw),
        boundary_ratio=0.7, host_swap=True)
    for _ in range(2):
        got = swap(text, neg, init_latents=init)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert all(p.is_meta for p in swap.high.model.parameters())
        assert all(p.is_cuda for p in swap.low.model.parameters())
    assert all(t.is_pinned() for t in swap._host[0].values())


@pytest.mark.cuda
@pytest.mark.parametrize("group,packed,chunk_blocks", [
    (1, False, 2), (1, False, 16), (1, True, 2), (2, False, 16),
    (2, True, 16), (4, False, 2)])
def test_cuda_head_dim64_matches_plain(cuda, group, packed, chunk_blocks):
    """K1/K1s (with and without the key split), K2 (G = 2, 4) and the
    split merge at head_dim 64, the CogVideoX width, against their plain
    versions in the joint layout: visual block 4 holds 32 keys and 96 pad
    keys, the text block starts at 5 * 128, text_len 90 / 0 (a degenerate
    row whose only block is the text block of the batch with none); the
    packed K|V stream too.  K1s's o equals K1's bit for bit."""
    g = torch.Generator(device=cuda)
    g.manual_seed(64 + group + 8 * packed + chunk_blocks)
    b, h, nq, nb, d = 2, 3, 8, 6, 64
    q, k, v = (torch.randn((b, h, n * BM, d), generator=g, device=cuda
                           ).to(torch.bfloat16) for n in (nq, nb, nb))
    mask = torch.rand((b, h, nq, nb), generator=g, device=cuda) < 0.4
    mask[..., 4] = mask[..., 5] = True
    mask[1, 0, 1] = False
    mask[1, 0, 1, 5] = True                    # only the text block
    tl = torch.tensor([90, 0], dtype=torch.int32, device=cuda)
    kw = dict(visual_len=4 * BN + 32, text_start=5 * BN,
              chunk_blocks=chunk_blocks,
              packed_kv=torch.cat([k, v], dim=-1) if packed else None)
    k1 = tk.block_sparse_flash_attention.launches
    k2 = tk.block_sparse_flash_attention_grouped.launches
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
        assert tk.block_sparse_flash_attention.launches == k1 + 1
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
        assert tk.block_sparse_flash_attention_grouped.launches == k2 + 1
    assert want[1, 0, BM:2 * BM].float().abs().max() > 0.01
    torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.cuda
def test_cuda_head_dim64_windowed_dense_matches_plain(cuda):
    """K1 with full index lists at block_m 1024 and head_dim 64 (the
    CogVideoX warm calls' windowed dense): 972 visual tokens, the text at
    972 .. 972 + text_len (not block aligned), against the plain
    version."""
    from rectified_spaattn_tpu_torch.attention.modes import \
        _windowed_dense_flash
    g = torch.Generator(device=cuda)
    g.manual_seed(640)
    b, h, s, d = 2, 4, 972 + 128, 64
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=cuda
                           ).to(torch.bfloat16) for _ in range(3))
    tl = torch.tensor([128, 37], dtype=torch.int32, device=cuda)
    got = _windowed_dense_flash(q, k, v, visual_len=972, text_start=972,
                                tlen=tl)
    want = _windowed_dense_flash(q.cpu(), k.cpu(), v.cpu(), visual_len=972,
                                 text_start=972, tlen=tl.cpu())
    torch.testing.assert_close(got.float().cpu(), want.float(), **BF16)


@pytest.mark.cuda
def test_cuda_rejects_head_dim_96(cuda):
    """K1, K2, K1q and K3 take head_dim 64 or 128 on the card and raise
    otherwise (no padded launch)."""
    z = lambda d: torch.zeros((1, 1, BM, d), dtype=torch.bfloat16,
                              device=cuda)
    tl = torch.zeros(1, dtype=torch.int32, device=cuda)
    idx = torch.zeros((1, 1, 1, 1), dtype=torch.int32, device=cuda)
    cnt = torch.ones((1, 1, 1), dtype=torch.int32, device=cuda)
    kw = dict(visual_len=BN, text_start=None)
    with pytest.raises(ValueError, match="head_dim 64 or 128, got 96"):
        tk.block_sparse_flash_attention(z(96), z(96), z(96), idx, cnt, tl,
                                        **kw)
    with pytest.raises(ValueError, match="head_dim 64 or 128, got 96"):
        tk.block_sparse_flash_attention_grouped(
            z(96), z(96), z(96), idx, cnt, idx, cnt * 0, tl, group=1, **kw)
    with pytest.raises(ValueError, match="head_dim 64 or 128, got 96"):
        tk.block_sparse_flash_attention(
            z(96), z(96), z(96), idx, cnt, tl,
            kv_quant=ops.quantize_kv_blocks(z(96), z(96), BN),
            quant_mode="int8", **kw)
    with pytest.raises(ValueError, match="head_dim 64 or 128, got 96"):
        tk.dense_attention(z(96), z(96), z(96), mode="flash")


@pytest.mark.cuda
def test_cuda_flux_upscale_matches_cpu(cuda):
    """A tiny Flux upscale (head_dim 128: the kernels' width) with a
    nudged ControlNet on the GPU in bf16 (K1 / K2 on the trunk, K3 in the
    ControlNet) against the same weights on the CPU in fp32, the same
    noise; within 5 % of the output's largest value."""
    from rectified_spaattn_tpu_torch.models import (
        FluxConfig, FluxControlNet, FluxControlNetConfig, FluxDiT,
        init_controlnet_weights, init_random_weights)
    from rectified_spaattn_tpu_torch.pipelines import (FluxPipeline,
                                                       FluxUpscalePipeline)
    cfg = FluxConfig(hidden_dim=256, heads=2, num_dual_blocks=1,
                     num_single_blocks=1, text_dim=64, pooled_dim=32)
    cn_cfg = FluxControlNetConfig(hidden_dim=256, heads=2,
                                  num_dual_blocks=1, text_dim=64,
                                  pooled_dim=32)
    gen = torch.Generator().manual_seed(4)
    trunk = init_random_weights(FluxDiT(cfg), gen)
    cn = init_controlnet_weights(FluxControlNet(cn_cfg), gen, nudge=0.02)
    text = torch.randn((1, 512, 64), generator=gen)
    mask = torch.zeros((1, 512), dtype=torch.bool)
    mask[:, :9] = True
    pooled = torch.randn((1, 32), generator=gen)
    base_init = torch.randn((1, 64, 64), generator=gen)
    up_noise = torch.randn((1, 1024, 64), generator=gen)
    kw = dict(num_steps=2, sa_drop_rate=0.5, group_rows=2,
              sparse_layer_gate=(1, 2))
    outs = []
    for dev, dt in (("cpu", torch.float32), (cuda, torch.bfloat16)):
        t, c = FluxDiT(cfg), FluxControlNet(cn_cfg)
        t.load_state_dict(trunk.state_dict())
        c.load_state_dict(cn.state_dict())
        pipe = FluxUpscalePipeline(
            base=FluxPipeline(model=t.to(dt), height=128, width=128,
                              device=dev, **kw),
            up=FluxPipeline(model=t, height=512, width=512, device=dev,
                            **kw),
            controlnet=c.to(dt))
        outs.append(pipe(text, mask, pooled, base_init=base_init,
                         up_noise=up_noise).cpu())
    want, got = outs
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 0.05 * float(want.abs().max())


@pytest.mark.cuda
def test_cuda_resize_bicubic_matches_cpu(cuda):
    """The bicubic resize on CUDA tensors equals the CPU's within fp32
    rounding (TF32 off)."""
    from rectified_spaattn_tpu_torch.pipelines import resize_bicubic
    x = torch.randn((1, 3, 33, 47), generator=torch.Generator().manual_seed(2))
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = resize_bicubic(x.to(cuda), 132, 188).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    torch.testing.assert_close(got, resize_bicubic(x, 132, 188), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.cuda
def test_cuda_diff_metrics_match_cpu(cuda):
    """eval/diff_metrics.py on CUDA tensors (float64 on the card) against
    the same metrics on the CPU, at rtol 1e-10: [F,H,W,C] frames in
    [-1, 1] and an [H,W,C] image in [0, 1]."""
    from rectified_spaattn_tpu_torch.eval import diff_metrics as dm
    g = torch.Generator().manual_seed(3)
    for shape, lo in (((3, 40, 56, 3), -1.0), ((48, 64, 3), 0.0)):
        a = torch.rand(shape, generator=g, dtype=torch.float64) * (1 - lo) + lo
        b = (a + 0.05 * torch.randn(shape, generator=g, dtype=torch.float64)
             ).clamp(lo, 1.0)
        want = dm.evaluate_pair(a, b)
        got = dm.evaluate_pair(a.to(cuda), b.to(cuda))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-10), k


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["hunyuan", "wan"])
def test_cuda_scan_pipelines_equal_unrolled(cuda, family):
    """HunyuanVideo (2 + 2 blocks, int8 QLinears, G = 2, TeaCache on) and
    Wan (4 blocks, a dense and a sparse warm-gate segment) at head_dim 128
    in bf16 on the card: stacked, with dispatch_segments 1 and 2, each equal
    to the unrolled run bit for bit with the same kernel launches;
    stacking leaves the card's allocated bytes as they were (one copy of
    the weights)."""
    from rectified_spaattn_tpu_torch.models import (
        HunyuanVideoConfig, HunyuanVideoDiT, WanConfig, WanDiT,
        init_random_weights, quant, scan)
    from rectified_spaattn_tpu_torch.pipelines import (HunyuanVideoPipeline,
                                                       WanPipeline)
    counters = (tk.block_sparse_flash_attention,
                tk.block_sparse_flash_attention_grouped,
                tk.dense_flash_attention, tk.block_sparse.merge_splits)
    g = torch.Generator(device=cuda)
    g.manual_seed(5)

    def model():
        gen = torch.Generator(device=cuda)
        gen.manual_seed(0)
        with torch.device(cuda):
            m = (HunyuanVideoDiT(HunyuanVideoConfig(
                hidden_dim=256, heads=2, num_dual_blocks=2,
                num_single_blocks=2, text_dim=64, pooled_dim=32,
                num_refiner_blocks=1)) if family == "hunyuan" else
                 WanDiT(WanConfig(hidden_dim=256, heads=2, num_blocks=4,
                                  ffn_dim=512, text_dim=64)))
        m = init_random_weights(m.to(torch.bfloat16), gen)
        return (quant.quantize_model(m, bits=8, min_size=1)
                if family == "hunyuan" else m)

    if family == "hunyuan":
        kw = dict(height=128, width=128, frames=8, num_steps=3,
                  sa_drop_rate=0.5, p_remain_rates=0.5, group_rows=2,
                  enable_teacache=True, device=cuda)
        text = torch.randn((1, 256, 64), generator=g, device=cuda)
        mask = torch.zeros((1, 256), dtype=torch.bool, device=cuda)
        mask[:, :20] = True
        make = lambda m, **k: HunyuanVideoPipeline(model=m, **kw, **k)
        run = lambda p, init: p(text, mask, init_latents=init)
        lists = ("dual_blocks", "single_blocks")
    else:
        kw = dict(height=192, width=240, frames=5, num_steps=3,
                  sa_drop_rate=0.5, p_remain_rates=0.5, mode="sparse",
                  warm_layers=1, warm_last_layers=1, warm_calls=2,
                  device=cuda)
        text = torch.randn((1, 32, 64), generator=g, device=cuda)
        make = lambda m, **k: WanPipeline(model=m, **kw, **k)
        run = lambda p, init: p.denoise(init, text, torch.zeros_like(text))
        lists = ("blocks",)

    def counted(pipe, init):
        for f in counters:
            f.launches = 0
        out = run(pipe, init)
        torch.cuda.synchronize()
        return out, [f.launches for f in counters]

    ref = make(model())
    init = torch.randn((1, 16, *ref.grid), generator=g, device=cuda)
    want, launches = counted(ref, init)
    assert launches[0] > 0
    m = model()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    scan.stack_model_blocks(m, *lists)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before <= 2**20
    for k in (1, 2):
        got, got_l = counted(make(m, scan_blocks=True, dispatch_segments=k),
                             init)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert got_l == launches


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TOPP_KINDS)
@pytest.mark.parametrize("shape", [
    (1, 24, 900, 901), (1, 48, 351, 352), (1, 4, 64, 513), (1, 4, 64, 591),
    (1, 4, 64, 1803), (1, 2, 16, 3000)])
def test_cuda_topp_select_matches_plain(cuda, kind, shape):
    """P1 at the benchmark cells' probs shapes (HunyuanVideo, CogVideoX)
    and the other row lengths of the plan (Flux, Wan, the long-context
    point, one row past the warp layout), with top-k floors of 1, 4 and a
    fifth of the row (the cells' is ~0.2 and 0.15): one launch a call; the
    plain model of its order bit for bit, with its search and with the 32
    rounds as written; the plain bisection except where a row's fp64 mass
    at the cut lies within 1e-5 of p_remain."""
    p = topp_rows(kind, shape, cuda)
    for p_remain, floor in ((0.3, 1), (0.6, 4), (0.3, shape[-1] // 5)):
        before = plan_select.topp_select.launches
        got = plan_select.topp_select(p, p_remain, floor)
        torch.cuda.synchronize()
        assert plan_select.topp_select.launches == before + 1
        assert torch.equal(got, plan_select._simulate(p, p_remain, floor))
        assert torch.equal(got, plan_select._simulate(p, p_remain, floor,
                                                      snap=False))
        want = ops.topp_threshold_onehot_bisect(p, p_remain, floor)
        gaps = plan_select.cut_gaps(p, got, want, p_remain)
        assert bool((gaps <= 1e-5).all()), gaps
    before = plan_select.topp_select.launches
    assert bool(plan_select.topp_select(p, 1.0, 1).all())
    assert plan_select.topp_select.launches == before
