"""The port's CUDA kernels K1/K2/K3 against their plain PyTorch versions, on
a CUDA GPU (bf16, 2e-2: the repo's bf16 tolerance, tests/test_kernels.py).
Marked ``cuda``; each test skips without a GPU.  This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from rectified_spaattn_tpu_torch import kernels as tk
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
@pytest.mark.parametrize("group", [1, 2, 4])
def test_cuda_kernels_match_plain(cuda, group):
    g = torch.Generator(device=cuda)
    g.manual_seed(group)
    b, h, nq, nb, d = 2, 4, 8, 12, 128
    q, k, v = (torch.randn((b, h, n * BM, d), generator=g, device=cuda
                           ).to(torch.bfloat16) for n in (nq, nb, nb))
    mask = torch.rand((b, h, nq, nb), generator=g, device=cuda) < 0.35
    mask[..., 0] = mask[..., -1] = True
    tl = torch.tensor([90, 17], dtype=torch.int32, device=cuda)
    kw = dict(visual_len=(nb - 1) * BN - 50, text_start=(nb - 1) * BN)
    if group == 1:
        idx, cnt = ops.mask_to_indices(mask)
        got = tk.block_sparse_flash_attention(q, k, v, idx, cnt, tl, **kw)
        want = tk.block_sparse_flash_attention_torch(q, k, v, idx, cnt, tl,
                                                     **kw)
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
@pytest.mark.parametrize("case", ["tails", "mask_b2", "scale_fp16",
                                  "strided"])
def test_cuda_dense_flash_matches_plain(cuda, case):
    """K3 against its plain version: Sq and Sk off the 64-row/64-key tiles,
    a kv_valid mask at B=2 with a row that has no valid key (V averaged
    over all keys), a given sm_scale in fp16, and a head-split [B,S,H,D]
    projection read and written in place."""
    g = torch.Generator(device=cuda)
    g.manual_seed(11)
    dt = torch.float16 if case == "scale_fp16" else torch.bfloat16
    b, h, sq, sk, d = (2 if case == "mask_b2" else 1), 3, 200, 257, 128
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
