"""The port's CUDA kernels K1/K2 against their plain PyTorch versions, on
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
def test_cuda_rejects_fp32(cuda):
    q = torch.zeros((1, 1, BM, 128), device=cuda)
    idx = torch.zeros((1, 1, 1, 1), dtype=torch.int32, device=cuda)
    cnt = torch.ones((1, 1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        tk.block_sparse_flash_attention(
            q, q, q, idx, cnt, torch.zeros(1, dtype=torch.int32, device=cuda),
            visual_len=BN, text_start=None)
