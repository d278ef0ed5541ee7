"""The plan's top-p / top-k selection kernel P1 (kernels/plan_select.py) on
the CPU: the wrapper is the plain bisection there, bit for bit; the plain
model of the kernel's summation order (``_simulate``) gives the plain
bisection's masks at the main path's row lengths, a row apart only where
its fp64 mass at the cut lies within 1e-5 of p_remain; the layout chosen
for each length covers the row and names a kernel the source builds; the
plan build selects through the wrapper.  The kernel itself runs in
tests/test_torch_cuda.py."""

import os
import re

import pytest
import torch

from rectified_spaattn_tpu_torch.bench.inputs import TOPP_KINDS, topp_rows
from rectified_spaattn_tpu_torch.kernels import cuda_build, plan_select
from rectified_spaattn_tpu_torch.sparse import (SparseConfig,
                                                build_sparse_plan, ops)

torch.set_num_threads(1)
# the plan's row lengths: CogVideoX, Flux, Wan (visual layout), HunyuanVideo,
# the long-context point; and one past the warp layout
NPS = (352, 513, 591, 901, 1803, 3000)


@pytest.mark.parametrize("kind", TOPP_KINDS)
@pytest.mark.parametrize("p_remain,floor", [(0.3, 1), (0.6, 3), (1.0, 1)])
def test_topp_select_on_cpu_is_the_plain_bisection(kind, p_remain, floor):
    p = topp_rows(kind, (2, 3, 6, 40))
    got = plan_select.topp_select(p, p_remain, floor)
    assert got.dtype == torch.bool and got.shape == p.shape
    assert torch.equal(got,
                       ops.topp_threshold_onehot_bisect(p, p_remain, floor))


@pytest.mark.parametrize("kind", TOPP_KINDS)
@pytest.mark.parametrize("n", NPS)
def test_kernel_model_matches_plain_bisection(kind, n):
    """The model of P1's order against the plain bisection; its search
    (bounds snapped to the row's values) against its own 32 rounds as
    written, bit for bit."""
    p = topp_rows(kind, (1, 3, 16, n))
    for p_remain, floor in ((0.3, 1), (0.6, 4), (0.3, n // 5)):
        got = plan_select._simulate(p, p_remain, floor)
        assert torch.equal(got, plan_select._simulate(p, p_remain, floor,
                                                      snap=False))
        want = ops.topp_threshold_onehot_bisect(p, p_remain, floor)
        gaps = plan_select.cut_gaps(p, got, want, p_remain)
        assert bool((gaps <= 1e-5).all()), gaps
    assert bool(plan_select._simulate(p, 1.0, 1).all())


@pytest.mark.parametrize("row", ["one_value", "all_zero", "one_hot",
                                 "floor_above_row", "tiny_mass"])
def test_kernel_search_matches_its_rounds_on_odd_rows(row):
    """Rows of probabilities at the edges of the search: one value, all
    zero (hi == lo + 1 from the start), a single 1.0 (the top of the
    range), a floor above the row's length, a tiny p_remain; the snapped
    search gives the 32 rounds' mask, and the plain bisection's."""
    g = torch.Generator().manual_seed(7)
    p = torch.rand((4, 901), generator=g) / 400
    floor, p_remain = 1, 0.3
    if row == "one_value":
        p[:] = 1.0 / 901
    elif row == "all_zero":
        p[:] = 0.0
    elif row == "one_hot":
        p[:] = 0.0
        p[:, 5] = 1.0
    elif row == "floor_above_row":
        floor = 1000
    else:
        p_remain = 1e-6
    assert torch.equal(plan_select._simulate(p, p_remain, floor),
                       plan_select._simulate(p, p_remain, floor, snap=False))
    assert torch.equal(
        plan_select._simulate(p, p_remain, floor, snap=False),
        ops.topp_threshold_onehot_bisect(p, p_remain, floor))


def test_cut_gaps_sees_a_real_difference():
    p = topp_rows("random", (4, 901))
    want = ops.topp_threshold_onehot_bisect(p, 0.3, 1)
    got = want.clone()
    got[2, int(torch.argmax(torch.where(want[2], -1.0, p[2])))] = True
    assert plan_select.cut_gaps(p, want, want, 0.3).numel() == 0
    gaps = plan_select.cut_gaps(p, got, want, 0.3)
    assert gaps.numel() == 1 and float(gaps[0]) > 1e-5


def _source_lists() -> dict:
    with open(os.path.join(cuda_build.CSRC, "plan_select.cu")) as f:
        text = f.read()
    return {name: tuple(int(v) for v in re.findall(
        r"X\((\d+)\)", re.search(
            rf"#define {name}\(X\)((?:[^\n]*\\\n)*[^\n]*)", text).group(1)))
        for name in ("RSA_WARP_VPLS", "RSA_CTA_VPLS")}


@pytest.mark.parametrize("n", NPS)
def test_layout_covers_the_row(n):
    row_warps, vpl = plan_select.layout(n)
    lanes = 32 * row_warps
    assert lanes * vpl >= n
    vpls = (plan_select.WARP_VPL if row_warps == 1 else plan_select.CTA_VPL)
    assert vpl in vpls and all(v * lanes < n for v in vpls if v < vpl)
    assert row_warps == 1 or 32 * plan_select.WARP_VPL[-1] < n
    src = _source_lists()
    assert src == {"RSA_WARP_VPLS": plan_select.WARP_VPL,
                   "RSA_CTA_VPLS": plan_select.CTA_VPL}


def test_layout_refuses_rows_past_the_cta_layout():
    top = 32 * plan_select.CTA_WARPS * plan_select.CTA_VPL[-1]
    assert plan_select.layout(top) == (plan_select.CTA_WARPS,
                                       plan_select.CTA_VPL[-1])
    with pytest.raises(ValueError):
        plan_select.layout(top + 1)


@pytest.mark.parametrize("topp_impl,calls", [("bisect", 1), ("sort", 0)])
def test_plan_selects_through_the_wrapper(monkeypatch, topp_impl, calls):
    seen = []
    real = plan_select.topp_select

    def counted(*a, **kw):
        seen.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(plan_select, "topp_select", counted)
    g = torch.Generator().manual_seed(0)
    b, h, bm, nq, d, tl = 1, 2, 16, 6, 8, 16
    q = torch.randn((b, h, nq * bm, d), generator=g)
    k = torch.randn((b, h, nq * bm + tl, d), generator=g)
    v = torch.randn((b, h, nq * bm + tl, d), generator=g)
    cfg = SparseConfig(top_k_floor=1, block_m=bm, block_n=bm, text_len=tl,
                       topp_impl=topp_impl)
    plan = build_sparse_plan(q, k, v, cfg)
    assert len(seen) == calls
    assert plan.block_mask.shape[:3] == (b, h, nq)
