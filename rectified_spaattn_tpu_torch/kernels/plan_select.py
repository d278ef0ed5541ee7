"""The sparse plan's top-p / top-k threshold selection: kernel P1 and its
plain PyTorch model.

  P1   ``topp_select``  the plan's selection under ``topp_impl == "bisect"``
       (sparse/pipeline.py::_plan_rows), the function of
       ``sparse/ops.py::topp_threshold_onehot_bisect`` (the JAX package's
       rectified_spaattn_tpu/sparse/ops.py, in XLA operations there): the
       32-round bisection of each row's threshold on the fp32 bit pattern,
       in one launch over every row.

The kernel is hand-written CUDA C++ in ``csrc/plan_select.cu`` (its header
gives the design and what bounds it on the H100), built with nvcc at first
use into its own library and loaded with ctypes (kernels/cuda_build.py).
A CPU tensor returns ``ops.topp_threshold_onehot_bisect`` unchanged — the
tests' path; a CUDA tensor launches P1 or raises; nothing falls back.
``topp_select.launches`` counts its launches.

P1 computes the same function as the plain bisection on rows of
probabilities (0 <= p <= 1, as the plan's softmax gives; it does not check
them), with one difference in arithmetic: each round's mass is an fp32 sum in the kernel's own fixed
order, not ``torch.sum``'s.  ``_simulate`` repeats that order in plain
PyTorch, bit for bit, so a row's mask can differ from the plain
bisection's only where the mass at some round lies within fp32 rounding of
``p_remain``.  ``layout`` picks how a row is spread over threads from its
length alone; the kernel and ``_simulate`` both take its choice.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..sparse import ops
from . import cuda_build

ROUNDS = 32
# the values a thread holds, by layout (csrc/plan_select.cu's
# RSA_WARP_VPLS and RSA_CTA_VPLS name the same lists)
# (powers of two, and 12 and 20 for CogVideoX's 352 and Flux's / Wan's
# ~513-640 columns)
WARP_VPL = (1, 2, 4, 8, 12, 16, 20, 32, 64)
CTA_VPL = (8, 16, 32, 64)
CTA_WARPS = 16      # warps a row in the cta layout (csrc CTA_WARPS)


def _declare(lib):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.rsa_topp_select_launch.argtypes = [p, p, ll, i, f, i, i, i, p]
    lib.rsa_topp_select_launch.restype = i


def layout(n_cols: int) -> tuple[int, int]:
    """(row_warps, vpl) for rows of ``n_cols`` floats: one warp a row
    (row_warps 1) while ``vpl`` = ceil(n_cols / 32) values a lane fit the
    registers, else one CTA of ``CTA_WARPS`` warps a row; ``vpl`` is the
    smallest of the layout's list that covers the row."""
    for row_warps, vpls in ((1, WARP_VPL), (CTA_WARPS, CTA_VPL)):
        need = -(-n_cols // (32 * row_warps))
        for vpl in vpls:
            if vpl >= need:
                return row_warps, vpl
    raise ValueError(f"rows of {n_cols} columns exceed the selection "
                     f"kernel's {32 * CTA_WARPS * CTA_VPL[-1]}")


def _min_count(top_k_floor) -> int:
    return math.ceil(max(top_k_floor, 1))


def _simulate(probs: torch.Tensor, p_remain: float, top_k_floor: int,
              snap: bool = True) -> torch.Tensor:
    """P1's arithmetic in plain PyTorch: thread l of a row holds columns
    l, l + lanes, ... (``layout``), adds its selected values in that order,
    a warp's 32 sums meet in a halving tree (the xor-shuffle butterfly's
    result) and, in the cta layout, the warps' sums in another.  With
    ``snap`` (the kernel's search) a row moves lo up to its least kept
    value after a pass and hi down past its largest value not kept after a
    failure, and stops at hi == lo + 1 (csrc/plan_select.cu gives why that
    is the 32 rounds' lo on rows of probabilities); without it every row
    runs the 32 rounds as written."""
    if p_remain >= 1.0:
        return torch.ones(probs.shape, dtype=torch.bool, device=probs.device)
    n = probs.shape[-1]
    pf = probs.float().reshape(-1, n)
    rows = pf.shape[0]
    row_warps, vpl = layout(n)
    lanes = 32 * row_warps
    x = F.pad(pf, (0, lanes * vpl - n), value=-math.inf).reshape(
        rows, vpl, lanes)
    xb = x.view(torch.int32)
    lo = torch.clamp(pf.amin(dim=-1), min=0.0).view(torch.int32)
    hi = pf.amax(dim=-1).view(torch.int32) + 1
    dev = pf.device
    pr = torch.tensor(p_remain, dtype=torch.float32, device=dev)
    floor = _min_count(top_k_floor)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    i32 = torch.iinfo(torch.int32)
    for _ in range(ROUNDS):
        mid = (lo + hi) >> 1                    # int32: < 2^31 for p <= 1
        ge = x >= mid.view(torch.float32)[:, None, None]
        s = torch.zeros((rows, lanes), dtype=torch.float32, device=dev)
        for i in range(vpl):
            s = s + torch.where(ge[:, i], x[:, i], zero)
        s = s.reshape(rows, row_warps, 32)
        for off in (16, 8, 4, 2, 1):
            s = s[..., :off] + s[..., off:2 * off]
        s = s[..., 0]
        off = row_warps // 2
        while off:
            s = s[:, :off] + s[:, off:2 * off]
            off //= 2
        ok = (s[:, 0] > pr) & (ge.sum(dim=(1, 2)) >= floor)
        bmin = torch.where(ge, xb, i32.max).amin(dim=(1, 2))
        bmax = torch.where(ge, i32.min, xb).amax(dim=(1, 2))
        if snap:
            live = hi - lo > 1
            new_lo = torch.where(ok, bmin, lo)
            new_hi = torch.where(ok, hi, torch.maximum(bmax, lo) + 1)
            lo = torch.where(live, new_lo, lo)
            hi = torch.where(live, new_hi, hi)
        else:
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return (pf >= lo.view(torch.float32)[:, None]).reshape(probs.shape)


def cut_gaps(probs: torch.Tensor, got: torch.Tensor, want: torch.Tensor,
             p_remain: float) -> torch.Tensor:
    """For each row whose two selections differ, |fp64 mass kept by the
    tighter of the two masks - p_remain|: near 0 where the two sums' orders
    rounded a round's mass to opposite sides of ``p_remain``, the only way
    two bisections of one row can part.  Empty where every row agrees."""
    n = probs.shape[-1]
    got, want = got.reshape(-1, n), want.reshape(-1, n)
    rows = (got != want).any(dim=-1)
    p = probs.reshape(-1, n)[rows].double()
    g, w = got[rows], want[rows]
    tight = torch.where((g.sum(-1) <= w.sum(-1))[:, None], g, w)
    return (torch.where(tight, p, 0.0).sum(-1) - p_remain).abs()


def topp_select(probs: torch.Tensor, p_remain: float,
                top_k_floor: int) -> torch.Tensor:
    """Top-p / top-k block selection: keep = probs >= t*, t* the largest
    threshold whose kept mass exceeds ``p_remain`` with at least
    ``top_k_floor`` (and 1) columns kept, found by 32 halvings of the fp32
    bit pattern; ties at the cut are kept.  probs [..., NP] of values in
    [0, 1] (fp32; other float types are converted) → bool [..., NP]."""
    if probs.device.type == "cpu":
        return ops.topp_threshold_onehot_bisect(probs, p_remain, top_k_floor)
    if probs.device.type != "cuda":
        raise ValueError(f"unsupported device {probs.device}")
    if p_remain >= 1.0:
        return torch.ones(probs.shape, dtype=torch.bool, device=probs.device)
    pf = probs.float().contiguous()
    out = torch.empty(probs.shape, dtype=torch.bool, device=probs.device)
    n = probs.shape[-1]
    if not out.numel():
        return out
    row_warps, vpl = layout(n)
    lib = cuda_build.load("plan_select", _declare)
    rc = lib.rsa_topp_select_launch(
        pf.data_ptr(), out.data_ptr(), pf.numel() // n, n, float(p_remain),
        _min_count(top_k_floor), vpl, row_warps,
        torch.cuda.current_stream(probs.device).cuda_stream)
    if rc:
        raise RuntimeError(
            f"P1 launch failed: {lib.rsa_error_string(rc).decode()}")
    topp_select.launches += 1
    return out


topp_select.launches = 0
