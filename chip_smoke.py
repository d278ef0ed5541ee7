#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py          # from the repository root, one GPU

Builds the port's CUDA kernels from rectified_spaattn_tpu_torch/csrc with
nvcc (sm_90a) and drives the HunyuanVideo sparse denoise path:

  1. device: the card's name and power limit; TF32 off.
  2. kernels: K1 (single-row gather) and K2 (grouped-row gather) against
     their plain PyTorch versions in bf16 at small shapes — random masks,
     the text window at B=2, zero-count and all-masked rows, full index
     lists with block_m 1024, K2 at G=2 and G=4 (and K2 == K1 row by row);
     max abs error <= 2e-2 and, relative to the output's own scale, max
     abs error <= 5 % of max |output| and rms error <= 2 % of its std.
  3. site: one rectified sparse-attention site at the HunyuanVideo
     operating point (115,200 visual + 256 text tokens, 24 heads x 128,
     sa_drop_rate 0.8, p_remain 0.3, the Gilbert neighbour mask of
     build_site(32, 45, 80)): plan build, group_rows 1 and 2, the windowed
     dense baseline and scaled_dot_product_attention as a yardstick, each
     timed with CUDA events; each kernel at these shapes against its plain
     version on the full inputs (the relative limits), with its bound; and
     each kernel again on inputs whose text keys carry most of the weight.
  4. pipeline: HunyuanVideoPipeline at full width (HunyuanVideoConfig()
     defaults) cut to 2 dual + 2 single blocks, 720x1280x128 frames, 3
     steps, TeaCache on, group_rows 2, seeded bf16 random weights — the
     kernels' launch counters are zeroed just before and read just after;
     then one step with the density probe on (untimed in the above); plus
     a small pipeline on the GPU (bf16) against the same one on the CPU
     (fp32).

Each phase prints one JSON line with its seconds.  Then a {"kernels": ...}
line, the nvidia-smi line, and last {"ok": true, "device": {...}}.  Any
failure exits non-zero; nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12      # H100 SXM HBM3
TOL = 2e-2                    # the repo's bf16 tolerance (tests/test_kernels.py:101)
REL_MAX, REL_RMS = 0.05, 0.02  # limits relative to the output's scale
DEV = "cuda"
# the operating point: latent grid (T', H', W') of 128x720x1280 video,
# heads, text slot, valid text tokens
SITE = dict(grid=(32, 45, 80), heads=24, head_dim=128, text_len=256, tlen=100)
# the denoise run: full-width config cut to 2 dual + 2 single blocks
PIPE = dict(cfg=dict(num_dual_blocks=2, num_single_blocks=2), height=720,
            width=1280, frames=128, steps=3)


def emit(phase: str, t0: float, **fields):
    line = {"phase": phase, "seconds": round(time.perf_counter() - t0, 3),
            **fields}
    print(json.dumps(line), flush=True)


def cuda_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def held_to_scale(name, got, want) -> dict:
    """Kernel vs plain version held to the output's own scale: max abs
    error <= REL_MAX x the largest |output| and rms error <= REL_RMS x the
    output's std.  At the operating point an output averages ~10^5 keys,
    so its values are ~1e-2 and a fixed 2e-2 could not fail."""
    diff = got.float() - want.float()
    ref = want.float()
    r = {"max_abs_err": float(diff.abs().max()),
         "rms_err": float(diff.square().mean().sqrt()),
         "ref_max_abs": float(ref.abs().max()), "ref_std": float(ref.std())}
    if not (torch.isfinite(got.float()).all()
            and r["max_abs_err"] <= REL_MAX * r["ref_max_abs"]
            and r["rms_err"] <= REL_RMS * r["ref_std"]):
        raise AssertionError(f"{name}: error beyond {REL_MAX} x max |ref| "
                             f"or {REL_RMS} x std(ref): {r}")
    return r


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------- phase 0/1 ---

def build(kernels):
    """nvcc for the CUDA kernels and g++ for the curve walker, in
    parallel; returns the kernels' ptxas resource lines."""
    from rectified_spaattn_tpu_torch.curves import native
    out = {}

    def nvcc():
        out["lib"], out["log"] = kernels.build_kernels(("-Xptxas", "-v"))

    th = threading.Thread(target=nvcc)
    th.start()
    out["walker"] = native.walker()
    th.join()
    if "lib" not in out:
        raise RuntimeError("kernel build failed (see the error above)")
    ptxas = [ln.strip() for ln in out["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    return out["walker"], ptxas


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return proc.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- phase 2 ---

def kernel_cases(kernels, ops):
    """Small bf16 cases, kernel vs plain version; returns max errors."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(
        s, generator=gen, device=dev).to(dt)
    errs = {"K1": 0.0, "K2": 0.0}
    cases = []

    def check(name, got, want, kern):
        e = max_err(got, want)
        if not (torch.isfinite(got.float()).all() and e <= TOL):
            raise AssertionError(f"{name}: max abs err {e} > {TOL}")
        errs[kern] = max(errs[kern], e)
        cases.append({"case": name, **held_to_scale(name, got, want)})

    def k1_case(name, b, h, nq, nb, d, mask, visual_len, text_start, tlen,
                block_m=128, dtype=torch.bfloat16):
        q = rnd(b, h, nq * block_m, d, dt=dtype)
        k, v = rnd(b, h, nb * 128, d, dt=dtype), rnd(b, h, nb * 128, d, dt=dtype)
        idx, cnt = ops.mask_to_indices(mask)
        tl = torch.tensor(tlen, dtype=torch.int32, device=dev)
        kw = dict(visual_len=visual_len, text_start=text_start,
                  block_m=block_m)
        got = kernels.block_sparse_flash_attention(q, k, v, idx, cnt, tl, **kw)
        want = kernels.block_sparse_flash_attention_torch(
            q, k, v, idx, cnt, tl, **kw)
        check(name, got, want, "K1")
        return q, k, v, tl

    m = torch.rand((1, 4, 16, 16), generator=gen, device=dev) < 0.4
    m[..., 0] = True
    k1_case("k1_random_masks", 1, 4, 16, 16, 128, m, 16 * 128, None, [0])
    # text window: [15 visual blocks (last 40 tokens pad) | 1 text block],
    # text_len[b] < text_len_max at B=2
    m = torch.rand((2, 4, 15, 16), generator=gen, device=dev) < 0.5
    m[..., -1] = True
    k1_case("k1_text_window_b2", 2, 4, 15, 16, 128, m, 15 * 128 - 40,
            15 * 128, [100, 37])
    # zero-count rows (exact 0) and an all-masked row with count > 0: its
    # only block is the text block of a batch whose text_len is 0
    m = torch.zeros((2, 2, 4, 5), dtype=torch.bool, device=dev)
    m[:, :, 0, :3] = True
    m[:, :, 2, 4] = True
    q, k, v, tl = k1_case("k1_zero_count_and_all_masked", 2, 2, 4, 5, 128, m,
                          4 * 128, 4 * 128, [64, 0])
    idx, cnt = ops.mask_to_indices(m)
    out = kernels.block_sparse_flash_attention(
        q, k, v, idx, cnt, tl, visual_len=4 * 128, text_start=4 * 128)
    if out[:, :, 128:256].abs().max() != 0 or out[:, :, 384:].abs().max() != 0:
        raise AssertionError("a count == 0 row is not exactly 0")
    # full index lists with block_m 1024, Sq != S (the dense baseline)
    nb = 10
    full = torch.ones((1, 4, 2, nb), dtype=torch.bool, device=dev)
    k1_case("k1_full_lists_bm1024", 1, 4, 2, nb, 128, full, 8 * 128 - 7,
            9 * 128, [50], block_m=1024)
    # the fp16 instantiation
    m = torch.rand((1, 2, 4, 6), generator=gen, device=dev) < 0.5
    m[..., 0] = True
    k1_case("k1_fp16", 1, 2, 4, 6, 128, m, 6 * 128 - 30, None, [0],
            dtype=torch.float16)

    # K2 at G = 2 and 4, against its plain version and row by row vs K1
    b, h, nq, nb, d = 1, 4, 8, 12, 128
    q, k, v = rnd(b, h, nq * 128, d), rnd(b, h, nb * 128, d), rnd(b, h, nb * 128, d)
    m = torch.rand((b, h, nq, nb), generator=gen, device=dev) < 0.35
    m[..., 0] = True
    m[..., -1] = True                      # a text block
    vis, tstart = (nb - 1) * 128 - 50, (nb - 1) * 128
    tl = torch.tensor([90], dtype=torch.int32, device=dev)
    idx1, cnt1 = ops.mask_to_indices(m)
    ref1 = kernels.block_sparse_flash_attention(
        q, k, v, idx1, cnt1, tl, visual_len=vis, text_start=tstart)
    for grp in (2, 4):
        ui, uc, rb, cl = ops.group_rows(m, grp, clean_blocks=vis // 128)
        kw = dict(group=grp, visual_len=vis, text_start=tstart)
        got = kernels.block_sparse_flash_attention_grouped(
            q, k, v, ui, uc, rb, cl, tl, **kw)
        want = kernels.block_sparse_flash_attention_grouped_torch(
            q, k, v, ui, uc, rb, cl, tl, **kw)
        check(f"k2_g{grp}", got, want, "K2")
        check(f"k2_g{grp}_vs_k1_rows", got, ref1, "K2")
    return errs, cases


# --------------------------------------------------------------- phase 3 ---

def smooth_qkv(gen, h, sv, text_len, d, h2l, grid, alpha=4.0, sigma=1.0):
    """Spatially smooth q/k/v (a shared low-frequency field over the
    latent grid plus per-token noise, in curve order): the regime real
    checkpoints run in, where pooled attention concentrates (bench.py's
    smooth_inputs, in torch)."""
    dev = h2l.device
    lt, lh, lw = grid
    lin = h2l.long()
    coords = torch.stack([lin // (lh * lw) / lt, lin // lw % lh / lh,
                          lin % lw / lw], dim=-1).float()
    nfreq = 16
    w = torch.randn((3, nfreq), generator=gen, device=dev) * 3.0
    phase = torch.rand((nfreq,), generator=gen, device=dev) * 2 * torch.pi
    proj = coords @ w + phase
    basis = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
    mix = torch.randn((h, 2 * nfreq, d), generator=gen, device=dev) \
        / (2 * nfreq) ** 0.5
    field = torch.nn.functional.pad(
        torch.einsum("sf,hfd->hsd", basis, mix), (0, 0, 0, text_len))
    return tuple(
        (alpha * field + sigma * torch.randn(field.shape, generator=gen,
                                             device=dev))[None].to(
            torch.bfloat16) for _ in range(3))


def site_phase(kernels, ops, regime: str):
    """The attention site at the operating point on "random" (iid) or
    "smooth" inputs; returns timings and, per kernel at these (the main
    path's) shapes, its time and bound — on random inputs also its plain
    version on the full inputs, the dense baseline and the SDPA yardstick."""
    from rectified_spaattn_tpu_torch.attention import (
        attention, kv_validity, rectified_sparse_attention)
    from rectified_spaattn_tpu_torch.pipelines import build_site
    from rectified_spaattn_tpu_torch.sparse import build_sparse_plan

    dev = torch.device(DEV)
    full = regime == "random"
    b, h, d, text_len = 1, SITE["heads"], SITE["head_dim"], SITE["text_len"]
    site, _, h2l = build_site(*SITE["grid"], sa_drop_rate=0.8, p_remain=0.3,
                              layout="joint", text_len=text_len, device=dev)
    sv = site.visual_len                      # 115,200 (900 blocks)
    s = sv + text_len
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    if full:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev
                               ).to(torch.bfloat16) for _ in range(3))
    else:
        q, k, v = smooth_qkv(gen, h, sv, text_len, d, h2l, SITE["grid"])
    tlen = torch.tensor([SITE["tlen"]], dtype=torch.int32, device=dev)
    cfg1 = site.cfg
    cfg2 = dataclasses.replace(cfg1, group_rows=2)
    nbr = site.neighbor_mask
    res = {"regime": regime}
    kern = {}        # per kernel at these shapes, printed on lines of its own

    def site_call(cfg, **kw):
        return rectified_sparse_attention(q, k, v, cfg, nbr, visual_len=sv,
                                          text_len_rt=tlen, **kw)

    def launches_of(fn):
        k1, k2 = (kernels.block_sparse_flash_attention,
                  kernels.block_sparse_flash_attention_grouped)
        k1.launches = k2.launches = 0
        fn()
        return {"K1": k1.launches, "K2": k2.launches}

    res["plan_ms"] = cuda_ms(lambda: site_call(cfg1, density_only=True))
    res["density"] = float(site_call(cfg1, density_only=True))
    res["sparse_g1_ms"] = cuda_ms(lambda: site_call(cfg1))
    res["sparse_g2_ms"] = cuda_ms(lambda: site_call(cfg2))
    res["launches_per_call"] = {"sparse_g1": launches_of(
        lambda: site_call(cfg1)), "sparse_g2": launches_of(
        lambda: site_call(cfg2))}
    out2 = site_call(cfg2)
    if out2.shape != q.shape or not torch.isfinite(out2.float()).all():
        raise AssertionError("site output is not finite of shape q.shape")
    del out2
    valid = kv_validity(b, s, sv, sv, tlen, device=dev)
    amask = valid[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if full:
        dense = lambda: attention(q, k, v, "flash", cfg=cfg1, visual_len=sv,
                                  text_len_rt=tlen)
        res["dense_ms"] = cuda_ms(dense, reps=2)
        res["launches_per_call"]["dense"] = launches_of(dense)
        res["sdpa_dense_ms"] = cuda_ms(
            lambda: sdpa(q, k, v, attn_mask=amask), reps=2)

    # the kernels' own inputs, as rectified_sparse_attention builds them
    zero = torch.zeros((), dtype=q.dtype, device=dev)
    kz = torch.where(valid[:, None, :, None], k, zero)
    vz = torch.where(valid[:, None, :, None], v, zero)
    text_valid = torch.arange(text_len, device=dev)[None, :] < tlen[:, None]
    q_vis, q_txt = q[:, :, :sv], q[:, :, sv:]
    plan = build_sparse_plan(q_vis, kz, vz, cfg1, neighbor_mask=nbr,
                             text_valid=text_valid)
    nbt = s // 128
    pairs = float(plan.counts.sum())           # (row block, key block) pairs
    res["pairs"] = pairs
    kv_bytes = lambda blocks: 2 * blocks * 128 * d * 2
    # K/V blocks some visual row lists, per head: the bytes K1/K2 must read
    used = torch.zeros((b * h, nbt), dtype=torch.int32, device=dev)
    used.scatter_add_(1, plan.indices.reshape(b * h, -1).long(),
                      (torch.arange(plan.indices.shape[-1], device=dev)
                       < plan.counts[..., None]).reshape(b * h, -1).int())
    vis_kv_blocks = float((used > 0).sum())
    qo_bytes = lambda rows: 2 * b * h * rows * d * 2
    flops_pair = lambda rows: 4.0 * rows * 128 * d
    idx_bytes = lambda *ts: sum(t.numel() * 4 for t in ts)
    kw = dict(visual_len=sv, text_start=sv)

    def measure(name, kern_fn, plain_fn, flops, nbytes, library=None):
        got = kern_fn()
        r = {}
        if full:
            t_plain = time.perf_counter()
            want = plain_fn()
            torch.cuda.synchronize()
            r["plain_ms"] = (time.perf_counter() - t_plain) * 1e3
            r.update(held_to_scale(name, got, want))
            del want
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: output is not finite")
        del got
        torch.cuda.empty_cache()
        r["bound_ms"], r["bound_by"] = bound_ms(flops, nbytes)
        r["ms"] = cuda_ms(kern_fn)
        r["library_ms"] = cuda_ms(library, reps=2) if library else None
        r["roofline_share"] = r["bound_ms"] / r["ms"]
        kern[name] = r
        print(json.dumps({"kernel_at_site": name, "regime": regime, **r}),
              flush=True)

    # K2, visual rows at group_rows 2 (the pipeline's visual job); the
    # bound counts each row block's own (member) pairs
    ui, uc, rb, cl = ops.group_rows(plan.block_mask, 2,
                                    clean_blocks=sv // 128)
    # union slots per own slot: the work a kernel computing every union
    # tile would do, relative to the plan (K2 skips non-member tiles)
    res["k2_union_growth"] = float(uc.sum()) * 2 / pairs
    g2 = dict(group=2, **kw)
    measure("K2_visual_g2",
            lambda: kernels.block_sparse_flash_attention_grouped(
                q_vis, kz, vz, ui, uc, rb, cl, tlen, **g2),
            # group_rows' clean prefix is exact: the wrapper's clamp keeps it
            lambda: kernels.block_sparse_flash_attention_grouped_torch(
                q_vis, kz, vz, ui, uc, rb, cl, tlen, **g2),
            flops=pairs * flops_pair(128),
            nbytes=qo_bytes(sv) + kv_bytes(vis_kv_blocks)
            + idx_bytes(ui, uc, rb, cl))
    # K1, visual rows at group_rows 1
    measure("K1_visual_g1",
            lambda: kernels.block_sparse_flash_attention(
                q_vis, kz, vz, plan.indices, plan.counts, tlen, **kw),
            lambda: kernels.block_sparse_flash_attention_torch(
                q_vis, kz, vz, plan.indices, plan.counts, tlen, **kw),
            flops=pairs * flops_pair(128),
            nbytes=qo_bytes(sv) + kv_bytes(vis_kv_blocks)
            + idx_bytes(plan.indices, plan.counts))
    if not full:
        return res, kern
    # K1, text rows with full index lists (the pipeline's text job)
    nt = text_len // 128
    fidx = torch.arange(nbt, dtype=torch.int32, device=dev).expand(
        b, h, nt, nbt)
    fcnt = torch.full((b, h, nt), nbt, dtype=torch.int32, device=dev)
    measure("K1_text_rows",
            lambda: kernels.block_sparse_flash_attention(
                q_txt, kz, vz, fidx, fcnt, tlen, **kw),
            lambda: kernels.block_sparse_flash_attention_torch(
                q_txt, kz, vz, fidx, fcnt, tlen, **kw),
            flops=b * h * nt * nbt * flops_pair(128),
            nbytes=qo_bytes(text_len) + kv_bytes(b * h * nbt)
            + idx_bytes(fidx, fcnt),
            library=lambda: sdpa(q_txt, k, v, attn_mask=amask))
    # K1, the windowed dense baseline (full lists, block_m 1024)
    nqd = -(-s // 1024)
    qd = torch.nn.functional.pad(q, (0, 0, 0, nqd * 1024 - s))
    didx = torch.arange(nbt, dtype=torch.int32, device=dev).expand(
        b, h, nqd, nbt)
    dcnt = torch.full((b, h, nqd), nbt, dtype=torch.int32, device=dev)
    dkw = dict(block_m=1024, **kw)
    measure("K1_dense_bm1024",
            lambda: kernels.block_sparse_flash_attention(
                qd, k, v, didx, dcnt, tlen, **dkw),
            lambda: kernels.block_sparse_flash_attention_torch(
                qd, k, v, didx, dcnt, tlen, **dkw),
            flops=b * h * nqd * nbt * flops_pair(1024),
            nbytes=qo_bytes(nqd * 1024) + kv_bytes(b * h * nbt)
            + idx_bytes(didx, dcnt),
            library=lambda: sdpa(q, k, v, attn_mask=amask))
    res["text_weighted"] = text_weighted_checks(
        kernels, q, k, v, (plan.indices, plan.counts), (ui, uc, rb, cl),
        (fidx, fcnt), tlen, gen, kw)
    return res, kern


def text_weighted_checks(kernels, q, k, v, k1_lists, k2_lists, text_lists,
                         tlen, gen, kw, heads: int = 2):
    """Each kernel at the operating point's shapes on inputs whose text
    keys carry most of the softmax weight, against its plain version.

    A direction u per head is added to every query and to every key of
    the text slot (valid or padding), scaled so that a text key scores
    about GAP above the rest, and only TLEN text tokens are valid: those
    few keys then hold most of the weight.  K/V are not zeroed at the
    padding, so a kernel that gets the text window wrong, even by one
    token at either end, moves the output far past the limits; with iid
    inputs 100 text keys among 10^5 hardly move it.  The visual rows run
    on ``heads`` heads to keep the plain version short."""
    gap, tlen_w = 11.0, 7
    sv = kw["visual_len"]
    d = q.shape[-1]
    tlen = torch.full_like(tlen, tlen_w)
    u = torch.randn((1, q.shape[1], 1, d), generator=gen, device=q.device)
    u = (gap * d ** 0.5) ** 0.5 * u / u.norm(dim=-1, keepdim=True)
    qp = (q.float() + u).to(q.dtype)
    kp = k.clone()
    kp[:, :, sv:] = (k[:, :, sv:].float() + u).to(k.dtype)
    # softmax weight on the valid text keys, text rows, head 0
    sc = (qp[0, 0, sv:].float() @ kp[0, 0].float().T) / d ** 0.5
    valid = torch.arange(kp.shape[2], device=q.device) < sv + tlen_w
    w = torch.softmax(sc.masked_fill(~valid, -torch.inf), dim=-1)
    out = {"text_len": tlen_w,
           "text_weight_share": float(w[:, sv:].sum(-1).mean())}
    del sc, w
    hs = slice(0, heads)
    ui, uc, rb, cl = (t[:, hs] for t in k2_lists)
    idx, cnt = (t[:, hs] for t in k1_lists)
    qv, kv, vv = qp[:, hs, :sv], kp[:, hs], v[:, hs]
    g2 = dict(group=2, **kw)
    cases = {
        "K1_text_rows": (
            lambda: kernels.block_sparse_flash_attention(
                qp[:, :, sv:], kp, v, *text_lists, tlen, **kw),
            lambda: kernels.block_sparse_flash_attention_torch(
                qp[:, :, sv:], kp, v, *text_lists, tlen, **kw)),
        "K1_visual_g1": (
            lambda: kernels.block_sparse_flash_attention(
                qv, kv, vv, idx, cnt, tlen, **kw),
            lambda: kernels.block_sparse_flash_attention_torch(
                qv, kv, vv, idx, cnt, tlen, **kw)),
        "K2_visual_g2": (
            lambda: kernels.block_sparse_flash_attention_grouped(
                qv, kv, vv, ui, uc, rb, cl, tlen, **g2),
            lambda: kernels.block_sparse_flash_attention_grouped_torch(
                qv, kv, vv, ui, uc, rb, cl, tlen, **g2)),
    }
    for name, (kern_fn, plain_fn) in cases.items():
        out[name] = held_to_scale(f"{name} (text-weighted)", kern_fn(),
                                  plain_fn())
    return out


# --------------------------------------------------------------- phase 4 ---

def pipeline_phase(kernels):
    from rectified_spaattn_tpu_torch.cli.generate import _random_text
    from rectified_spaattn_tpu_torch.models import (
        HunyuanVideoConfig, HunyuanVideoDiT, init_random_weights)
    from rectified_spaattn_tpu_torch.pipelines import HunyuanVideoPipeline

    dev = torch.device(DEV)
    cfg = HunyuanVideoConfig(**PIPE["cfg"])
    with torch.device(dev):
        model = HunyuanVideoDiT(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = init_random_weights(model.to(torch.bfloat16), gen)
    pipe = HunyuanVideoPipeline(
        model=model, height=PIPE["height"], width=PIPE["width"],
        frames=PIPE["frames"], num_steps=PIPE["steps"],
        sa_drop_rate=0.8, p_remain_rates=0.3, mode="sparse",
        enable_teacache=True, rel_l1_thresh=0.15, group_rows=2, device=dev)
    text, mask = _random_text("several hot air balloons flying over a city.",
                              256, cfg.text_dim, device=dev)
    noise = torch.Generator(device=dev)
    noise.manual_seed(42)
    torch.cuda.reset_peak_memory_stats()
    k1, k2 = (kernels.block_sparse_flash_attention,
              kernels.block_sparse_flash_attention_grouped)
    k1.launches = k2.launches = 0
    out = pipe(text, mask, generator=noise)
    launches = {"K1": k1.launches, "K2": k2.launches}
    torch.cuda.synchronize()
    if out.shape != (1, cfg.in_channels, *pipe.grid):
        raise AssertionError(f"pipeline output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError("pipeline output is not finite")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel did not run on the main path: "
                             f"{launches}")
    computed = pipe.teacache_stats["computed"]
    res = {"launches": launches, "step_seconds": pipe.step_seconds,
           "denoise_seconds": pipe.denoise_seconds,
           "teacache": pipe.teacache_stats,
           "teacache_decisions": pipe.teacache.decisions,
           "visual_tokens": pipe.site.visual_len,
           "launches_per_computed_step": {
               n: c / computed for n, c in launches.items()},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    res["profiled_step"] = profile_step(pipe, text, mask)
    # block 0's mask density, from one more step with the probe on (the
    # CLI's --density; kept out of the timed steps above)
    pipe.density_probe = True
    pipe(text, mask, generator=noise, num_steps=1)
    res["block0_density"] = pipe.density_samples
    res["step_seconds_with_probe"] = pipe.step_seconds
    return res


def profile_step(pipe, text, mask, top: int = 12):
    """One computed denoise step under torch.profiler: device time by
    kernel name and the device's idle share of the step's wall clock."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(43)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe(text, mask, generator=gen, num_steps=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    # device-side events only (kernels, copies): the CPU-side operator
    # events carry the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e3
    rows = sorted(events, key=dev_us, reverse=True)[:top]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3) if busy else None,
            "top": [{"name": e.key[:80], "ms": dev_us(e) / 1e3,
                     "calls": e.count} for e in rows]}


def small_pipeline_check():
    """A small pipeline (head_dim 128, one block of each kind) on the GPU
    in bf16 against the same weights on the CPU in fp32."""
    from rectified_spaattn_tpu_torch.models import (
        HunyuanVideoConfig, HunyuanVideoDiT, init_random_weights)
    from rectified_spaattn_tpu_torch.pipelines import HunyuanVideoPipeline

    cfg = HunyuanVideoConfig(hidden_dim=256, heads=2, num_dual_blocks=1,
                             num_single_blocks=1, text_dim=64, pooled_dim=32,
                             num_refiner_blocks=1)
    gen = torch.Generator()
    gen.manual_seed(3)
    ref = init_random_weights(HunyuanVideoDiT(cfg), gen)
    gpu = HunyuanVideoDiT(cfg)
    gpu.load_state_dict(ref.state_dict())
    gpu = gpu.to(torch.bfloat16)
    text = torch.randn((1, 256, cfg.text_dim), generator=gen)
    mask = torch.zeros((1, 256), dtype=torch.bool)
    mask[:, :20] = True
    kw = dict(height=128, width=128, frames=8, num_steps=3, sa_drop_rate=0.5,
              p_remain_rates=0.5, group_rows=2)
    p_cpu = HunyuanVideoPipeline(model=ref, device="cpu", **kw)
    init = torch.randn((1, cfg.in_channels, *p_cpu.grid), generator=gen)
    want = p_cpu(text, mask, init_latents=init)
    got = HunyuanVideoPipeline(model=gpu, device=DEV, **kw)(
        text, mask, init_latents=init).cpu()
    err = max_err(got, want)
    scale = float(want.abs().max())
    if not err <= 0.05 * scale:
        raise AssertionError(f"small pipeline GPU vs CPU: {err} > 5% of "
                             f"{scale}")
    return {"max_abs_err": err, "ref_max_abs": scale}


# ------------------------------------------------------------------ main ---

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from rectified_spaattn_tpu_torch import kernels
    from rectified_spaattn_tpu_torch.sparse import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    t0 = time.perf_counter()
    walker, ptxas = build(kernels)
    emit("build", t0, curve_walker=walker, ptxas=ptxas)

    t0 = time.perf_counter()
    emit("device", t0, name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    errs, cases = kernel_cases(kernels, ops)
    emit("kernels_vs_plain", t0, tolerance=TOL, max_abs_err=errs, cases=cases)

    sites = {}
    for regime in ("random", "smooth"):
        t0 = time.perf_counter()
        res, sites[regime] = site_phase(kernels, ops, regime)
        emit(f"site_{regime}", t0, **res)
    site, smooth = sites["random"], sites["smooth"]

    t0 = time.perf_counter()
    small = small_pipeline_check()
    emit("small_pipeline_gpu_vs_cpu", t0, **small)

    t0 = time.perf_counter()
    pipe = pipeline_phase(kernels)
    emit("pipeline", t0, **pipe)

    src = "rectified_spaattn_tpu_torch/csrc/block_sparse.cu"
    k1, k2, k1t = (site["K1_visual_g1"], site["K2_visual_g2"],
                   site["K1_text_rows"])
    line = {"kernels": [
        {"name": "K1", "route": "cuda", "source": src,
         "replaces": "rectified_spaattn_tpu/kernels/block_sparse.py:89",
         "launches": pipe["launches"]["K1"],
         "max_abs_err": max(errs["K1"], k1t["max_abs_err"]),
         "ms": k1t["ms"], "plain_ms": k1t["plain_ms"],
         "bound_ms": k1t["bound_ms"], "bound_by": k1t["bound_by"],
         "library_ms": k1t["library_ms"],
         "shape": "text rows: q [1,24,256,128] x full lists over 902 blocks",
         "other_jobs": {"visual_rows_g1": k1,
                        "visual_rows_g1_smooth": smooth["K1_visual_g1"],
                        "dense_bm1024": site["K1_dense_bm1024"]}},
        {"name": "K2", "route": "cuda", "source": src,
         "replaces": "rectified_spaattn_tpu/kernels/block_sparse.py:317",
         "launches": pipe["launches"]["K2"],
         "max_abs_err": max(errs["K2"], k2["max_abs_err"]),
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None,
         "shape": "visual rows: q [1,24,115200,128], G=2 union lists",
         "other_jobs": {"visual_rows_g2_smooth": smooth["K2_visual_g2"]}},
    ]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
