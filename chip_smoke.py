#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py          # from the repository root, one GPU
                                   # (more cards add the multi_gpu phase)

Builds the port's CUDA kernels from rectified_spaattn_tpu_torch/csrc with
nvcc (sm_90a, one nvcc per source, all started together) and drives the
HunyuanVideo sparse denoise path, its int8 serving levers (K1q, S1, int8 /
int4 weights, the int8 offloaded TeaCache residual), the Wan2.1-14B
denoise path, the multi-device path (K1s, the ring, tensor parallelism)
and the kernel-diagnostic path (K1q-s, the S3 / S2 ablations, the
headline bench).  Every attention kernel (K1/K1s, K2, K1q/K1q-s, K3)
and every S3 / S2 ablation run on the Hopper mainloop of
csrc/hopper_attn.cuh (K1q with a converter warpgroup and, for "mxu8",
the int8 wgmma; S3 and S2 as K1's and K2's policies with one part taken
out or changed), and S1 on its CTA, TMA copies and wgmma shapes; K1's
launches of fewer row tiles than SMs split each index list into key
ranges that the merge kernel folds:

  0. build: per library each kernel's ptxas registers and spill bytes,
     and its SASS counts (HGMMA / IGMMA, HMMA / IMMA, FSEL, BRA, UTMALDG):
     S1's int8 kernel on IGMMA and its bf16 kernel on HGMMA, both with
     TMA loads, and no kernel with HMMA or IMMA.
  1. device: the card's name and power limit; TF32 off.
  2. kernels: K1 (single-row gather), K2 (grouped-row gather) and K3
     (dense flash) against their plain PyTorch versions in bf16 at small
     shapes — random masks, the text window at B=2, zero-count and
     all-masked rows, degenerate rows (every gathered key masked, count >
     0: V averaged over the chunk's lanes) at chunk_blocks 2 and 16 for K1
     and K2, full index lists with block_m 1024, the key split at 16 row
     tiles (a degenerate list and the text window among them), K2 at G=2
     and G=4 (and K2 == K1 row by row); K3 with Sq and Sk off its tiles, 512
     and 257 keys, a kv_valid mask at B=2 with a row of no valid key, a
     given sm_scale; max abs error <= 2e-2 and, relative to the output's
     own scale, max abs error <= 5 % of max |output| and rms error <= 2 %
     of its std.  Then K1q ("int8" and "mxu8") against its plain version:
     random masks, the text window at B=2, zero-count and all-masked rows,
     a clean prefix followed by text blocks, chunk_blocks 2, 16 and 24.
  3. site: one rectified sparse-attention site at the HunyuanVideo
     operating point (115,200 visual + 256 text tokens, 24 heads x 128,
     sa_drop_rate 0.8, p_remain 0.3, the Gilbert neighbour mask of
     build_site(32, 45, 80)): plan build, group_rows 1 and 2 (K2 also at
     G = 4 on the same plan), the windowed
     dense baseline and scaled_dot_product_attention as a yardstick, each
     timed with CUDA events; each kernel at these shapes against its plain
     version on the full inputs (the relative limits), with its bound (the
     merge kernel at the text rows' split on seeded partials); and
     each kernel again on inputs whose text keys carry most of the weight.
     K1q in both modes on the same plan at the site's chunk_blocks (24):
     quantize_kv_blocks ms, K1q ms against bf16 K1's, its error against
     bf16 K1, and (random inputs) its plain version.
  4. pipeline: HunyuanVideoPipeline at full width (HunyuanVideoConfig()
     defaults) cut to 2 dual + 2 single blocks, 720x1280x128 frames, 3
     steps, TeaCache on, group_rows 2, seeded bf16 random weights — the
     kernels' launch counters (the merge kernel's too: the text rows
     split) are zeroed just before and read just after;
     then one step with the density probe on (untimed in the above); plus
     a small pipeline on the GPU (bf16) against the same one on the CPU
     (fp32).
  4b. int8: S1 (bf16 and int8 looped dots on the mainloop's TMA and
     wgmma shapes, int8 bit for bit against its plain version, rates
     against the peaks, at most 1.05 of them, torch.bmm / torch._int_mm as
     yardsticks for the same operations: 64 calls of one dot a pair); a
     small pipeline on the GPU (bf16) against the CPU (fp32)
     with int4 weights, K1q "int8" and the int8 residual; then the
     full-width 2+2-block HunyuanVideo pipeline with int8 weights, K1q
     "mxu8" and the int8 TeaCache residual held in pinned host memory
     (a replayed schedule computes, skips, computes) — weight bytes and
     peak memory against the bf16 pipeline.
  5. Wan site: the self-attention site at the Wan2.1-14B operating point
     (75,600 visual tokens padded once to 75,648, 40 heads x 128, visual
     layout with first-frame retention, sa_drop_rate 0.75, p_remain 0.3)
     on random and smooth inputs: plan, K1 at G=1 with its plain version
     at full shape; on random inputs the windowed dense K1 of the warm
     layers against SDPA with the same key mask, and K3 at the T2V text
     cross shape (512 keys) and the I2V image cross shape (257 keys)
     against its plain version and SDPA.
  6. Wan pipeline: a small sparse Wan pipeline on the GPU (bf16) against
     the CPU (fp32); then WanPipeline at full width (WanConfig()) cut to 4
     blocks, 720x1280x81 frames, 3 UniPC steps under CFG, TeaCache on,
     warm_calls 2 (step 1 dense, steps 2-3 sparse past the 2 warm layers),
     seeded bf16 random weights — the launch counters and the sparse plans
     built are zeroed just before and read just after; then one sparse
     step under the profiler.
  6b. k1q_stats: K1q-s (K1q with m and l) in both modes against its plain
     version at small shapes (o equal to K1q's bit for bit, m / l as
     k1s_vs_plain holds them); at the Hunyuan site (both regimes) its time
     beside K1q's and, random inputs, both modes against their plain
     versions on the full inputs.
  7. k1s_vs_plain: K1s (K1 with the row max m and sum l) in bf16 against
     its plain version at small shapes — random masks, the text window at
     B=2, count-0 rows (m == -inf and l == 0 exactly), degenerate rows at
     chunk_blocks 2 and 16, packed_kv, the key split; o held as K1 is and
     equal to K1's bit for bit, m within M_TOL absolute, l within L_REL
     relative.
  8. ring_hunyuan: the ring at the Hunyuan site point (115,200 visual + 256
     text tokens, 100 valid), sp = 4 through the in-process group on this
     one card, on random and smooth inputs — K1s's launch counter zeroed
     just before and read just after; the visual and text outputs against
     the single-device site (K1, group_rows 1, the ring's sort-based
     top-p) within the relative limits; the mask entries that differ from
     the single-device plan; the composed plan_row_chunk + kv_packed ring
     against the plain ring; one ring step's visual-row and text-row K1s
     against the plain version on the full inputs, with bound, plain ms
     and (text rows) the flash-attention call that returns the log-sum-exp
     (held to m + log l); the ring's total ms beside the site's.
  9. ring_wan: the Wan site at 75,648 tokens, sp = 3, visual layout with
     first-frame retention, against the single-device site with the same
     visual_len (the visual ring takes every token as valid).
 10. kernelvars: every S3 variant (S3a with 2 and 3 ring stages,
     twophase, runs1/2/4) against its plain version at the 8 x 24 x 32
     grid; then bench.kernelvars at the Hunyuan point (the realistic_qkv
     plan, chunk 16; launch counters zeroed just before and read just
     after), base held to K1 there, twophase equal to base and runs* to
     K1 bit for bit, S3c's pieces per list; every variant but
     the three-stage rings against its plain version on
     that plan, the load-only variants bit for bit, noexp's NaN rows, the
     three-stage rings equal to the two-stage ones; per variant its time
     against K1's on the same plan (K1 timed first and last), the bytes it
     gathers (GB/s) or its TF/s.
 11. groupedvars: every S2 variant at G = 2 and 4 against its plain
     version at the small grid; bench.groupedvars at the Hunyuan point
     (counters as above; K2 timed first and last on the same lists; full
     and prefetch held to K1's single-row output); full, nobias, compute
     and computeclean at G = 2 and full at G = 4 against their plain
     versions on its plan, dma bit for bit, full and prefetch equal to K2
     bit for bit.
 12. headline: bench.headline's JSON line (the sparse site against the
     windowed dense, bench.py's keys).
 12b. kernel_ab: kernel_ab.py on this tree: K1 (visual, text rows, the
     Hunyuan and Wan windowed dense), K2, K1q, K1s (a ring step's text
     rows) and K3 (both Wan cross shapes), each beside the SDPA call on
     the same inputs.
 13. multi_gpu, with two or more cards: one process per card (up to 4) on
     NCCL runs the Hunyuan ring of phase 8 (random inputs), held against
     its in-process output; two run the full-width 2+2-block Hunyuan
     pipeline at tp = 2, held against phase 4's output, with per-rank
     weight bytes and peak memory.  With one card it prints a "skipped"
     line and goes on.

Each phase prints one JSON line with its seconds.  Then a {"kernels": ...}
line, the nvidia-smi line, and last {"ok": true, "device": {...}}.  Any
failure exits non-zero; nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import threading
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12       # H100 SXM dense int8 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12      # H100 SXM HBM3
TOL = 2e-2                    # the repo's bf16 tolerance (tests/test_kernels.py:101)
REL_MAX, REL_RMS = 0.05, 0.02  # limits relative to the output's scale
M_TOL, L_REL = 2e-2, 0.01     # K1s's row max (absolute) and row sum (relative)
DEV = "cuda"
# the operating point: latent grid (T', H', W') of 128x720x1280 video,
# heads, text slot, valid text tokens
SITE = dict(grid=(32, 45, 80), heads=24, head_dim=128, text_len=256, tlen=100)
# the denoise run: full-width config cut to 2 dual + 2 single blocks
PIPE = dict(cfg=dict(num_dual_blocks=2, num_single_blocks=2), height=720,
            width=1280, frames=128, steps=3)
# the Wan2.1-14B operating point: latent grid (T', H', W') of 81x720x1280
# video, heads, the text and CLIP-image context lengths of the cross
# attention
WAN_SITE = dict(grid=(21, 45, 80), heads=40, head_dim=128, text_len=512,
                image_len=257)
# the Wan denoise run: WanConfig() cut from 40 to 4 blocks; warm_calls 2
# makes step 1 dense and steps 2-3 sparse (past the 2 warm layers)
WAN_PIPE = dict(cfg=dict(num_blocks=4), height=720, width=1280, frames=81,
                steps=3, warm_layers=2, warm_calls=2)
# the ring's sequence-parallel ways: 900 Hunyuan blocks over 4 ranks, 591
# Wan blocks over 3
RING_SP = dict(hunyuan=4, wan=3)


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


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------- phase 0/1 ---

def build(kernels):
    """nvcc for each CUDA source (all started together) and g++ for the
    curve walker, in parallel; returns the walker and, per library, each
    kernel's ptxas registers and spill bytes and (the mainloop kernels)
    its SASS counts."""
    from rectified_spaattn_tpu_torch.curves import native
    out = {}

    def nvcc():
        out["libs"] = kernels.build_kernels(("-Xptxas", "-v"))

    th = threading.Thread(target=nvcc)
    th.start()
    out["walker"] = native.walker()
    th.join()
    if "libs" not in out:
        raise RuntimeError("kernel build failed (see the error above)")
    ptxas = {name: ptxas_table(log) for name, (_, log) in out["libs"].items()}
    ptxas["sass"] = {name: sass_counts(lib)
                     for name, (lib, _) in out["libs"].items()}
    check_sass(ptxas["sass"])
    return out["walker"], ptxas


def kernel_name(mangled: str) -> str:
    """A kernel's mangled name without the anonymous namespace's prefix,
    which carries a hash of its file: the same kernel keeps its name
    across trees."""
    return re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", mangled)


def ptxas_table(log: str) -> dict:
    """ptxas -v's lines as {kernel: {"registers", "spill_stores"}}."""
    table, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = kernel_name(m.group(1))
            table[fn] = {}
        elif fn and "spill stores" in ln:
            table[fn]["spill_stores"] = int(
                re.search(r"(\d+) bytes spill stores", ln).group(1))
        elif fn and "Used" in ln and "registers" in ln:
            table[fn]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    return table


def sass_counts(lib: str) -> dict:
    """Per kernel of a built library (hopper_attn_kernel: K1/K1s, K2, K3,
    the S3 / S2 policies; hopper_attn_q_kernel: K1q/K1q-s; loop_kernel:
    S1; the merge kernel), its count of SASS branches (BRA), selects
    (FSEL), wgmma instructions (HGMMA: bf16 / fp16, IGMMA: int8), warp-level
    mma.sync (HMMA, IMMA) and TMA tile loads (UTMALDG: the boxes the code
    issues, q's among them), read with cuobjdump: the mask is branch-free
    when its 64 scores a thread show up as 64 FSEL and the kernel's
    branches do not grow with them.  "sha1": a digest of the kernel's
    instruction text, equal for the same code in two trees."""
    from rectified_spaattn_tpu_torch.kernels import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True)
    if proc.returncode:
        return {"cuobjdump": proc.stderr.strip()[:200]}
    counts, digests, fn = {}, {}, None
    for ln in proc.stdout.splitlines():
        if "Function :" in ln:
            fn = kernel_name(ln.split("Function :")[1].strip())
            counts[fn] = {"BRA": 0, "FSEL": 0, "HGMMA": 0, "IGMMA": 0,
                          "HMMA": 0, "IMMA": 0, "UTMALDG": 0}
            digests[fn] = hashlib.sha1()
        elif fn and "*/" in ln:
            text = ln.split("*/", 1)[1].split("/*")[0].strip()
            digests[fn].update(text.encode())
            ops = text.split()
            if ops and ops[0].startswith("@"):
                ops = ops[1:]
            op = ops[0].split(".")[0] if ops else ""
            if op in counts[fn]:
                counts[fn][op] += 1
    for fn, d in digests.items():
        counts[fn]["sha1"] = d.hexdigest()[:12]
    return counts


def check_sass(sass: dict) -> None:
    """S1's int8 kernel runs IGMMA and its bf16 kernel HGMMA, both fed by
    TMA (UTMALDG), and no kernel of any library has a warp-level mma
    (HMMA / IMMA)."""
    failed = {lib: c["cuobjdump"] for lib, c in sass.items()
              if "cuobjdump" in c}
    if failed:
        raise AssertionError(f"SASS not read: {failed}")
    s1 = {k: c for k, c in sass["int8_probe"].items() if "loop_kernel" in k}
    [i8] = [c for k, c in s1.items() if "ILb1E" in k]
    [b16] = [c for k, c in s1.items() if "ILb0E" in k]
    bad = [f"S1 {t}: {c}" for t, c, op in (("int8", i8, "IGMMA"),
                                             ("bf16", b16, "HGMMA"))
           if not (c[op] and c["UTMALDG"])]
    bad += [f"{lib}: {k} has {c['HMMA']} HMMA, {c['IMMA']} IMMA"
            for lib, table in sass.items() for k, c in table.items()
            if c["HMMA"] or c["IMMA"]]
    if bad:
        raise AssertionError("SASS: " + "; ".join(bad))


def tma_loads(counts: dict, policy: str) -> int:
    """UTMALDG instructions in the SASS of the bf16 hopper_attn_kernel
    whose policy's mangled name holds ``policy`` (one of sass_counts'
    tables), or None where cuobjdump failed."""
    if "cuobjdump" in counts:
        return None
    [n] = [c["UTMALDG"] for k, c in counts.items()
           if "hopper_attn_kernelI13__nv_bfloat16" in k and policy in k]
    return n


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
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    cases = []

    def check(name, got, want, kern):
        e = max_err(got, want)
        if not (torch.isfinite(got.float()).all() and e <= TOL):
            raise AssertionError(f"{name}: max abs err {e} > {TOL}")
        errs[kern] = max(errs[kern], e)
        cases.append({"case": name, **held_to_scale(name, got, want)})

    def k1_case(name, b, h, nq, nb, d, mask, visual_len, text_start, tlen,
                block_m=128, dtype=torch.bfloat16, **extra):
        q = rnd(b, h, nq * block_m, d, dt=dtype)
        k, v = rnd(b, h, nb * 128, d, dt=dtype), rnd(b, h, nb * 128, d, dt=dtype)
        idx, cnt = ops.mask_to_indices(mask)
        tl = torch.tensor(tlen, dtype=torch.int32, device=dev)
        kw = dict(visual_len=visual_len, text_start=text_start,
                  block_m=block_m, **extra)
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
    # degenerate rows: a row whose only block is the text block of a batch
    # with text_len 0 averages V over its chunk's lanes, padding included
    m = torch.rand((2, 2, 4, 6), generator=gen, device=dev) < 0.5
    m[..., 0] = True
    m[1, 0, 1] = False
    m[1, 0, 1, 5] = True
    for cb in (2, 16):
        k1_case(f"k1_degenerate_chunk{cb}", 2, 2, 4, 6, 128, m, 5 * 128 - 20,
                5 * 128, [60, 0], chunk_blocks=cb)
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
    # the key split: 16 row tiles over lists of 10 chunks (merged by the
    # merge kernel), the text window, a degenerate list (batch 1's text)
    m = torch.rand((2, 4, 2, 40), generator=gen, device=dev) < 0.5
    m[..., -1] = True
    m[1, 2, 1] = False
    m[1, 2, 1, -1] = True
    merges = kernels.block_sparse.merge_splits.launches
    k1_case("k1_split_short_rows", 2, 4, 2, 40, 128, m, 39 * 128 - 40,
            39 * 128, [90, 0], chunk_blocks=4)
    if kernels.block_sparse.merge_splits.launches != merges + 1:
        raise AssertionError("k1_split_short_rows did not split")

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
    # K2 degenerate rows: a row block with no block of its own in a G=2
    # union averages V over the union's lanes
    m2 = m.clone()
    m2[0, 1, 2] = False
    ui, uc, rb, cl = ops.group_rows(m2, 2, clean_blocks=vis // 128)
    for cb in (2, 16):
        kw = dict(group=2, visual_len=vis, text_start=tstart, chunk_blocks=cb)
        check(f"k2_g2_degenerate_chunk{cb}",
              kernels.block_sparse_flash_attention_grouped(
                  q, k, v, ui, uc, rb, cl, tl, **kw),
              kernels.block_sparse_flash_attention_grouped_torch(
                  q, k, v, ui, uc, rb, cl, tl, **kw), "K2")

    # K3: rows and keys off the 64-row / 64-key tiles, Wan's 512 text and
    # 257 image keys, a kv_valid mask at B=2 with a row of no valid key
    # (V averaged over all keys), a given sm_scale
    def k3_case(name, b, h, sq, sk, valid=None, sm_scale=None):
        q, k, v = rnd(b, h, sq, 128), rnd(b, h, sk, 128), rnd(b, h, sk, 128)
        got = kernels.dense_attention(q, k, v, valid, mode="flash",
                                      sm_scale=sm_scale)
        want = kernels.flash._vanilla_attention(q, k, v, valid, sm_scale)
        check(name, got, want, "K3")
        return got, v

    k3_case("k3_sq200_sk130", 1, 3, 200, 130)
    k3_case("k3_sk512", 1, 4, 256, 512)
    k3_case("k3_sk257_no_mask", 1, 4, 333, 257)
    valid = torch.rand((2, 257), generator=gen, device=dev) < 0.6
    valid[1] = False
    got, v = k3_case("k3_mask_b2_no_valid_row", 2, 2, 100, 257, valid)
    e = max_err(got[1], v[1].float().mean(1, keepdim=True).expand_as(got[1]))
    if e > TOL:
        raise AssertionError(f"K3 row with no valid key: {e} from the mean")
    k3_case("k3_sm_scale", 1, 2, 130, 512, sm_scale=0.03)
    return errs, cases


def k1q_cases(kernels, ops):
    """K1q in both modes against its plain version on small bf16 cases;
    returns max errors per mode and the cases."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16)
    errs = {"int8": 0.0, "mxu8": 0.0}
    cases = []

    def case(name, b, h, nq, nb, mask, visual_len, text_start, tlen):
        q, k, v = rnd(b, h, nq * 128, 128), rnd(b, h, nb * 128, 128), \
            rnd(b, h, nb * 128, 128)
        tl = torch.tensor(tlen, dtype=torch.int32, device=dev)
        payload = ops.quantize_kv_blocks(k, v, 128)
        idx, cnt = ops.mask_to_indices(mask)
        for cb in (2, 16, 24):
            for mode in ("int8", "mxu8"):
                kw = dict(visual_len=visual_len, text_start=text_start,
                          chunk_blocks=cb, kv_quant=payload, quant_mode=mode)
                got = kernels.block_sparse_flash_attention(
                    q, k, v, idx, cnt, tl, **kw)
                want = kernels.block_sparse_flash_attention_torch(
                    q, k, v, idx, cnt, tl, **kw)
                full = f"{name}_chunk{cb}_{mode}"
                e = max_err(got, want)
                if not (torch.isfinite(got.float()).all() and e <= TOL):
                    raise AssertionError(f"{full}: max abs err {e} > {TOL}")
                zero = (cnt == 0).repeat_interleave(128, dim=2)
                if zero.any() and got[zero].abs().max() != 0:
                    raise AssertionError(f"{full}: a count == 0 row is not 0")
                errs[mode] = max(errs[mode], e)
                cases.append({"case": full, **held_to_scale(full, got, want)})

    m = torch.rand((1, 4, 16, 16), generator=gen, device=dev) < 0.4
    m[..., 0] = True
    case("k1q_random_masks", 1, 4, 16, 16, m, 16 * 128, None, [0])
    m = torch.rand((2, 4, 15, 16), generator=gen, device=dev) < 0.5
    m[..., -1] = True
    case("k1q_text_window_b2", 2, 4, 15, 16, m, 15 * 128 - 40, 15 * 128,
         [100, 37])
    m = torch.zeros((2, 2, 4, 5), dtype=torch.bool, device=dev)
    m[:, :, 0, :3] = True
    m[:, :, 2, 4] = True
    case("k1q_zero_count_and_all_masked", 2, 2, 4, 5, m, 4 * 128, 4 * 128,
         [64, 0])
    # a clean prefix of 10 visual blocks, then a padded boundary block and
    # the text blocks: chunk_blocks 2 splits it into clean and tail chunks
    m = torch.zeros((1, 2, 4, 14), dtype=torch.bool, device=dev)
    m[..., :11] = True
    m[..., 12:] = True
    case("k1q_clean_prefix", 1, 2, 4, 14, m, 11 * 128 - 60, 12 * 128, [150])
    return errs, cases


# --------------------------------------------------------------- phase 3 ---

def measure(kern, name, regime, check: bool, kern_fn, plain_fn, flops,
            nbytes, library=None, peak=PEAK_BF16_FLOPS):
    """One kernel at the main path's shapes: with ``check``, its plain
    version on the same inputs (time and the relative limits); then its
    CUDA-event time, its bound and, where one PyTorch call computes the
    same function, that call's time.  Stores the result in ``kern[name]``
    and prints it on a kernel_at_site line."""
    got = kern_fn()
    r = {}
    if check:
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
    r["bound_ms"], r["bound_by"] = bound_ms(flops, nbytes, peak)
    r["ms"] = cuda_ms(kern_fn)
    r["library_ms"] = cuda_ms(library, reps=2) if library else None
    r["roofline_share"] = r["bound_ms"] / r["ms"]
    kern[name] = r
    print(json.dumps({"kernel_at_site": name, "regime": regime, **r}),
          flush=True)


def site_inputs(regime: str) -> dict:
    """The site's inputs at the operating point on "random" (iid, seed 7)
    or "smooth" q/k/v: the site, its text length, the key validity, K and
    V zeroed off it as rectified_sparse_attention zeroes them, and the
    single-row plan (``gen`` goes on drawing text-weighted inputs).  Uses
    only entry points every slice of the port has, so kernel_ab.py builds
    the same inputs for an older tree's package."""
    from rectified_spaattn_tpu_torch.attention import kv_validity
    from rectified_spaattn_tpu_torch.pipelines import build_site
    from rectified_spaattn_tpu_torch.sparse import build_sparse_plan

    dev = torch.device(DEV)
    b, h, d, text_len = 1, SITE["heads"], SITE["head_dim"], SITE["text_len"]
    site, _, h2l = build_site(*SITE["grid"], sa_drop_rate=0.8, p_remain=0.3,
                              layout="joint", text_len=text_len, device=dev)
    sv = site.visual_len                      # 115,200 (900 blocks)
    s = sv + text_len
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    if regime == "random":
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev
                               ).to(torch.bfloat16) for _ in range(3))
    else:
        from rectified_spaattn_tpu_torch.bench.inputs import smooth_qkv
        q, k, v = smooth_qkv(gen, h, text_len, d, h2l, SITE["grid"])
    tlen = torch.tensor([SITE["tlen"]], dtype=torch.int32, device=dev)
    valid = kv_validity(b, s, sv, sv, tlen, device=dev)
    zero = torch.zeros((), dtype=q.dtype, device=dev)
    kz = torch.where(valid[:, None, :, None], k, zero)
    vz = torch.where(valid[:, None, :, None], v, zero)
    text_valid = torch.arange(text_len, device=dev)[None, :] < tlen[:, None]
    plan = build_sparse_plan(q[:, :, :sv], kz, vz, site.cfg,
                             neighbor_mask=site.neighbor_mask,
                             text_valid=text_valid)
    return dict(site=site, gen=gen, q=q, k=k, v=v, tlen=tlen, valid=valid,
                kz=kz, vz=vz, plan=plan)


def site_phase(kernels, ops, regime: str):
    """The attention site at the operating point on "random" (iid) or
    "smooth" inputs; returns timings and, per kernel at these (the main
    path's) shapes, its time and bound — on random inputs also its plain
    version on the full inputs, the dense baseline and the SDPA yardstick."""
    from rectified_spaattn_tpu_torch.attention import (
        attention, rectified_sparse_attention)

    dev = torch.device(DEV)
    full = regime == "random"
    b, h, d, text_len = 1, SITE["heads"], SITE["head_dim"], SITE["text_len"]
    st = site_inputs(regime)
    site, gen, q, k, v, tlen, valid, kz, vz, plan = (
        st[n] for n in ("site", "gen", "q", "k", "v", "tlen", "valid", "kz",
                        "vz", "plan"))
    sv = site.visual_len
    s = sv + text_len
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
    amask = valid[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if full:
        dense = lambda: attention(q, k, v, "flash", cfg=cfg1, visual_len=sv,
                                  text_len_rt=tlen)
        res["dense_ms"] = cuda_ms(dense, reps=2)
        res["launches_per_call"]["dense"] = launches_of(dense)
        res["sdpa_dense_ms"] = cuda_ms(
            lambda: sdpa(q, k, v, attn_mask=amask), reps=2)

    # the kernels' own inputs (site_inputs' kz, vz and plan)
    q_vis, q_txt = q[:, :, :sv], q[:, :, sv:]
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

    # K2, visual rows at group_rows 2 (the pipeline's visual job); the
    # bound counts each row block's own (member) pairs
    ui, uc, rb, cl = ops.group_rows(plan.block_mask, 2,
                                    clean_blocks=sv // 128)
    # union slots per own slot: the work a kernel computing every union
    # tile would do, relative to the plan (K2 skips non-member tiles)
    res["k2_union_growth"] = float(uc.sum()) * 2 / pairs
    g2 = dict(group=2, **kw)
    measure(kern, "K2_visual_g2", regime, full,
            lambda: kernels.block_sparse_flash_attention_grouped(
                q_vis, kz, vz, ui, uc, rb, cl, tlen, **g2),
            # group_rows' clean prefix is exact: the wrapper's clamp keeps it
            lambda: kernels.block_sparse_flash_attention_grouped_torch(
                q_vis, kz, vz, ui, uc, rb, cl, tlen, **g2),
            flops=pairs * flops_pair(128),
            nbytes=qo_bytes(sv) + kv_bytes(vis_kv_blocks)
            + idx_bytes(ui, uc, rb, cl))
    # K2 at G = 4 on the same plan (a row block's member slots in a union
    # of four)
    ui4, uc4, rb4, cl4 = ops.group_rows(plan.block_mask, 4,
                                        clean_blocks=sv // 128)
    g4 = dict(group=4, **kw)
    measure(kern, "K2_visual_g4", regime, full,
            lambda: kernels.block_sparse_flash_attention_grouped(
                q_vis, kz, vz, ui4, uc4, rb4, cl4, tlen, **g4),
            lambda: kernels.block_sparse_flash_attention_grouped_torch(
                q_vis, kz, vz, ui4, uc4, rb4, cl4, tlen, **g4),
            flops=pairs * flops_pair(128),
            nbytes=qo_bytes(sv) + kv_bytes(vis_kv_blocks)
            + idx_bytes(ui4, uc4, rb4, cl4))
    del ui4, uc4, rb4, cl4
    # K1, visual rows at group_rows 1
    measure(kern, "K1_visual_g1", regime, full,
            lambda: kernels.block_sparse_flash_attention(
                q_vis, kz, vz, plan.indices, plan.counts, tlen, **kw),
            lambda: kernels.block_sparse_flash_attention_torch(
                q_vis, kz, vz, plan.indices, plan.counts, tlen, **kw),
            flops=pairs * flops_pair(128),
            nbytes=qo_bytes(sv) + kv_bytes(vis_kv_blocks)
            + idx_bytes(plan.indices, plan.counts))
    # lists whose every listed key is masked (K1's second pass runs only
    # for them)
    valid_blk = valid[0].reshape(nbt, 128).any(dim=1)
    slot = torch.arange(plan.indices.shape[-1], device=dev)
    live = (slot < plan.counts[..., None]) & valid_blk[plan.indices.long()]
    res["degenerate_lists"] = int(((plan.counts > 0)
                                   & ~live.any(dim=-1)).sum())
    del live
    # K1q, both modes, on the same plan at the site's chunk_blocks
    ref = kernels.block_sparse_flash_attention(
        q_vis, kz, vz, plan.indices, plan.counts, tlen, **kw)
    qkw = dict(chunk_blocks=cfg1.kernel_chunk_blocks, **kw)
    res["k1q_chunk_blocks"] = qkw["chunk_blocks"]
    k1q_bytes = (qo_bytes(sv) + kv_bytes(vis_kv_blocks) / 2
                 + 2 * b * h * nbt * 4 + idx_bytes(plan.indices, plan.counts))
    for mode in ("int8", "mxu8"):
        k1q_at_site(kernels, ops, kern, mode, regime, full, ref,
                    (q_vis, kz, vz, plan.indices, plan.counts, tlen), qkw,
                    flops=pairs * flops_pair(128), nbytes=k1q_bytes)
    del ref
    # K1q-s (K1q with the row stats) on the same inputs, launches counted
    # from here
    for mode in ("int8", "mxu8"):
        k1q_stats_at_site(kernels, ops, kern, mode, regime, full,
                          (q_vis, kz, vz, plan.indices, plan.counts, tlen),
                          qkw, flops=pairs * flops_pair(128),
                          nbytes=k1q_bytes + 2 * b * h * sv * 4)
    torch.cuda.empty_cache()
    if not full:
        return res, kern
    # K1, text rows with full index lists (the pipeline's text job)
    nt = text_len // 128
    fidx = torch.arange(nbt, dtype=torch.int32, device=dev).expand(
        b, h, nt, nbt)
    fcnt = torch.full((b, h, nt), nbt, dtype=torch.int32, device=dev)
    measure(kern, "K1_text_rows", regime, full,
            lambda: kernels.block_sparse_flash_attention(
                q_txt, kz, vz, fidx, fcnt, tlen, **kw),
            lambda: kernels.block_sparse_flash_attention_torch(
                q_txt, kz, vz, fidx, fcnt, tlen, **kw),
            flops=b * h * nt * nbt * flops_pair(128),
            nbytes=qo_bytes(text_len) + kv_bytes(b * h * nbt)
            + idx_bytes(fidx, fcnt),
            library=lambda: sdpa(q_txt, k, v, attn_mask=amask))
    merge_at_site(kernels, kern, regime, b * h * nt, fidx.shape[-1])
    # K1, the windowed dense baseline (full lists, block_m 1024)
    nqd = -(-s // 1024)
    qd = torch.nn.functional.pad(q, (0, 0, 0, nqd * 1024 - s))
    didx = torch.arange(nbt, dtype=torch.int32, device=dev).expand(
        b, h, nqd, nbt)
    dcnt = torch.full((b, h, nqd), nbt, dtype=torch.int32, device=dev)
    dkw = dict(block_m=1024, **kw)
    measure(kern, "K1_dense_bm1024", regime, full,
            lambda: kernels.block_sparse_flash_attention(
                qd, k, v, didx, dcnt, tlen, **dkw),
            lambda: kernels.block_sparse_flash_attention_torch(
                qd, k, v, didx, dcnt, tlen, **dkw),
            flops=b * h * nqd * nbt * flops_pair(1024),
            nbytes=qo_bytes(nqd * 1024) + kv_bytes(b * h * nbt)
            + idx_bytes(didx, dcnt),
            library=lambda: sdpa(q, k, v, attn_mask=amask))
    res["text_weighted"] = text_weighted_checks(
        kernels, ops, q, k, v, (plan.indices, plan.counts), (ui, uc, rb, cl),
        (fidx, fcnt), tlen, gen, kw, cfg1.kernel_chunk_blocks)
    return res, kern


def merge_at_site(kernels, kern, regime, tiles, nb_slots):
    """The key split's merge kernel at the shape of the text rows' split
    (the ranges _split_plan gives their launch on this card), on seeded
    partials, against its plain version (``_merge_splits``); bound: the
    partials read once, o and the stats written once."""
    bs = kernels.block_sparse
    n, _ = bs._split_plan(tiles, nb_slots, 16, torch.cuda.get_device_properties(
        0).multi_processor_count)
    rows, d = tiles * 128, SITE["head_dim"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(99)
    o_p = torch.randn((n, rows, d), generator=gen, device=DEV)
    m_p = torch.randn((n, rows), generator=gen, device=DEV)
    l_p = torch.rand((n, rows), generator=gen, device=DEV) * 100 + 1
    m_p[0, :64], l_p[0, :64] = -torch.inf, 0.0       # an empty range
    args = (o_p, m_p, l_p, torch.bfloat16)
    got = bs.merge_splits(*args, return_stats=True)
    t0 = time.perf_counter()
    want = bs._merge_splits(list(o_p), list(m_p), list(l_p))
    torch.cuda.synchronize()
    r = {"plain_ms": (time.perf_counter() - t0) * 1e3, "n_split": n,
         **held_to_scale("K1 split merge", got[0], want[0].to(torch.bfloat16))}
    r["m_max_abs_err"] = max_err(got[1], want[1])
    r["l_max_rel_err"] = float(((got[2] - want[2]).abs() / want[2]).max())
    if not (r["max_abs_err"] <= TOL and r["m_max_abs_err"] == 0
            and r["l_max_rel_err"] <= 1e-4):
        raise AssertionError(f"K1 split merge vs its plain version: {r}")
    r["bound_ms"], r["bound_by"] = bound_ms(
        0.0, n * rows * (d + 2) * 4 + rows * (d * 2 + 8))
    r["ms"] = cuda_ms(lambda: bs.merge_splits(*args, return_stats=True),
                      reps=20)
    r["library_ms"] = None
    r["roofline_share"] = r["bound_ms"] / r["ms"]
    kern["K1_merge"] = r
    print(json.dumps({"kernel_at_site": "K1_merge", "regime": regime, **r}),
          flush=True)


def k1q_at_site(kernels, ops, kern, mode, regime, check, ref, args, qkw,
                flops, nbytes):
    """K1q in one mode at the site: the payload's build time, the kernel
    against its plain version (``check``) and its bound ("int8" by bf16
    operations, "mxu8" by int8 operations), and its output against bf16
    K1's on the same plan."""
    q_vis, kz, vz = args[:3]
    quantize = lambda: ops.quantize_kv_blocks(kz, vz, 128)
    quantize_ms = cuda_ms(quantize)
    payload = quantize()
    kkw = dict(kv_quant=payload, quant_mode=mode, **qkw)
    name = f"K1q_{mode}_visual"
    measure(kern, name, regime, check,
            lambda: kernels.block_sparse_flash_attention(*args, **kkw),
            lambda: kernels.block_sparse_flash_attention_torch(*args, **kkw),
            flops=flops, nbytes=nbytes,
            peak=PEAK_INT8_OPS if mode == "mxu8" else PEAK_BF16_FLOPS)
    got = kernels.block_sparse_flash_attention(*args, **kkw)
    diff = got.float() - ref.float()
    kern[name].update({
        "quantize_kv_ms": quantize_ms,
        "vs_bf16_k1": {"max_abs_err": float(diff.abs().max()),
                       "rel_max": float(diff.abs().max()
                                        / ref.float().abs().max()),
                       "rel_rms": float(diff.square().mean().sqrt()
                                        / ref.float().std())}})
    print(json.dumps({"kernel_at_site_vs_bf16": name, "regime": regime,
                      **kern[name]["vs_bf16_k1"]}), flush=True)
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: output is not finite")


def k1q_stats_at_site(kernels, ops, kern, mode, regime, check, args, qkw,
                      flops, nbytes):
    """K1q-s in one mode at the site: its o against K1q's bit for bit, m
    and l finite where a list has blocks, and (``check``) o, m and l
    against the plain version on the full inputs as check_k1s holds
    them; its time beside K1q's, measured just before."""
    k1 = kernels.block_sparse_flash_attention
    kkw = dict(kv_quant=ops.quantize_kv_blocks(args[1], args[2], 128),
               quant_mode=mode, **qkw)
    name = f"K1q-s_{mode}_visual"
    before = dict(k1.quant_stats_launches)
    o, m, l = k1(*args, return_stats=True, **kkw)
    if not torch.equal(o, k1(*args, **kkw)):
        raise AssertionError(f"{name}: o differs from K1q's")
    live = (args[4] > 0).repeat_interleave(128, dim=2)
    if not (torch.isfinite(m[live]).all() and torch.isfinite(l[live]).all()
            and bool((m[~live] == -torch.inf).all())
            and bool((l[~live] == 0).all())):
        raise AssertionError(f"{name}: m / l not finite on live rows, or "
                             "a count-0 row with m != -inf or l != 0")
    r = {}
    if check:
        t_plain = time.perf_counter()
        want = kernels.block_sparse_flash_attention_torch(
            *args, return_stats=True, **kkw)
        torch.cuda.synchronize()
        r["plain_ms"] = (time.perf_counter() - t_plain) * 1e3
        r.update(check_k1s(name, (o, m, l), want, args[4]))
        del want
    del o, m, l
    torch.cuda.empty_cache()
    r["bound_ms"], r["bound_by"] = bound_ms(
        flops, nbytes, PEAK_INT8_OPS if mode == "mxu8" else PEAK_BF16_FLOPS)
    r["ms"] = cuda_ms(lambda: k1(*args, return_stats=True, **kkw))
    r["k1q_ms"] = kern[f"K1q_{mode}_visual"]["ms"]
    r["stats_cost"] = r["ms"] / r["k1q_ms"] - 1.0
    r["library_ms"] = None
    r["roofline_share"] = r["bound_ms"] / r["ms"]
    r["launches"] = (k1.quant_stats_launches[mode] - before[mode])
    kern[name] = r
    print(json.dumps({"kernel_at_site": name, "regime": regime, **r}),
          flush=True)


def text_weighted_checks(kernels, ops, q, k, v, k1_lists, k2_lists,
                         text_lists, tlen, gen, kw, chunk_blocks,
                         heads: int = 2):
    """Each kernel at the operating point's shapes on inputs whose text
    keys carry most of the softmax weight, against its plain version.

    A direction u per head is added to every query and to every key of
    the text slot (valid or padding), scaled so that a text key scores
    about GAP above the rest, and only TLEN text tokens are valid: those
    few keys then hold most of the weight.  K/V are not zeroed at the
    padding, so a kernel that gets the text window wrong, even by one
    token at either end, moves the output far past the limits; with iid
    inputs 100 text keys among 10^5 hardly move it.  The visual rows run
    on ``heads`` heads to keep the plain version short; K1q (both modes)
    takes the int8 payload of these K/V."""
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
    payload = ops.quantize_kv_blocks(kv, vv, 128)
    qkw = {m: dict(chunk_blocks=chunk_blocks, kv_quant=payload, quant_mode=m,
                   **kw) for m in ("int8", "mxu8")}
    cases = {
        **{f"K1q_{m}_visual": (
            lambda m=m: kernels.block_sparse_flash_attention(
                qv, kv, vv, idx, cnt, tlen, **qkw[m]),
            lambda m=m: kernels.block_sparse_flash_attention_torch(
                qv, kv, vv, idx, cnt, tlen, **qkw[m]))
           for m in ("int8", "mxu8")},
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
    kerns = {"K1": kernels.block_sparse_flash_attention,
             "K2": kernels.block_sparse_flash_attention_grouped,
             "K3": kernels.dense_flash_attention,
             "K1_merge": kernels.block_sparse.merge_splits}
    for f in kerns.values():
        f.launches = 0
    out = pipe(text, mask, generator=noise)
    launches = {n: f.launches for n, f in kerns.items()}
    torch.cuda.synchronize()
    if out.shape != (1, cfg.in_channels, *pipe.grid):
        raise AssertionError(f"pipeline output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError("pipeline output is not finite")
    # K1 and K2 are this path's kernels, K1's text rows split and merged;
    # K3 is not on it
    if min(launches["K1"], launches["K2"], launches["K1_merge"]) == 0 \
            or launches["K3"]:
        raise AssertionError(f"unexpected launches on the HunyuanVideo "
                             f"path: {launches}")
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
    return res, out.cpu()


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


def small_pipeline_check(quant_bits: int = 0, **pipe_kw):
    """A small pipeline (head_dim 128, one block of each kind) on the GPU
    in bf16 against the same weights on the CPU in fp32; with
    ``quant_bits`` both run the same quantized weights, and ``pipe_kw``
    sets pipeline options (K1q, the TeaCache residual) on both."""
    from rectified_spaattn_tpu_torch.models import (
        HunyuanVideoConfig, HunyuanVideoDiT, init_random_weights, quant)
    from rectified_spaattn_tpu_torch.pipelines import HunyuanVideoPipeline

    cfg = HunyuanVideoConfig(hidden_dim=256, heads=2, num_dual_blocks=1,
                             num_single_blocks=1, text_dim=64, pooled_dim=32,
                             num_refiner_blocks=1)
    gen = torch.Generator()
    gen.manual_seed(3)
    ref = init_random_weights(HunyuanVideoDiT(cfg), gen)
    if quant_bits:
        # min_size 1: these widths are far below quantize_params' 1 << 20
        quant.quantize_model(ref, bits=quant_bits, min_size=1)
    gpu = HunyuanVideoDiT(cfg)
    quant.adopt_layout(gpu, ref.state_dict())
    gpu.load_state_dict(ref.state_dict())
    gpu = gpu.to(torch.bfloat16)
    text = torch.randn((1, 256, cfg.text_dim), generator=gen)
    mask = torch.zeros((1, 256), dtype=torch.bool)
    mask[:, :20] = True
    kw = dict(height=128, width=128, frames=8, num_steps=3, sa_drop_rate=0.5,
              p_remain_rates=0.5, group_rows=2)
    kw.update(pipe_kw)
    p_cpu = HunyuanVideoPipeline(model=ref, device="cpu", **kw)
    init = torch.randn((1, cfg.in_channels, *p_cpu.grid), generator=gen)
    want = p_cpu(text, mask, init_latents=init)
    p_gpu = HunyuanVideoPipeline(model=gpu, device=DEV, **kw)
    got = p_gpu(text, mask, init_latents=init).cpu()
    err = max_err(got, want)
    scale = float(want.abs().max())
    if not err <= 0.05 * scale:
        raise AssertionError(f"small pipeline GPU vs CPU: {err} > 5% of "
                             f"{scale}")
    res = {"max_abs_err": err, "ref_max_abs": scale}
    if quant_bits:
        res["layouts"] = sorted({m.layout for m in gpu.modules()
                                 if isinstance(m, quant.QLinear)})
    if p_gpu.teacache.enabled:
        res["teacache_decisions"] = p_gpu.teacache.decisions
    return res


# ------------------------------------------------------------ int8 phases ---

def int8_probe_phase():
    """S1: both types against the plain version (int8 bit for bit), then
    the probe's timed path with the launch counter zeroed before and read
    after."""
    from rectified_spaattn_tpu_torch.kernels import int8_probe
    res = {"check": int8_probe.check()}
    int8_probe.loop_dots.launches = 0
    res.update(int8_probe.measure())
    res["launches"] = int8_probe.loop_dots.launches
    if res["launches"] == 0:
        raise AssertionError("S1 was never launched")
    return res


def quant_launches(kernels):
    """{kernel: launches} for K1, K2, K3 and the two K1q modes."""
    k1 = kernels.block_sparse_flash_attention
    return {"K1": k1.launches, "K1q_int8": k1.quant_launches["int8"],
            "K1q_mxu8": k1.quant_launches["mxu8"],
            "K2": kernels.block_sparse_flash_attention_grouped.launches,
            "K3": kernels.dense_flash_attention.launches,
            "K1_merge": kernels.block_sparse.merge_splits.launches}


def zero_launches(kernels):
    k1 = kernels.block_sparse_flash_attention
    k1.launches = 0
    k1.quant_launches.update(int8=0, mxu8=0)
    kernels.block_sparse_flash_attention_grouped.launches = 0
    kernels.dense_flash_attention.launches = 0
    kernels.block_sparse.merge_splits.launches = 0


def small_int4_check(kernels):
    """The small GPU-vs-CPU pipeline with int4 weights, K1q "int8" and the
    int8 TeaCache residual (a replayed schedule that skips step 2), the
    launch counters zeroed before and read after."""
    zero_launches(kernels)
    res = small_pipeline_check(
        quant_bits=4, group_rows=1, kv_quant="int8", enable_teacache=True,
        teacache_residual="int8", teacache_schedule=[True, False, True])
    res["launches"] = quant_launches(kernels)
    if res["launches"]["K1q_int8"] == 0 or res["layouts"] != ["int4"]:
        raise AssertionError(f"small int4 pipeline: {res}")
    return res


def pipeline_int8_phase(kernels, bf16_peak_gb):
    """HunyuanVideoPipeline at full width, 2+2 blocks, 3 steps, with int8
    weights (quantize_model in place), K1q "mxu8" for the visual rows and
    the int8 TeaCache residual in pinned host memory; a replayed schedule
    computes, skips and computes, so the skip applies the offloaded
    residual.  Launch counters zeroed just before the run, read after."""
    from rectified_spaattn_tpu_torch.cli.generate import _random_text
    from rectified_spaattn_tpu_torch.models import (
        HunyuanVideoConfig, HunyuanVideoDiT, init_random_weights, quant)
    from rectified_spaattn_tpu_torch.pipelines import HunyuanVideoPipeline

    dev = torch.device(DEV)
    cfg = HunyuanVideoConfig(**PIPE["cfg"])
    with torch.device(dev):
        model = HunyuanVideoDiT(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = init_random_weights(model.to(torch.bfloat16), gen)
    bf16_bytes = quant.quantized_nbytes(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quant.quantize_model(model, bits=8)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    int8_bytes = quant.quantized_nbytes(model)
    layouts = {}
    for m in model.modules():
        if isinstance(m, quant.QLinear):
            layouts[m.layout] = layouts.get(m.layout, 0) + 1
    pipe = HunyuanVideoPipeline(
        model=model, height=PIPE["height"], width=PIPE["width"],
        frames=PIPE["frames"], num_steps=PIPE["steps"],
        sa_drop_rate=0.8, p_remain_rates=0.3, mode="sparse",
        enable_teacache=True, rel_l1_thresh=0.15, group_rows=1,
        kv_quant="mxu8", teacache_residual="int8", teacache_offload=True,
        teacache_schedule=[True, False, True], device=dev)
    text, mask = _random_text("several hot air balloons flying over a city.",
                              256, cfg.text_dim, device=dev)
    noise = torch.Generator(device=dev)
    noise.manual_seed(42)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    out = pipe(text, mask, generator=noise)
    launches = quant_launches(kernels)
    torch.cuda.synchronize()
    held = pipe.teacache.states[0].previous_residual
    if out.shape != (1, cfg.in_channels, *pipe.grid) \
            or not torch.isfinite(out).all():
        raise AssertionError("int8 pipeline output is not finite of its shape")
    # K1q (mxu8) runs the visual rows, bf16 K1 the text rows (split and
    # merged); no K2 at group_rows 1, no K3 on this path
    if min(launches["K1"], launches["K1q_mxu8"], launches["K1_merge"]) == 0 \
            or launches["K2"] or launches["K3"] or launches["K1q_int8"]:
        raise AssertionError(f"unexpected launches on the int8 path: "
                             f"{launches}")
    if not (isinstance(held, tuple) and held[0].dtype == torch.int8
            and held[0].device.type == "cpu" and held[0].is_pinned()):
        raise AssertionError("the TeaCache residual is not int8 in pinned "
                             "host memory")
    computed = pipe.teacache_stats["computed"]
    res = {"launches": launches, "step_seconds": pipe.step_seconds,
           "denoise_seconds": pipe.denoise_seconds,
           "teacache": pipe.teacache_stats,
           "teacache_decisions": pipe.teacache.decisions,
           "launches_per_computed_step": {
               n: c / computed for n, c in launches.items()},
           "weights_gb": {"bf16": bf16_bytes / 2**30,
                          "int8": int8_bytes / 2**30},
           "qlinear_layouts": layouts, "quantize_seconds": quant_s,
           "residual_host_mb": sum(t.numel() * t.element_size()
                                   for t in held) / 2**20,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "bf16_pipeline_peak_mem_gb": bf16_peak_gb}
    # one more computed step under the profiler (the schedule's first
    # call computes)
    res["profiled_step"] = profile_step(pipe, text, mask)
    return res


# ------------------------------------------------------------- Wan phases ---

def plain_dense(kernels, q, k, v, heads: int = 8):
    """K3's plain version over chunks of heads (its fp32 scores at the
    T2V cross shape would take 6 GB per 40 heads)."""
    out = torch.empty_like(q)
    for h0 in range(0, q.shape[1], heads):
        hs = slice(h0, h0 + heads)
        out[:, hs] = kernels.flash._vanilla_attention(q[:, hs], k[:, hs],
                                                      v[:, hs])
    return out


def wan_site_phase(kernels, regime: str):
    """The Wan2.1-14B self-attention site (visual layout, first-frame
    retention, 75,600 tokens padded once to 75,648 as the pipeline pads
    them) on "random" or "smooth" inputs: plan, K1 at G=1 and, on random
    inputs, the windowed dense K1 of the warm layers against SDPA with the
    same key mask and K3 at the text (512 keys) and CLIP-image (257 keys)
    cross shapes against SDPA."""
    from rectified_spaattn_tpu_torch.attention import (
        kv_validity, rectified_sparse_attention)
    from rectified_spaattn_tpu_torch.bench.inputs import smooth_qkv
    from rectified_spaattn_tpu_torch.pipelines import build_site
    from rectified_spaattn_tpu_torch.sparse import build_sparse_plan

    dev = torch.device(DEV)
    full = regime == "random"
    b, h, d = 1, WAN_SITE["heads"], WAN_SITE["head_dim"]
    site, _, h2l = build_site(*WAN_SITE["grid"], sa_drop_rate=0.75,
                              p_remain=0.3, layout="visual",
                              first_frame_retention=True, device=dev)
    sv = site.visual_len                      # 75,600
    s = sv + (-sv) % 128                      # 75,648
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    if full:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev
                               ).to(torch.bfloat16) for _ in range(3))
    else:
        q, k, v = smooth_qkv(gen, h, s - sv, d, h2l, WAN_SITE["grid"])
    cfg, nbr = site.cfg, site.neighbor_mask
    res = {"regime": regime, "visual_len": sv, "tokens": s,
           "first_frame_blocks": cfg.first_frame_blocks}
    kern = {}

    def site_call(**kw):
        return rectified_sparse_attention(q, k, v, cfg, nbr, visual_len=sv,
                                          **kw)

    res["plan_ms"] = cuda_ms(lambda: site_call(density_only=True))
    res["density"] = float(site_call(density_only=True))
    res["sparse_ms"] = cuda_ms(lambda: site_call())
    k1 = kernels.block_sparse_flash_attention
    k1.launches = 0
    out = site_call()
    res["launches_per_call"] = {"K1": k1.launches}
    # the 48 padding rows too: the head slices them off, but they must
    # not carry a NaN into the residual stream
    if out.shape != q.shape or not torch.isfinite(out.float()).all():
        raise AssertionError("Wan site output is not finite of shape q.shape")
    del out

    # the kernel's own inputs, as rectified_sparse_attention builds them
    valid = kv_validity(b, s, sv, None, None, device=dev)
    zero = torch.zeros((), dtype=q.dtype, device=dev)
    kz = torch.where(valid[:, None, :, None], k, zero)
    vz = torch.where(valid[:, None, :, None], v, zero)
    plan = build_sparse_plan(q, kz, vz, cfg, neighbor_mask=nbr)
    nbt = s // 128
    pairs = float(plan.counts.sum())
    res["pairs"] = pairs
    used = torch.zeros((b * h, nbt), dtype=torch.int32, device=dev)
    used.scatter_add_(1, plan.indices.reshape(b * h, -1).long(),
                      (torch.arange(plan.indices.shape[-1], device=dev)
                       < plan.counts[..., None]).reshape(b * h, -1).int())
    kv_bytes = lambda blocks: 2 * blocks * 128 * d * 2
    qo_bytes = 2 * b * h * s * d * 2
    tl0 = torch.zeros((b,), dtype=torch.int32, device=dev)
    kw = dict(visual_len=sv, text_start=None)
    measure(kern, "K1_wan_visual_g1", regime, full,
            lambda: kernels.block_sparse_flash_attention(
                q, kz, vz, plan.indices, plan.counts, tl0, **kw),
            lambda: kernels.block_sparse_flash_attention_torch(
                q, kz, vz, plan.indices, plan.counts, tl0, **kw),
            flops=pairs * 4.0 * 128 * 128 * d,
            nbytes=qo_bytes + kv_bytes(float((used > 0).sum()))
            + plan.indices.numel() * 4 + plan.counts.numel() * 4)
    if not full:
        return res, kern
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # K1 with full lists at block_m 1024: the dense warm layers (the
    # windowed path pads q to 74 row tiles of 1024)
    nqd = -(-s // 1024)
    qd = torch.nn.functional.pad(q, (0, 0, 0, nqd * 1024 - s))
    didx = torch.arange(nbt, dtype=torch.int32, device=dev).expand(
        b, h, nqd, nbt)
    dcnt = torch.full((b, h, nqd), nbt, dtype=torch.int32, device=dev)
    dkw = dict(block_m=1024, **kw)
    measure(kern, "K1_wan_dense_bm1024", regime, full,
            lambda: kernels.block_sparse_flash_attention(
                qd, k, v, didx, dcnt, tl0, **dkw),
            lambda: kernels.block_sparse_flash_attention_torch(
                qd, k, v, didx, dcnt, tl0, **dkw),
            flops=4.0 * b * h * s * s * d,
            nbytes=qo_bytes + 2 * b * h * s * d * 2 + didx.numel() * 4,
            library=lambda: sdpa(q, k, v,
                                 attn_mask=valid[:, None, None, :]))
    del qd, plan, kz, vz
    torch.cuda.empty_cache()
    # K3 at the cross shapes, q and k/v as the blocks hand them over:
    # head-split views of [B, S, H, D] projections
    qx = torch.randn((b, s, h, d), generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    for name, sk in (("K3_t2v_text", WAN_SITE["text_len"]),
                     ("K3_i2v_image", WAN_SITE["image_len"])):
        kx, vx = (torch.randn((b, sk, h, d), generator=gen, device=dev).to(
            torch.bfloat16).transpose(1, 2) for _ in range(2))
        measure(kern, name, regime, True,
                lambda: kernels.dense_attention(qx, kx, vx, mode="flash"),
                lambda: plain_dense(kernels, qx, kx, vx),
                flops=4.0 * b * h * s * sk * d,
                nbytes=2 * b * h * (s + sk) * d * 2,
                library=lambda: sdpa(qx, kx, vx))
    return res, kern


def count_sparse_plans():
    """Count the rectified site's plan builds (one per sparse-layer call)
    by wrapping the plan builder where the site looks it up; returns
    (counter, restore)."""
    from rectified_spaattn_tpu_torch.attention import rectified
    orig, count = rectified.build_sparse_plan, [0]

    def counted(*a, **kw):
        count[0] += 1
        return orig(*a, **kw)

    rectified.build_sparse_plan = counted
    return count, lambda: setattr(rectified, "build_sparse_plan", orig)


def wan_pipeline_phase(kernels):
    """WanPipeline at full width (WanConfig()) cut to 4 blocks,
    720x1280x81, 3 UniPC steps under CFG, TeaCache on, seeded bf16 random
    weights; the launch counters (and the sparse plans built) are zeroed
    just before the run and read just after."""
    from rectified_spaattn_tpu_torch.cli.generate import _random_text
    from rectified_spaattn_tpu_torch.models import (
        WanConfig, WanDiT, init_random_weights)
    from rectified_spaattn_tpu_torch.pipelines import WanPipeline

    dev = torch.device(DEV)
    cfg = WanConfig(**WAN_PIPE["cfg"])
    with torch.device(dev):
        model = WanDiT(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = init_random_weights(model.to(torch.bfloat16), gen)
    pipe = WanPipeline(
        model=model, height=WAN_PIPE["height"], width=WAN_PIPE["width"],
        frames=WAN_PIPE["frames"], num_steps=WAN_PIPE["steps"],
        sa_drop_rate=0.75, p_remain_rates=0.3, mode="sparse",
        enable_teacache=True, teacache_thresh=0.2,
        warm_layers=WAN_PIPE["warm_layers"],
        warm_calls=WAN_PIPE["warm_calls"], group_rows=1, device=dev)
    text, _ = _random_text("several hot air balloons flying over a city.",
                           512, cfg.text_dim, device=dev)
    neg, _ = _random_text("", 512, cfg.text_dim, device=dev)
    noise = torch.Generator(device=dev)
    noise.manual_seed(42)
    torch.cuda.reset_peak_memory_stats()
    kerns = {"K1": kernels.block_sparse_flash_attention,
             "K2": kernels.block_sparse_flash_attention_grouped,
             "K3": kernels.dense_flash_attention,
             "K1_merge": kernels.block_sparse.merge_splits}
    plans, restore = count_sparse_plans()
    try:
        for f in kerns.values():
            f.launches = 0
        out = pipe(text, neg, generator=noise)
        launches = {n: f.launches for n, f in kerns.items()}
    finally:
        restore()
    torch.cuda.synchronize()
    if out.shape != (1, cfg.out_channels, *pipe.grid):
        raise AssertionError(f"Wan pipeline output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError("Wan pipeline output is not finite")
    decisions = pipe.teacache.decisions
    computed = sum(decisions)
    sparse_calls = sum(1 for i, c in enumerate(decisions)
                       if c and i >= WAN_PIPE["warm_calls"])
    want_plans = sparse_calls * (cfg.num_blocks - WAN_PIPE["warm_layers"])
    # K3 once per block per computed call (T2V: the text cross only); K1
    # once per block per computed call (windowed dense or sparse), never
    # split: Wan has no text rows, and its visual rows fill the card
    want = {"K1": cfg.num_blocks * computed, "K2": 0,
            "K3": cfg.num_blocks * computed, "K1_merge": 0}
    if launches != want or plans[0] != want_plans or want_plans == 0:
        raise AssertionError(f"Wan launches {launches} (want {want}), "
                             f"sparse plans {plans[0]} (want {want_plans} "
                             "> 0)")
    res = {"launches": launches, "sparse_plans": plans[0],
           "step_seconds": pipe.step_seconds,
           "denoise_seconds": pipe.denoise_seconds,
           "teacache": pipe.teacache_stats, "teacache_decisions": decisions,
           "visual_tokens": pipe.site.visual_len, "pad": pipe.pad,
           "launches_per_computed_call": {
               n: c / computed for n, c in launches.items()},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    # one more step, both CFG calls computed and sparse past the warm
    # layers, under the profiler
    pipe.warm_calls = 0
    res["profiled_sparse_step"] = profile_step(pipe, text, neg)
    return res


def small_wan_pipeline_check():
    """A small sparse Wan pipeline (head_dim 128, 360 tokens padded to 384)
    on the GPU in bf16 against the same weights on the CPU in fp32."""
    from rectified_spaattn_tpu_torch.models import (
        WanConfig, WanDiT, init_random_weights)
    from rectified_spaattn_tpu_torch.pipelines import WanPipeline

    cfg = WanConfig(hidden_dim=256, heads=2, num_blocks=2, ffn_dim=512,
                    text_dim=64)
    gen = torch.Generator()
    gen.manual_seed(5)
    ref = init_random_weights(WanDiT(cfg), gen)
    gpu = WanDiT(cfg)
    gpu.load_state_dict(ref.state_dict())
    gpu = gpu.to(torch.bfloat16)
    text = torch.randn((1, 32, cfg.text_dim), generator=gen)
    neg = torch.zeros_like(text)
    kw = dict(height=192, width=240, frames=5, num_steps=3, sa_drop_rate=0.5,
              p_remain_rates=0.5, warm_layers=1, warm_calls=0)
    p_cpu = WanPipeline(model=ref, device="cpu", **kw)
    init = torch.randn((1, cfg.in_channels, *p_cpu.grid), generator=gen)
    want = p_cpu(text, neg, init_latents=init)
    got = WanPipeline(model=gpu, device=DEV, **kw)(
        text, neg, init_latents=init).cpu()
    err = max_err(got, want)
    scale = float(want.abs().max())
    if not err <= 0.05 * scale:
        raise AssertionError(f"small Wan pipeline GPU vs CPU: {err} > 5% of "
                             f"{scale}")
    return {"max_abs_err": err, "ref_max_abs": scale}


# ------------------------------------------------------ multi-device ---

def check_k1s(name, got, want, counts, block_m: int = 128) -> dict:
    """K1s (o, m, l) against its plain version: o to the relative limits,
    m within M_TOL and l within L_REL on rows with a listed block, and
    m == -inf and l == 0 exactly on count-0 rows (``counts`` [B,H,NQ])."""
    o, m, l = got
    wo, wm, wl = want
    r = {"case": name, **held_to_scale(name, o, wo)}
    zero = (counts == 0).repeat_interleave(block_m, dim=2)
    if zero.any() and not (bool((m[zero] == -torch.inf).all())
                           and bool((l[zero] == 0).all())):
        raise AssertionError(f"{name}: a count == 0 row has m != -inf or "
                             "l != 0")
    live = ~zero
    r["count0_rows"] = int(zero.sum())
    r["m_max_abs_err"] = float((m[live] - wm[live]).abs().max())
    r["l_max_rel_err"] = float(((l[live] - wl[live]).abs()
                                / wl[live]).max())
    if not (r["m_max_abs_err"] <= M_TOL and r["l_max_rel_err"] <= L_REL):
        raise AssertionError(f"{name}: stats beyond m {M_TOL} / l {L_REL}: "
                             f"{r}")
    return r


def k1s_cases(kernels, ops):
    """K1s against its plain version on small bf16 cases; returns the
    largest errors and the cases."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16)
    errs = {"o": 0.0, "m": 0.0, "l_rel": 0.0}
    cases = []

    def case(name, b, h, nq, nb, mask, visual_len, text_start, tlen,
             chunk_blocks=16, packed=False):
        q, k, v = rnd(b, h, nq * 128, 128), rnd(b, h, nb * 128, 128), \
            rnd(b, h, nb * 128, 128)
        tl = torch.tensor(tlen, dtype=torch.int32, device=dev)
        idx, cnt = ops.mask_to_indices(mask)
        kw = dict(visual_len=visual_len, text_start=text_start,
                  chunk_blocks=chunk_blocks, return_stats=True,
                  packed_kv=torch.cat([k, v], dim=-1) if packed else None)
        got = kernels.block_sparse_flash_attention(q, k, v, idx, cnt, tl,
                                                   **kw)
        want = kernels.block_sparse_flash_attention_torch(q, k, v, idx, cnt,
                                                          tl, **kw)
        k1 = kernels.block_sparse_flash_attention(
            q, k, v, idx, cnt, tl,
            **{n: a for n, a in kw.items() if n != "return_stats"})
        if not torch.equal(got[0], k1):
            raise AssertionError(f"{name}: K1s o differs from K1's")
        e = max_err(got[0], want[0])
        if not (torch.isfinite(got[0].float()).all() and e <= TOL):
            raise AssertionError(f"{name}: max abs err {e} > {TOL}")
        r = check_k1s(name, got, want, cnt)
        errs["o"] = max(errs["o"], e)
        errs["m"] = max(errs["m"], r["m_max_abs_err"])
        errs["l_rel"] = max(errs["l_rel"], r["l_max_rel_err"])
        cases.append(r)

    m = torch.rand((1, 4, 16, 16), generator=gen, device=dev) < 0.4
    m[..., 0] = True
    case("k1s_random_masks", 1, 4, 16, 16, m, 16 * 128, None, [0])
    m = torch.rand((2, 4, 15, 16), generator=gen, device=dev) < 0.5
    m[..., -1] = True
    case("k1s_text_window_b2", 2, 4, 15, 16, m, 15 * 128 - 40, 15 * 128,
         [100, 37])
    # count-0 rows (rows 1 and 3) and, in batch 1, a degenerate row block
    # (its only block the text block of a batch with text_len 0)
    m = torch.zeros((2, 2, 4, 5), dtype=torch.bool, device=dev)
    m[:, :, 0, :3] = True
    m[:, :, 2, 4] = True
    for cb in (2, 16):
        case(f"k1s_count0_and_degenerate_chunk{cb}", 2, 2, 4, 5, m, 4 * 128,
             4 * 128, [64, 0], chunk_blocks=cb)
    m = torch.rand((1, 2, 8, 10), generator=gen, device=dev) < 0.4
    m[0, 1, 5] = False
    case("k1s_packed_kv", 1, 2, 8, 10, m, 10 * 128, None, [0], packed=True)
    # the key split (16 row tiles, 10 chunks a list), count-0 rows, a
    # degenerate list and the text window at B = 2, packed and not
    m = torch.rand((2, 4, 2, 40), generator=gen, device=dev) < 0.5
    m[..., -1] = True
    m[0, 1, 0] = False
    m[1, 2, 1] = False
    m[1, 2, 1, -1] = True
    merges = kernels.block_sparse.merge_splits.launches
    for packed in (False, True):
        case(f"k1s_split_short_rows{'_packed' if packed else ''}", 2, 4, 2,
             40, m, 39 * 128 - 40, 39 * 128, [90, 0], chunk_blocks=4,
             packed=packed)
    if kernels.block_sparse.merge_splits.launches != merges + 4:
        raise AssertionError("k1s_split_short_rows did not split")
    return errs, cases


def measure_k1s(kern, name, regime, check, kern_fn, plain_fn, counts, flops,
                nbytes, library=None):
    """``measure`` for K1s: the plain check holds o to the relative limits
    and m / l as check_k1s does."""
    got = kern_fn()
    r = {}
    if check:
        t_plain = time.perf_counter()
        want = plain_fn()
        torch.cuda.synchronize()
        r["plain_ms"] = (time.perf_counter() - t_plain) * 1e3
        r.update(check_k1s(name, got, want, counts))
        del want
    if not torch.isfinite(got[0].float()).all():
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


def ring_launches(kernels):
    k1 = kernels.block_sparse_flash_attention
    return {"K1s": k1.stats_launches, "K1": k1.launches,
            "K2": kernels.block_sparse_flash_attention_grouped.launches,
            "K1_merge": kernels.block_sparse.merge_splits.launches}


def zero_ring_launches(kernels):
    k1 = kernels.block_sparse_flash_attention
    k1.stats_launches = k1.launches = 0
    kernels.block_sparse_flash_attention_grouped.launches = 0
    kernels.block_sparse.merge_splits.launches = 0


def ring_masks(q_vis, k_vis, v_vis, n, nbr, cfg, text_keys=None,
               text_valid=None):
    """Every rank's plan mask of the ring, concatenated over the ranks
    ([B,H,NB,NB]), from the pooled statistics the ring all-gathers."""
    from rectified_spaattn_tpu_torch.attention.ring import (pooled_stats,
                                                            rank_plan)
    kp, vp, dk = pooled_stats(k_vis, v_vis, 128)
    s_l = q_vis.shape[2] // n
    return torch.cat([rank_plan(r, n, q_vis[:, :, r * s_l:(r + 1) * s_l],
                                kp, vp, dk, nbr, cfg, text_keys,
                                text_valid)[0] for r in range(n)], dim=2)


def k1s_step_bytes(b, h, rows, d, kv_blocks, *lists):
    """Bytes one K1s call must move: q read, o written, m and l written,
    the K/V blocks its lists use read once, the lists read."""
    return (2 * b * h * rows * d * 2 + 2 * b * h * rows * 4
            + 2 * kv_blocks * 128 * d * 2 + sum(t.numel() * 4 for t in lists))


def used_blocks(indices, counts) -> float:
    """K/V blocks (per batch x head) some list of ``indices`` uses."""
    bh = indices.shape[0] * indices.shape[1]
    nb = int(indices.max()) + 1
    used = torch.zeros((bh, nb), dtype=torch.int32, device=indices.device)
    used.scatter_add_(1, indices.reshape(bh, -1).long(),
                      (torch.arange(indices.shape[-1], device=indices.device)
                       < counts[..., None]).reshape(bh, -1).int())
    return float((used > 0).sum())


def ring_step_k1s(kernels, ops, kern, prefix, regime, check, q_vis, k_vis,
                  v_vis, mask0, n, q_text=None):
    """K1s of rank 0's first ring step (its own shard) on the full inputs:
    the visual rows and, with ``q_text``, the text rows with full lists
    over the shard."""
    b, h, sv, d = q_vis.shape
    s_l = sv // n
    nb_l = s_l // 128
    q0 = q_vis[:, :, :s_l].contiguous()
    k0, v0 = k_vis[:, :, :s_l].contiguous(), v_vis[:, :, :s_l].contiguous()
    idx, cnt = ops.mask_to_indices(mask0[..., :nb_l])
    tl0 = torch.zeros((b,), dtype=torch.int32, device=q0.device)
    kw = dict(visual_len=s_l, text_start=None, return_stats=True)
    pairs = float(cnt.sum())
    measure_k1s(kern, f"{prefix}_visual", regime, check,
                lambda: kernels.block_sparse_flash_attention(
                    q0, k0, v0, idx, cnt, tl0, **kw),
                lambda: kernels.block_sparse_flash_attention_torch(
                    q0, k0, v0, idx, cnt, tl0, **kw), cnt,
                flops=pairs * 4.0 * 128 * 128 * d,
                nbytes=k1s_step_bytes(b, h, s_l, d, used_blocks(idx, cnt),
                                      idx, cnt))
    kern[f"{prefix}_visual"]["pairs"] = pairs
    if q_text is None:
        return
    qt = q_text
    nt = qt.shape[2] // 128
    fidx = torch.arange(nb_l, dtype=torch.int32, device=q0.device).expand(
        b, h, nt, nb_l)
    fcnt = torch.full((b, h, nt), nb_l, dtype=torch.int32, device=q0.device)
    flash = torch.ops.aten._scaled_dot_product_flash_attention
    name = f"{prefix}_text"
    measure_k1s(kern, name, regime, check,
                lambda: kernels.block_sparse_flash_attention(
                    qt, k0, v0, fidx, fcnt, tl0, **kw),
                lambda: kernels.block_sparse_flash_attention_torch(
                    qt, k0, v0, fidx, fcnt, tl0, **kw), fcnt,
                flops=b * h * nt * nb_l * 4.0 * 128 * 128 * d,
                nbytes=k1s_step_bytes(b, h, qt.shape[2], d, b * h * nb_l,
                                      fidx, fcnt),
                library=lambda: flash(qt, k0, v0))
    # the flash call's log-sum-exp is m + log l of the same rows
    _, m, l = kernels.block_sparse_flash_attention(qt, k0, v0, fidx, fcnt,
                                                   tl0, **kw)
    lse = flash(qt, k0, v0)[1]
    kern[name]["library_lse_vs_m_log_l"] = float(
        (lse.float() - (m + torch.log(l))).abs().max())


def ring_hunyuan_phase(kernels, ops, regime: str):
    """The ring at the Hunyuan site point, sp = 4 in-process on this card
    (see the module docstring); returns (results, per-kernel results,
    (visual out, text out) on the host where a second card can use it)."""
    from rectified_spaattn_tpu_torch.attention import (
        kv_validity, rectified_sparse_attention,
        ring_rectified_sparse_attention)
    from rectified_spaattn_tpu_torch.bench.inputs import smooth_qkv
    from rectified_spaattn_tpu_torch.parallel import in_process_mesh
    from rectified_spaattn_tpu_torch.pipelines import build_site
    from rectified_spaattn_tpu_torch.sparse import build_sparse_plan

    dev = torch.device(DEV)
    full = regime == "random"
    b, h, d, text_len = 1, SITE["heads"], SITE["head_dim"], SITE["text_len"]
    n = RING_SP["hunyuan"]
    site, _, h2l = build_site(*SITE["grid"], sa_drop_rate=0.8, p_remain=0.3,
                              layout="joint", text_len=text_len, device=dev)
    sv = site.visual_len
    s = sv + text_len
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    if full:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev
                               ).to(torch.bfloat16) for _ in range(3))
    else:
        q, k, v = smooth_qkv(gen, h, text_len, d, h2l, SITE["grid"])
    tlen = torch.tensor([SITE["tlen"]], dtype=torch.int32, device=dev)
    # the ring selects blocks by the sort-based top-p (the JAX ring's)
    cfg = dataclasses.replace(site.cfg, topp_impl="sort")
    nbr = site.neighbor_mask
    mesh = in_process_mesh(sp=n)
    qv, kvv, vv = q[:, :, :sv], k[:, :, :sv], v[:, :, :sv]
    text = dict(q_text=q[:, :, sv:], k_text=k[:, :, sv:],
                v_text=v[:, :, sv:], text_len_rt=tlen)

    def ring(cfg_=cfg, **kw):
        return ring_rectified_sparse_attention(mesh, qv, kvv, vv, cfg_, nbr,
                                               **text, **kw)

    res = {"regime": regime, "sp": n, "visual_tokens": sv}
    zero_ring_launches(kernels)
    out_v, out_t = ring()
    launches = ring_launches(kernels)
    torch.cuda.synchronize()
    # per rank: n visual steps, a visual-text pass, n text-row passes over
    # the visual shards (48 row tiles: split and merged) and a text-text
    # pass
    want = {"K1s": n * (2 * n + 2), "K1": 0, "K2": 0, "K1_merge": n * n}
    if launches != want:
        raise AssertionError(f"ring launches {launches}, want {want}")
    res["launches"] = launches
    single = lambda: rectified_sparse_attention(q, k, v, cfg, nbr,
                                                visual_len=sv,
                                                text_len_rt=tlen)
    ref = single()
    res["vs_single_device"] = {
        "visual": held_to_scale(f"ring visual ({regime}) vs the site",
                                out_v, ref[:, :, :sv]),
        "text": held_to_scale(f"ring text ({regime}) vs the site", out_t,
                              ref[:, :, sv:])}
    del ref
    res["ring_ms"] = cuda_ms(ring, reps=1)
    res["single_device_site_ms"] = cuda_ms(single, reps=1)
    # the plans: every rank's mask against the single-device plan
    valid = kv_validity(b, s, sv, sv, tlen, device=dev)
    zero = torch.zeros((), dtype=k.dtype, device=dev)
    kz = torch.where(valid[:, None, :, None], k, zero)
    vz = torch.where(valid[:, None, :, None], v, zero)
    text_valid = torch.arange(text_len, device=dev)[None, :] < tlen[:, None]
    plan = build_sparse_plan(qv, kz, vz, cfg, neighbor_mask=nbr,
                             text_valid=text_valid)
    nb = sv // 128
    masks = ring_masks(qv, kvv, vv, n, nbr, cfg, kz[:, :, sv:].float(),
                       text_valid)
    res["mask_entries"] = masks.numel()
    res["mask_entries_differing"] = int(
        (masks != plan.block_mask[..., :nb]).sum())
    res["density"] = float(masks.float().mean())
    del plan, kz, vz
    # the composed levers: row-tiled plans, one packed K|V buffer
    kvp = torch.cat([kvv, vv], dim=-1)
    cv, ct = ring_rectified_sparse_attention(
        mesh, qv, kvp[..., :d], kvp[..., d:],
        dataclasses.replace(cfg, plan_row_chunk=64), nbr, kv_packed=kvp,
        **text)
    res["composed_vs_plain"] = {
        "visual": held_to_scale("composed ring visual", cv, out_v),
        "text": held_to_scale("composed ring text", ct, out_t),
        "max_abs_diff": max(max_err(cv, out_v), max_err(ct, out_t))}
    del cv, ct, kvp
    # the multi_gpu phase holds the NCCL ring against this output
    outs = ((out_v.cpu(), out_t.cpu()) if torch.cuda.device_count() >= 2
            else None)
    del out_v, out_t
    torch.cuda.empty_cache()
    kern = {}
    ring_step_k1s(kernels, ops, kern, "K1s_ring", regime, full, qv, kvv, vv,
                  masks[:, :, :sv // n // 128], n, q_text=q[:, :, sv:])
    return res, kern, outs


def ring_wan_phase(kernels, ops):
    """The visual ring at the Wan site, 75,648 tokens over sp = 3, against
    the single-device site with the same visual_len (random inputs)."""
    from rectified_spaattn_tpu_torch.attention import (
        rectified_sparse_attention, ring_rectified_sparse_attention)
    from rectified_spaattn_tpu_torch.parallel import in_process_mesh
    from rectified_spaattn_tpu_torch.pipelines import build_site
    from rectified_spaattn_tpu_torch.sparse import build_sparse_plan

    dev = torch.device(DEV)
    b, h, d = 1, WAN_SITE["heads"], WAN_SITE["head_dim"]
    n = RING_SP["wan"]
    site, _, _ = build_site(*WAN_SITE["grid"], sa_drop_rate=0.75,
                            p_remain=0.3, layout="visual",
                            first_frame_retention=True, device=dev)
    s = site.visual_len + (-site.visual_len) % 128          # 75,648
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev
                           ).to(torch.bfloat16) for _ in range(3))
    cfg = dataclasses.replace(site.cfg, topp_impl="sort")
    nbr = site.neighbor_mask
    mesh = in_process_mesh(sp=n)
    ring = lambda: ring_rectified_sparse_attention(mesh, q, k, v, cfg, nbr)
    res = {"regime": "random", "sp": n, "tokens": s,
           "first_frame_blocks": cfg.first_frame_blocks}
    zero_ring_launches(kernels)
    out = ring()
    launches = ring_launches(kernels)
    torch.cuda.synchronize()
    want = {"K1s": n * n, "K1": 0, "K2": 0, "K1_merge": 0}
    if launches != want:
        raise AssertionError(f"Wan ring launches {launches}, want {want}")
    res["launches"] = launches
    single = lambda: rectified_sparse_attention(q, k, v, cfg, nbr,
                                                visual_len=s)
    res["vs_single_device"] = held_to_scale("Wan ring vs the site", out,
                                            single())
    del out
    res["ring_ms"] = cuda_ms(ring, reps=1)
    res["single_device_site_ms"] = cuda_ms(single, reps=1)
    plan = build_sparse_plan(q, k, v, cfg, neighbor_mask=nbr)
    masks = ring_masks(q, k, v, n, nbr, cfg)
    res["mask_entries"] = masks.numel()
    res["mask_entries_differing"] = int((masks != plan.block_mask).sum())
    res["density"] = float(masks.float().mean())
    del plan
    torch.cuda.empty_cache()
    kern = {}
    ring_step_k1s(kernels, ops, kern, "K1s_ring_wan", "random", True, q, k,
                  v, masks[:, :, :s // n // 128], n)
    return res, kern


def _mg_init(rank: int, world: int, tmp: str, name: str):
    sys.path.insert(0, ROOT)
    from rectified_spaattn_tpu_torch.parallel import init_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(f"cuda:{rank}", init_method=f"file://{tmp}/{name}",
                     world_size=world, rank=rank)
    return torch.device("cuda", rank)


def _mg_ring_worker(rank: int, world: int, tmp: str):
    """One rank of the NCCL ring at the phase-8 point (random inputs, made
    on this card from the phase's seed; every rank is given the global
    tensors and returns the global output), held against the in-process
    ring's output; writes mg_ring_<rank>.json."""
    import torch.distributed as dist
    dev = _mg_init(rank, world, tmp, "ring_rdv")
    from rectified_spaattn_tpu_torch.attention import (
        ring_rectified_sparse_attention)
    from rectified_spaattn_tpu_torch.parallel import make_mesh
    from rectified_spaattn_tpu_torch.pipelines import build_site
    b, h, d, text_len = 1, SITE["heads"], SITE["head_dim"], SITE["text_len"]
    site, _, _ = build_site(*SITE["grid"], sa_drop_rate=0.8, p_remain=0.3,
                            layout="joint", text_len=text_len, device=dev)
    sv = site.visual_len
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    q, k, v = (torch.randn((b, h, sv + text_len, d), generator=gen,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    text = dict(q_text=q[:, :, sv:], k_text=k[:, :, sv:],
                v_text=v[:, :, sv:],
                text_len_rt=torch.tensor([SITE["tlen"]], dtype=torch.int32,
                                         device=dev))
    cfg = dataclasses.replace(site.cfg, topp_impl="sort")
    mesh = make_mesh(dp=1, tp=1, sp=world)
    ring = lambda: ring_rectified_sparse_attention(
        mesh, q[:, :, :sv], k[:, :, :sv], v[:, :, :sv], cfg,
        site.neighbor_mask, **text)
    out_v, out_t = ring()
    ref_v, ref_t = torch.load(os.path.join(tmp, "ring_ref.pt"))
    res = {"rank": rank, "world": world,
           "visual": held_to_scale(f"NCCL ring rank {rank} visual", out_v,
                                   ref_v.to(dev)),
           "text": held_to_scale(f"NCCL ring rank {rank} text", out_t,
                                 ref_t.to(dev))}
    del out_v, out_t, ref_v, ref_t
    dist.barrier()
    res["ring_ms"] = cuda_ms(ring, reps=1)
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    with open(os.path.join(tmp, f"mg_ring_{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _mg_pipe_worker(rank: int, world: int, tmp: str):
    """One rank of the full-width 2+2-block Hunyuan pipeline at tp =
    ``world``, built and run as phase 4 builds and runs it; rank 0 holds
    the latents against phase 4's; writes mg_pipe_<rank>.json."""
    import torch.distributed as dist
    dev = _mg_init(rank, world, tmp, "pipe_rdv")
    from rectified_spaattn_tpu_torch import kernels
    from rectified_spaattn_tpu_torch.cli.generate import _random_text
    from rectified_spaattn_tpu_torch.models import (
        HunyuanVideoConfig, HunyuanVideoDiT, init_random_weights, quant)
    from rectified_spaattn_tpu_torch.parallel import make_mesh
    from rectified_spaattn_tpu_torch.pipelines import HunyuanVideoPipeline
    cfg = HunyuanVideoConfig(**PIPE["cfg"])
    with torch.device(dev):
        model = HunyuanVideoDiT(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = init_random_weights(model.to(torch.bfloat16), gen)
    full_bytes = quant.quantized_nbytes(model)
    pipe = HunyuanVideoPipeline(
        model=model, height=PIPE["height"], width=PIPE["width"],
        frames=PIPE["frames"], num_steps=PIPE["steps"],
        sa_drop_rate=0.8, p_remain_rates=0.3, mode="sparse",
        enable_teacache=True, rel_l1_thresh=0.15, group_rows=2, device=dev,
        mesh=make_mesh(tp=world))
    text, mask = _random_text("several hot air balloons flying over a city.",
                              256, cfg.text_dim, device=dev)
    noise = torch.Generator(device=dev)
    noise.manual_seed(42)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    k1, k2 = (kernels.block_sparse_flash_attention,
              kernels.block_sparse_flash_attention_grouped)
    k1.launches = k2.launches = 0
    out = pipe(text, mask, generator=noise)
    torch.cuda.synchronize(dev)
    res = {"rank": rank, "tp": world,
           "launches": {"K1": k1.launches, "K2": k2.launches},
           "step_seconds": pipe.step_seconds,
           "teacache_decisions": pipe.teacache.decisions,
           "weights_gb": quant.quantized_nbytes(pipe.model) / 2**30,
           "full_model_weights_gb": full_bytes / 2**30,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30}
    if rank == 0:
        ref = torch.load(os.path.join(tmp, "pipe_ref.pt"))
        res["vs_single_gpu"] = held_to_scale("tp pipeline vs one GPU", out,
                                             ref.to(dev))
    with open(os.path.join(tmp, f"mg_pipe_{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _read_json(tmp: str, name: str) -> dict:
    with open(os.path.join(tmp, name)) as f:
        return json.load(f)


def multi_gpu_phase(ring_ref, pipe_ref):
    """Phase 10: the NCCL ring over up to 4 cards and the tp = 2 pipeline,
    each in processes of its own (one per card, joined before return)."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    count = torch.cuda.device_count()
    world = min(count, RING_SP["hunyuan"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mg_")
    try:
        torch.save(ring_ref, os.path.join(tmp, "ring_ref.pt"))
        torch.save(pipe_ref, os.path.join(tmp, "pipe_ref.pt"))
        torch.cuda.empty_cache()
        res = {"devices": count}
        mp.spawn(_mg_ring_worker, args=(world, tmp), nprocs=world)
        res["ring"] = [_read_json(tmp, f"mg_ring_{r}.json")
                       for r in range(world)]
        mp.spawn(_mg_pipe_worker, args=(2, tmp), nprocs=2)
        res["pipeline_tp2"] = [_read_json(tmp, f"mg_pipe_{r}.json")
                               for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    decisions = {tuple(r["teacache_decisions"]) for r in res["pipeline_tp2"]}
    if len(decisions) != 1 or min(r["launches"]["K2"]
                                  for r in res["pipeline_tp2"]) == 0:
        raise AssertionError(f"tp pipeline ranks: {res['pipeline_tp2']}")
    return res


# ------------------------------------------------- kernel diagnostics ---

def k1q_stats_cases(kernels, ops):
    """K1q-s in both modes against its plain version on small bf16 cases
    (K1q's masks: random, the text window at B=2, count-0 and all-masked
    rows, a clean prefix), chunk_blocks 2, 16 and 24: o held as K1 is and
    equal to K1q's bit for bit, m and l as check_k1s holds them."""
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5432)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16)
    errs = {"o": 0.0, "m": 0.0, "l_rel": 0.0}
    cases = []

    def case(name, b, h, nq, nb, mask, visual_len, text_start, tlen):
        q, k, v = rnd(b, h, nq * 128, 128), rnd(b, h, nb * 128, 128), \
            rnd(b, h, nb * 128, 128)
        tl = torch.tensor(tlen, dtype=torch.int32, device=dev)
        payload = ops.quantize_kv_blocks(k, v, 128)
        idx, cnt = ops.mask_to_indices(mask)
        for cb in (2, 16, 24):
            for mode in ("int8", "mxu8"):
                kw = dict(visual_len=visual_len, text_start=text_start,
                          chunk_blocks=cb, kv_quant=payload, quant_mode=mode)
                got = kernels.block_sparse_flash_attention(
                    q, k, v, idx, cnt, tl, return_stats=True, **kw)
                want = kernels.block_sparse_flash_attention_torch(
                    q, k, v, idx, cnt, tl, return_stats=True, **kw)
                full = f"{name}_chunk{cb}_{mode}"
                if not torch.equal(got[0], kernels.block_sparse_flash_attention(
                        q, k, v, idx, cnt, tl, **kw)):
                    raise AssertionError(f"{full}: o differs from K1q's")
                e = max_err(got[0], want[0])
                if e > TOL:
                    raise AssertionError(f"{full}: max abs err {e} > {TOL}")
                r = check_k1s(full, got, want, cnt)
                errs["o"] = max(errs["o"], e)
                errs["m"] = max(errs["m"], r["m_max_abs_err"])
                errs["l_rel"] = max(errs["l_rel"], r["l_max_rel_err"])
                cases.append(r)

    m = torch.rand((1, 4, 16, 16), generator=gen, device=dev) < 0.4
    m[..., 0] = True
    case("k1qs_random_masks", 1, 4, 16, 16, m, 16 * 128, None, [0])
    m = torch.rand((2, 4, 15, 16), generator=gen, device=dev) < 0.5
    m[..., -1] = True
    case("k1qs_text_window_b2", 2, 4, 15, 16, m, 15 * 128 - 40, 15 * 128,
         [100, 37])
    m = torch.zeros((2, 2, 4, 5), dtype=torch.bool, device=dev)
    m[:, :, 0, :3] = True
    m[:, :, 2, 4] = True
    case("k1qs_count0_and_all_masked", 2, 2, 4, 5, m, 4 * 128, 4 * 128,
         [64, 0])
    m = torch.zeros((1, 2, 4, 14), dtype=torch.bool, device=dev)
    m[..., :11] = True
    m[..., 12:] = True
    case("k1qs_clean_prefix", 1, 2, 4, 14, m, 11 * 128 - 60, 12 * 128, [150])
    return errs, cases


# the S3 variants chip_smoke drives (every S3a name, the three-stage ring
# for the load, compute and whole kernels, twophase, runs at three caps)
# and the S2 groups
S3_DRIVEN = ("base", "base3", "dma", "dma3", "dmahalf", "dmabig", "compute",
             "compute3", "computeclean", "computenomask", "computenoexp",
             "nomask", "noexp", "twophase", "runs1", "runs2", "runs4")
S2_GROUPS = (2, 4)


def s3_call(kv, name, args, kw, plain=False):
    """The wrapper (or, ``plain``, its plain version) of S3 ``name``."""
    if name == "twophase":
        fn = kv.twophase_torch if plain else kv.twophase
        return lambda: fn(*args, **kw)
    if name.startswith("runs"):
        fn = kv.runs_torch if plain else kv.runs
        return lambda: fn(*args, max_run=int(name[4:]), **kw)
    fn = kv.kernel_variant_torch if plain else kv.kernel_variant
    return lambda: fn(name, *args, **kw)


def variant_vs_plain(name, got, want, exact: bool) -> dict:
    """A variant against its plain version: bit for bit (the load-only
    variants' fp32 sums), NaN where the plain version has NaN (noexp), or
    the bf16 tolerance and the relative limits."""
    nan = torch.isnan(want.float())
    if not torch.equal(nan, torch.isnan(got.float())):
        raise AssertionError(f"{name}: NaN positions differ from the plain "
                             "version")
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not bit for bit its plain version")
        return {"case": name, "bit_exact": True}
    if nan.all():
        return {"case": name, "all_nan": True}
    keep = ~nan
    g, w = got[keep].float(), want[keep].float()
    # the repo's bf16 tolerance, rtol = atol = TOL (tests/test_kernels.py)
    if not bool(((g - w).abs() <= TOL + TOL * w.abs()).all()):
        raise AssertionError(f"{name}: beyond rtol = atol = {TOL}: max abs "
                             f"err {max_err(g, w)}")
    if want[keep].float().abs().max() == 0:
        if got[keep].float().abs().max() != 0:
            raise AssertionError(f"{name}: not 0 where its plain version is")
        return {"case": name, "zero": True}
    return {"case": name, **held_to_scale(name, got[keep], want[keep])}


def kernelvars_phase(kernels):
    """S3: each variant against its plain version at the small grid; then
    the kernelvars bench at the HunyuanVideo point (its main path, the
    launch counters zeroed just before and read just after), base held to
    K1 there by the relative limits, twophase equal to base and runs* to
    K1 bit for bit; S3c's pieces per list; then every variant but the
    three-stage rings on the bench's full plan against its plain version
    (the load-only variants bit for bit, noexp's NaN rows), the three-stage
    rings equal to the two-stage ones; per variant its time against K1's,
    the bytes it gathers (GB/s) or the operations it does (TF/s)."""
    from rectified_spaattn_tpu_torch.bench import kernelvars
    kv = kernels.variants
    res = {"small_vs_plain": []}
    st = kernelvars.setup(small=True)
    args = (st["q"], st["k"], st["v"], st["indices"], st["counts"], st["tlen"])
    kw = dict(visual_len=st["visual_len"], text_start=st["visual_len"],
              chunk_blocks=16)
    for name in S3_DRIVEN:
        res["small_vs_plain"].append(variant_vs_plain(
            f"s3_small_{name}", s3_call(kv, name, args, kw)(),
            s3_call(kv, name, args, kw, plain=True)(),
            exact=name.rstrip("3") in kv.LOAD_ONLY))
    del st, args
    torch.cuda.empty_cache()

    for f in (kv.kernel_variant, kv.twophase, kv.runs):
        f.launches.clear()
    # K1 timed first and last (the variants against the mean), 5 calls each
    bench = kernelvars.main(["--variants",
                             ",".join(["k1", *S3_DRIVEN, "k1"]),
                             "--check", "--iters", "5"])
    res["launches"] = {**kv.kernel_variant.launches, **kv.twophase.launches,
                       **kv.runs.launches}
    missing = [n for n in S3_DRIVEN if not res["launches"].get(n)]
    if missing:
        raise AssertionError(f"S3 variants never launched: {missing}")
    checked = {n for n in S3_DRIVEN if kernelvars.reference(n)}
    if set(bench["check"]) != checked:
        raise AssertionError(f"kernelvars checked {sorted(bench['check'])}, "
                             f"not {sorted(checked)}")
    for name, r in bench["check"].items():
        if name == "base":
            if not (r["max_abs_err"] <= REL_MAX * r["ref_max_abs"]
                    and r["rms_err"] <= REL_RMS * r["ref_std"]):
                raise AssertionError(f"base vs K1 beyond the relative "
                                     f"limits: {r}")
        elif not r["equal"]:
            raise AssertionError(f"{name} not bit for bit {r['ref']} on the "
                                 f"full plan: {r}")
    res["bench"] = bench

    st = kernelvars.setup()
    args = (st["q"], st["k"], st["v"], st["indices"], st["counts"], st["tlen"])
    kw = dict(visual_len=st["visual_len"], text_start=st["visual_len"],
              chunk_blocks=16)
    # S3c's walk on this plan: per list, its units and each cap's pieces
    # (the producer's index reads)
    lists = st["counts"].numel()
    res["units_per_row"] = float(st["counts"].sum()) / lists
    res["pieces_per_row"] = {
        n: float((kv.piece_lengths(st["indices"], st["counts"], 16,
                                   int(n[4:])) > 0).sum()) / lists
        for n in S3_DRIVEN if n.startswith("runs")}
    res["full_vs_plain"] = {}
    for name in ("base", "twophase", "runs4", "dma", "dmahalf", "dmabig",
                 "compute", "computeclean", "computenomask", "computenoexp",
                 "nomask", "noexp"):
        got = s3_call(kv, name, args, kw)()
        t0 = time.perf_counter()
        want = s3_call(kv, name, args, kw, plain=True)()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        res["full_vs_plain"][name] = {
            **variant_vs_plain(f"s3_full_{name}", got, want,
                               exact=name in kv.LOAD_ONLY),
            "plain_ms": plain_ms}
        del got, want
    for name in ("base", "dma", "compute"):
        if not torch.equal(s3_call(kv, name + "3", args, kw)(),
                           s3_call(kv, name, args, kw)()):
            raise AssertionError(f"{name}3 differs from {name}")
    torch.cuda.empty_cache()

    # the work of each variant on this plan
    b, h = st["q"].shape[:2]
    g = 16
    counts = st["counts"].long()
    pairs = float(counts.sum())
    ext = float(((counts + g - 1) // g * g).sum())     # the chunk extent
    # the bytes each pair's block copy moves: every variant's 128-row CTA
    # copies a block's K and V once (64 KB)
    per_pair = 128 * 2 * 128 * 2
    gathered = {"dmahalf": pairs * per_pair / 2, "dmabig": ext * per_pair,
                "nomask": ext * per_pair, "computenomask": 0.0,
                **{n: 0.0 for n in ("compute", "compute3", "computeclean",
                                    "computenoexp")}}
    flops_pair = 4.0 * 128 * 128 * 128
    used = used_blocks(st["indices"], st["counts"])
    k1_bytes = (2 * b * h * st["visual_len"] * 128 * 2 + used * 128 * 256 * 2
                + st["indices"].numel() * 4 + counts.numel() * 4)
    k1_ms = bench["ms"]["k1"]
    res["variants"] = {}
    for name in S3_DRIVEN:
        ms = bench["ms"][name]
        nbytes = gathered.get(name, pairs * per_pair)
        flops = 0.0 if name.rstrip("3") in kv.LOAD_ONLY else flops_pair * (
            ext if name in ("nomask", "computenomask") else pairs)
        r = {"ms": ms, "vs_k1": ms / k1_ms, "gathered_gb": nbytes / 1e9,
             "gathered_gb_per_s": nbytes / ms / 1e6,
             "tflops_per_s": flops / ms / 1e9}
        print(json.dumps({"s3_variant": name, **r}), flush=True)
        res["variants"][name] = r
    res["k1_ms"] = k1_ms
    res["pairs"], res["chunk_extent_pairs"] = pairs, ext
    res["bound_ms"], res["bound_by"] = bound_ms(pairs * flops_pair, k1_bytes)
    return res


def groupedvars_phase(kernels):
    """S2: each variant at G = 2 and 4 against its plain version at the
    small grid; then the groupedvars bench at the HunyuanVideo point (its
    main path, the launch counters zeroed just before and read just after;
    full and prefetch held to K1's single-row output); then on the bench's
    plan full, nobias, compute and computeclean at G = 2 and full at G = 4
    against their plain versions, dma bit for bit, full and prefetch equal
    to K2's output bit for bit (full is K2's mainloop policy, prefetch the
    same arithmetic per row tile)."""
    from rectified_spaattn_tpu_torch.bench import groupedvars
    kv = kernels.variants
    res = {"small_vs_plain": []}

    def run_all(st, g, grouped, plain=False):
        fn = kv.grouped_variant_torch if plain else kv.grouped_variant
        return lambda name: fn(name, st["q"], st["k"], st["k"], *grouped,
                               st["tlen"], group=g,
                               visual_len=st["visual_len"],
                               text_start=st["visual_len"])

    st = groupedvars.setup(small=True)
    for g in S2_GROUPS:
        grouped = groupedvars.lists(st, g)
        for name in kv.S2:
            res["small_vs_plain"].append(variant_vs_plain(
                f"s2_small_g{g}_{name}", run_all(st, g, grouped)(name),
                run_all(st, g, grouped, plain=True)(name),
                exact=name == "dma"))
    del st
    torch.cuda.empty_cache()

    kv.grouped_variant.launches.clear()
    bench = groupedvars.main(["--groups", ",".join(map(str, S2_GROUPS)),
                              "--check", "--iters", "5"])
    res["launches"] = dict(kv.grouped_variant.launches)
    missing = [f"g{g}_{n}" for g in S2_GROUPS for n in kv.S2
               if not res["launches"].get(f"g{g}_{n}")]
    if missing:
        raise AssertionError(f"S2 variants never launched: {missing}")
    for name, r in bench["check"].items():
        if not (r["max_abs_err"] <= REL_MAX * r["ref_max_abs"]
                and r["rms_err"] <= REL_RMS * r["ref_std"]):
            raise AssertionError(f"{name} vs K1 beyond the relative limits: "
                                 f"{r}")
    res["bench"] = bench

    st = groupedvars.setup()
    res["full_vs_plain"] = {}
    for g, name in ((2, "full"), (2, "nobias"), (2, "compute"),
                    (2, "computeclean"), (4, "full")):
        grouped = groupedvars.lists(st, g)
        got = run_all(st, g, grouped)(name)
        t0 = time.perf_counter()
        want = run_all(st, g, grouped, plain=True)(name)
        torch.cuda.synchronize()
        res["full_vs_plain"][f"g{g}_{name}"] = {
            **variant_vs_plain(f"s2 {name} g{g}", got, want, exact=False),
            "plain_ms": (time.perf_counter() - t0) * 1e3}
        del got, want
    grouped = groupedvars.lists(st, 2)
    run2 = run_all(st, 2, grouped)
    k2 = kernels.block_sparse_flash_attention_grouped(
        st["q"], st["k"], st["k"], *grouped, st["tlen"], group=2,
        visual_len=st["visual_len"], text_start=st["visual_len"])
    for name in ("full", "prefetch"):
        if not torch.equal(run2(name), k2):
            raise AssertionError(f"S2 {name} is not K2's output bit for bit")
    res["full_prefetch_vs_k2"] = {"bit_exact": True}
    del k2
    res["dma_vs_plain"] = variant_vs_plain(
        "s2 dma g2", run2("dma"), run_all(st, 2, grouped, plain=True)("dma"),
        exact=True)
    b, h = st["q"].shape[:2]
    pairs = float(st["mask"].sum())
    used = float(st["mask"].any(dim=2).sum())
    k2_bytes = (2 * b * h * st["visual_len"] * 128 * 2 + used * 128 * 256 * 2
                + sum(t.numel() * 4 for t in grouped))
    res["pairs"] = pairs
    res["bound_ms"], res["bound_by"] = bound_ms(pairs * 4.0 * 128 ** 3,
                                                k2_bytes)
    return res


def kernel_ab_phase():
    """kernel_ab.py (beside this file) on this tree: the attention kernels
    at the main path's shapes, each beside the SDPA call on the same
    inputs, 3 calls each; its one JSON line's numbers."""
    spec = importlib.util.spec_from_file_location(
        "kernel_ab", os.path.join(ROOT, "kernel_ab.py"))
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    res = ab.main(["--reps", "3", "--label", "chip_smoke"])
    return {n: v for n, v in res.items() if n not in ("label", "root")}


def headline_phase():
    """The headline bench at the HunyuanVideo point: its one JSON line."""
    from rectified_spaattn_tpu_torch.bench import headline
    line = headline.main([])
    d = line["detail"]
    if not all(map(lambda x: x == x and 0 < x < float("inf"),
                   (line["value"], d["sparse_ms"], d["dense_ours_ms"],
                    d["dense_stock_flash_ms_oneshot"],
                    d["random_inputs"]["sparse_ms"]))):
        raise AssertionError(f"headline times not finite and positive: "
                             f"{line}")
    return line


def k1q_stats_entry(src, site, smooth, small_errs) -> dict:
    """The kernels line's K1q-s entry: mxu8 at the Hunyuan site (random
    inputs) against its plain version on the full inputs."""
    r = site["K1q-s_mxu8_visual"]
    launches = {f"{m}_{reg}": kern[f"K1q-s_{m}_visual"]["launches"]
                for reg, kern in (("random", site), ("smooth", smooth))
                for m in ("int8", "mxu8")}
    return {"name": "K1q-s", "route": "cuda", "source": src,
            "replaces": "rectified_spaattn_tpu/kernels/block_sparse.py:176",
            "design": "hopper_attn_q_kernel with STATS (m and l as K1s "
                      "writes them)",
            "launches": sum(launches.values()),
            "launches_by_path": {"k1q_stats_at_site": launches},
            "max_abs_err": max(small_errs["o"], r["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
            "shape": "mxu8, visual rows: q [1,24,115200,128], int8 K|V "
                     "[24,115456,256], chunk_blocks 24, with m and l",
            "other_jobs": {"int8_visual": site["K1q-s_int8_visual"],
                           "mxu8_visual_smooth": smooth["K1q-s_mxu8_visual"],
                           "int8_visual_smooth": smooth["K1q-s_int8_visual"]}}


def variant_entries(s3, s2, sass) -> list:
    """The kernels line's S3a, S3b, S3c and S2 entries: each at the
    benches' HunyuanVideo plans, its launches in the bench's run, its
    plain version on the full plan, the bound of the attention it computes
    (S3a: base, S3c: runs4, S2: full at G = 2), and its time against K1's
    (S3) or K2's (S2) on the same plan, each S3 kernel's device time
    alone beside K1's (the bench's ``kernel_ms``); S3c's TMA loads in its
    SASS against K1's (``sass``: the build's SASS counts)."""
    src = "rectified_spaattn_tpu_torch/csrc/variants.cu"
    bench, launches = s3["bench"], s3["launches"]
    small_err = lambda prefix: max(
        [c.get("max_abs_err", 0.0) for c in s3["small_vs_plain"]
         if c["case"].startswith(prefix)] or [0.0])

    def s3_entry(name, key, replaces, names, shape, design, **extra):
        full = s3["full_vs_plain"][key]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "design": design,
                "launches": sum(launches.get(n, 0) for n in names),
                "launches_by_path": {"bench.kernelvars": {
                    n: launches.get(n, 0) for n in names}},
                "max_abs_err": max(full["max_abs_err"],
                                   small_err(f"s3_small_{key}")),
                "ms": bench["ms"][key], "plain_ms": full["plain_ms"],
                "bound_ms": s3["bound_ms"], "bound_by": s3["bound_by"],
                "library_ms": None, "shape": shape,
                "k1_ms_same_plan": s3["k1_ms"],
                "k1_ms_first_last": bench["ms_each"]["k1"],
                "vs_k1": bench["ms"][key] / s3["k1_ms"],
                # the kernels alone, from the bench's profiler trace
                "kernel_ms": bench["kernel_ms"][key],
                "k1_kernel_ms": bench["kernel_ms"]["k1"],
                "other_jobs": {n: s3["variants"][n] for n in names},
                **extra}

    plan = ("kernelvars plan: q [1,24,115200,128] x 902 key blocks, "
            "realistic_qkv, chunk_blocks 16")
    s3a = [n for n in S3_DRIVEN if n != "twophase" and not
           n.startswith("runs")]
    runs = [n for n in S3_DRIVEN if n.startswith("runs")]
    s2_full = s2["full_vs_plain"]["g2_full"]
    s2_small = max(c.get("max_abs_err", 0.0) for c in s2["small_vs_plain"])
    s2_ms = s2["bench"]["ms"]
    policy = "hopper mainloop policy"
    return [
        s3_entry("S3a", "base", "scripts/bench_kernelvars.py:56", s3a,
                 f"base (every unit masked), {plan}", policy),
        s3_entry("S3b", "twophase", "scripts/bench_kernelvars.py:205",
                 ["twophase"], f"twophase, {plan}", policy,
                 base_ms_same_plan=bench["ms"]["base"],
                 vs_base=bench["ms"]["twophase"] / bench["ms"]["base"]),
        s3_entry("S3c", "runs4", "scripts/bench_kernelvars.py:316", runs,
                 f"runs4 (run pieces, 128-row boxes), {plan}", policy,
                 utmaldg_sass=tma_loads(sass["variants"], "RunPieces"),
                 k1_utmaldg_sass=tma_loads(sass["block_sparse"],
                                           "SparseTilesIS1_Lb0E"),
                 units_per_row=s3["units_per_row"],
                 pieces_per_row=s3["pieces_per_row"]),
        {"name": "S2", "route": "cuda", "source": src,
         "replaces": "scripts/bench_groupedvars.py:39", "design": policy,
         "launches": sum(s2["launches"].values()),
         "launches_by_path": {"bench.groupedvars": s2["launches"]},
         "max_abs_err": max(s2_full["max_abs_err"], s2_small),
         "ms": s2_ms["g2_full"], "plain_ms": s2_full["plain_ms"],
         "bound_ms": s2["bound_ms"], "bound_by": s2["bound_by"],
         "library_ms": None,
         "shape": "full at G=2, groupedvars plan: q [1,24,115200,128], "
                  "smooth q/k (v = k), chunk_blocks 16",
         "k2_ms_same_plan": s2_ms["g2_k2"],
         "k2_ms_first_last": s2["bench"]["ms_each"]["g2_k2"],
         "vs_k2": s2_ms["g2_full"] / s2_ms["g2_k2"],
         "g1_ms_same_plan": s2_ms["g1"],
         "other_jobs": {k: {"ms": v, "vs_k2": v / s2_ms[k[:3] + "k2"]}
                        for k, v in s2_ms.items()
                        if k != "g2_full" and k[:3] + "k2" in s2_ms}},
    ]


# ------------------------------------------------------------------ main ---

def main() -> int:
    t_start = time.perf_counter()
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
         torch=torch.__version__, cuda=torch.version.cuda,
         device_count=torch.cuda.device_count())

    t0 = time.perf_counter()
    errs, cases = kernel_cases(kernels, ops)
    emit("kernels_vs_plain", t0, tolerance=TOL, max_abs_err=errs, cases=cases)

    t0 = time.perf_counter()
    qerrs, qcases = k1q_cases(kernels, ops)
    emit("k1q_vs_plain", t0, tolerance=TOL, max_abs_err=qerrs, cases=qcases)

    t0 = time.perf_counter()
    serrs, scases = k1s_cases(kernels, ops)
    emit("k1s_vs_plain", t0, tolerance={"o": TOL, "m": M_TOL, "l_rel": L_REL},
         max_err=serrs, cases=scases)

    t0 = time.perf_counter()
    qserrs, qscases = k1q_stats_cases(kernels, ops)
    emit("k1q_stats_vs_plain", t0,
         tolerance={"o": TOL, "m": M_TOL, "l_rel": L_REL}, max_err=qserrs,
         cases=qscases)

    sites = {}
    for regime in ("random", "smooth"):
        t0 = time.perf_counter()
        res, sites[regime] = site_phase(kernels, ops, regime)
        emit(f"site_{regime}", t0, **res)
        emit(f"site_k1q_{regime}", t0,
             chunk_blocks=res["k1q_chunk_blocks"],
             bf16_k1_ms=sites[regime]["K1_visual_g1"]["ms"],
             **{n: r for n, r in sites[regime].items()
                if n.startswith("K1q")})
    # K1q-s: the small cases above and, at the site, its time with and
    # without the stats (both regimes)
    t0 = time.perf_counter()
    k1qs = {f"{n}_{regime}": r for regime, kern in sites.items()
            for n, r in kern.items() if n.startswith("K1q-s")}
    emit("k1q_stats", t0, max_err_small=qserrs, **k1qs)

    t0 = time.perf_counter()
    small = small_pipeline_check()
    emit("small_pipeline_gpu_vs_cpu", t0, **small)

    t0 = time.perf_counter()
    pipe, pipe_latents = pipeline_phase(kernels)
    emit("pipeline", t0, **pipe)

    t0 = time.perf_counter()
    probe = int8_probe_phase()
    emit("int8_probe", t0, **probe)

    t0 = time.perf_counter()
    small4 = small_int4_check(kernels)
    emit("small_pipeline_int4_gpu_vs_cpu", t0, **small4)

    t0 = time.perf_counter()
    pipe8 = pipeline_int8_phase(kernels, pipe["peak_mem_gb"])
    emit("pipeline_int8", t0, **pipe8)

    wsites = {}
    for regime in ("random", "smooth"):
        t0 = time.perf_counter()
        res, wsites[regime] = wan_site_phase(kernels, regime)
        emit(f"wan_site_{regime}", t0, **res)

    t0 = time.perf_counter()
    small = small_wan_pipeline_check()
    emit("small_wan_pipeline_gpu_vs_cpu", t0, **small)

    t0 = time.perf_counter()
    wpipe = wan_pipeline_phase(kernels)
    emit("wan_pipeline", t0, **wpipe)

    rings, ring_res, ring_ref = {}, {}, None
    for regime in ("random", "smooth"):
        t0 = time.perf_counter()
        ring_res[regime], rings[regime], outs = ring_hunyuan_phase(
            kernels, ops, regime)
        if regime == "random":
            ring_ref = outs
        del outs
        emit(f"ring_hunyuan_{regime}", t0, **ring_res[regime])

    t0 = time.perf_counter()
    wring, rings["wan"] = ring_wan_phase(kernels, ops)
    emit("ring_wan", t0, **wring)

    t0 = time.perf_counter()
    s3 = kernelvars_phase(kernels)
    emit("kernelvars", t0, **s3)

    t0 = time.perf_counter()
    s2 = groupedvars_phase(kernels)
    emit("groupedvars", t0, **s2)

    t0 = time.perf_counter()
    head = headline_phase()
    emit("headline", t0, line=head)

    t0 = time.perf_counter()
    ab = kernel_ab_phase()
    emit("kernel_ab", t0, **ab)

    t0 = time.perf_counter()
    if torch.cuda.device_count() < 2:
        print(json.dumps({"phase": "multi_gpu", "skipped": "1 device"}),
              flush=True)
    else:
        emit("multi_gpu", t0, **multi_gpu_phase(ring_ref, pipe_latents))

    site, smooth = sites["random"], sites["smooth"]
    wsite = wsites["random"]
    src = "rectified_spaattn_tpu_torch/csrc/block_sparse.cu"
    k1, k2, k1t = (site["K1_visual_g1"], site["K2_visual_g2"],
                   site["K1_text_rows"])
    k3, k3i = wsite["K3_t2v_text"], wsite["K3_i2v_image"]
    by_path = lambda n: {"hunyuan": pipe["launches"][n],
                         "wan": wpipe["launches"][n]}
    ks_t, ks_v = rings["random"]["K1s_ring_text"], \
        rings["random"]["K1s_ring_visual"]
    mainloop = "rectified_spaattn_tpu_torch/csrc/hopper_attn.cuh"
    design = ("the Hopper mainloop of " + mainloop + " (128-row CTAs, TMA "
              "into an mbarrier ring, wgmma, branch-free mask)")
    # kernel_ab's times beside SDPA's at the main path's shapes
    ab_of = lambda *names: {n: {"ms": ab[n], "sdpa_ms": ab.get(f"{n}_sdpa")}
                            for n in names}
    q_design = ("hopper_attn_q_kernel on the mainloop's parts: int8 tiles "
                "by TMA into a staging ring, converted to 16 bits by the "
                "producer warpgroup; mxu8's QK^T on the s8 wgmma")
    merge = site["K1_merge"]
    line = {"kernels": [
        {"name": "K1", "route": "cuda", "source": src,
         "replaces": "rectified_spaattn_tpu/kernels/block_sparse.py:89",
         "launches": pipe["launches"]["K1"] + wpipe["launches"]["K1"],
         "launches_by_path": by_path("K1"),
         "max_abs_err": max(errs["K1"], k1t["max_abs_err"]),
         "ms": k1t["ms"], "plain_ms": k1t["plain_ms"],
         "bound_ms": k1t["bound_ms"], "bound_by": k1t["bound_by"],
         "library_ms": k1t["library_ms"],
         "shape": "text rows: q [1,24,256,128] x full lists over 902 blocks",
         "design": design + ", key split for short-row launches",
         "kernel_ab": ab_of("K1_text_rows", "K1_dense_bm1024",
                            "K1_wan_dense_bm1024", "K1_visual_g1"),
         "other_jobs": {"visual_rows_g1": k1,
                        "visual_rows_g1_smooth": smooth["K1_visual_g1"],
                        "dense_bm1024": site["K1_dense_bm1024"],
                        "wan_visual_g1": wsite["K1_wan_visual_g1"],
                        "wan_visual_g1_smooth":
                            wsites["smooth"]["K1_wan_visual_g1"],
                        "wan_dense_bm1024": wsite["K1_wan_dense_bm1024"]}},
        {"name": "K2", "route": "cuda", "source": src,
         "replaces": "rectified_spaattn_tpu/kernels/block_sparse.py:317",
         "launches": pipe["launches"]["K2"] + wpipe["launches"]["K2"],
         "launches_by_path": by_path("K2"),
         "max_abs_err": max(errs["K2"], k2["max_abs_err"],
                            site["K2_visual_g4"]["max_abs_err"]),
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None,
         "shape": "visual rows: q [1,24,115200,128], G=2 union lists",
         "design": design + ", member slots of the union list only",
         "kernel_ab": ab_of("K2_visual_g2"),
         "other_jobs": {"visual_rows_g2_smooth": smooth["K2_visual_g2"],
                        "visual_rows_g4": site["K2_visual_g4"],
                        "visual_rows_g4_smooth": smooth["K2_visual_g4"]}},
        {"name": "K3", "route": "cuda",
         "source": "rectified_spaattn_tpu_torch/csrc/dense_flash.cu",
         "replaces": "rectified_spaattn_tpu/kernels/flash.py:49",
         "launches": pipe["launches"]["K3"] + wpipe["launches"]["K3"],
         "launches_by_path": by_path("K3"),
         "max_abs_err": max(errs["K3"], k3["max_abs_err"],
                            k3i["max_abs_err"]),
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": k3["library_ms"],
         "shape": "Wan T2V text cross: q [1,40,75648,128] x 512 keys",
         "design": design + ", persistent CTAs",
         "kernel_ab": ab_of("K3_t2v_text", "K3_i2v_image"),
         "other_jobs": {"i2v_image_cross_257": k3i}},
        {"name": "K1q", "route": "cuda", "source": src,
         "replaces": "rectified_spaattn_tpu/kernels/block_sparse.py:176",
         "launches": (pipe8["launches"]["K1q_mxu8"]
                      + small4["launches"]["K1q_int8"]),
         "launches_by_path": {
             "hunyuan_int8_pipeline_mxu8": pipe8["launches"]["K1q_mxu8"],
             "small_int4_pipeline_int8": small4["launches"]["K1q_int8"]},
         "max_abs_err": max(*qerrs.values(),
                            site["K1q_mxu8_visual"]["max_abs_err"],
                            site["K1q_int8_visual"]["max_abs_err"]),
         "ms": site["K1q_mxu8_visual"]["ms"],
         "plain_ms": site["K1q_mxu8_visual"]["plain_ms"],
         "bound_ms": site["K1q_mxu8_visual"]["bound_ms"],
         "bound_by": site["K1q_mxu8_visual"]["bound_by"],
         "library_ms": None,
         "shape": "mxu8, visual rows: q [1,24,115200,128], int8 K|V "
                  "[24,115456,256], chunk_blocks 24",
         "design": q_design,
         "kernel_ab": ab_of("K1q_mxu8_visual", "K1q_int8_visual"),
         "other_jobs": {"int8_visual": site["K1q_int8_visual"],
                        "mxu8_visual_smooth": smooth["K1q_mxu8_visual"],
                        "int8_visual_smooth": smooth["K1q_int8_visual"]}},
        {"name": "S1", "route": "cuda",
         "source": "rectified_spaattn_tpu_torch/csrc/int8_probe.cu",
         "replaces": "scripts/bench_int8mxu.py:30",
         "launches": probe["launches"],
         "launches_by_path": {"int8_probe": probe["launches"]},
         "max_abs_err": probe["check"]["int8"]["max_abs_err"],
         "ms": probe["int8"]["ms"],
         "plain_ms": probe["check"]["int8"]["plain_ms"],
         "bound_ms": probe["int8"]["bound_ms"], "bound_by": "operations",
         "library_ms": probe["int8"]["library_ms"],
         "library_call": probe["int8"]["library"],
         "library_one_dot_ms": probe["int8"]["library_one_dot_ms"],
         "peak_share": probe["int8"]["peak_share"],
         "sm_clock_power": probe["int8"]["sm_clock_power"],
         "shape": f"int8, {probe['pairs']} pairs of {probe['shape']}",
         "design": "the mainloop's CTA: TMA into an mbarrier ring, "
                   "m64n128k32 s8 / m64n128k16 bf16 wgmma, persistent",
         "bf16": {"ms": probe["bf16"]["ms"],
                  "plain_ms": probe["check"]["bf16"]["plain_ms"],
                  "max_abs_err": probe["check"]["bf16"]["max_abs_err"],
                  "bound_ms": probe["bf16"]["bound_ms"],
                  "bound_by": "operations",
                  "peak_share": probe["bf16"]["peak_share"],
                  "sm_clock_power": probe["bf16"]["sm_clock_power"],
                  "library_ms": probe["bf16"]["library_ms"],
                  "library_call": probe["bf16"]["library"],
                  "library_one_dot_ms": probe["bf16"]["library_one_dot_ms"]},
         "int8_over_bf16": probe["int8_over_bf16"]},
        {"name": "K1s", "route": "cuda", "source": src,
         "replaces": "rectified_spaattn_tpu/kernels/block_sparse.py:311",
         "launches": (ring_res["random"]["launches"]["K1s"]
                      + wring["launches"]["K1s"]),
         "launches_by_path": {
             "ring_hunyuan": ring_res["random"]["launches"]["K1s"],
             "ring_wan": wring["launches"]["K1s"]},
         "max_abs_err": max(serrs["o"], ks_t["max_abs_err"],
                            ks_v["max_abs_err"]),
         "ms": ks_t["ms"], "plain_ms": ks_t["plain_ms"],
         "bound_ms": ks_t["bound_ms"], "bound_by": ks_t["bound_by"],
         "library_ms": ks_t["library_ms"],
         "library_lse_vs_m_log_l": ks_t["library_lse_vs_m_log_l"],
         "shape": "one ring step, text rows: q [1,24,256,128] x full lists "
                  "over one sp=4 shard (225 blocks)",
         "design": design + ", key split for short-row launches",
         "kernel_ab": ab_of("K1s_ring_text"),
         "other_jobs": {"ring_visual_rows": ks_v,
                        "ring_visual_rows_smooth":
                            rings["smooth"]["K1s_ring_visual"],
                        "ring_text_rows_smooth":
                            rings["smooth"]["K1s_ring_text"],
                        "wan_ring_visual_rows":
                            rings["wan"]["K1s_ring_wan_visual"]}},
        {"name": "K1_merge", "route": "cuda", "source": src,
         "replaces": "rectified_spaattn_tpu/kernels/block_sparse.py:89 "
                     "(K1/K1s's key split; the merge of "
                     "rectified_spaattn_tpu/attention/ring.py:48)",
         "launches": pipe["launches"]["K1_merge"]
                     + wpipe["launches"]["K1_merge"],
         "launches_by_path": by_path("K1_merge"),
         "max_abs_err": merge["max_abs_err"], "ms": merge["ms"],
         "plain_ms": merge["plain_ms"], "bound_ms": merge["bound_ms"],
         "bound_by": merge["bound_by"], "library_ms": None,
         "shape": f"{merge['n_split']} ranges x 6,144 rows x 128 (the "
                  "Hunyuan text rows' split)",
         "design": "one warp a row"},
        k1q_stats_entry(src, site, smooth, qserrs),
        *variant_entries(s3, s2, ptxas["sass"]),
    ]}
    t0 = time.perf_counter()
    emit("total", t0, total_seconds=time.perf_counter() - t_start)
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
