#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py          # from the repository root, one GPU
                                   # (more cards add the multi_gpu phase)

Builds the port's CUDA kernels from rectified_spaattn_tpu_torch/csrc with
nvcc (sm_90a, one nvcc per source, all started together) and drives the
HunyuanVideo sparse denoise path (T2V and I2V), its int8 serving levers
(K1q, S1, int8 / int4 weights, the int8 offloaded TeaCache residual), the
Wan2.1-14B denoise path, Wan2.2 A14B with host_swap, the CogVideoX1.5
T2V / I2V path (K1 and K2 at head_dim 64), Flux.1-dev's two-stage 4096^2
upscale with its ControlNet (K1, K2 and K3 at 65,536 + 512 tokens), batch
evaluation (eval/run_eval.py and the multi-process launcher), the
stacked block execution (models/scan.py: scan_blocks and
dispatch_segments, and HunyuanVideo at its published depth with int4 weights), the
multi-device path (K1s, the ring, tensor parallelism)
and the kernel-diagnostic path (K1q-s, the S3 / S2 ablations, the
headline bench, the plan-stage and diagnostic benches).  Every attention kernel (K1/K1s, K2, K1q/K1q-s, K3)
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
     given sm_scale; then K1 and K2 at head_dim 64 in CogVideoX's joint
     layout with visual_len % 128 != 0 (visual rows, packed K|V, text rows
     split and merged, the windowed dense at block_m 1024, K2 at G = 2 and
     4); max abs error <= 2e-2 and, relative to the output's
     own scale, max abs error <= 5 % of max |output| and rms error <= 2 %
     of its std.  Then P1 (the plan's top-p selection, plan_select.cu)
     at the benchmark cells' probs shapes and the plan's other row
     lengths: its masks against the plain model of its summation order
     (bit for bit) and the plain bisection (rows apart only within 1e-5
     of p_remain, counted), its device ms (a profiler trace) beside
     its bound and the plain bisection's, its launches.  Then K1q ("int8" and "mxu8") against its plain version:
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
  4a. pipeline_i2v: the same pipeline as HunyuanVideo I2V
     (image_condition_type "token_replace"), the same weights, noise and
     text and a seeded first-frame latent: launch counters zeroed just
     before and read just after, held to phase 4's per computed step; the
     first frame held bit for bit; s/step against phase 4's; then the
     small pipeline on the GPU (bf16) against the CPU (fp32) under
     token_replace and under latent_concat (in_channels 33), held to the
     output's scale.
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
  4c. ckpt: the pixel end.  The port's safetensors codec on every dtype,
     written and read back bit for bit; the HunyuanVideo VAE at its
     published widths (a seeded bf16 vae/ snapshot, loaded in fp32) on the
     GPU against the CPU at a [1,16,2,8,8] latent (fp32 rtol 2e-4 / atol
     2e-5, TF32 off), the untiled and tiled (32 / 4) decode of a
     [1,16,9,60,104] latent (480x832x33) timed with their peak memory, and
     the encode of its frames back to the latent's shape; then a seeded
     bf16 transformer/ snapshot (HunyuanVideoConfig() widths, 2 dual + 2
     single blocks): load_transformer on the card (seconds, peak host RSS,
     device bytes), every tensor equal bit for bit to a CPU load, and the
     CLI with --ckpt_dir at 480x832, --frame 36 (9 latent frames, 33
     decoded), 2 sparse steps at group_rows 2 -- K1's and K2's launch
     counters zeroed just before and read just after, uint8 frames
     [33,480,832,3] written; then the CLI's --model hunyuan-i2v on the
     same snapshot with a seeded .npy --image, the VAE's encode of it held
     in the final latents' first frame bit for bit.
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
  6a. wan22_a14b: Wan2.2 I2V-A14B, two WanConfig(in_channels=36) trees
     at full width cut to 6 blocks (2 warm, 2 sparse, 2 last-warm),
     seeds 0 and 1, 720x1280x81, 4 Euler steps over the boundary 0.875 (2
     high, 2 low) under CFG, TeaCache on, the i2v_condition of a seeded
     image through the CLI's stand-in encoder: first co-resident, then
     with host_swap (both trees pinned on the host) -- launch counters and
     sparse plans zeroed just before and read just after, the output
     equal to the co-resident run bit for bit, the device weight bytes
     after every swap at most one tree's + 5 %; load and swap seconds,
     GB/s, the 40-block extrapolation, s/step and both peaks (the swap
     run's by segment: load, high steps, low steps); then the same swap
     on stacked trees (scan_blocks, dispatch_segments=2): equal
     to the co-resident run bit for bit, each swapped tree exactly one
     tree's bytes, its peak within 5 % of the unstacked swap's.
  6c. cog_site: the CogVideoX1.5 site at its operating point (the token
     grid (6, 48, 85): 24,480 visual tokens, 191 blocks + 32 keys, and a
     256-slot text tail with 226 valid; 48 heads x 64, sa_drop_rate 0.85,
     p_remain 0.3) on random and smooth inputs: plan and site ms, then K1
     visual rows, K2 at G = 2, K1 text rows (split and merged) and the
     windowed dense K1 at block_m 1024, each against its plain version on
     the full inputs, with its time, bound and SDPA's time where one call
     computes the same function.
 6d. pipeline_cogvideox: CogVideoXConfig() at full width and depth (42
     blocks), 768x1360x81, 4 DDIM steps under dynamic CFG (5 dense warm
     calls, then 3 sparse), group_rows 2, TeaCache off, seeded bf16 random
     weights: s/step, peak memory, K1 / K2 / merge launches per dense and
     per sparse call (counters zeroed just before, read just after), and a
     profiled sparse step.  pipeline_cogvideox_i2v: the same at
     in_channels 32 with 6 blocks, ofs 2.0 and a seeded image's condition
     through the CLI's stand-in encoder.  (The small GPU-vs-CPU check of
     phase 4 runs the CogVideoX T2V and I2V pipelines too, TeaCache on,
     and the ckpt phase a CogVideoX leg: a 2-block full-width snapshot in
     diffusers' key layout loaded bit for bit against a CPU load, then
     --model cogvideox-t2v --ckpt_dir at 480x832.)
 6e. flux_site: Flux.1-dev's 4096^2 stage (the token grid (1, 256, 256):
     65,536 visual tokens in 512 blocks, 512 text slots all valid; 24
     heads x 128, sa_drop_rate 0.9, p_remain 0.3) on random and smooth
     inputs: the plan and the site, K2 at G = 2, K1 visual, K1 text rows
     (split and merged), the windowed dense K1 at block_m 1024 (beside
     SDPA: every key is valid, so unmasked) and K3 as the ControlNet runs
     it, unmasked self-attention over all 66,048 tokens (beside unmasked
     SDPA), each against its plain version on the full inputs with its
     time and bound.  pipeline_flux: FluxConfig() at full width and depth
     (19 + 38 blocks, 11.9e9 parameters built on the card in bf16) and
     the 5-block FluxControlNetConfig() (nudged as the CLI's random build
     does) as a FluxUpscalePipeline: base 1024^2 then up 4096^2, 2 steps
     each, every step sparse under the gate (37, 57), nearest-latent
     control, group_rows 2, TeaCache off: s/step per stage, peak memory,
     device weight bytes, the launches of every trunk call (K2 37, K1 57,
     K3 0) and every ControlNet call (K3 5), counters zeroed just before
     and read just after; then one up step under the profiler.  (Phase 4's
     small check runs a small Flux upscale with a ControlNet, nearest
     control and through a small 2-D VAE and the bicubic resize, on the
     GPU in bf16 against the CPU in fp32, and the ckpt phase a Flux leg:
     a seeded bf16 snapshot at FluxConfig() widths cut to 2 + 2 blocks, a
     2-block controlnet/ and FLUX.1-dev's 2-D vae/ config, loaded on the
     card and held to a CPU load bit for bit, then --model flux-upscale
     --ckpt_dir at 1024^2, 2 steps a stage, writing a [1024, 1024, 3]
     uint8 image with K1, K2 and K3 launched.)
 6f. eval: batch evaluation (eval/run_eval.py) on the ckpt phase's
     snapshots, launch counters zeroed just before each phase and read
     just after.  eval_hunyuan: run_eval.main --model hunyuan --ckpt_dir
     (HunyuanVideoConfig() widths, 2 dual + 2 single blocks, its VAE), 3
     prompts at 480x832, --frame 36, 2 steps, --score: the files written
     ([33,480,832,3] uint8), seconds per prompt (its VAE decode apart),
     peak memory; K1 and merge launches of the sparse calls (the 3
     prompts, whose outputs the scoring reuses; G = 1: visual rows, text
     rows split and merged) and of the dense rerun (2 prompts, the
     windowed dense K1) apart, each equal to the count the blocks and
     steps give; diff_vs_dense finite with cosine in (0, 1];
     live_metrics and each gated adapter's availability.
     eval_multihost: the launcher as two processes on this card (python -m
     ...parallel.multihost --coordinator_address 127.0.0.1:<port>
     --num_processes 2 --process_id 0|1, tp 1 over gloo), 3 prompts at
     --frame 12 without --score: rank 0 writes prompts 0 and 2, rank 1
     prompt 1, each file equal byte for byte to a one-process run's.
     eval_flux: --model flux-upscale --ckpt_dir (2 + 2 blocks, FLUX.1-dev's
     VAE config) --controlnet_dir (2 blocks) at 1024^2, 2 steps, --score, 2
     prompts: [1024,1024,3] images, dense_ref over every prompt, FID's
     gate, CLIPScore refused on pseudo-text; K1, K3 (the ControlNet) and
     merge launches of the sparse and the dense calls apart, each equal
     to the count the blocks and steps give, K2 none.
 6g. scan: the stacked block execution (models/scan.py), every run with
     the launch counters zeroed just before and read just after, each
     model stacked in place on the card first (the allocated bytes just
     before and after equal within 1 MiB: no second copy): (a) the
     Hunyuan pipeline of phase 4 (its config, seeds and steps, TeaCache
     on, G = 2) with scan_blocks, then dispatch_segments=2, the latents
     held to phase 4's bit for bit (else, reported, within the pipeline
     limits), launches and TeaCache decisions equal, s/step and peak
     beside phase 4's; (b) the Wan pipeline of phase 6 likewise, its
     sparse plans too; (c) CogVideoX at full width cut to 4 blocks, and
     Flux's upscale cut to 2 + 2 blocks with a 2-block ControlNet and the
     gate (1, 3), unrolled then stacked on the same weights; (d) the
     serving tier at HunyuanVideo's published depth: HunyuanVideoConfig()
     (20 + 40 blocks, 720x1280x128, 115,200 + 256 tokens) with int4
     weights (quantize_model), stacked, dispatch_segments=2, one sparse step
     at G = 2, TeaCache off, against the same step unrolled on the same
     weights: s/step, device weight bytes, peak, K1 / K2 / merge 60 each.
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
 14. fp32: the widths and types the JAX kernels take beyond the paths
     above (TF32 off).  fp32_small: fp32 K1 / K1s (text window at B=2,
     count-0 and degenerate rows, chunk_blocks 2 and 16, packed K|V), K2
     at G = 2 and 4, the key split and its merge, full lists at block_m
     1024, K3 off its tiles and with a kv_valid mask, and the merge
     writing fp32 rows, each at head_dim 128 and 64 against its plain
     version at F32_TOL; K1q / K1q-s in both modes at head_dim 64 and
     with an fp16 or fp32 q, and K3 in bf16 at 64, at phase 2's limits.
     fp32_site: at the Hunyuan site in fp32 K1 visual rows, K2 at G = 2,
     K1 and K1s on the text rows (split, merged), the merge writing fp32
     rows and the windowed dense (beside SDPA in fp32), K1q with an fp32
     and an fp16 q; Wan's text cross K3 in fp32 (beside SDPA); at the
     CogVideoX site (48 x 64) K1q / K1q-s in both modes and K3 unmasked
     over its 24,736 tokens (beside SDPA); fp32 held to F32_REL, each
     with its time, bound (4 bytes an element, the products counted once
     at the TF32 rate; the split route's 3x bf16 operations apart as
     route_bound_ms) and plain time.  fp32_small_pipelines: the small
     Hunyuan, Wan and CogVideoX T2V pipelines with the GPU model in fp32
     against the CPU at PIPE_F32 (CogVideoX again with TeaCache on, at
     PIPE_BF16: its residual is stored in bf16), launch counters zeroed
     just before and read just after.  fp32_full_width:
     HunyuanVideoConfig() cut to 2 + 2 blocks with fp32 weights at
     480x832x33, 3 steps, G = 2: s/step, peak, launches per computed call
     (counters zeroed just before, read just after), then the same
     weights in bf16 and the largest difference of the two outputs
     (reported).
 15. e2e: the end-to-end A/B benches of rectified_spaattn_tpu_torch/bench
     (ports of scripts/bench_e2e*.py, fidelity_gate.py, bench_longctx.py,
     ab_eval.py) through their run() at full width, one JSON line a leg
     (E2E): HunyuanVideo at its published 20 + 40 blocks (int4, stacked,
     p_remain 0.05, 1 step), Wan2.1-T2V-14B at 8 of 40 blocks (2 steps,
     then the TeaCache tier at the script's signal_scale 0.0979),
     CogVideoX1.5-5B at all 42 blocks (2 steps; its weights drawn leaf
     by leaf onto the card inside the leg), Flux.1-dev at 4 + 8 of
     19 + 38 blocks at 4096^2 (2 steps), each sparse and dense (flash):
     s/step and their ratio; the fidelity gate at 115,456 tokens (joint)
     and 115,200 (visual), held to FIDELITY_LIMITS; the long-context site
     at 230,656 tokens (sparse and dense at group_rows 1, sparse at 2),
     its K1 visual-row, K1 text-row (split and merged), K2 and
     windowed-dense calls held on 2 of 24 heads (the first and the last)
     to their plain versions at REL_MAX / REL_RMS, and the fidelity gate
     at that point; ab_eval at its defaults.  Each leg with its launch
     counters zeroed just before and read just after (the legs' kernels
     launched, the others not), its peak memory, and the executed density
     of every plan the leg built (build_sparse_plan wrapped to keep each
     plan's counts; the densities taken after the leg); every latent
     finite and of its shape.
 16. diag: the diagnostic benches of rectified_spaattn_tpu_torch/bench
     (ports of the last scripts of scripts/) through their run() at their
     defaults, one JSON line a leg with its launch counters (K1q's too)
     zeroed just before and read just after: planstages at the Hunyuan
     point and at the CogVideoX site, each in a process of its own (each
     plan stage's host, event and kernel ms, every stage's trace holding
     its kernels; the stages recomposed equal build_sparse_plan's mask,
     indices and counts bit for bit, and the int16 sort its indices);
     planopts (A == C, counts equal, sort == scatter == int16); runstats
     (its histogram shares sum to 1); grouped at G = 1, 2, 4, 8 and again
     with K1q "int8" at G = 1 and chunk_blocks 16, groupfull at G = 1, 2
     (every run against the first within REL_MAX / REL_RMS); coalesce;
     dense and kernel, whose K1, K3 and windowed-dense calls (block_m 256,
     512, 1024) are held on heads 0 and 23 to their plain versions
     (held_on_path); fullpath; ab_randreg.  The plan-only legs launch no
     attention kernel.

Each phase prints one JSON line with its seconds.  Then a {"kernels": ...}
line, the nvidia-smi line, and last {"ok": true, "device": {...}}.  Any
failure exits non-zero; nothing falls back to the CPU.
"""

from __future__ import annotations

import atexit
import dataclasses
import hashlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12       # H100 SXM dense int8 (NVIDIA data sheet)
PEAK_TF32_FLOPS = 494.7e12    # H100 SXM dense TF32 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12      # H100 SXM HBM3
TOL = 2e-2                    # the repo's bf16 tolerance (tests/test_kernels.py:101)
REL_MAX, REL_RMS = 0.05, 0.02  # limits relative to the output's scale
F32_TOL = dict(rtol=2e-4, atol=2e-5)   # fp32 (tests/test_kernels.py:44)
F32_REL = (1e-3, 1e-4)        # fp32 at the sites: of max |output|, of its std
PIPE_F32 = dict(rtol=1e-3, atol=1e-4)  # one-device pipelines (PERF.md §2)
PIPE_BF16 = dict(rtol=TOL, atol=TOL)   # with TeaCache's bf16 residual (§2)
M_TOL, L_REL = 2e-2, 0.01     # K1s's row max (absolute) and row sum (relative)
DEV = "cuda"
# the operating point: latent grid (T', H', W') of 128x720x1280 video,
# heads, text slot, valid text tokens
SITE = dict(grid=(32, 45, 80), heads=24, head_dim=128, text_len=256, tlen=100)
# the denoise run: full-width config cut to 2 dual + 2 single blocks
PIPE = dict(cfg=dict(num_dual_blocks=2, num_single_blocks=2), height=720,
            width=1280, frames=128, steps=3)
# Wan2.2 I2V-A14B: WanConfig() at in_channels 36 cut from 40 to 6 blocks
# a tree (2 warm, 2 sparse, 2 last-warm), 4 Euler steps at shift 5 over
# the boundary 0.875 (2 high-noise steps, 2 low)
A14B = dict(cfg=dict(in_channels=36, num_blocks=6), height=720, width=1280,
            frames=81, steps=4, warm_layers=2, warm_last_layers=2,
            boundary_ratio=0.875)
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
# CogVideoX1.5-5B's operating point: the token grid (T', H', W') of
# 81x768x1360 video (24,480 visual tokens: 191 blocks + 32 keys), 48 heads
# x 64, the 256-slot T5 text tail with 226 valid tokens
COG_SITE = dict(grid=(6, 48, 85), heads=48, head_dim=64, text_len=256,
                tlen=226, sa_drop_rate=0.85)
# the CogVideoX denoise run: CogVideoXConfig() at full width and depth (42
# blocks), 768x1360x81 (latent grid (12, 96, 170)), 4 DDIM steps under
# dynamic CFG: 8 calls, 5 dense warm calls then 3 sparse, group_rows 2,
# TeaCache off so that every call computes
COG_PIPE = dict(cfg={}, height=768, width=1360, frames=81, steps=4,
                group_rows=2, cut="none: 42 of 42 blocks")
# CogVideoX1.5 I2V: in_channels 32, cut from 42 to 6 blocks
COG_I2V = dict(cfg=dict(in_channels=32, num_blocks=6),
               cut="6 of 42 blocks")
# Flux.1-dev's 4096^2 upscale stage: the token grid (1, 256, 256), 65,536
# visual tokens in 512 blocks, and 512 text slots all valid (the
# reference's diffusers pipeline passes no text mask); 24 heads x 128
FLUX_SITE = dict(grid=(1, 256, 256), heads=24, head_dim=128, text_len=512,
                 tlen=512, sa_drop_rate=0.9)
# the Flux upscale run: FluxConfig() at full width and depth (19 dual + 38
# single blocks) and FluxControlNetConfig() (5 dual blocks, nudged off its
# zero init as the CLI's random build does); base 1024^2 then up 4096^2,
# 2 mu-Euler steps each, every step sparse under the gate (37, 57): 37
# sparse blocks, 20 windowed dense; nearest-latent control, group_rows 2,
# TeaCache off
FLUX_PIPE = dict(cfg={}, cn_cfg={}, base=1024, up=4096, steps=2,
                 group_rows=2,
                 cut="none: 19 + 38 of 19 + 38 blocks, 5 of 5 ControlNet "
                     "blocks; 2 steps a stage")
# the scan phase (models/scan.py): Hunyuan and Wan as PIPE / WAN_PIPE,
# CogVideoX cut from 42 to 4 blocks, Flux to 2 + 2 blocks with a 2-block
# ControlNet and the gate (1, 3), so that each stack runs a sparse and a
# windowed-dense segment; then the serving tier at full depth:
# HunyuanVideoConfig() (20 + 40 blocks) with int4 weights, stacked,
# dispatch_segments=2, one sparse step at G = 2, TeaCache off
SCAN = dict(windows=2, cog_cfg=dict(num_blocks=4),
            flux_cfg=dict(num_dual_blocks=2, num_single_blocks=2),
            flux_cn_cfg=dict(num_dual_blocks=2), flux_gate=(1, 3),
            full_cfg={}, full_bits=4, full_steps=1,
            cut="CogVideoX 4 of 42 blocks; Flux 2 + 2 of 19 + 38, "
                "ControlNet 2 of 5; full depth: none (20 + 40 of 20 + 40)")
# the e2e phase: the bench/ modules' run() keyword arguments a leg, at the
# published widths and token counts (E2E["cut"]: the depth each leg cuts)
E2E = dict(
    hunyuan=dict(dual=20, single=40, scan_blocks=True, quant=4,
                 p_remain=0.05, steps=1, modes="sparse,flash"),
    wan=dict(blocks=8, steps=2, modes="sparse,flash", teacache=True,
             signal_scale=0.0979),
    cog=dict(steps=2, modes="sparse,flash"),
    flux=dict(dual=4, single=8, size=4096, steps=2, modes="sparse,flash"),
    fidelity=(dict(layout="joint", frames=128),
              dict(layout="visual", frames=128)),
    longctx=(dict(frames=256, group_rows=1),
             dict(frames=256, group_rows=2, skip_dense=True)),
    ab_eval={},
    cut="HunyuanVideo none (20 + 40 of 20 + 40, 1 step); Wan2.1 8 of 40 "
        "blocks; CogVideoX none (42 of 42); Flux 4 + 8 of 19 + 38")
# the longctx leg's kernel calls held to their plain versions
LONGCTX_HELD = ("K1_visual_g1", "K1_text_rows", "K2_visual_g2",
                "K1_dense_bm1024")
# the small GPU-vs-CPU CogVideoX pipelines' TeaCache: the random model's
# temb signal scaled into the cogvideox polynomial's positive range; the
# accumulated signal is 0.097-0.099 at call 2 (skip) and 0.19 at call 4
# (compute) in fp32 and in bf16 on the CPU, so calls 2 and 3 skip
SMALL_COG_TEACACHE = dict(enable_teacache=True, teacache_thresh=0.14,
                          teacache_signal_scale=0.1)


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


def device_kernel_ms(fn, name: str, reps: int = 20) -> float | None:
    """Device ms a call of the kernel whose name holds ``name``, from a
    torch.profiler trace of ``reps`` calls after one warm-up: the kernel
    alone, without the host's pace between launches (which CUDA events
    over back-to-back calls include where a kernel is shorter than its
    launch).  None where the trace does not hold ``reps`` such kernels."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and name in e.key]
    if sum(e.count for e in ev) != reps:
        return None
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) for e in ev)
    return us / 1e3 / reps


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def held_f32(name, got, want, tol=PIPE_F32) -> dict:
    """got within ``tol`` (rtol / atol) of want everywhere, and finite."""
    err = (got.float() - want.float()).abs()
    bound = tol["atol"] + tol["rtol"] * want.float().abs()
    r = {"max_abs_err": float(err.max()),
         "max_err_over_tol": float((err / bound).max()),
         "ref_max_abs": float(want.float().abs().max()), **tol}
    if not (torch.isfinite(got.float()).all() and r["max_err_over_tol"] <= 1):
        raise AssertionError(f"{name}: beyond rtol {tol['rtol']} / atol "
                             f"{tol['atol']}: {r}")
    return r


def held_to_scale(name, got, want, limits=(REL_MAX, REL_RMS)) -> dict:
    """Kernel vs plain version held to the output's own scale: max abs
    error <= REL_MAX x the largest |output| and rms error <= REL_RMS x the
    output's std (``limits``: fp32 F32_REL).  At the operating point an
    output averages ~10^5 keys, so its values are ~1e-2 and a fixed 2e-2
    could not fail."""
    rel_max, rel_rms = limits
    diff = got.float() - want.float()
    ref = want.float()
    r = {"max_abs_err": float(diff.abs().max()),
         "rms_err": float(diff.square().mean().sqrt()),
         "ref_max_abs": float(ref.abs().max()), "ref_std": float(ref.std())}
    if not (torch.isfinite(got.float()).all()
            and r["max_abs_err"] <= rel_max * r["ref_max_abs"]
            and r["rms_err"] <= rel_rms * r["ref_std"]):
        raise AssertionError(f"{name}: error beyond {rel_max} x max |ref| "
                             f"or {rel_rms} x std(ref): {r}")
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


FP_OPS = re.compile(r"^(?!FENCE)(F|H|MUFU|I2F|IGMMA)")  # SASS opcode prefixes


def sass_counts(lib: str) -> dict:
    """Per kernel of a built library (hopper_attn_kernel: K1/K1s, K2, K3,
    the S3 / S2 policies; hopper_attn_q_kernel: K1q/K1q-s; loop_kernel:
    S1; the merge kernel), its count of SASS branches (BRA), selects
    (FSEL), wgmma instructions (HGMMA: bf16 / fp16, IGMMA: int8), warp-level
    mma.sync (HMMA, IMMA) and TMA tile loads (UTMALDG: the boxes the code
    issues, q's among them) and its fp32 FFMA / FADD / FMUL, read with
    cuobjdump: the mask is branch-free when its 64 scores a thread show
    up as 64 FSEL and the kernel's branches do not grow with them.
    "sha1": a digest of the kernel's instruction text, equal for the same
    code in two trees; "ops_sha1": a digest of its multiset of opcodes
    with their modifiers (operands dropped, order ignored), equal where
    two builds issue the same instructions in another order or on other
    registers; "fp_ops_sha1": the same over its floating-point,
    conversion and tensor-core opcodes alone (FP_OPS), the instructions
    that make the output's bits, equal where two builds differ only in
    integer, address, control or memory instructions."""
    from rectified_spaattn_tpu_torch.kernels import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True)
    if proc.returncode:
        return {"cuobjdump": proc.stderr.strip()[:200]}
    counts, digests, opcodes, fn = {}, {}, {}, None
    for ln in proc.stdout.splitlines():
        if "Function :" in ln:
            fn = kernel_name(ln.split("Function :")[1].strip())
            counts[fn] = {"BRA": 0, "FSEL": 0, "HGMMA": 0, "IGMMA": 0,
                          "HMMA": 0, "IMMA": 0, "UTMALDG": 0, "FFMA": 0,
                          "FADD": 0, "FMUL": 0}
            digests[fn], opcodes[fn] = hashlib.sha1(), []
        elif fn and "*/" in ln:
            text = ln.split("*/", 1)[1].split("/*")[0].strip()
            digests[fn].update(text.encode())
            ops = text.split()
            if ops and ops[0].startswith("@"):
                ops = ops[1:]
            op = ops[0].split(".")[0] if ops else ""
            if op in counts[fn]:
                counts[fn][op] += 1
            if ops:
                opcodes[fn].append(ops[0])
    multiset = lambda ops: hashlib.sha1(
        "\n".join(sorted(ops)).encode()).hexdigest()[:12]
    for fn, d in digests.items():
        counts[fn]["sha1"] = d.hexdigest()[:12]
        counts[fn]["ops_sha1"] = multiset(opcodes[fn])
        counts[fn]["fp_ops_sha1"] = multiset(
            [o for o in opcodes[fn] if FP_OPS.match(o)])
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
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K1_d64": 0.0, "K2_d64": 0.0}
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
    head_dim64_cases(kernels, ops, check, rnd, gen)
    return errs, cases


def head_dim64_cases(kernels, ops, check, rnd, gen):
    """K1 and K2 at head_dim 64 (CogVideoX's width, their D = 64
    instantiations) against their plain versions, in CogVideoX's joint
    layout with visual_len % 128 != 0: 7 visual blocks + 32 keys (block 7
    holds 32 keys and 96 pad keys), the text slot from block 8, 226 valid
    text tokens of 256 at B=1 and 100 / 0 at B=2 (a degenerate row whose
    only block is the text block of the batch with none)."""
    dev = torch.device("cuda")
    d, nvb = 64, 8                       # visual blocks incl. the partial one
    vis, tstart, nb = 7 * 128 + 32, nvb * 128, nvb + 2
    bs = kernels.block_sparse

    def inputs(b, h, rows):
        return (rnd(b, h, rows, d), rnd(b, h, nb * 128, d),
                rnd(b, h, nb * 128, d))

    # K1 on visual rows, random masks with the partial block and both text
    # blocks listed; and on the packed K|V stream
    q, k, v = inputs(2, 4, nvb * 128)
    m = torch.rand((2, 4, nvb, nb), generator=gen, device=dev) < 0.4
    m[..., 7] = m[..., 8] = m[..., 9] = True
    m[1, 2, 3] = False
    m[1, 2, 3, 8] = True                 # only a text block, batch 1: none
    idx, cnt = ops.mask_to_indices(m)
    tl = torch.tensor([100, 0], dtype=torch.int32, device=dev)
    kw = dict(visual_len=vis, text_start=tstart)
    for name, extra in (("k1_d64_joint_visual_rows", {}),
                        ("k1_d64_packed_kv",
                         {"packed_kv": torch.cat([k, v], dim=-1)})):
        check(name, kernels.block_sparse_flash_attention(
                  q, k, v, idx, cnt, tl, **kw, **extra),
              kernels.block_sparse_flash_attention_torch(
                  q, k, v, idx, cnt, tl, **kw, **extra), "K1_d64")
    # K1 on text rows with full lists: a short launch (8 row tiles), split
    # into key ranges and merged by the D = 64 merge kernel
    qt, kt, vt = inputs(1, 4, 256)
    full_idx = torch.arange(nb, dtype=torch.int32, device=dev).expand(
        1, 4, 2, nb)
    full_cnt = torch.full((1, 4, 2), nb, dtype=torch.int32, device=dev)
    t226 = torch.tensor([226], dtype=torch.int32, device=dev)
    merges = bs.merge_splits.launches
    check("k1_d64_text_rows_split",
          kernels.block_sparse_flash_attention(
              qt, kt, vt, full_idx, full_cnt, t226, chunk_blocks=4, **kw),
          kernels.block_sparse_flash_attention_torch(
              qt, kt, vt, full_idx, full_cnt, t226, chunk_blocks=4, **kw),
          "K1_d64")
    if bs.merge_splits.launches != merges + 1:
        raise AssertionError("k1_d64_text_rows_split did not split")
    # K1 as the windowed dense of the warm calls (attention/modes.py):
    # the model's layout [visual ; text] unpadded, so the text window
    # starts inside block 7, at block_m 1024
    from rectified_spaattn_tpu_torch.attention.modes import (
        _windowed_dense_flash)
    s = vis + 256
    qd, kd, vd = (rnd(1, 4, s, d) for _ in range(3))
    dkw = dict(visual_len=vis, text_start=vis, tlen=t226, block_m=1024)
    k1 = kernels.block_sparse_flash_attention
    before = k1.launches
    got = _windowed_dense_flash(qd, kd, vd, **dkw)
    if k1.launches != before + 1:
        raise AssertionError("the windowed dense did not launch K1 once")
    check("k1_d64_windowed_dense_bm1024", got, _windowed_dense_flash(
        qd.cpu(), kd.cpu(), vd.cpu(), visual_len=vis, text_start=vis,
        tlen=t226.cpu(), block_m=1024).to(dev), "K1_d64")
    # K2 at G = 2 and 4 on the visual rows' masks, held to K1 row by row
    ref = kernels.block_sparse_flash_attention(q, k, v, idx, cnt, tl, **kw)
    for grp in (2, 4):
        ui, uc, rb, cl = ops.group_rows(m, grp, clean_blocks=vis // 128)
        g = dict(group=grp, **kw)
        got = kernels.block_sparse_flash_attention_grouped(
            q, k, v, ui, uc, rb, cl, tl, **g)
        check(f"k2_d64_g{grp}", got,
              kernels.block_sparse_flash_attention_grouped_torch(
                  q, k, v, ui, uc, rb, cl, tl, **g), "K2_d64")
        if grp == 2:
            check("k2_d64_g2_packed_kv",
                  kernels.block_sparse_flash_attention_grouped(
                      q, k, v, ui, uc, rb, cl, tl,
                      packed_kv=torch.cat([k, v], dim=-1), **g), got,
                  "K2_d64")
    # K2 equals K1 on every row block with a live own key (the degenerate
    # row block (1, 2, 3) averages the union's lanes instead)
    live = torch.ones_like(ref, dtype=torch.bool)
    live[1, 2, 3 * 128:4 * 128] = False
    e = float((got.float() - ref.float())[live].abs().max())
    if e > TOL:
        raise AssertionError(f"K2 at head_dim 64 vs K1's rows: {e}")


# the plan's probs: the benchmark cells' HunyuanVideo and CogVideoX sites,
# then the other row lengths (Flux, Wan, the long-context point, one row
# past the warp layout) at fewer rows
TOPP_SHAPES = {"hunyuan": (1, 24, 900, 901), "cogvideox": (1, 48, 351, 352),
               "flux": (1, 24, 256, 513), "wan": (1, 40, 256, 591),
               "longctx": (1, 24, 256, 1803), "cta": (1, 4, 64, 3000)}


def plan_select_leg(kernels, ops) -> dict:
    """P1 (kernels/plan_select.py) against the plain bisection on each of
    ``TOPP_SHAPES`` and four kinds of rows at p_remain 0.3 (the cells')
    with top-k floors of 1 and a fifth of the row, and at 0.6 with 4: its
    masks equal the plain model of its summation order bit for bit (its
    search and the 32 rounds as written), and the plain bisection's except
    on rows whose fp64 mass at the cut lies within 1e-5 of p_remain
    (counted); then, on near-uniform rows at 0.3 with a floor of a fifth of
    the row, its device time from a profiler trace (``ms``) beside its
    bound (probs read once, the mask written once) and the plain
    bisection's (CUDA events), the host-paced time of 50 back-to-back
    calls by CUDA events (``host_paced_ms``: launch overhead, where it is
    above ``ms``), and its launches."""
    from rectified_spaattn_tpu_torch.bench.inputs import TOPP_KINDS, topp_rows
    ps = kernels.plan_select
    out = {}
    for name, shape in TOPP_SHAPES.items():
        cut = shape[-1] // 5      # a top-k floor near the cells' (0.2, 0.15)
        r = {"shape": list(shape), "layout": list(ps.layout(shape[-1])),
             "rows_apart": 0, "max_cut_gap": 0.0}
        for kind in TOPP_KINDS:
            p = topp_rows(kind, shape, DEV)
            for p_remain, floor in ((0.3, 1), (0.6, 4), (0.3, cut)):
                got = ps.topp_select(p, p_remain, floor)
                if not (torch.equal(got, ps._simulate(p, p_remain, floor))
                        and torch.equal(got, ps._simulate(
                            p, p_remain, floor, snap=False))):
                    raise AssertionError(f"P1 {name} {kind}: not its model")
                gaps = ps.cut_gaps(p, got, ops.topp_threshold_onehot_bisect(
                    p, p_remain, floor), p_remain)
                if gaps.numel():
                    r["rows_apart"] += gaps.numel()
                    r["max_cut_gap"] = max(r["max_cut_gap"],
                                           float(gaps.max()))
                if not bool((gaps <= 1e-5).all()):
                    raise AssertionError(f"P1 {name} {kind}: rows apart "
                                         f"beyond 1e-5: {gaps.tolist()}")
        p = topp_rows("random", shape, DEV)
        before = ps.topp_select.launches
        r["ms"] = device_kernel_ms(lambda: ps.topp_select(p, 0.3, cut),
                                   "topp_select_kernel")
        r["host_paced_ms"] = cuda_ms(lambda: ps.topp_select(p, 0.3, cut),
                                     reps=50, warmup=5)
        r["launches"] = ps.topp_select.launches - before
        if r["launches"] != 76:
            raise AssertionError(f"P1 {name}: {r['launches']} launches for "
                                 "76 calls")
        r["plain_ms"] = cuda_ms(
            lambda: ops.topp_threshold_onehot_bisect(p, 0.3, cut), reps=5)
        r["bound_ms"], r["bound_by"] = bound_ms(0, 5 * p.numel())
        r["roofline_share"] = (r["bound_ms"] / r["ms"] if r["ms"]
                               else None)
        out[name] = r
        del p
        torch.cuda.empty_cache()
    return out


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
            nbytes, library=None, peak=PEAK_BF16_FLOPS,
            limits=(REL_MAX, REL_RMS), route_ops=None):
    """One kernel at the main path's shapes: with ``check``, its plain
    version on the same inputs (time and the relative ``limits``); then
    its CUDA-event time, its bound (``flops``, the function's operations
    counted once, at ``peak``) and, where one PyTorch call computes the
    same function, that call's time.  With ``route_ops``, also
    ``route_bound_ms``: the chosen route's ``route_ops`` x ``flops`` at the
    bf16 rate.  Stores the result in ``kern[name]`` and prints it on a
    kernel_at_site line."""
    got = kern_fn()
    r = {}
    if check:
        t_plain = time.perf_counter()
        want = plain_fn()
        torch.cuda.synchronize()
        r["plain_ms"] = (time.perf_counter() - t_plain) * 1e3
        r.update(held_to_scale(name, got, want, limits))
        del want
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: output is not finite")
    del got
    torch.cuda.empty_cache()
    r["bound_ms"], r["bound_by"] = bound_ms(flops, nbytes, peak)
    if route_ops:
        r["route_bound_ms"] = bound_ms(route_ops * flops, nbytes)[0]
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


def merge_at_site(kernels, kern, regime, tiles, nb_slots,
                  d: int = SITE["head_dim"], name: str = "K1_merge",
                  out_dtype=torch.bfloat16):
    """The key split's merge kernel at the shape of the text rows' split
    (the ranges _split_plan gives their launch on this card), on seeded
    partials, against its plain version (``_merge_splits``), writing rows
    in ``out_dtype`` (bf16: TOL; fp32: F32_TOL); bound: the partials read
    once, o and the stats written once."""
    bs = kernels.block_sparse
    n, _ = bs._split_plan(tiles, nb_slots, 16, torch.cuda.get_device_properties(
        0).multi_processor_count)
    rows = tiles * 128
    gen = torch.Generator(device=DEV)
    gen.manual_seed(99)
    o_p = torch.randn((n, rows, d), generator=gen, device=DEV)
    m_p = torch.randn((n, rows), generator=gen, device=DEV)
    l_p = torch.rand((n, rows), generator=gen, device=DEV) * 100 + 1
    m_p[0, :64], l_p[0, :64] = -torch.inf, 0.0       # an empty range
    args = (o_p, m_p, l_p, out_dtype)
    got = bs.merge_splits(*args, return_stats=True)
    t0 = time.perf_counter()
    want = bs._merge_splits(list(o_p), list(m_p), list(l_p))
    torch.cuda.synchronize()
    r = {"plain_ms": (time.perf_counter() - t0) * 1e3, "n_split": n,
         **held_to_scale(name, got[0], want[0].to(out_dtype))}
    r["m_max_abs_err"] = max_err(got[1], want[1])
    r["l_max_rel_err"] = float(((got[2] - want[2]).abs() / want[2]).max())
    f32 = out_dtype == torch.float32
    if not ((torch.allclose(got[0], want[0], **F32_TOL) if f32
             else r["max_abs_err"] <= TOL) and r["m_max_abs_err"] == 0
            and r["l_max_rel_err"] <= 1e-4):
        raise AssertionError(f"{name} vs its plain version: {r}")
    r["bound_ms"], r["bound_by"] = bound_ms(
        0.0, n * rows * (d + 2) * 4 + rows * (d * (4 if f32 else 2) + 8))
    r["ms"] = cuda_ms(lambda: bs.merge_splits(*args, return_stats=True),
                      reps=20)
    r["library_ms"] = None
    r["roofline_share"] = r["bound_ms"] / r["ms"]
    kern[name] = r
    print(json.dumps({"kernel_at_site": name, "regime": regime, **r}),
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

def hunyuan_full_model(image_condition_type=None, dtype=torch.bfloat16):
    """The full-width HunyuanVideoDiT of PIPE with seeded bf16 (or
    ``dtype``) weights (the same for T2V and I2V: the condition type adds
    no weight)."""
    from rectified_spaattn_tpu_torch.models import (
        HunyuanVideoConfig, HunyuanVideoDiT, init_random_weights)

    dev = torch.device(DEV)
    cfg = HunyuanVideoConfig(**PIPE["cfg"],
                             image_condition_type=image_condition_type)
    with torch.device(dev):
        model = HunyuanVideoDiT(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return init_random_weights(model.to(dtype), gen)


def hunyuan_full_pipe(image_condition_type=None, model=None, **pipe_kw):
    """The HunyuanVideoPipeline of PIPE over ``model`` (default
    ``hunyuan_full_model``), its config and its text inputs; ``pipe_kw``
    adds pipeline options (scan_blocks, dispatch_segments)."""
    from rectified_spaattn_tpu_torch.cli.generate import _random_text
    from rectified_spaattn_tpu_torch.pipelines import HunyuanVideoPipeline

    dev = torch.device(DEV)
    if model is None:
        model = hunyuan_full_model(image_condition_type)
    cfg = model.cfg
    pipe = HunyuanVideoPipeline(
        model=model, height=PIPE["height"], width=PIPE["width"],
        frames=PIPE["frames"], num_steps=PIPE["steps"],
        sa_drop_rate=0.8, p_remain_rates=0.3, mode="sparse",
        enable_teacache=True, rel_l1_thresh=0.15, group_rows=2, device=dev,
        **pipe_kw)
    text, mask = _random_text("several hot air balloons flying over a city.",
                              256, cfg.text_dim, device=dev)
    return pipe, cfg, text, mask


def path_kernels(kernels) -> dict:
    """The main path's launch counters: the attention kernels and P1, the
    plan's selection (one launch a plan)."""
    return {"K1": kernels.block_sparse_flash_attention,
            "K2": kernels.block_sparse_flash_attention_grouped,
            "K3": kernels.dense_flash_attention,
            "K1_merge": kernels.block_sparse.merge_splits,
            "P1": kernels.plan_select.topp_select}


def pipeline_phase(kernels):
    pipe, cfg, text, mask = hunyuan_full_pipe()
    noise = torch.Generator(device=DEV)
    noise.manual_seed(42)
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 2**30
    kerns = path_kernels(kernels)
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
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "start_gb": start_gb}
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
    gen = torch.Generator(device=DEV)
    gen.manual_seed(43)
    return profile_run(lambda: pipe(text, mask, generator=gen, num_steps=1),
                       top)


def profile_run(run, top: int = 12):
    """``run()`` under torch.profiler: device time by kernel name and the
    device's idle share of its wall clock."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
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
            "top": [{"name": e.key[:160], "ms": dev_us(e) / 1e3,
                     "calls": e.count} for e in rows]}


def pipeline_i2v_phase(kernels, t2v: dict):
    """HunyuanVideo I2V (token_replace) at PIPE's full width and depth,
    the T2V phase's weights, noise and text, and a seeded first-frame
    latent; the launch counters zeroed just before the run and read just
    after, and held to the T2V run's per computed step.  Its s/step
    against the T2V phase's; then the small GPU-vs-CPU pipeline under
    token_replace and under latent_concat."""
    pipe, cfg, text, mask = hunyuan_full_pipe("token_replace")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(7)
    first = torch.randn((1, cfg.in_channels, 1, *pipe.grid[1:]),
                        generator=gen, device=DEV)
    noise = torch.Generator(device=DEV)
    noise.manual_seed(42)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kerns = path_kernels(kernels)
    for f in kerns.values():
        f.launches = 0
    out = pipe(text, mask, generator=noise, first_frame=first)
    launches = {n: f.launches for n, f in kerns.items()}
    torch.cuda.synchronize()
    if out.shape != (1, cfg.in_channels, *pipe.grid) \
            or not torch.isfinite(out).all():
        raise AssertionError("I2V pipeline output is not finite of its shape")
    if not torch.equal(out[:, :, :1], first):
        raise AssertionError("the I2V pipeline did not hold the first frame")
    # the same sparse decisions per computed step as T2V: token_replace
    # changes the modulation, not the attention path
    computed = pipe.teacache_stats["computed"]
    per_step = {n: c / computed for n, c in launches.items()}
    if per_step != t2v["launches_per_computed_step"] or launches["K3"]:
        raise AssertionError(f"I2V launches {launches} per computed step "
                             f"{per_step}, T2V "
                             f"{t2v['launches_per_computed_step']}")
    s_step = float(np.mean(pipe.step_seconds))
    t2v_s_step = float(np.mean(t2v["step_seconds"]))
    res = {"launches": launches, "launches_per_computed_step": per_step,
           "step_seconds": pipe.step_seconds,
           "denoise_seconds": pipe.denoise_seconds,
           "teacache": pipe.teacache_stats,
           "teacache_decisions": pipe.teacache.decisions,
           "first_frame_tokens": int(pipe._ff_mask_curve.sum()),
           "first_frame_held": True,
           "s_per_step": s_step, "t2v_s_per_step": t2v_s_step,
           "i2v_over_t2v": s_step / t2v_s_step,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "t2v_peak_mem_gb": t2v["peak_mem_gb"]}
    del pipe, out
    torch.cuda.empty_cache()
    res["small_token_replace_gpu_vs_cpu"] = small_pipeline_check(
        image_condition_type="token_replace")
    res["small_latent_concat_gpu_vs_cpu"] = small_pipeline_check(
        image_condition_type="latent_concat")
    return res


def small_pipeline_check(quant_bits: int = 0, image_condition_type=None,
                         dtype=torch.bfloat16, **pipe_kw):
    """A small pipeline (head_dim 128, one block of each kind) on the GPU
    in bf16 (or ``dtype``: fp32, held to PIPE_F32) against the same
    weights on the CPU in fp32; with
    ``quant_bits`` both run the same quantized weights, and ``pipe_kw``
    sets pipeline options (K1q, the TeaCache residual) on both.  With
    ``image_condition_type`` both run I2V on the same seeded first frame
    (token_replace, held bit for bit) or condition (latent_concat), held
    to the output's scale."""
    from rectified_spaattn_tpu_torch.models import (
        HunyuanVideoConfig, HunyuanVideoDiT, init_random_weights, quant)
    from rectified_spaattn_tpu_torch.pipelines import HunyuanVideoPipeline

    concat = image_condition_type == "latent_concat"
    cfg = HunyuanVideoConfig(hidden_dim=256, heads=2, num_dual_blocks=1,
                             num_single_blocks=1, text_dim=64, pooled_dim=32,
                             num_refiner_blocks=1,
                             in_channels=33 if concat else 16,
                             image_condition_type=image_condition_type)
    gen = torch.Generator()
    gen.manual_seed(3)
    ref = init_random_weights(HunyuanVideoDiT(cfg), gen)
    if quant_bits:
        # min_size 1: these widths are far below quantize_params' 1 << 20
        quant.quantize_model(ref, bits=quant_bits, min_size=1)
    gpu = HunyuanVideoDiT(cfg)
    quant.adopt_layout(gpu, ref.state_dict())
    gpu.load_state_dict(ref.state_dict())
    gpu = gpu.to(dtype)
    text = torch.randn((1, 256, cfg.text_dim), generator=gen)
    mask = torch.zeros((1, 256), dtype=torch.bool)
    mask[:, :20] = True
    kw = dict(height=128, width=128, frames=8, num_steps=3, sa_drop_rate=0.5,
              p_remain_rates=0.5, group_rows=2)
    kw.update(pipe_kw)
    p_cpu = HunyuanVideoPipeline(model=ref, device="cpu", **kw)
    init = torch.randn((1, cfg.out_channels, *p_cpu.grid), generator=gen)
    extra = {}
    if image_condition_type == "token_replace":
        extra["first_frame"] = torch.randn(
            (1, cfg.out_channels, 1, *p_cpu.grid[1:]), generator=gen)
    elif concat:
        extra["condition"] = torch.randn(
            (1, cfg.in_channels - cfg.out_channels, *p_cpu.grid),
            generator=gen)
    want = p_cpu(text, mask, init_latents=init, **extra)
    p_gpu = HunyuanVideoPipeline(model=gpu, device=DEV, **kw)
    got = p_gpu(text, mask, init_latents=init, **extra).cpu()
    if dtype == torch.float32:
        return held_f32("small pipeline fp32 GPU vs CPU", got, want)
    if image_condition_type:
        res = held_to_scale(f"small {image_condition_type} pipeline GPU vs "
                            "CPU", got, want)
        if "first_frame" in extra:
            if not torch.equal(got[:, :, :1], extra["first_frame"]):
                raise AssertionError("small token_replace pipeline: the "
                                     "first frame is not held")
            res["first_frame_held"] = True
        return res
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
    """{kernel: launches} for K1, K2, K3, the two K1q modes, the merge and
    P1."""
    k1 = kernels.block_sparse_flash_attention
    return {"K1": k1.launches, "K1q_int8": k1.quant_launches["int8"],
            "K1q_mxu8": k1.quant_launches["mxu8"],
            "K2": kernels.block_sparse_flash_attention_grouped.launches,
            "K3": kernels.dense_flash_attention.launches,
            "K1_merge": kernels.block_sparse.merge_splits.launches,
            "P1": kernels.plan_select.topp_select.launches}


def zero_launches(kernels):
    k1 = kernels.block_sparse_flash_attention
    k1.launches = 0
    k1.quant_launches.update(int8=0, mxu8=0)
    kernels.block_sparse_flash_attention_grouped.launches = 0
    kernels.dense_flash_attention.launches = 0
    kernels.block_sparse.merge_splits.launches = 0
    kernels.plan_select.topp_select.launches = 0


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


# ------------------------------------------------------------ ckpt phase ---

# the checkpoint path: a synthetic diffusers snapshot (seeded random
# weights, bf16 on disk) at published widths.  The VAE is the
# vae/config.json of tencent/HunyuanVideo (diffusers format); the
# transformer has HunyuanVideoConfig()'s widths, cut to 2 dual + 2 single
# blocks as PIPE is.  --frame 36 gives 36 // 4 = 9 latent frames (the
# pipeline's lt = frames // 4), which the causal VAE decodes to 33.
CKPT = dict(
    vae={"_class_name": "AutoencoderKLHunyuanVideo", "in_channels": 3,
         "out_channels": 3, "latent_channels": 16,
         "block_out_channels": [128, 256, 512, 512], "layers_per_block": 2,
         "temporal_compression_ratio": 4, "spatial_compression_ratio": 8,
         "scaling_factor": 0.476986, "mid_block_add_attention": True},
    transformer={"_class_name": "HunyuanVideoTransformer3DModel",
                 "in_channels": 16, "out_channels": 16,
                 "num_attention_heads": 24, "attention_head_dim": 128,
                 "num_layers": 2, "num_single_layers": 2,
                 "num_refiner_layers": 2, "mlp_ratio": 4.0, "patch_size": 2,
                 "patch_size_t": 1, "guidance_embeds": True,
                 "text_embed_dim": 4096, "pooled_projection_dim": 768,
                 "rope_axes_dim": [16, 56, 56]},
    small_latent=(1, 16, 2, 8, 8), latent=(1, 16, 9, 60, 104), tile=32,
    overlap=4, height=480, width=832, frame=36, frames_out=33, steps=2)
# the CogVideoX leg: CogVideoXTransformer3DModel at CogVideoXConfig()'s
# widths (48 heads x 64, T5 4096, time and ofs embeddings of 512, patch
# (2, 2, 2)) cut to 2 blocks; 480x832 with --frame 33 gives (33 - 1) // 8
# + 1 = 5 latent frames, 6 rounded to patch_size_t, which the phase's VAE
# (4x in time) decodes to 21; 3 steps make 6 calls, the last one sparse
COG_CKPT = dict(
    transformer={"_class_name": "CogVideoXTransformer3DModel",
                 "in_channels": 16, "out_channels": 16,
                 "num_attention_heads": 48, "attention_head_dim": 64,
                 "num_layers": 2, "text_embed_dim": 4096,
                 "time_embed_dim": 512, "ofs_embed_dim": 512,
                 "patch_size": 2, "patch_size_t": 2},
    height=480, width=832, frame=33, frames_out=21, steps=3)
# the Flux leg: FluxTransformer2DModel at FluxConfig()'s widths cut to 2
# dual + 2 single blocks, a 2-block FluxControlNetModel, and the 2-D
# AutoencoderKL of FLUX.1-dev's published vae/config.json (16 latent
# channels, 8x, no quant convs); the CLI at 1024^2: base 256^2, up 1024^2
FLUX_CKPT = dict(
    vae={"_class_name": "AutoencoderKL", "in_channels": 3, "out_channels": 3,
         "latent_channels": 16, "block_out_channels": [128, 256, 512, 512],
         "layers_per_block": 2, "scaling_factor": 0.3611,
         "shift_factor": 0.1159, "use_quant_conv": False,
         "use_post_quant_conv": False, "mid_block_add_attention": True},
    transformer={"_class_name": "FluxTransformer2DModel", "in_channels": 64,
                 "num_attention_heads": 24, "attention_head_dim": 128,
                 "num_layers": 2, "num_single_layers": 2,
                 "joint_attention_dim": 4096, "pooled_projection_dim": 768,
                 "axes_dims_rope": [16, 56, 56], "guidance_embeds": True,
                 "patch_size": 1},
    controlnet={"_class_name": "FluxControlNetModel", "in_channels": 64,
                "num_attention_heads": 24, "attention_head_dim": 128,
                "num_layers": 2, "num_single_layers": 0,
                "joint_attention_dim": 4096, "pooled_projection_dim": 768,
                "axes_dims_rope": [16, 56, 56], "guidance_embeds": True},
    height=1024, width=1024, steps=2)
VAE_TOL = dict(rtol=2e-4, atol=2e-5)   # fp32 (tests/test_kernels.py:44)


def codec_check() -> dict:
    """Every dtype of the port's safetensors codec, written and read back
    bit for bit (the card's machine has no safetensors package)."""
    import tempfile
    from rectified_spaattn_tpu_torch.models import safetensors_io as sio
    gen = torch.Generator().manual_seed(7)
    tensors = {}
    for name, dt in sio.DTYPES.items():
        if dt.is_floating_point:
            tensors[name] = torch.randn((3, 33), generator=gen).to(dt)
        elif dt == torch.bool:
            tensors[name] = torch.randint(0, 2, (17,), generator=gen).bool()
        else:
            lo = 0 if dt == torch.uint8 else -120
            tensors[name] = torch.randint(lo, 120, (2, 5, 7),
                                          generator=gen).to(dt)
    tensors["empty"] = torch.zeros((0, 4), dtype=torch.bfloat16)
    tensors["scalar"] = torch.tensor(2.5, dtype=torch.float64)
    tensors["on_device"] = torch.randn((64, 64), generator=gen).to(
        DEV, torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        path = sio.save_file(tensors, os.path.join(tmp, "c.safetensors"))
        back = {m: sio.load_file(path, use_mmap=m) for m in (True, False)}
        nbytes = os.path.getsize(path)
    for mapped, got in back.items():
        for k, t in tensors.items():
            if not (got[k].dtype == t.dtype and got[k].shape == t.shape
                    and torch.equal(got[k], t.cpu())):
                raise AssertionError(f"codec: {k} differs (mmap={mapped})")
    return {"tensors": sorted(tensors), "file_bytes": nbytes,
            "bit_for_bit": True}


def _synth(sd, gen, name, shape, kind):
    """One seeded tensor of a synthetic snapshot on the card: weights
    N(0, 1/fan_in), biases 0, norm scales 1 (Flax's initialisers)."""
    if kind == "w":
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        t = torch.randn(shape, generator=gen, device=DEV) * fan_in ** -0.5
    elif kind == "ones":
        t = torch.ones(shape, device=DEV)
    else:
        t = torch.zeros(shape, device=DEV)
    sd[name] = t.to(torch.bfloat16)


def synth_hunyuan_sd(cj: dict, gen) -> dict:
    """A diffusers HunyuanVideoTransformer3DModel state dict for the config
    json ``cj`` (the key set of tests/manifests/hunyuan_keys.json)."""
    d = cj["num_attention_heads"] * cj["attention_head_dim"]
    hd, mlp_h = cj["attention_head_dim"], int(d * cj["mlp_ratio"])
    sd = {}
    lin = lambda n, o, i: (_synth(sd, gen, n + ".weight", (o, i), "w"),
                           _synth(sd, gen, n + ".bias", (o,), "0"))
    ln = lambda n, c: (_synth(sd, gen, n + ".weight", (c,), "ones"),
                       _synth(sd, gen, n + ".bias", (c,), "0"))
    rms = lambda n, c: _synth(sd, gen, n + ".weight", (c,), "ones")
    p, pt = cj["patch_size"], cj["patch_size_t"]
    _synth(sd, gen, "x_embedder.proj.weight",
           (d, cj["in_channels"], pt, p, p), "w")
    _synth(sd, gen, "x_embedder.proj.bias", (d,), "0")
    for emb, in_f in (("timestep_embedder", 256), ("guidance_embedder", 256),
                      ("text_embedder", cj["pooled_projection_dim"])):
        lin(f"time_text_embed.{emb}.linear_1", d, in_f)
        lin(f"time_text_embed.{emb}.linear_2", d, d)
    ce, text = "context_embedder", cj["text_embed_dim"]
    lin(f"{ce}.proj_in", d, text)
    lin(f"{ce}.time_text_embed.timestep_embedder.linear_1", d, 256)
    lin(f"{ce}.time_text_embed.timestep_embedder.linear_2", d, d)
    lin(f"{ce}.time_text_embed.text_embedder.linear_1", d, text)
    lin(f"{ce}.time_text_embed.text_embedder.linear_2", d, d)
    for i in range(cj["num_refiner_layers"]):
        b = f"{ce}.token_refiner.refiner_blocks.{i}"
        ln(f"{b}.norm1", d)
        ln(f"{b}.norm2", d)
        for nm in ("to_q", "to_k", "to_v", "to_out.0"):
            lin(f"{b}.attn.{nm}", d, d)
        lin(f"{b}.ff.net.0.proj", mlp_h, d)
        lin(f"{b}.ff.net.2", d, mlp_h)
        lin(f"{b}.norm_out.linear", 2 * d, d)
    for i in range(cj["num_layers"]):
        b = f"transformer_blocks.{i}"
        lin(f"{b}.norm1.linear", 6 * d, d)
        lin(f"{b}.norm1_context.linear", 6 * d, d)
        for nm in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                   "add_v_proj", "to_out.0", "to_add_out"):
            lin(f"{b}.attn.{nm}", d, d)
        for nm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            rms(f"{b}.attn.{nm}", hd)
        for ff in ("ff", "ff_context"):
            lin(f"{b}.{ff}.net.0.proj", mlp_h, d)
            lin(f"{b}.{ff}.net.2", d, mlp_h)
    for i in range(cj["num_single_layers"]):
        b = f"single_transformer_blocks.{i}"
        lin(f"{b}.norm.linear", 3 * d, d)
        for nm in ("to_q", "to_k", "to_v"):
            lin(f"{b}.attn.{nm}", d, d)
        rms(f"{b}.attn.norm_q", hd)
        rms(f"{b}.attn.norm_k", hd)
        lin(f"{b}.proj_mlp", mlp_h, d)
        lin(f"{b}.proj_out", d, d + mlp_h)
    lin("norm_out.linear", 2 * d, d)
    lin("proj_out", pt * p * p * cj["out_channels"], d)
    return sd


def synth_vae_sd(cfg, gen) -> dict:
    """A diffusers VAE state dict (encoder and decoder) for the port's
    VAEConfig ``cfg`` (the key set of tests/test_weights.py::synth_vae_sd;
    3-D convolutions for a video VAE, 2-D for an image one)."""
    sd = {}
    dims = 3 if cfg.video else 2

    def conv(name, o, i, k=3):
        _synth(sd, gen, name + ".weight", (o, i, *(k,) * dims), "w")
        _synth(sd, gen, name + ".bias", (o,), "0")

    def gn(name, c):
        _synth(sd, gen, name + ".weight", (c,), "ones")
        _synth(sd, gen, name + ".bias", (c,), "0")

    def resnet(prefix, o, i):
        gn(prefix + ".norm1", i)
        conv(prefix + ".conv1", o, i)
        gn(prefix + ".norm2", o)
        conv(prefix + ".conv2", o, o)
        if i != o:
            conv(prefix + ".conv_shortcut", o, i, k=1)

    def mid(prefix, c):
        resnet(prefix + ".resnets.0", c, c)
        resnet(prefix + ".resnets.1", c, c)
        gn(prefix + ".attentions.0.group_norm", c)
        for nm in ("to_q", "to_k", "to_v", "to_out.0"):
            _synth(sd, gen, f"{prefix}.attentions.0.{nm}.weight", (c, c),
                   "w")
            _synth(sd, gen, f"{prefix}.attentions.0.{nm}.bias", (c,), "0")

    ch = list(cfg.block_out_channels)
    n, rch = len(ch), list(reversed(ch))
    conv("decoder.conv_in", rch[0], cfg.latent_channels)
    mid("decoder.mid_block", rch[0])
    prev = rch[0]
    for i, f in enumerate(rch):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", f, prev)
            prev = f
        if cfg.spatial_upsample[i] or cfg.temporal_upsample[i]:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", f, f)
    gn("decoder.conv_norm_out", rch[-1])
    conv("decoder.conv_out", cfg.out_channels, rch[-1])
    conv("encoder.conv_in", ch[0], cfg.out_channels)
    prev = ch[0]
    for i, f in enumerate(ch):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", f, prev)
            prev = f
        if cfg.spatial_upsample[n - 1 - i] or cfg.temporal_upsample[n - 1 - i]:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", f, f)
    mid("encoder.mid_block", ch[-1])
    gn("encoder.conv_norm_out", ch[-1])
    conv("encoder.conv_out", 2 * cfg.latent_channels, ch[-1])
    return sd


def write_snapshot(root: str, sub: str, sd: dict, config: dict) -> int:
    """<root>/<sub>/ with the state dict and its config.json; bytes."""
    from rectified_spaattn_tpu_torch.models.safetensors_io import save_file
    d = os.path.join(root, sub)
    os.makedirs(d, exist_ok=True)
    path = save_file(sd, os.path.join(d, "diffusion_pytorch_model"
                                         ".safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f)
    return os.path.getsize(path)


class HostPeak:
    """Peak resident set size of this process over a ``with`` body,
    sampled every 5 ms from /proc/self/statm, and the size before it."""

    @staticmethod
    def rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def __enter__(self):
        self.before = self.peak = self.rss()
        self._stop = threading.Event()

        def poll():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, self.rss())
        self._th = threading.Thread(target=poll, daemon=True)
        self._th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join()
        self.peak = max(self.peak, self.rss())

    def gb(self) -> dict:
        return {"before_gb": self.before / 2**30, "peak_gb": self.peak / 2**30}


def vae_checks(root: str) -> dict:
    """The full-width VAE: GPU against CPU on the small latent (fp32,
    TF32 off), then the untiled and tiled decode of the 480x832x33 latent
    timed with CUDA events, and the encode of its frames."""
    from rectified_spaattn_tpu_torch.models.pretrained import (
        load_vae, vae_config_from_json)
    cfg = vae_config_from_json(CKPT["vae"], video=True)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(11)
    res = {"snapshot_bytes": write_snapshot(root, "vae",
                                            synth_vae_sd(cfg, gen),
                                            CKPT["vae"]),
           "config": dataclasses.asdict(cfg)}
    t0 = time.perf_counter()
    encode, decode = load_vae(root, dtype="float32", device=DEV)
    torch.cuda.synchronize()
    res["load_seconds"] = time.perf_counter() - t0
    _, decode_cpu = load_vae(root, dtype="float32", device="cpu")
    small = torch.randn(CKPT["small_latent"], generator=gen, device=DEV)
    got = decode(small).cpu()
    want = decode_cpu(small.cpu())
    torch.testing.assert_close(got, want, **VAE_TOL)
    diff = (got - want).abs()
    res["small_gpu_vs_cpu"] = {
        "shape": list(got.shape), "tolerance": VAE_TOL,
        "max_abs_err": float(diff.max()),
        "max_err_over_bound": float((diff / (VAE_TOL["atol"] + VAE_TOL[
            "rtol"] * want.abs())).max()),
        "ref_max_abs": float(want.abs().max())}
    del decode_cpu

    # the timed runs at torch's default for cuDNN (TF32 convolutions), the
    # setting the CLI runs at; the check above ran with TF32 off
    torch.backends.cudnn.allow_tf32 = True
    try:
        res.update(vae_timed(encode, decode, gen))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return res


def vae_timed(encode, decode, gen) -> dict:
    """The untiled and the tiled decode of the 480x832x33 latent and the
    encode of its frames, each timed once with CUDA events beside its
    peak memory; shapes checked."""
    from rectified_spaattn_tpu_torch.models.vae import tiled_decode
    lat = torch.randn(CKPT["latent"], generator=gen, device=DEV)
    out, res = {}, {"cudnn_tf32": torch.backends.cudnn.allow_tf32}
    runs = (("untiled", lambda: decode(lat)),
            ("tiled", lambda: tiled_decode(decode, lat, CKPT["tile"],
                                           CKPT["overlap"])),
            ("encode", lambda: encode(out["untiled"])))
    for name, fn in runs:
        def run(name=name, fn=fn):
            out[name] = fn()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(run, reps=1, warmup=0)
        res[name] = {"ms": ms, "peak_mem_gb":
                     torch.cuda.max_memory_allocated() / 2**30}
    pixels = (1, 3, CKPT["frames_out"], CKPT["height"], CKPT["width"])
    for name, shape in (("untiled", pixels), ("tiled", pixels),
                        ("encode", CKPT["latent"])):
        if tuple(out[name].shape) != shape \
                or not torch.isfinite(out[name]).all():
            raise AssertionError(f"VAE {name} gave {tuple(out[name].shape)}"
                                 f", want {shape}")
    res["tiled_vs_untiled_max_abs"] = float(
        (out["tiled"] - out["untiled"]).abs().max())
    res["latent"], res["pixels"] = list(CKPT["latent"]), list(pixels)
    return res


def ckpt_phase(kernels, root: str) -> dict:
    """The pixel end: the codec, the full-width VAE, and the HunyuanVideo
    checkpoint path through the CLI (--ckpt_dir) on a synthetic bf16
    snapshot; K1's and K2's launch counters zeroed just before the CLI
    run and read just after.  The CLI runs at torch's default for cuDNN
    (TF32 convolutions in the VAE), as a user's run does.  The snapshots
    stay in ``root`` for the eval phases."""
    from rectified_spaattn_tpu_torch.cli.generate import main as cli_main
    from rectified_spaattn_tpu_torch.models.pretrained import load_transformer

    res = {"codec": codec_check()}
    out_dir = os.path.join(root, "out")
    try:
        res["vae"] = vae_checks(root)
        torch.cuda.empty_cache()

        gen = torch.Generator(device=DEV)
        gen.manual_seed(12)
        sd = synth_hunyuan_sd(CKPT["transformer"], gen)
        res["transformer_snapshot_bytes"] = write_snapshot(
            root, "transformer", sd, CKPT["transformer"])
        del sd
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        with HostPeak() as host:
            t0 = time.perf_counter()
            _, model = load_transformer("hunyuan", root, device=DEV)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        res["load"] = {"seconds": load_s, "host_rss": host.gb(),
                       "device_bytes": torch.cuda.memory_allocated() - base,
                       "param_bytes": sum(p.numel() * p.element_size()
                                          for p in model.parameters())}
        t0 = time.perf_counter()
        _, ref = load_transformer("hunyuan", root, cache=False, device="cpu")
        res["load"]["cpu_seconds"] = time.perf_counter() - t0
        got, want = model.state_dict(), ref.state_dict()
        if set(got) != set(want):
            raise AssertionError("GPU and CPU loads hold different keys")
        for k, t in want.items():
            g = got[k]
            if g.dtype != t.dtype or not torch.equal(g.cpu(), t):
                raise AssertionError(f"{k}: the GPU load differs from the "
                                     f"CPU load")
        res["load"]["tensors_equal_to_cpu_load"] = len(want)
        del model, ref, got, want
        torch.cuda.empty_cache()

        argv = ["--model", "hunyuan", "--ckpt_dir", root, "--height",
                str(CKPT["height"]), "--width", str(CKPT["width"]),
                "--frame", str(CKPT["frame"]), "--num_steps",
                str(CKPT["steps"]), "--mode", "sparse", "--group_rows", "2",
                "--out_dir", out_dir, "--device", DEV]
        kerns = path_kernels(kernels)
        torch.backends.cudnn.allow_tf32 = True
        zero_launches(kernels)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        line = cli_main(argv)
        cli_s = time.perf_counter() - t0
        launches = {n: f.launches for n, f in kerns.items()}
        if min(launches["K1"], launches["K2"]) == 0 or launches["K3"]:
            raise AssertionError(f"unexpected launches on the checkpoint "
                                 f"path: {launches}")
        frames = np.load(line["output"]) if line["output"].endswith(
            ".npy") else None
        want_shape = (CKPT["frames_out"], CKPT["height"], CKPT["width"], 3)
        if frames is None or frames.dtype != np.uint8 \
                or frames.shape != want_shape:
            raise AssertionError(f"the CLI wrote {line['output']}: "
                                 f"{getattr(frames, 'shape', None)}, "
                                 f"want uint8 {want_shape}")
        res["cli"] = {"argv": argv, "line": line, "seconds": cli_s,
                      "launches": launches, "frames": list(frames.shape),
                      "frames_dtype": str(frames.dtype),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                      "cudnn_tf32": True}
        res["cli_i2v"] = ckpt_i2v_cli(kernels, root, out_dir)
        torch.cuda.empty_cache()
        res["cogvideox"] = ckpt_cog_leg(kernels, root, out_dir)
        torch.cuda.empty_cache()
        res["flux"] = ckpt_flux_leg(kernels, root, out_dir)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return res


def ckpt_i2v_cli(kernels, root: str, out_dir: str) -> dict:
    """The CLI's hunyuan-i2v on the same snapshot (a T2V transformer, so
    token_replace is forced) with a seeded .npy image: its VAE encodes the
    image into the first latent frame, which the final latents hold bit
    for bit.  The pipeline's denoise is wrapped to read its first_frame
    and its output; K1's and K2's counters zeroed just before the run and
    read just after."""
    from rectified_spaattn_tpu_torch.cli.generate import main as cli_main
    from rectified_spaattn_tpu_torch.pipelines import HunyuanVideoPipeline

    image = os.path.join(root, "image.npy")
    np.save(image, np.random.default_rng(21).uniform(
        0, 255, (CKPT["height"], CKPT["width"], 3)).astype(np.float32))
    argv = ["--model", "hunyuan-i2v", "--ckpt_dir", root, "--image", image,
            "--height", str(CKPT["height"]), "--width", str(CKPT["width"]),
            "--frame", str(CKPT["frame"]), "--num_steps", str(CKPT["steps"]),
            "--mode", "sparse", "--group_rows", "2", "--out_dir", out_dir,
            "--device", DEV]
    seen, denoise = {}, HunyuanVideoPipeline.denoise

    def read(self, *a, **kw):
        seen["first_frame"] = kw.get("first_frame")
        seen["latents"] = denoise(self, *a, **kw)
        return seen["latents"]

    kerns = path_kernels(kernels)
    HunyuanVideoPipeline.denoise = read
    try:
        zero_launches(kernels)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        line = cli_main(argv)
        cli_s = time.perf_counter() - t0
        launches = {n: f.launches for n, f in kerns.items()}
    finally:
        HunyuanVideoPipeline.denoise = denoise
    if min(launches["K1"], launches["K2"]) == 0 or launches["K3"]:
        raise AssertionError(f"unexpected launches on the I2V checkpoint "
                             f"path: {launches}")
    first, lat = seen["first_frame"], seen["latents"]
    lt = CKPT["frame"] // 4
    want_ff = (1, lat.shape[1], 1, *lat.shape[3:])
    if first is None or tuple(first.shape) != want_ff \
            or not float(first.abs().max()) > 0:
        raise AssertionError(f"the CLI's first frame: "
                             f"{None if first is None else first.shape}")
    if lat.shape[2] != lt or not torch.equal(lat[:, :, :1],
                                             first.to(lat.dtype)):
        raise AssertionError("the I2V CLI run did not hold the encoded "
                             "first frame")
    frames = np.load(line["output"]) if line["output"].endswith(
        ".npy") else None
    want_shape = (CKPT["frames_out"], CKPT["height"], CKPT["width"], 3)
    if frames is None or frames.dtype != np.uint8 \
            or frames.shape != want_shape:
        raise AssertionError(f"the I2V CLI wrote {line['output']}")
    return {"argv": argv, "line": line, "seconds": cli_s,
            "launches": launches, "first_frame": list(first.shape),
            "first_frame_held": True, "frames": list(frames.shape),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


# -------------------------------------------------------- CogVideoX phases ---

def joint_site_inputs(c: dict, regime: str) -> dict:
    """A joint site's inputs at ``c`` (COG_SITE, FLUX_SITE) on "random"
    (iid, seed 8) or "smooth" q/k/v in the model's layout [visual ; text],
    and the kernels' layout: rectified_sparse_attention's zero pad between
    the visual and the text tokens (CogVideoX: visual 24,480 to 24,576, the
    text slot from there; Flux: none, 65,536 fill 512 blocks), K and V
    zeroed off the key window, and the single-row plan."""
    from rectified_spaattn_tpu_torch.attention import kv_validity
    from rectified_spaattn_tpu_torch.pipelines import build_site
    from rectified_spaattn_tpu_torch.sparse import build_sparse_plan

    dev = torch.device(DEV)
    b, h, d, text_len = 1, c["heads"], c["head_dim"], c["text_len"]
    site, _, h2l = build_site(*c["grid"], sa_drop_rate=c["sa_drop_rate"],
                              p_remain=0.3, layout="joint",
                              text_len=text_len, device=dev)
    sv = site.visual_len
    sv_pad = -(-sv // 128) * 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    if regime == "random":
        q, k, v = (torch.randn((b, h, sv + text_len, d), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(3))
    else:
        from rectified_spaattn_tpu_torch.bench.inputs import smooth_qkv
        q, k, v = smooth_qkv(gen, h, text_len, d, h2l, c["grid"])
    tlen = torch.tensor([c["tlen"]], dtype=torch.int32, device=dev)

    def ins(x):
        return torch.cat([x[:, :, :sv], x.new_zeros((b, h, sv_pad - sv, d)),
                          x[:, :, sv:]], dim=2)

    qp, kp, vp = ins(q), ins(k), ins(v)
    valid = kv_validity(b, sv_pad + text_len, sv, sv_pad, tlen, device=dev)
    zero = torch.zeros((), dtype=q.dtype, device=dev)
    kz = torch.where(valid[:, None, :, None], kp, zero)
    vz = torch.where(valid[:, None, :, None], vp, zero)
    text_valid = torch.arange(text_len, device=dev)[None, :] < tlen[:, None]
    plan = build_sparse_plan(qp[:, :, :sv_pad], kz, vz, site.cfg,
                             neighbor_mask=site.neighbor_mask,
                             text_valid=text_valid)
    return dict(site=site, q=q, k=k, v=v, qp=qp, kp=kp, vp=vp, tlen=tlen,
                valid=valid, kz=kz, vz=vz, plan=plan, sv_pad=sv_pad)


def joint_site_phase(kernels, ops, c: dict, regime: str, prefix: str):
    """A joint attention site at its operating point (COG_SITE: CogVideoX,
    prefix "cog_"; FLUX_SITE: Flux's 4096^2 stage, "flux_") on "random" or
    "smooth" inputs: the plan's time and the site's, then each kernel of
    the path at these shapes against its plain version on the full inputs
    (the relative limits), with its time, bound and, where one SDPA call
    computes the same function, that call's time: K1 on the visual rows
    (G = 1), K2 at G = 2, K1 on the text rows (key split and merge), and
    the windowed dense K1 of the dense calls or blocks at block_m 1024
    (attention/modes.py::_windowed_dense_flash, the model's unpadded
    layout).  Returns (results, per-kernel results, the inputs)."""
    from rectified_spaattn_tpu_torch.attention import (
        attention, kv_validity, rectified_sparse_attention)

    dev = torch.device(DEV)
    b, h, d = 1, c["heads"], c["head_dim"]
    text_len = c["text_len"]
    st = joint_site_inputs(c, regime)
    site, q, k, v, qp, tlen, valid, kz, vz, plan, sv_pad = (
        st[n] for n in ("site", "q", "k", "v", "qp", "tlen", "valid", "kz",
                        "vz", "plan", "sv_pad"))
    sv = site.visual_len
    cfg1 = site.cfg
    cfg2 = dataclasses.replace(cfg1, group_rows=2)
    res = {"regime": regime, "visual_len": sv, "text_len": text_len,
           "valid_text": int(tlen[0]), "heads": h, "head_dim": d}
    kern = {}

    def site_call(cfg, **kw):
        return rectified_sparse_attention(q, k, v, cfg, site.neighbor_mask,
                                          visual_len=sv, text_len_rt=tlen,
                                          **kw)

    def launches_of(fn):
        fs = {"K1": kernels.block_sparse_flash_attention,
              "K2": kernels.block_sparse_flash_attention_grouped,
              "K1_merge": kernels.block_sparse.merge_splits}
        for f in fs.values():
            f.launches = 0
        fn()
        return {n: f.launches for n, f in fs.items()}

    res["plan_ms"] = cuda_ms(lambda: site_call(cfg1, density_only=True))
    res["density"] = float(site_call(cfg1, density_only=True))
    res["sparse_g1_ms"] = cuda_ms(lambda: site_call(cfg1))
    res["sparse_g2_ms"] = cuda_ms(lambda: site_call(cfg2))
    res["launches_per_call"] = {
        "sparse_g1": launches_of(lambda: site_call(cfg1)),
        "sparse_g2": launches_of(lambda: site_call(cfg2))}
    out = site_call(cfg2)
    if out.shape != q.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{prefix}site output is not finite of shape "
                             "q.shape")
    del out

    nbt = (sv_pad + text_len) // 128
    pairs = float(plan.counts.sum())
    res["pairs"] = pairs
    kv_bytes = lambda blocks: 2 * blocks * 128 * d * 2
    used = torch.zeros((b * h, nbt), dtype=torch.int32, device=dev)
    used.scatter_add_(1, plan.indices.reshape(b * h, -1).long(),
                      (torch.arange(plan.indices.shape[-1], device=dev)
                       < plan.counts[..., None]).reshape(b * h, -1).int())
    vis_kv_blocks = float((used > 0).sum())
    qo_bytes = lambda rows: 2 * b * h * rows * d * 2
    flops_pair = lambda rows: 4.0 * rows * 128 * d
    idx_bytes = lambda *ts: sum(t.numel() * 4 for t in ts)
    kw = dict(visual_len=sv, text_start=sv_pad)
    q_vis, q_txt = qp[:, :, :sv_pad], qp[:, :, sv_pad:]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    ui, uc, rb, cl = ops.group_rows(plan.block_mask, 2,
                                    clean_blocks=sv // 128)
    g2 = dict(group=2, **kw)
    measure(kern, prefix + "K2_visual_g2", regime, True,
            lambda: kernels.block_sparse_flash_attention_grouped(
                q_vis, kz, vz, ui, uc, rb, cl, tlen, **g2),
            lambda: kernels.block_sparse_flash_attention_grouped_torch(
                q_vis, kz, vz, ui, uc, rb, cl, tlen, **g2),
            flops=pairs * flops_pair(128),
            nbytes=qo_bytes(sv_pad) + kv_bytes(vis_kv_blocks)
            + idx_bytes(ui, uc, rb, cl))
    del ui, uc, rb, cl
    measure(kern, prefix + "K1_visual_g1", regime, True,
            lambda: kernels.block_sparse_flash_attention(
                q_vis, kz, vz, plan.indices, plan.counts, tlen, **kw),
            lambda: kernels.block_sparse_flash_attention_torch(
                q_vis, kz, vz, plan.indices, plan.counts, tlen, **kw),
            flops=pairs * flops_pair(128),
            nbytes=qo_bytes(sv_pad) + kv_bytes(vis_kv_blocks)
            + idx_bytes(plan.indices, plan.counts))
    # the text rows: full lists over every key block, the split's merge
    nt = text_len // 128
    fidx = torch.arange(nbt, dtype=torch.int32, device=dev).expand(
        b, h, nt, nbt)
    fcnt = torch.full((b, h, nt), nbt, dtype=torch.int32, device=dev)
    keys = sv + int(tlen[0])              # the keys the window keeps
    amask = valid[:, None, None, :]
    measure(kern, prefix + "K1_text_rows", regime, True,
            lambda: kernels.block_sparse_flash_attention(
                q_txt, kz, vz, fidx, fcnt, tlen, **kw),
            lambda: kernels.block_sparse_flash_attention_torch(
                q_txt, kz, vz, fidx, fcnt, tlen, **kw),
            flops=4.0 * b * h * text_len * keys * d,
            nbytes=qo_bytes(text_len) + 2 * b * h * keys * d * 2
            + idx_bytes(fidx, fcnt),
            library=lambda: sdpa(q_txt, kz, vz, attn_mask=amask))
    merge_at_site(kernels, kern, regime, b * h * nt, nbt, d=d,
                  name=prefix + "K1_merge")
    # the warm calls' windowed dense, as attention(mode="flash") runs it on
    # the model's layout: K1 over full lists at block_m 1024, the text
    # window from the 24,480th key; the rows the data needs are the real
    # ones, the keys the window's
    s = sv + text_len
    nbd = -(-s // 128)
    nqd = -(-(nbd * 128) // 1024)
    pad = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, n - s))
    qd, kd, vd = pad(q, nqd * 1024), pad(k, nbd * 128), pad(v, nbd * 128)
    didx = torch.arange(nbd, dtype=torch.int32, device=dev).expand(
        b, h, nqd, nbd)
    dcnt = torch.full((b, h, nqd), nbd, dtype=torch.int32, device=dev)
    dkw = dict(visual_len=sv, text_start=sv, block_m=1024)
    dvalid = kv_validity(b, s, sv, sv, tlen, device=dev)[:, None, None, :]
    # every key valid (Flux's 512 text slots): the same function unmasked
    dmask = None if bool(dvalid.all()) else dvalid
    measure(kern, prefix + "K1_dense_bm1024", regime, True,
            lambda: kernels.block_sparse_flash_attention(
                qd, kd, vd, didx, dcnt, tlen, **dkw),
            lambda: kernels.block_sparse_flash_attention_torch(
                qd, kd, vd, didx, dcnt, tlen, **dkw),
            flops=4.0 * b * h * s * keys * d,
            nbytes=qo_bytes(s) + 2 * b * h * keys * d * 2
            + idx_bytes(didx, dcnt),
            library=lambda: sdpa(q, k, v, attn_mask=dmask))
    dense = lambda: attention(q, k, v, "flash", cfg=cfg1, visual_len=sv,
                              text_len_rt=tlen)
    res["dense_ms"] = cuda_ms(dense, reps=2)
    res["launches_per_call"]["dense"] = launches_of(dense)
    if res["launches_per_call"]["dense"] != {"K1": 1, "K2": 0,
                                             "K1_merge": 0}:
        raise AssertionError(f"the windowed dense launched "
                             f"{res['launches_per_call']['dense']}")
    return res, kern, st


def cog_full_pipe(cfg_kw: dict, steps: int, seed: int = 0):
    """A CogVideoXPipeline of COG_PIPE's geometry on a full-width
    CogVideoXConfig (``cfg_kw`` cuts its depth or widens its input), with
    seeded bf16 random weights drawn on the card; TeaCache off, so every
    call computes; and the seeded cond / uncond T5 stand-ins."""
    from rectified_spaattn_tpu_torch.cli.generate import _random_text
    from rectified_spaattn_tpu_torch.models import (
        CogVideoXConfig, CogVideoXDiT, init_random_weights)
    from rectified_spaattn_tpu_torch.pipelines import CogVideoXPipeline

    dev = torch.device(DEV)
    cfg = CogVideoXConfig(**cfg_kw)
    with torch.device(dev):
        model = CogVideoXDiT(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = init_random_weights(model.to(torch.bfloat16), gen)
    pipe = CogVideoXPipeline(
        model=model, height=COG_PIPE["height"], width=COG_PIPE["width"],
        frames=COG_PIPE["frames"], num_steps=steps, sa_drop_rate=0.85,
        p_remain_rates=0.3, mode="sparse", enable_teacache=False,
        group_rows=COG_PIPE["group_rows"], device=dev)
    text = _random_text("several hot air balloons flying over a city.", 256,
                        cfg.text_dim, device=dev)[0]
    neg = _random_text("", 256, cfg.text_dim, device=dev)[0]
    return pipe, cfg, text, neg


def per_call_launches(kernels, pipe):
    """Wrap ``pipe.model.run_blocks`` to record, per computed call, the
    launches of ``path_kernels`` it made; returns the list it fills."""
    kerns = path_kernels(kernels)
    calls, run = [], pipe.model.run_blocks

    def counted(*a, **kw):
        before = {n: f.launches for n, f in kerns.items()}
        out = run(*a, **kw)
        calls.append({n: f.launches - before[n] for n, f in kerns.items()})
        return out

    pipe.model.run_blocks = counted
    return calls


def cog_pipe_run(kernels, pipe, text, neg, **call_kw):
    """The pipeline's run with the launch counters zeroed just before and
    read just after, per call too; checks the shape, finiteness, the
    calls gated sparse (from call 5 on) and that each dense call launched
    K1 once a block (the windowed dense) and each sparse call K2 (visual
    rows), K1 (text rows), the merge and P1 (its plan) once a block, and
    K3 never."""
    kerns = path_kernels(kernels)
    calls = per_call_launches(kernels, pipe)
    noise = torch.Generator(device=DEV)
    noise.manual_seed(42)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for f in kerns.values():
        f.launches = 0
    out = pipe(text, neg, generator=noise, **call_kw)
    torch.cuda.synchronize()
    launches = {n: f.launches for n, f in kerns.items()}
    del pipe.model.run_blocks
    n = pipe.model.cfg.num_blocks
    cfg = pipe.model.cfg
    if out.shape != (1, cfg.out_channels, *pipe.grid) \
            or not torch.isfinite(out).all():
        raise AssertionError(f"CogVideoX output {tuple(out.shape)} not "
                             f"finite or of the wrong shape")
    ncalls = 2 * len(pipe.step_seconds)
    want_sparse = list(range(pipe.sparse_warm_calls, ncalls))
    dense_call = {"K1": n, "K2": 0, "K3": 0, "K1_merge": 0, "P1": 0}
    sparse_call = {"K1": n, "K2": n, "K3": 0, "K1_merge": n, "P1": n}
    want = [sparse_call if c in want_sparse else dense_call
            for c in range(ncalls)]
    if pipe.sparse_calls != want_sparse or calls != want:
        raise AssertionError(f"CogVideoX launches per call {calls} (sparse "
                             f"calls {pipe.sparse_calls}), want {want}")
    return out, {
        "launches": launches,
        "launches_per_dense_call": dense_call,
        "launches_per_sparse_call": sparse_call,
        "sparse_calls": pipe.sparse_calls, "step_seconds": pipe.step_seconds,
        "denoise_seconds": pipe.denoise_seconds,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


def pipeline_cogvideox_phase(kernels):
    """CogVideoX1.5-5B T2V at full width and depth (COG_PIPE): s/step, peak
    memory, launches per dense and sparse call, then one sparse step (2
    calls, the gate at 0) under the profiler."""
    pipe, cfg, text, neg = cog_full_pipe(COG_PIPE["cfg"], COG_PIPE["steps"])
    res = {"config": dataclasses.asdict(cfg),
           "params": sum(p.numel() for p in pipe.model.parameters()),
           "weight_gb": tree_bytes(pipe.model) / 2**30,
           "grid": list(pipe.grid), "visual_tokens": pipe.site.visual_len,
           "steps": COG_PIPE["steps"], "cut": COG_PIPE["cut"]}
    _, run = cog_pipe_run(kernels, pipe, text, neg)
    res.update(run)
    pipe.sparse_warm_calls = 0
    gen = torch.Generator(device=DEV)
    gen.manual_seed(43)
    res["profiled_sparse_step"] = profile_run(
        lambda: pipe(text, neg, generator=gen, num_steps=1))
    return res


def pipeline_cogvideox_i2v_phase(kernels):
    """CogVideoX1.5 I2V: in_channels 32 (noise | image latents), COG_I2V's
    depth, the condition of a seeded image through the CLI's stand-in
    encoder (cog_i2v_condition: the first latent frame, zeros after), ofs
    2.0; launches per call as the T2V phase's."""
    from rectified_spaattn_tpu_torch.cli.generate import _demo_vae_encoder
    from rectified_spaattn_tpu_torch.pipelines import cog_i2v_condition

    pipe, cfg, text, neg = cog_full_pipe(COG_I2V["cfg"], COG_PIPE["steps"],
                                         seed=1)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(44)
    image = torch.rand((1, 3, COG_PIPE["height"], COG_PIPE["width"]),
                       generator=gen, device=DEV) * 2 - 1
    enc = _demo_vae_encoder(cfg.out_channels, (1, *pipe.grid[1:]), DEV)
    cond = cog_i2v_condition(image, enc, pipe.grid)
    if cond.shape != (1, cfg.in_channels - cfg.out_channels, *pipe.grid) \
            or cond[:, :, 1:].abs().max() != 0 \
            or not cond[:, :, :1].abs().max() > 0:
        raise AssertionError("cog_i2v_condition: not the first latent frame "
                             "alone")
    seen, embed = {}, pipe.model.embed

    def read_ofs(*a, **kw):
        seen["ofs"] = a[4] if len(a) > 4 else kw.get("ofs")
        return embed(*a, **kw)

    pipe.model.embed = read_ofs
    try:
        _, res = cog_pipe_run(kernels, pipe, text, neg, condition=cond)
    finally:
        del pipe.model.embed
    if seen["ofs"] is None or not bool((seen["ofs"] == 2.0).all()):
        raise AssertionError(f"I2V ran with ofs {seen['ofs']}, want 2.0")
    res.update({"config": dataclasses.asdict(cfg), "ofs": 2.0,
                "condition": list(cond.shape), "cut": COG_I2V["cut"]})
    return res


def small_cog_check(i2v: bool, dtype=torch.bfloat16,
                    teacache=None) -> dict:
    """A small CogVideoX pipeline (2 blocks of 4 heads x 64) on the GPU in
    bf16 against the same weights on the CPU in fp32, TeaCache on (calls
    2 and 3 skip; the same decisions on both), sparse from call 5, I2V on
    a seeded condition; held to the output's scale.  With ``dtype`` fp32
    the output is held to PIPE_F32 with TeaCache off (``teacache``'s
    default there), to PIPE_BF16 with it on: its residual is stored in
    bf16 on both devices, so a residual element whose fp32 values straddle
    a bf16 rounding boundary differs by one bf16 step, which the skipped
    calls add to the latents (PERF.md §2).  The run with it on reports
    its reading against PIPE_F32 and those steps in the last residuals
    stored."""
    from rectified_spaattn_tpu_torch.models import (
        CogVideoXConfig, CogVideoXDiT, init_random_weights)
    from rectified_spaattn_tpu_torch.pipelines import CogVideoXPipeline

    cfg = CogVideoXConfig(in_channels=32 if i2v else 16, hidden_dim=256,
                          heads=4, num_blocks=2, text_dim=64,
                          time_embed_dim=64)
    gen = torch.Generator()
    gen.manual_seed(5)
    ref = init_random_weights(CogVideoXDiT(cfg), gen)
    gpu = CogVideoXDiT(cfg)
    gpu.load_state_dict(ref.state_dict())
    gpu = gpu.to(dtype)
    text = torch.randn((1, 256, cfg.text_dim), generator=gen)
    neg = torch.zeros_like(text)
    f32 = dtype == torch.float32
    tea = not f32 if teacache is None else teacache
    kw = dict(height=128, width=256, frames=17, num_steps=4, sa_drop_rate=0.5,
              p_remain_rates=0.5, group_rows=2,
              **(SMALL_COG_TEACACHE if tea else {}))
    p_cpu = CogVideoXPipeline(model=ref, device="cpu", **kw)
    init = torch.randn((1, cfg.out_channels, *p_cpu.grid), generator=gen)
    extra = {}
    if i2v:
        cond = torch.zeros((1, 16, *p_cpu.grid))
        cond[:, :, :1] = torch.randn((1, 16, 1, *p_cpu.grid[1:]),
                                     generator=gen)
        extra["condition"] = cond
    want = p_cpu(text, neg, init_latents=init, **extra)
    p_gpu = CogVideoXPipeline(model=gpu, device=DEV, **kw)
    got = p_gpu(text, neg, init_latents=init, **extra).cpu()
    if p_gpu.teacache.decisions != p_cpu.teacache.decisions \
            or (tea and False not in p_gpu.teacache.decisions) \
            or not p_gpu.sparse_calls:
        raise AssertionError(
            f"small CogVideoX pipeline: decisions {p_gpu.teacache.decisions}"
            f" (CPU {p_cpu.teacache.decisions}), sparse calls "
            f"{p_gpu.sparse_calls}")
    name = f"small CogVideoX {'I2V' if i2v else 'T2V'} pipeline GPU vs CPU"
    if f32 and tea:
        err = (got - want).abs()
        return {**held_f32(name + " (fp32, TeaCache)", got, want, PIPE_BF16),
                "max_err_over_pipe_f32": float(
                    (err / (PIPE_F32["atol"]
                            + PIPE_F32["rtol"] * want.abs())).max()),
                "residual_bf16_steps": bf16_steps(p_gpu.teacache,
                                                  p_cpu.teacache),
                "teacache_decisions": p_gpu.teacache.decisions,
                "sparse_calls": p_gpu.sparse_calls}
    if f32:
        return {**held_f32(name + " (fp32)", got, want),
                "teacache_decisions": p_gpu.teacache.decisions,
                "sparse_calls": p_gpu.sparse_calls}
    return {**held_to_scale(name, got, want),
            "teacache_decisions": p_gpu.teacache.decisions,
            "sparse_calls": p_gpu.sparse_calls}


def bf16_steps(tea_gpu, tea_cpu) -> list:
    """For each CFG stream, the last bf16 residuals the two runs stored:
    the count of elements that differ, how many of them are neighbouring
    bf16 values (one step apart), and the largest difference over the
    residual's max |value|."""
    out = []
    for sg, sc in zip(tea_gpu.states, tea_cpu.states):
        a = sg.previous_residual.cpu().float()
        b = sc.previous_residual.float()
        top = torch.maximum(a.abs(), b.abs()).clamp_min(
            torch.finfo(torch.bfloat16).tiny)
        step = torch.exp2(torch.floor(torch.log2(top)) - 7)
        diff, err = a != b, (a - b).abs()
        out.append({"differ": int(diff.sum()),
                    "one_step": int((diff & (err <= step)).sum()),
                    "of": b.numel(),
                    "max_diff_over_max": float(err.max() / b.abs().max())})
    return out


def synth_cog_sd(cj: dict, gen) -> dict:
    """A diffusers CogVideoXTransformer3DModel state dict (1.5: the Linear
    patch embed, the ofs embedding) for the config json ``cj``."""
    d = cj["num_attention_heads"] * cj["attention_head_dim"]
    hd, te = cj["attention_head_dim"], cj["time_embed_dim"]
    sd = {}
    lin = lambda n, o, i: (_synth(sd, gen, n + ".weight", (o, i), "w"),
                           _synth(sd, gen, n + ".bias", (o,), "0"))
    ln = lambda n, c: (_synth(sd, gen, n + ".weight", (c,), "ones"),
                       _synth(sd, gen, n + ".bias", (c,), "0"))
    patch = cj["patch_size_t"] * cj["patch_size"] ** 2
    lin("patch_embed.proj", d, cj["in_channels"] * patch)
    lin("patch_embed.text_proj", d, cj["text_embed_dim"])
    for emb in ("time_embedding", "ofs_embedding"):
        lin(f"{emb}.linear_1", te, te)
        lin(f"{emb}.linear_2", te, te)
    for i in range(cj["num_layers"]):
        b = f"transformer_blocks.{i}"
        for n in ("norm1", "norm2"):
            lin(f"{b}.{n}.linear", 6 * d, te)
            ln(f"{b}.{n}.norm", d)
        for nm in ("to_q", "to_k", "to_v", "to_out.0"):
            lin(f"{b}.attn1.{nm}", d, d)
        ln(f"{b}.attn1.norm_q", hd)
        ln(f"{b}.attn1.norm_k", hd)
        lin(f"{b}.ff.net.0.proj", 4 * d, d)
        lin(f"{b}.ff.net.2", d, 4 * d)
    ln("norm_final", d)
    lin("norm_out.linear", 2 * d, te)
    ln("norm_out.norm", d)
    lin("proj_out", patch * cj["out_channels"], d)
    return sd


def ckpt_cog_leg(kernels, root: str, out_dir: str) -> dict:
    """The CogVideoX checkpoint path: a seeded bf16 snapshot with
    transformer/ in diffusers' CogVideoXTransformer3DModel key layout at
    CogVideoXConfig()'s widths cut to 2 blocks, and the phase's 16-channel
    VAE; load_transformer on the card held to a CPU load bit for bit; then
    the CLI's --model cogvideox-t2v --ckpt_dir at 480x832 (K1 and K2
    launched, the text rows split and merged, K3 never), writing uint8
    frames."""
    from rectified_spaattn_tpu_torch.cli.generate import main as cli_main
    from rectified_spaattn_tpu_torch.models.pretrained import load_transformer

    c = COG_CKPT
    cog_root = os.path.join(root, "cogvideox")
    os.makedirs(cog_root)
    os.symlink(os.path.join(root, "vae"), os.path.join(cog_root, "vae"))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(13)
    sd = synth_cog_sd(c["transformer"], gen)
    res = {"transformer_snapshot_bytes": write_snapshot(
        cog_root, "transformer", sd, c["transformer"])}
    del sd
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, model = load_transformer("cogvideox", cog_root, device=DEV)
    torch.cuda.synchronize()
    res["load_seconds"] = time.perf_counter() - t0
    _, ref = load_transformer("cogvideox", cog_root, cache=False,
                              device="cpu")
    got, want = model.state_dict(), ref.state_dict()
    if set(got) != set(want) or any(
            got[k].dtype != t.dtype or not torch.equal(got[k].cpu(), t)
            for k, t in want.items()):
        raise AssertionError("the CogVideoX GPU load differs from the CPU "
                             "load")
    res.update(tensors_equal_to_cpu_load=len(want),
               config=dataclasses.asdict(cfg))
    del model, ref, got, want
    torch.cuda.empty_cache()
    argv = ["--model", "cogvideox-t2v", "--ckpt_dir", cog_root, "--height",
            str(c["height"]), "--width", str(c["width"]), "--frame",
            str(c["frame"]), "--num_steps", str(c["steps"]), "--mode",
            "sparse", "--group_rows", "2", "--out_dir", out_dir, "--device",
            DEV]
    kerns = path_kernels(kernels)
    zero_launches(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    line = cli_main(argv)
    cli_s = time.perf_counter() - t0
    launches = {n: f.launches for n, f in kerns.items()}
    if min(launches["K1"], launches["K2"], launches["K1_merge"]) == 0 \
            or launches["K3"]:
        raise AssertionError(f"unexpected launches on the CogVideoX "
                             f"checkpoint path: {launches}")
    frames = np.load(line["output"]) if line["output"].endswith(
        ".npy") else None
    want_shape = (c["frames_out"], c["height"], c["width"], 3)
    if frames is None or frames.dtype != np.uint8 \
            or frames.shape != want_shape:
        raise AssertionError(f"the CogVideoX CLI wrote {line['output']}: "
                             f"{getattr(frames, 'shape', None)}, want uint8 "
                             f"{want_shape}")
    res["cli"] = {"argv": argv, "line": line, "seconds": cli_s,
                  "launches": launches, "frames": list(frames.shape),
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    return res


# ------------------------------------------------------------ Flux phases ---

def flux_site_phase(kernels, ops, regime: str):
    """Flux's attention site at its 4096^2 operating point (FLUX_SITE) on
    "random" or "smooth" inputs: joint_site_phase's plan, K2 at G = 2, K1
    visual, K1 text rows (split and merged) and the windowed dense K1 of
    the 20 dense-band blocks at block_m 1024; then K3 as the ControlNet
    runs it: unmasked self-attention over all 66,048 tokens (padded text
    slots included), against its plain version on the full inputs (in
    chunks of heads and rows) and beside unmasked SDPA."""
    res, kern, st = joint_site_phase(kernels, ops, FLUX_SITE, regime,
                                     "flux_")
    q, k, v = st["q"], st["k"], st["v"]
    del st
    torch.cuda.empty_cache()
    b, h, s, d = q.shape
    k3 = kernels.dense_flash_attention
    k3.launches = 0
    measure(kern, "flux_K3_self", regime, True,
            lambda: kernels.dense_attention(q, k, v, mode="flash"),
            lambda: plain_dense(kernels, q, k, v, heads=1, rows=8192),
            flops=4.0 * b * h * s * s * d, nbytes=4 * b * h * s * d * 2,
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v))
    if k3.launches == 0:
        raise AssertionError("K3 was not launched at the Flux site")
    res["tokens"] = s
    return res, kern


def flux_full_pipe(cfg_kw=None, cn_kw=None, **pipe_kw):
    """A FluxUpscalePipeline of FLUX_PIPE's geometry on FluxConfig() and
    FluxControlNetConfig() (``cfg_kw`` / ``cn_kw`` cut their depths,
    ``pipe_kw`` adds stage options) with the CLI's seeded random weights
    (random_flux: built on the card in bf16, so no fp32 tree of the 12B
    trunk ever exists; the ControlNet nudged off its zero init), the
    seeded T5 stand-in and a seeded pooled vector."""
    from rectified_spaattn_tpu_torch.cli.generate import (_random_text,
                                                          random_flux)
    from rectified_spaattn_tpu_torch.models import (FluxConfig,
                                                    FluxControlNetConfig)
    from rectified_spaattn_tpu_torch.pipelines import (FluxPipeline,
                                                       FluxUpscalePipeline)

    dev = torch.device(DEV)
    cfg = FluxConfig(**FLUX_PIPE["cfg"], **(cfg_kw or {}))
    cn_cfg = FluxControlNetConfig(**FLUX_PIPE["cn_cfg"], **(cn_kw or {}))
    model, cn = random_flux(cfg, cn_cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    kw = dict(num_steps=FLUX_PIPE["steps"], sa_drop_rate=0.9,
              p_remain_rates=0.3, mode="sparse",
              group_rows=FLUX_PIPE["group_rows"], device=dev, **pipe_kw)
    pipe = FluxUpscalePipeline(
        base=FluxPipeline(model=model, height=FLUX_PIPE["base"],
                          width=FLUX_PIPE["base"], **kw),
        up=FluxPipeline(model=model, height=FLUX_PIPE["up"],
                        width=FLUX_PIPE["up"], **kw),
        controlnet=cn)
    text, mask = _random_text("several hot air balloons flying over a city.",
                              512, cfg.text_dim, device=dev)
    pooled = torch.randn((1, cfg.pooled_dim), generator=gen, device=dev)
    return pipe, cfg, cn_cfg, text, mask, pooled


def record_calls(kernels, obj, name: str, calls: list):
    """Wrap ``obj.<name>`` to append, per call, the launches of
    ``path_kernels`` it made to ``calls``; returns the undo."""
    kerns = path_kernels(kernels)
    fn = getattr(obj, name)

    def counted(*a, **kw):
        before = {n: f.launches for n, f in kerns.items()}
        out = fn(*a, **kw)
        calls.append({n: f.launches - before[n] for n, f in kerns.items()})
        return out

    setattr(obj, name, counted)
    return lambda: delattr(obj, name)


def check_flux_launches(trunk: list, ctrl: list, steps: int) -> None:
    """Each of the 2 x ``steps`` trunk calls launched K2 37 times (the
    visual rows of the 37 sparse blocks), P1 37 (their plans), K1 57
    (their text rows, split and merged, and the 20 windowed dense blocks)
    and K3 never; each of the ``steps`` ControlNet calls K3 5 times (its 5
    blocks) and nothing else."""
    want_trunk = {"K1": 57, "K2": 37, "K3": 0, "P1": 37}
    bad = [c for c in trunk if {k: c[k] for k in want_trunk} != want_trunk
           or c["K1_merge"] == 0]
    bad += [c for c in ctrl if c != {"K1": 0, "K2": 0, "K3": 5,
                                     "K1_merge": 0, "P1": 0}]
    if bad or len(trunk) != 2 * steps or len(ctrl) != steps:
        raise AssertionError(f"Flux launches per trunk call {trunk}, per "
                             f"ControlNet call {ctrl}")


def pipeline_flux_phase(kernels):
    """Flux.1-dev's upscale at full width and depth (FLUX_PIPE): s/step of
    each stage, peak memory, the device's weight bytes, and the launches
    of each trunk call and each ControlNet call (counters zeroed just
    before the run, read just after): every trunk call K2 37 (the visual
    rows of the sparse blocks), K1 57 (their text rows and the 20
    windowed dense blocks) and K3 0, every ControlNet call K3 5 and
    nothing else.  Then one up step under the profiler."""
    pipe, cfg, cn_cfg, text, mask, pooled = flux_full_pipe()
    model, cn = pipe.up.model, pipe.controlnet
    res = {"config": dataclasses.asdict(cfg),
           "controlnet_config": dataclasses.asdict(cn_cfg),
           "params": sum(p.numel() for p in model.parameters()),
           "controlnet_params": sum(p.numel() for p in cn.parameters()),
           "device_weight_gb": device_tree_bytes(model, cn) / 2**30,
           "base_tokens": pipe.base.site.visual_len,
           "up_tokens": pipe.up.site.visual_len, "text_slots": 512,
           "valid_text": int(mask.sum()), "steps": FLUX_PIPE["steps"],
           "cut": FLUX_PIPE["cut"]}
    kerns = path_kernels(kernels)
    trunk, ctrl = [], []
    undo = [record_calls(kernels, model, "run_blocks", trunk),
            record_calls(kernels, cn, "forward", ctrl)]
    noise = torch.Generator(device=DEV)
    noise.manual_seed(42)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for f in kerns.values():
        f.launches = 0
    try:
        out = pipe(text, mask, pooled, generator=noise)
        torch.cuda.synchronize()
    finally:
        for u in undo:
            u()
    launches = {n: f.launches for n, f in kerns.items()}
    if out.shape != (1, pipe.up.gh * pipe.up.gw, cfg.in_channels) \
            or not torch.isfinite(out).all():
        raise AssertionError(f"Flux output {tuple(out.shape)} not finite or "
                             f"of the wrong shape")
    n = FLUX_PIPE["steps"]
    check_flux_launches(trunk, ctrl, n)
    per_up_step = [{k: t[k] + c[k] for k in t}
                   for t, c in zip(trunk[n:], ctrl)]
    res.update({"launches": launches, "launches_per_trunk_call": trunk,
                "launches_per_controlnet_call": ctrl,
                "launches_per_up_step": per_up_step,
                "base_step_seconds": pipe.base.step_seconds,
                "up_step_seconds": pipe.up.step_seconds,
                "base_denoise_seconds": pipe.base.denoise_seconds,
                "up_denoise_seconds": pipe.up.denoise_seconds,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    del out
    # one up step with the ControlNet, under the profiler
    gen = torch.Generator(device=DEV)
    gen.manual_seed(43)
    base = torch.randn((1, pipe.base.gh * pipe.base.gw, cfg.in_channels),
                       generator=gen, device=DEV)
    control = pipe.control_tokens(base)
    fn = pipe.controlnet_fn(control, text, pooled)
    init = pipe.up.noise(1, generator=gen)
    res["profiled_up_step"] = profile_run(
        lambda: pipe.up(text, mask, pooled, controlnet_fn=fn,
                        init_tokens=init, num_steps=1))
    return res


def counted_run(kernels, run):
    """``run()`` with the path's launch counters zeroed just before and
    read just after; returns (its output, launches, memory: the peak, the
    bytes allocated at the start (what earlier phases left) and the peak
    above them, GB)."""
    kerns = path_kernels(kernels)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated() / 2**30
    for f in kerns.values():
        f.launches = 0
    out = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    return (out, {n: f.launches for n, f in kerns.items()},
            {"peak_mem_gb": peak, "start_gb": start,
             "peak_above_start_gb": peak - start})


def held_to_run(name, got, want) -> dict:
    """A stacked run's output against the unrolled run's: bit for bit, or
    (reported as not) within the pipeline limits of held_to_scale."""
    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    if torch.equal(got, want):
        return {"bit_for_bit": True}
    return {"bit_for_bit": False, **held_to_scale(name, got, want)}


def stack_on_card(model, *names) -> dict:
    """Stack ``model``'s block lists in place (models/scan.py), the device
    bytes allocated just before and just after and the transient peak
    above them; raises if the card holds more than before (a second copy;
    the allocator's 512-byte rounding of one tensor against many may move
    the count by < 1 MiB)."""
    from rectified_spaattn_tpu_torch.models import scan
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    scan.stack_model_blocks(model, *names)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    weights = sum(t.numel() * t.element_size()
                  for t in scan.stacked_state_dict(model).values())
    r = {"allocated_before_gb": before / 2**30,
         "allocated_after_gb": after / 2**30,
         "stacking_peak_above_gb":
             (torch.cuda.max_memory_allocated() - before) / 2**30,
         "device_weight_gb": weights / 2**30}
    if after - before > 2**20:
        raise AssertionError(f"stacking grew the card's memory: {r}")
    return r


def scan_pair(name, unrolled: tuple, stacked_runs: dict) -> dict:
    """Hold each stacked run ({label: (output, launches, ...)}) to the
    unrolled run's (output, launches): the latents (held_to_run) and the
    launch counts, equal."""
    want, want_l = unrolled[:2]
    res = {}
    for label, (out, launches, *_rest) in stacked_runs.items():
        res[label] = held_to_run(f"{name} {label}", out, want)
        if launches != want_l or launches["K1"] == 0:
            raise AssertionError(f"{name} {label}: launches {launches}, the "
                                 f"unrolled run's {want_l}")
    return res


def scan_phase(kernels, hun: dict, hun_latents, wan: dict, wan_latents):
    """The stacked block execution (models/scan.py) on the card, each run
    with the launch counters zeroed just before and read just after:

    (a) Hunyuan at PIPE (phase 4's config, seeds and steps, TeaCache on,
        G = 2) stacked, then with dispatch_segments=2, held to phase
        4's latents and launches, its TeaCache decisions too;
    (b) Wan at WAN_PIPE (UniPC under CFG), stacked and with
        dispatch_segments=2, held to the Wan phase's latents, launches and
        sparse plans;
    (c) CogVideoX and Flux cut to SCAN's depths, unrolled then stacked
        on the same model;
    (d) the serving tier at full depth: HunyuanVideoConfig() with int4
        weights, stacked, dispatch_segments=2, one sparse step, held to
        the unrolled step on the same weights.

    Stacking happens on the card in place (``stack_on_card``: no second
    copy); the pipelines reuse those stacks."""
    from rectified_spaattn_tpu_torch.cli.generate import (_random_model,
                                                          _random_text)
    from rectified_spaattn_tpu_torch.models import (
        HunyuanVideoConfig, HunyuanVideoDiT, quantize_model)
    from rectified_spaattn_tpu_torch.pipelines import HunyuanVideoPipeline

    dev = torch.device(DEV)
    w = SCAN["windows"]
    res, runs = {"cut": SCAN["cut"]}, {}

    def seeded(seed=42):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return gen

    # (a) Hunyuan, phase 4's run
    model = hunyuan_full_model()
    stacking = stack_on_card(model, "dual_blocks", "single_blocks")
    pipe, cfg, text, mask = hunyuan_full_pipe(model=model, scan_blocks=True)
    stacked = {}
    for label, k in (("scan", 1), ("windows", w)):
        pipe.dispatch_segments = k
        stacked[label] = counted_run(
            kernels, lambda: pipe(text, mask, generator=seeded()))
        if pipe.teacache.decisions != hun["teacache_decisions"]:
            raise AssertionError(f"Hunyuan {label}: TeaCache decisions "
                                 f"{pipe.teacache.decisions}, phase 4's "
                                 f"{hun['teacache_decisions']}")
        stacked[label] += (pipe.step_seconds,)
    hold = scan_pair("Hunyuan", (hun_latents, hun["launches"]),
                     stacked)
    res["hunyuan"] = {
        "stacking": stacking, "hold": hold, "teacache": pipe.teacache_stats,
        **{label: {"launches": r[1], **r[2],
                   "step_seconds": r[3]} for label, r in stacked.items()},
        "unrolled": {"launches": hun["launches"],
                     "peak_mem_gb": hun["peak_mem_gb"],
                     "start_gb": hun["start_gb"],
                     "peak_above_start_gb":
                         hun["peak_mem_gb"] - hun["start_gb"],
                     "step_seconds": hun["step_seconds"]}}
    runs.update(hunyuan=stacked["scan"][1],
                hunyuan_windows=stacked["windows"][1])
    del pipe, model, stacked

    # (b) Wan, the Wan phase's run
    model = wan_full_model()
    stacking = stack_on_card(model, "blocks")
    pipe, wtext, wneg = wan_full_pipe(model, scan_blocks=True)
    stacked = {}
    for label, k in (("scan", 1), ("windows", w)):
        pipe.dispatch_segments = k
        plans, restore = record_plan_counts()
        try:
            stacked[label] = counted_run(
                kernels, lambda: pipe(wtext, wneg, generator=seeded()))
        finally:
            restore()
        if len(plans) != wan["sparse_plans"]:
            raise AssertionError(f"Wan {label}: {len(plans)} sparse plans, "
                                 f"the Wan phase's {wan['sparse_plans']}")
        stacked[label] += (pipe.step_seconds,)
    hold = scan_pair("Wan", (wan_latents, wan["launches"]), stacked)
    res["wan"] = {
        "stacking": stacking, "hold": hold,
        "sparse_plans": wan["sparse_plans"],
        **{label: {"launches": r[1], **r[2],
                   "step_seconds": r[3]} for label, r in stacked.items()},
        "unrolled": {"launches": wan["launches"],
                     "peak_mem_gb": wan["peak_mem_gb"],
                     "start_gb": wan["start_gb"],
                     "peak_above_start_gb":
                         wan["peak_mem_gb"] - wan["start_gb"],
                     "step_seconds": wan["step_seconds"]}}
    runs.update(wan=stacked["scan"][1], wan_windows=stacked["windows"][1])
    del pipe, model, stacked

    # (c) CogVideoX and Flux, unrolled then stacked on the same weights
    pipe, _, ctext, cneg = cog_full_pipe(SCAN["cog_cfg"], COG_PIPE["steps"])
    unrolled = counted_run(kernels,
                           lambda: pipe(ctext, cneg, generator=seeded()))
    stacking = stack_on_card(pipe.model, "blocks")
    spipe = dataclasses.replace(pipe, scan_blocks=True)
    stacked = {"scan": counted_run(
        kernels, lambda: spipe(ctext, cneg, generator=seeded()))}
    res["cogvideox"] = {
        "stacking": stacking,
        "hold": scan_pair("CogVideoX", unrolled, stacked),
        "unrolled": {"launches": unrolled[1], **unrolled[2],
                     "step_seconds": pipe.step_seconds},
        "scan": {"launches": stacked["scan"][1],
                 **stacked["scan"][2],
                 "step_seconds": spipe.step_seconds}}
    runs.update(cogvideox_unrolled=unrolled[1],
                cogvideox=stacked["scan"][1])
    del pipe, spipe, unrolled, stacked

    pipe, _, _, ftext, fmask, pooled = flux_full_pipe(
        SCAN["flux_cfg"], SCAN["flux_cn_cfg"],
        sparse_layer_gate=SCAN["flux_gate"])
    unrolled = counted_run(
        kernels, lambda: pipe(ftext, fmask, pooled, generator=seeded()))
    stacking = stack_on_card(pipe.up.model, "dual_blocks", "single_blocks")
    spipe = dataclasses.replace(
        pipe, base=dataclasses.replace(pipe.base, scan_blocks=True),
        up=dataclasses.replace(pipe.up, scan_blocks=True))
    stacked = {"scan": counted_run(
        kernels, lambda: spipe(ftext, fmask, pooled, generator=seeded()))}
    res["flux"] = {
        "stacking": stacking, "gate": list(SCAN["flux_gate"]),
        "hold": scan_pair("Flux", unrolled, stacked),
        "unrolled": {"launches": unrolled[1], **unrolled[2],
                     "up_step_seconds": pipe.up.step_seconds},
        "scan": {"launches": stacked["scan"][1],
                 **stacked["scan"][2],
                 "up_step_seconds": spipe.up.step_seconds}}
    if not stacked["scan"][1]["K2"] or not stacked["scan"][1]["K3"]:
        raise AssertionError(f"Flux stacked launches {stacked['scan'][1]}")
    runs.update(flux_unrolled=unrolled[1], flux=stacked["scan"][1])
    del pipe, spipe, unrolled, stacked
    torch.cuda.empty_cache()

    # (d) the serving tier at full depth
    t0 = time.perf_counter()
    fcfg = HunyuanVideoConfig(**SCAN["full_cfg"])
    model = quantize_model(_random_model(HunyuanVideoDiT, fcfg, dev),
                           bits=SCAN["full_bits"])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stacking = stack_on_card(model, "dual_blocks", "single_blocks")
    ftext, fmask = _random_text(
        "several hot air balloons flying over a city.", 256, fcfg.text_dim,
        device=dev)
    kw = dict(model=model, height=PIPE["height"], width=PIPE["width"],
              frames=PIPE["frames"], num_steps=SCAN["full_steps"],
              sa_drop_rate=0.8, p_remain_rates=0.3, mode="sparse",
              enable_teacache=False, group_rows=2, device=dev)
    spipe = HunyuanVideoPipeline(scan_blocks=True, dispatch_segments=w, **kw)
    stacked = counted_run(kernels,
                          lambda: spipe(ftext, fmask, generator=seeded()))
    upipe = HunyuanVideoPipeline(**kw)
    unrolled = counted_run(kernels,
                           lambda: upipe(ftext, fmask, generator=seeded()))
    blocks = fcfg.num_dual_blocks + fcfg.num_single_blocks
    n = blocks * SCAN["full_steps"]
    want = {"K1": n, "K2": n, "K3": 0, "K1_merge": n, "P1": n}
    if unrolled[1] != want:
        raise AssertionError(f"full-depth launches {unrolled[1]}, want "
                             f"{want} (one K2, K1, merge and P1 a block)")
    layouts = sorted({m.layout for m in model.modules()
                      if hasattr(m, "layout") and m.weight is None})
    res["hunyuan_full_depth"] = {
        "config": dataclasses.asdict(fcfg), "blocks": blocks,
        "weights": f"int{SCAN['full_bits']} (quantize_model), layouts "
                   f"{layouts}",
        "visual_tokens": spipe.site.visual_len, "group_rows": 2,
        "dispatch_segments": w, "steps": SCAN["full_steps"],
        "build_seconds": build_s, "stacking": stacking,
        "hold": scan_pair("full-depth Hunyuan", unrolled,
                          {"scan_windows": stacked}),
        "scan_windows": {"launches": stacked[1], **stacked[2],
                         "step_seconds": spipe.step_seconds},
        "unrolled": {"launches": unrolled[1], **unrolled[2],
                     "step_seconds": upipe.step_seconds}}
    runs.update(hunyuan_full_depth=stacked[1],
                hunyuan_full_depth_unrolled=unrolled[1])
    del spipe, upipe, model, stacked, unrolled
    torch.cuda.empty_cache()
    res["launches_by_run"] = runs
    return res


def tiny_flux_models(gen):
    """The small check's trunk (1 + 1 blocks, 2 heads of 128) and
    ControlNet (1 block, nudged), seeded on the host in fp32."""
    from rectified_spaattn_tpu_torch.models import (
        FluxConfig, FluxControlNet, FluxControlNetConfig, FluxDiT,
        init_controlnet_weights, init_random_weights)
    cfg = FluxConfig(hidden_dim=256, heads=2, num_dual_blocks=1,
                     num_single_blocks=1, text_dim=64, pooled_dim=32)
    cn_cfg = FluxControlNetConfig(hidden_dim=256, heads=2, num_dual_blocks=1,
                                  text_dim=64, pooled_dim=32)
    return (init_random_weights(FluxDiT(cfg), gen),
            init_controlnet_weights(FluxControlNet(cn_cfg), gen, nudge=0.02))


def tiny_image_vae(gen):
    """A seeded 2-D AutoencoderKL (16 latent channels, widths 32 / 64,
    stride 2, FLUX.1-dev's scaling and shift) on the host in fp32: (encoder,
    decoder)."""
    import torch.nn as nn
    from rectified_spaattn_tpu_torch.models import (VAEConfig, VAEDecoder,
                                                    VAEEncoder,
                                                    init_random_weights)
    cfg = VAEConfig(latent_channels=16, block_out_channels=(32, 64),
                    layers_per_block=1, temporal_upsample=(False, False),
                    spatial_upsample=(True, False), video=False,
                    mid_attention=True, scaling_factor=0.3611,
                    shift_factor=0.1159)
    out = []
    for cls in (VAEEncoder, VAEDecoder):
        m = init_random_weights(cls(cfg), gen)
        with torch.no_grad():
            for mod in m.modules():
                if isinstance(mod, nn.Conv2d):
                    mod.weight.normal_(0.0, mod.weight[0].numel() ** -0.5,
                                       generator=gen)
                    mod.bias.zero_()
        out.append(m.eval())
    return tuple(out)


def small_flux_check(pixels: bool) -> dict:
    """A small Flux upscale (base 128^2, up 512^2: 1,024 tokens in 8 blocks
    + 512 text slots, 9 valid; 2 sparse steps a stage, the gate (1, 2) so
    that the single block runs the windowed dense, group_rows 2) with a
    nudged ControlNet on the GPU in bf16 against the same weights on the
    CPU in fp32, the same noise; with ``pixels`` the control goes through
    a small 2-D VAE (fp32 on both) and the bicubic resize.  Held to the
    output's scale."""
    from rectified_spaattn_tpu_torch.models import FluxControlNet, FluxDiT
    from rectified_spaattn_tpu_torch.pipelines import (FluxPipeline,
                                                       FluxUpscalePipeline)

    gen = torch.Generator()
    gen.manual_seed(6)
    trunk, cn = tiny_flux_models(gen)
    enc, dec = tiny_image_vae(gen) if pixels else (None, None)
    text = torch.randn((1, 512, 64), generator=gen)
    mask = torch.zeros((1, 512), dtype=torch.bool)
    mask[:, :9] = True
    pooled = torch.randn((1, 32), generator=gen)
    base_init = torch.randn((1, 64, 64), generator=gen)
    up_noise = torch.randn((1, 1024, 64), generator=gen)
    kw = dict(num_steps=2, sa_drop_rate=0.5, group_rows=2,
              sparse_layer_gate=(1, 2))
    outs, seen = [], []
    for dev, dt in (("cpu", torch.float32), (DEV, torch.bfloat16)):
        t, c = FluxDiT(trunk.cfg), FluxControlNet(cn.cfg)
        t.load_state_dict(trunk.state_dict())
        c.load_state_dict(cn.state_dict())
        vae = {}
        if pixels:
            e, d = (m.to(dev) for m in (enc, dec))
            vae = dict(vae_encode=lambda px, e=e: (
                seen.append(tuple(px.shape)), e(px.to(dev)))[1],
                       vae_decode=lambda z, d=d: d(z.to(dev)))
        pipe = FluxUpscalePipeline(
            base=FluxPipeline(model=t.to(dt), height=128, width=128,
                              device=dev, **kw),
            up=FluxPipeline(model=t, height=512, width=512, device=dev,
                            **kw), controlnet=c.to(dt), **vae)
        with torch.no_grad():
            outs.append(pipe(text, mask, pooled, base_init=base_init,
                             up_noise=up_noise).cpu())
    want, got = outs
    res = held_to_scale(f"small Flux upscale{' (pixels)' if pixels else ''}"
                        " GPU vs CPU", got, want)
    if pixels:
        # base latents 16x16 -> 32x32 pixels, resized 4x, on both devices
        if seen != [(1, 3, 128, 128)] * 2:
            raise AssertionError(f"the pixel control encoded {seen}")
        res["encoded_pixels"] = list(seen[0])
    return res


def synth_flux_sd(cj: dict, gen, controlnet: bool = False) -> dict:
    """A diffusers FluxTransformer2DModel state dict for the config json
    ``cj`` (the key set of tests/manifests/flux_keys.json), or with
    ``controlnet`` a FluxControlNetModel's (flux_controlnet_keys.json: no
    head, controlnet_x_embedder and one projection per block)."""
    d = cj["num_attention_heads"] * cj["attention_head_dim"]
    hd, mlp_h = cj["attention_head_dim"], 4 * d
    sd = {}
    lin = lambda n, o, i: (_synth(sd, gen, n + ".weight", (o, i), "w"),
                           _synth(sd, gen, n + ".bias", (o,), "0"))
    rms = lambda n, c: _synth(sd, gen, n + ".weight", (c,), "ones")
    lin("x_embedder", d, cj["in_channels"])
    lin("context_embedder", d, cj["joint_attention_dim"])
    for emb, in_f in (("timestep_embedder", 256), ("guidance_embedder", 256),
                      ("text_embedder", cj["pooled_projection_dim"])):
        lin(f"time_text_embed.{emb}.linear_1", d, in_f)
        lin(f"time_text_embed.{emb}.linear_2", d, d)
    for i in range(cj["num_layers"]):
        b = f"transformer_blocks.{i}"
        lin(f"{b}.norm1.linear", 6 * d, d)
        lin(f"{b}.norm1_context.linear", 6 * d, d)
        for nm in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                   "add_v_proj", "to_out.0", "to_add_out"):
            lin(f"{b}.attn.{nm}", d, d)
        for nm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            rms(f"{b}.attn.{nm}", hd)
        for ff in ("ff", "ff_context"):
            lin(f"{b}.{ff}.net.0.proj", mlp_h, d)
            lin(f"{b}.{ff}.net.2", d, mlp_h)
        if controlnet:
            lin(f"controlnet_blocks.{i}", d, d)
    for i in range(cj["num_single_layers"]):
        b = f"single_transformer_blocks.{i}"
        lin(f"{b}.norm.linear", 3 * d, d)
        for nm in ("to_q", "to_k", "to_v"):
            lin(f"{b}.attn.{nm}", d, d)
        rms(f"{b}.attn.norm_q", hd)
        rms(f"{b}.attn.norm_k", hd)
        lin(f"{b}.proj_mlp", mlp_h, d)
        lin(f"{b}.proj_out", d, d + mlp_h)
        if controlnet:
            lin(f"controlnet_single_blocks.{i}", d, d)
    if controlnet:
        lin("controlnet_x_embedder", d, cj["in_channels"])
    else:
        lin("norm_out.linear", 2 * d, d)
        lin("proj_out", cj["in_channels"], d)
    return sd


def same_tensors(name: str, got: dict, want: dict) -> int:
    """Every tensor of a GPU load equal to the CPU load's, bit for bit;
    returns their count."""
    if set(got) != set(want) or any(
            got[k].dtype != t.dtype or not torch.equal(got[k].cpu(), t)
            for k, t in want.items()):
        raise AssertionError(f"the {name} GPU load differs from the CPU load")
    return len(want)


def ckpt_flux_leg(kernels, root: str, out_dir: str) -> dict:
    """The Flux checkpoint path: a seeded bf16 snapshot in diffusers' key
    layout (FLUX_CKPT: transformer/, controlnet/ and the 2-D vae/);
    load_transformer and load_flux_controlnet on the card held to CPU loads
    bit for bit; then the CLI's --model flux-upscale --ckpt_dir at
    1024^2 (base 256^2 and up 1024^2, 2 sparse steps each, the control
    through pixels) -- K1, K2 and K3 launched (counters zeroed just before,
    read just after) -- writing a [1024, 1024, 3] uint8 image.  The untiled
    2-D decode at 4096^2 is left out (ROADMAP)."""
    from rectified_spaattn_tpu_torch.cli.generate import main as cli_main
    from rectified_spaattn_tpu_torch.models.pretrained import (
        load_flux_controlnet, load_transformer, vae_config_from_json)

    c = FLUX_CKPT
    froot = os.path.join(root, "flux")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(14)
    res = {"snapshot_bytes": {
        "vae": write_snapshot(froot, "vae", synth_vae_sd(
            vae_config_from_json(c["vae"], video=False), gen), c["vae"]),
        "transformer": write_snapshot(froot, "transformer", synth_flux_sd(
            c["transformer"], gen), c["transformer"]),
        "controlnet": write_snapshot(froot, "controlnet", synth_flux_sd(
            c["controlnet"], gen, controlnet=True), c["controlnet"])}}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, model = load_transformer("flux", froot, device=DEV)
    _, cn = load_flux_controlnet(os.path.join(froot, "controlnet"),
                                 device=DEV)
    torch.cuda.synchronize()
    res["load_seconds"] = time.perf_counter() - t0
    _, ref = load_transformer("flux", froot, cache=False, device="cpu")
    _, cn_ref = load_flux_controlnet(os.path.join(froot, "controlnet"),
                                     device="cpu")
    res["tensors_equal_to_cpu_load"] = {
        "transformer": same_tensors("Flux transformer", model.state_dict(),
                                    ref.state_dict()),
        "controlnet": same_tensors("Flux ControlNet", cn.state_dict(),
                                   cn_ref.state_dict())}
    res["config"] = dataclasses.asdict(cfg)
    del model, cn, ref, cn_ref
    torch.cuda.empty_cache()
    argv = ["--model", "flux-upscale", "--ckpt_dir", froot, "--height",
            str(c["height"]), "--width", str(c["width"]), "--num_steps",
            str(c["steps"]), "--mode", "sparse", "--group_rows", "2",
            "--out_dir", out_dir, "--device", DEV]
    kerns = path_kernels(kernels)
    zero_launches(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    line = cli_main(argv)
    cli_s = time.perf_counter() - t0
    launches = {n: f.launches for n, f in kerns.items()}
    if min(launches["K1"], launches["K2"], launches["K3"]) == 0:
        raise AssertionError(f"unexpected launches on the Flux checkpoint "
                             f"path: {launches}")
    path = line["output"]
    image = (np.load(path) if path.endswith(".npy") else None)
    if image is None and path.endswith(".png"):
        from PIL import Image
        image = np.asarray(Image.open(path))
    want_shape = (c["height"], c["width"], 3)
    if image is None or image.dtype != np.uint8 \
            or image.shape != want_shape:
        raise AssertionError(f"the Flux CLI wrote {path}: "
                             f"{getattr(image, 'shape', None)}, want uint8 "
                             f"{want_shape}")
    res["cli"] = {"argv": argv, "line": line, "seconds": cli_s,
                  "launches": launches, "image": list(image.shape),
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    return res


# ------------------------------------------------------------ eval phases ---

# batch evaluation (eval/run_eval.py) on the ckpt phase's snapshots: the
# HunyuanVideo one at CKPT's widths (2 dual + 2 single blocks, its VAE) at
# 480x832, --frame 36, 2 steps, 3 prompts; the launcher's two ranks on the
# same snapshot at --frame 12 (eval_multihost_phase says why); Flux at
# FLUX_CKPT's (2 + 2 blocks, the 2-block ControlNet) at 1024^2, 2 prompts
EVAL_PROMPTS = ("several hot air balloons flying over a city.",
                "a red fox running through fresh snow, slow motion",
                "an old lighthouse on a cliff at dusk, waves below")
EVAL = dict(height=480, width=832, frame=36, steps=2, multihost_frame=12,
            flux_size=1024, pixels=(33, 480, 832, 3),
            flux_pixels=(1024, 1024, 3))


def write_prompts(root: str, n: int) -> str:
    path = os.path.join(root, f"eval_prompts_{n}.txt")
    with open(path, "w") as f:
        f.write("\n".join(EVAL_PROMPTS[:n]) + "\n")
    return path


class RunnerLog:
    """While active, every runner that run_eval.make_runner builds is
    wrapped: each call is timed (device-synced) and its kernel launches
    are counted apart, with the runner's mode ("sparse" or "flash"); the
    pipelines' final VAE decode (``decode_timed``, device-synced) is
    timed apart within the call, the rest being the text, the denoise and
    the copy to the host."""

    def __init__(self, run_eval, kernels):
        from rectified_spaattn_tpu_torch.pipelines import flux, hunyuan
        self.mod, self.make = run_eval, run_eval.make_runner
        self.pipes = [(m, m.decode_timed) for m in (hunyuan, flux)]
        self.kerns, self.calls, self.decodes = path_kernels(kernels), [], []

    def __enter__(self):
        def make(args):
            run, is_video = self.make(args)

            def logged(prompt, seed):
                before = {n: f.launches for n, f in self.kerns.items()}
                self.decodes.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run(prompt, seed)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                decode = sum(self.decodes)
                self.calls.append({
                    "mode": args.mode, "prompt": EVAL_PROMPTS.index(prompt),
                    "seconds": seconds, "decode_seconds": decode,
                    "rest_seconds": seconds - decode,
                    "launches": {n: f.launches - before[n]
                                 for n, f in self.kerns.items()}})
                return out
            logged.last_raw = run.last_raw
            return logged, is_video

        def timed_for(orig):
            def timed(vae_decode, latents):
                out, sec = orig(vae_decode, latents)
                if sec is not None:
                    self.decodes.append(sec)
                return out, sec
            return timed
        self.mod.make_runner = make
        for m, orig in self.pipes:
            m.decode_timed = timed_for(orig)
        return self

    def __exit__(self, *exc):
        self.mod.make_runner = self.make
        for m, orig in self.pipes:
            m.decode_timed = orig

    def by_mode(self) -> dict:
        out = {}
        for c in self.calls:
            m = out.setdefault(c["mode"], {"calls": 0, **{
                n: 0 for n in self.kerns}})
            m["calls"] += 1
            for n, k in c["launches"].items():
                m[n] += k
        return out


def run_eval_logged(kernels, argv) -> tuple:
    """run_eval.main(argv) in this process, at torch's default for cuDNN
    (TF32 convolutions in the VAE, as a user's run and the launcher's
    ranks have it): (written paths, scores, RunnerLog, launches, seconds,
    peak GB), the counters zeroed just before and read just after."""
    from rectified_spaattn_tpu_torch.eval import run_eval
    torch.backends.cudnn.allow_tf32 = True
    try:
        with RunnerLog(run_eval, kernels) as log:
            zero_launches(kernels)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            written, scores = run_eval.main(argv)
            seconds = time.perf_counter() - t0
            launches = {n: f.launches for n, f in log.kerns.items()}
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return (written, scores, log, launches, seconds,
            torch.cuda.max_memory_allocated() / 2**30)


def read_output(path: str):
    """A file run_eval wrote as an array (.npy, or .png through PIL)."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".png"):
        from PIL import Image
        return np.asarray(Image.open(path))
    return None


def check_diffs(name: str, scores: dict) -> dict:
    d = scores["diff_vs_dense"]
    if not all(np.isfinite(v) or k == "psnr" for k, v in d.items()) \
            or not 0.0 < d["cosine"] <= 1.0 + 1e-9:
        raise AssertionError(f"{name}: diff_vs_dense {d}")
    return d


def eval_hunyuan_phase(kernels, root: str) -> dict:
    """run_eval.main --model hunyuan --ckpt_dir <the ckpt phase's
    snapshot> --score in process, 3 prompts at 480x832x36, 2 sparse
    steps at G = 1 (run_eval has no --group_rows): the files written, the
    seconds per prompt (its decode apart) and the peak memory; K1's and
    the merge's and P1's launches by mode against the count the blocks,
    steps and prompts give (a sparse call: visual rows, split text rows
    and a plan per block and step, 3 calls, as the scoring reuses the run's outputs of
    its first 2 prompts; the dense rerun: one windowed dense K1 per block
    and step, 2 calls); diff_vs_dense finite with cosine in (0, 1]; each
    gated adapter's availability."""
    c = EVAL
    out_dir = os.path.join(root, "eval_hunyuan")
    argv = ["--model", "hunyuan", "--ckpt_dir", root, "--prompts",
            write_prompts(root, 3), "--height", str(c["height"]),
            "--width", str(c["width"]), "--frame", str(c["frame"]),
            "--num_steps", str(c["steps"]), "--score", "--out_dir", out_dir,
            "--device", DEV]
    written, scores, log, launches, seconds, peak = run_eval_logged(
        kernels, argv)
    frames = [read_output(p) for p in written]
    want_shape = c["pixels"]
    if len(written) != 3 or any(f is None or f.dtype != np.uint8
                                or f.shape != want_shape for f in frames):
        raise AssertionError(f"eval_hunyuan wrote {written}: "
                             f"{[getattr(f, 'shape', None) for f in frames]}"
                             f", want uint8 {want_shape}")
    blocks = (CKPT["transformer"]["num_layers"]
              + CKPT["transformer"]["num_single_layers"])
    per = blocks * c["steps"]
    modes = log.by_mode()
    want = {"sparse": {"calls": 3, "K1": 3 * 2 * per, "K1_merge": 3 * per,
                       "K2": 0, "K3": 0, "P1": 3 * per},
            "flash": {"calls": 2, "K1": 2 * per, "K1_merge": 0, "K2": 0,
                      "K3": 0, "P1": 0}}
    if modes != want or launches["K1"] != sum(m["K1"] for m in
                                              want.values()):
        raise AssertionError(f"eval_hunyuan launches {modes} (total "
                             f"{launches}), want {want}")
    gen = [x["seconds"] for x in log.calls[:3]]
    return {"argv": argv, "seconds": seconds,
            "files": [os.path.basename(p) for p in written],
            "extension": sorted({os.path.splitext(p)[1] for p in written}),
            "frames": list(want_shape), "seconds_per_prompt": gen,
            "mean_seconds_per_prompt": float(np.mean(gen)),
            "decode_seconds_per_prompt": [x["decode_seconds"]
                                          for x in log.calls[:3]],
            "peak_mem_gb": peak, "launches": launches,
            "launches_by_mode": modes, "expected_launches": want,
            "calls": log.calls,
            "diff_vs_dense": check_diffs("eval_hunyuan", scores),
            "live_metrics": scores["live_metrics"],
            "available": {k: scores[k]["available"]
                          for k in ("vbench", "vision_reward")}}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def eval_multihost_phase(root: str) -> dict:
    """The launcher (python -m ...parallel.multihost --coordinator_address
    127.0.0.1:<port> --num_processes 2 --process_id {0,1}) on this one
    card: two processes at tp 1, so gloo, each loading the snapshot, 3
    prompts without --score; rank 0 writes prompts 0 and 2, rank 1 prompt
    1, and each file equals byte for byte the file of the same name from
    a one-process run_eval.main (in this process) of the same arguments.
    At --frame 12 (9 decoded frames): at eval_hunyuan's --frame 36 each
    rank's untiled VAE decode peaks at ~47 GB (the ckpt phase's untiled
    decode of the same frames), and two at once do not fit one 80 GB
    card."""
    from rectified_spaattn_tpu_torch.eval import run_eval
    c = EVAL
    common = ["--model", "hunyuan", "--ckpt_dir", root, "--prompts",
              write_prompts(root, 3), "--height", str(c["height"]),
              "--width", str(c["width"]), "--frame",
              str(c["multihost_frame"]), "--num_steps", str(c["steps"])]
    one_dir, multi_dir = (os.path.join(root, "mh_one"),
                          os.path.join(root, "mh_multi"))
    torch.backends.cudnn.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        one, _ = run_eval.main(common + ["--device", DEV, "--out_dir",
                                         one_dir])
        one_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rectified_spaattn_tpu_torch.parallel"
         ".multihost", "--coordinator_address", f"127.0.0.1:{port}",
         "--num_processes", "2", "--process_id", str(i), *common,
         "--device", DEV, "--out_dir", multi_dir], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        logs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    multi_s = time.perf_counter() - t0
    ranks = []
    for i, (p, (out, err)) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"launcher rank {i} exited "
                                 f"{p.returncode}: {err[-3000:]}")
        ranks.append(json.loads(out.strip().splitlines()[-1]))
    names = [os.path.basename(p) for p in one]
    want = [[names[0], names[2]], [names[1]]]
    if [r["files"] for r in ranks] != want:
        raise AssertionError(f"the ranks wrote {ranks}, want {want}")
    equal, worst = {}, {}
    for name in names:
        with open(os.path.join(one_dir, name), "rb") as f, \
                open(os.path.join(multi_dir, name), "rb") as g:
            equal[name] = f.read() == g.read()
        if not equal[name]:
            a = read_output(os.path.join(one_dir, name))
            b = read_output(os.path.join(multi_dir, name))
            worst[name] = (None if a is None or a.shape != b.shape else int(
                np.abs(a.astype(np.int16) - b.astype(np.int16)).max()))
    res = {"argv": common, "one_process_seconds": one_s,
           "launcher_seconds": multi_s, "files": names, "ranks": ranks,
           "byte_equal": equal, "max_uint8_diff": worst}
    if not all(equal.values()):
        raise AssertionError(f"the launcher's files differ from the "
                             f"one-process run's: {res}")
    return res


def eval_flux_phase(kernels, root: str) -> dict:
    """run_eval.main --model flux-upscale --ckpt_dir <the ckpt phase's Flux
    snapshot> --controlnet_dir <its 2-block ControlNet> at 1024^2, 2 steps
    a stage, --score, 2 prompts: the image branch (dense_ref over every
    prompt, FID's gate, CLIPScore refused on pseudo-text); K1, K3 (the
    ControlNet), merge and P1 launches by mode against the count the
    blocks and steps give, K2 none (G = 1).  A sparse call (2, the scoring
    reusing the run's): visual and text rows and a plan per block, step
    and stage,
    the text rows split in the up stage only (the base stage's 256 + 512
    tokens make lists too short to split: _split_plan), K3 per ControlNet
    block and up step; a dense call (2 for the diffs, 2 for dense_ref):
    one windowed dense K1 per block, step and stage, the same K3."""
    froot = os.path.join(root, "flux")
    out_dir = os.path.join(root, "eval_flux")
    s = str(EVAL["flux_size"])
    argv = ["--model", "flux-upscale", "--ckpt_dir", froot,
            "--controlnet_dir", os.path.join(froot, "controlnet"),
            "--prompts", write_prompts(root, 2), "--height", s, "--width", s,
            "--num_steps", str(EVAL["steps"]), "--score", "--out_dir",
            out_dir, "--device", DEV]
    written, scores, log, launches, seconds, peak = run_eval_logged(
        kernels, argv)
    images = [read_output(p) for p in written]
    want_shape = EVAL["flux_pixels"]
    dense = sorted(os.listdir(os.path.join(out_dir, "dense_ref")))
    if len(written) != 2 or any(x is None or x.dtype != np.uint8
                                or x.shape != want_shape for x in images) \
            or dense != sorted(os.path.basename(p) for p in written):
        raise AssertionError(f"eval_flux wrote {written}: "
                             f"{[getattr(x, 'shape', None) for x in images]}"
                             f", want uint8 {want_shape}; dense_ref {dense}")
    tcfg = FLUX_CKPT["transformer"]
    per = (tcfg["num_layers"] + tcfg["num_single_layers"]) * EVAL["steps"]
    k3 = FLUX_CKPT["controlnet"]["num_layers"] * EVAL["steps"]
    want = {"sparse": {"calls": 2, "K1": 2 * (2 * 2 * per),
                       "K1_merge": 2 * per, "K2": 0, "K3": 2 * k3,
                       "P1": 2 * (2 * per)},
            "flash": {"calls": 4, "K1": 4 * (2 * per), "K1_merge": 0,
                      "K2": 0, "K3": 4 * k3, "P1": 0}}
    modes = log.by_mode()
    if modes != want or any(launches[n] != sum(m[n] for m in want.values())
                            for n in ("K1", "K1_merge", "K2", "K3", "P1")):
        raise AssertionError(f"eval_flux launches {modes} (total "
                             f"{launches}), want {want}")
    fid, clip = scores["fid"], scores["clip_score"]
    if fid["samples"] != {"sparse": 2, "dense": 2} \
            or "hash" not in clip["status"]:
        raise AssertionError(f"eval_flux scores {scores}")
    gen = [x["seconds"] for x in log.calls[:2]]
    return {"argv": argv, "seconds": seconds,
            "files": [os.path.basename(p) for p in written],
            "extension": sorted({os.path.splitext(p)[1] for p in written}),
            "dense_ref": dense, "image": list(want_shape),
            "seconds_per_prompt": gen,
            "mean_seconds_per_prompt": float(np.mean(gen)),
            "decode_seconds_per_prompt": [x["decode_seconds"]
                                          for x in log.calls[:2]],
            "peak_mem_gb": peak, "launches": launches,
            "launches_by_mode": modes, "expected_launches": want,
            "calls": log.calls,
            "diff_vs_dense": check_diffs("eval_flux", scores),
            "live_metrics": scores["live_metrics"],
            "available": {k: scores[k]["available"]
                          for k in ("vbench", "vision_reward", "clip_score",
                                    "fid")},
            "fid": fid}


# ------------------------------------------------------------- Wan phases ---

def plain_dense(kernels, q, k, v, heads: int = 8, rows=None):
    """K3's plain version over chunks of heads (its fp32 scores at the
    T2V cross shape would take 6 GB per 40 heads) and, with ``rows``, of
    query rows (every row is its own softmax)."""
    out = torch.empty_like(q)
    rows = rows or q.shape[2]
    for h0 in range(0, q.shape[1], heads):
        hs = slice(h0, h0 + heads)
        for r0 in range(0, q.shape[2], rows):
            rs = slice(r0, r0 + rows)
            out[:, hs, rs] = kernels.flash._vanilla_attention(
                q[:, hs, rs], k[:, hs], v[:, hs])
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


def record_plan_counts():
    """Keep every plan the rectified site builds (one per sparse-layer
    call) as (its per-row counts, its key-block count), by wrapping the
    plan builder where the site looks it up: no device work inside the
    run; ``plan_densities`` turns them into densities afterwards.  Returns
    (list, restore)."""
    from rectified_spaattn_tpu_torch.attention import rectified
    orig, got = rectified.build_sparse_plan, []

    def recorded(*a, **kw):
        plan = orig(*a, **kw)
        got.append((plan.counts, plan.block_mask.shape[-1]))
        return plan

    rectified.build_sparse_plan = recorded
    return got, lambda: setattr(rectified, "build_sparse_plan", orig)


def plan_densities(plans) -> torch.Tensor:
    """The executed density of each recorded plan, by the site's own
    formula (rectified.plan_density, which density_only returns)."""
    from rectified_spaattn_tpu_torch.attention.rectified import plan_density
    return torch.stack([plan_density(c, nb) for c, nb in plans]).cpu()


def wan_full_model():
    """WanConfig() cut to WAN_PIPE's depth, seeded bf16 weights."""
    from rectified_spaattn_tpu_torch.models import (
        WanConfig, WanDiT, init_random_weights)

    dev = torch.device(DEV)
    with torch.device(dev):
        model = WanDiT(WanConfig(**WAN_PIPE["cfg"]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return init_random_weights(model.to(torch.bfloat16), gen)


def wan_full_pipe(model, **pipe_kw):
    """The WanPipeline of WAN_PIPE over ``model`` and its cond / uncond
    text; ``pipe_kw`` adds pipeline options."""
    from rectified_spaattn_tpu_torch.cli.generate import _random_text
    from rectified_spaattn_tpu_torch.pipelines import WanPipeline

    dev = torch.device(DEV)
    pipe = WanPipeline(
        model=model, height=WAN_PIPE["height"], width=WAN_PIPE["width"],
        frames=WAN_PIPE["frames"], num_steps=WAN_PIPE["steps"],
        sa_drop_rate=0.75, p_remain_rates=0.3, mode="sparse",
        enable_teacache=True, teacache_thresh=0.2,
        warm_layers=WAN_PIPE["warm_layers"],
        warm_calls=WAN_PIPE["warm_calls"], group_rows=1, device=dev,
        **pipe_kw)
    text, _ = _random_text("several hot air balloons flying over a city.",
                           512, model.cfg.text_dim, device=dev)
    neg, _ = _random_text("", 512, model.cfg.text_dim, device=dev)
    return pipe, text, neg


def wan_pipeline_phase(kernels):
    """WanPipeline at full width (WanConfig()) cut to 4 blocks,
    720x1280x81, 3 UniPC steps under CFG, TeaCache on, seeded bf16 random
    weights; the launch counters (and the sparse plans built) are zeroed
    just before the run and read just after.  Returns (result, latents)."""
    dev = torch.device(DEV)
    pipe, text, neg = wan_full_pipe(wan_full_model())
    cfg = pipe.model.cfg
    noise = torch.Generator(device=dev)
    noise.manual_seed(42)
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 2**30
    kerns = path_kernels(kernels)
    plans, restore = record_plan_counts()
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
            "K3": cfg.num_blocks * computed, "K1_merge": 0,
            "P1": want_plans}
    if launches != want or len(plans) != want_plans or want_plans == 0:
        raise AssertionError(f"Wan launches {launches} (want {want}), "
                             f"sparse plans {len(plans)} (want {want_plans} "
                             "> 0)")
    res = {"launches": launches, "sparse_plans": len(plans),
           "step_seconds": pipe.step_seconds,
           "denoise_seconds": pipe.denoise_seconds,
           "teacache": pipe.teacache_stats, "teacache_decisions": decisions,
           "visual_tokens": pipe.site.visual_len, "pad": pipe.pad,
           "launches_per_computed_call": {
               n: c / computed for n, c in launches.items()},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "start_gb": start_gb}
    # one more step, both CFG calls computed and sparse past the warm
    # layers, under the profiler
    pipe.warm_calls = 0
    res["profiled_sparse_step"] = profile_step(pipe, text, neg)
    return res, out.cpu()


def tree_bytes(model) -> int:
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values())


def device_tree_bytes(*models) -> int:
    """Bytes of the models' parameters and buffers held on the card."""
    return sum(t.numel() * t.element_size() for m in models
               for t in m.state_dict().values() if t.is_cuda)


def wan22_a14b_phase(kernels):
    """Wan2.2 I2V-A14B: two WanConfig(in_channels=36) transformers at full
    width, 6 blocks each (2 warm, 2 sparse, 2 last-warm), different seeds;
    720x1280x81, 4 Euler steps at shift 5 over boundary 0.875 (2 high, 2
    low), CFG, TeaCache on, the condition of i2v_condition from the CLI's
    stand-in encoder on a seeded image.  First both trees co-resident;
    then the same run with host_swap (both trees pinned on the host, one
    on the card at a time), its launch counters and sparse plans zeroed
    just before and read just after, its output held to the co-resident
    one bit for bit and its device weight bytes, read after every swap, to
    one tree's."""
    from rectified_spaattn_tpu_torch.cli.generate import (
        _demo_vae_encoder, _random_text)
    from rectified_spaattn_tpu_torch.models import (
        WanConfig, WanDiT, init_random_weights)
    from rectified_spaattn_tpu_torch.pipelines import (
        Wan22A14BPipeline, WanPipeline, i2v_condition)

    dev = torch.device(DEV)
    cfg = WanConfig(**A14B["cfg"])
    models = []
    for seed in (0, 1):
        with torch.device(dev):
            m = WanDiT(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        models.append(init_random_weights(m.to(torch.bfloat16), gen))
    one_tree = tree_bytes(models[0])
    block_bytes = tree_bytes(models[0].blocks[0])
    text, _ = _random_text("several hot air balloons flying over a city.",
                           512, cfg.text_dim, device=dev)
    neg, _ = _random_text("", 512, cfg.text_dim, device=dev)
    kw = dict(height=A14B["height"], width=A14B["width"],
              frames=A14B["frames"], num_steps=A14B["steps"],
              sa_drop_rate=0.85, p_remain_rates=0.3, mode="sparse",
              enable_teacache=True, teacache_thresh=0.3,
              warm_layers=A14B["warm_layers"],
              warm_last_layers=A14B["warm_last_layers"], scheduler="euler",
              is_i2v=True, group_rows=1, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    image = torch.rand((1, 3, A14B["height"], A14B["width"]), generator=gen,
                       device=dev) * 2 - 1
    hi = WanPipeline(model=models[0], **kw)
    lo = WanPipeline(model=models[1], **kw)
    t0 = time.perf_counter()
    enc = _demo_vae_encoder(cfg.out_channels, hi.grid, dev)
    cond = i2v_condition(image, A14B["frames"], enc, lt=hi.grid[0])
    torch.cuda.synchronize()
    cond_s = time.perf_counter() - t0
    del enc, image
    init = torch.randn((1, cfg.out_channels, *hi.grid), generator=gen,
                       device=dev)
    kerns = path_kernels(kernels)

    def run(pipe):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        plans, restore = record_plan_counts()
        try:
            for f in kerns.values():
                f.launches = 0
            out = pipe(text, neg, condition=cond, init_latents=init)
            launches = {n: f.launches for n, f in kerns.items()}
        finally:
            restore()
        torch.cuda.synchronize()
        return out, {"launches": launches, "sparse_plans": len(plans),
                     "step_seconds": pipe.step_seconds,
                     "denoise_seconds": pipe.denoise_seconds,
                     "teacache": pipe.teacache_stats,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}

    co = Wan22A14BPipeline(high=hi, low=lo,
                           boundary_ratio=A14B["boundary_ratio"])
    out_co, res_co = run(co)
    # the setup of the host_swap run: both trees copied to the host once
    for m in models:
        m.to("cpu")
    del co, hi, lo
    hi = WanPipeline(model=models[0], defer_device=True, **kw)
    lo = WanPipeline(model=models[1], defer_device=True, **kw)
    sw = Wan22A14BPipeline(high=hi, low=lo,
                           boundary_ratio=A14B["boundary_ratio"],
                           host_swap=True)
    held, alloc, peaks, swap_in = [], [], [], sw._swap_in

    def swap_and_read(*a):
        # the peak up to this swap (the load, or the high-noise steps)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.reset_peak_memory_stats()
        sec = swap_in(*a)
        held.append(device_tree_bytes(hi.model, lo.model))
        alloc.append(torch.cuda.memory_allocated())
        return sec

    def swapped_run(pipe):
        out, res = run(pipe)
        res["peak_by_segment_gb"] = [*peaks, res["peak_mem_gb"]]
        res["peak_mem_gb"] = max(res["peak_by_segment_gb"])
        res["allocated_gb_after_swaps"] = [b / 2**30 for b in alloc]
        return out, res

    sw._swap_in = swap_and_read
    out, res = swapped_run(sw)
    tea = sw.teacache
    calls = {n: len(tea[n].decisions) for n in ("high", "low")}
    computed = sum(sum(tea[n].decisions) for n in ("high", "low"))
    n = cfg.num_blocks
    sparse_blocks = n - A14B["warm_layers"] - A14B["warm_last_layers"]
    # per computed call: K1 in every block (windowed dense or sparse), K3
    # the text cross of every block (no CLIP image branch on A14B); Wan's
    # visual rows fill the card, so nothing splits
    want = {"K1": n * computed, "K2": 0, "K3": n * computed, "K1_merge": 0,
            "P1": sparse_blocks * computed}
    if (res["launches"] != want or res_co["launches"] != want
            or res["sparse_plans"] != sparse_blocks * computed
            or res_co["sparse_plans"] != res["sparse_plans"]):
        raise AssertionError(f"A14B launches {res['launches']} / "
                             f"{res_co['launches']} (want {want}), sparse "
                             f"plans {res['sparse_plans']} / "
                             f"{res_co['sparse_plans']} (want "
                             f"{sparse_blocks * computed})")
    if calls != {"high": 4, "low": 4} or sw.swap_seconds <= 0:
        raise AssertionError(f"A14B routing: calls {calls}, swap "
                             f"{sw.swap_seconds}")
    if out.shape != (1, cfg.out_channels, *sw.high.grid) \
            or not torch.isfinite(out).all():
        raise AssertionError("A14B output is not finite of its shape")
    if not torch.equal(out, out_co):
        raise AssertionError(
            f"host_swap differs from the co-resident run: "
            f"{held_to_scale('A14B host_swap', out, out_co)}")
    if max(held) > 1.05 * one_tree:
        raise AssertionError(f"device weight bytes {held} above one tree "
                             f"({one_tree}) + 5 %")
    # the same swap on stacked trees (scan_blocks, dispatch_segments=2):
    # the trees back on the host from the pinned copies, each
    # stacked there; the tree swapped is the stacked one
    for pipe, tree in ((hi, sw._host[0]), (lo, sw._host[1])):
        pipe.model.to("meta")
        pipe.model.load_state_dict(tree, assign=True)
    # the first swap run's TeaCache state (its residuals on the card) goes
    load_s, swap_s = sw.load_seconds, sw.swap_seconds
    del sw, tea
    skw = dict(kw, scan_blocks=True, dispatch_segments=2)
    sws = Wan22A14BPipeline(
        high=WanPipeline(model=hi.model, defer_device=True, **skw),
        low=WanPipeline(model=lo.model, defer_device=True, **skw),
        boundary_ratio=A14B["boundary_ratio"], host_swap=True)
    hi, lo = sws.high, sws.low
    held_co, held, swap_in = held, [], sws._swap_in
    alloc.clear()
    peaks.clear()
    sws._swap_in = swap_and_read
    out_s, res_s = swapped_run(sws)
    swapped = [sum(t.numel() * t.element_size() for t in tree.values())
               for tree in sws._host]
    if res_s["launches"] != want or not torch.equal(out_s, out_co) \
            or swapped != [one_tree] * 2 or max(held) > 1.05 * one_tree \
            or res_s["peak_mem_gb"] > 1.05 * res["peak_mem_gb"]:
        raise AssertionError(
            f"A14B stacked host_swap: launches {res_s['launches']}, "
            f"equal {torch.equal(out_s, out_co)}, trees {swapped} (one "
            f"tree {one_tree}), device bytes {held}, peak by segment "
            f"{res_s['peak_by_segment_gb']} against "
            f"{res['peak_by_segment_gb']} GB, allocated after swaps "
            f"{res_s['allocated_gb_after_swaps']} against "
            f"{res['allocated_gb_after_swaps']} GB")
    res["scan_blocks_host_swap"] = dict(
        res_s, equal_to_co_resident=True, dispatch_segments=2,
        swapped_tree_gb=[b / 1e9 for b in swapped],
        device_weight_gb_after_swaps=[b / 1e9 for b in held],
        swap_seconds=sws.swap_seconds, load_seconds=sws.load_seconds,
        s_per_step=float(np.mean(res_s["step_seconds"])))
    gbps = lambda nbytes, sec: nbytes / sec / 1e9
    base = one_tree - n * block_bytes
    full = base + 40 * block_bytes
    rate = gbps(one_tree, swap_s)
    res.update(
        co_resident=res_co, calls=calls, computed_calls=computed,
        equal_to_co_resident=True, condition_seconds=cond_s,
        condition_shape=list(cond.shape), tree_gb=one_tree / 1e9,
        device_weight_gb_after_swaps=[b / 1e9 for b in held_co],
        load_seconds=load_s, swap_seconds=swap_s,
        load_gbps=gbps(one_tree, load_s), swap_gbps=rate,
        tree_gb_40_blocks=full / 1e9,
        swap_seconds_40_blocks_at_this_rate=full / 1e9 / rate,
        s_per_step=float(np.mean(res["step_seconds"])),
        co_resident_s_per_step=float(np.mean(res_co["step_seconds"])))
    del sws, hi, lo, models
    torch.cuda.empty_cache()
    return res


def small_wan_pipeline_check(dtype=torch.bfloat16):
    """A small sparse Wan pipeline (head_dim 128, 360 tokens padded to 384)
    on the GPU in bf16 (or ``dtype``: fp32, held to PIPE_F32) against the
    same weights on the CPU in fp32."""
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
    gpu = gpu.to(dtype)
    text = torch.randn((1, 32, cfg.text_dim), generator=gen)
    neg = torch.zeros_like(text)
    kw = dict(height=192, width=240, frames=5, num_steps=3, sa_drop_rate=0.5,
              p_remain_rates=0.5, warm_layers=1, warm_calls=0)
    p_cpu = WanPipeline(model=ref, device="cpu", **kw)
    init = torch.randn((1, cfg.in_channels, *p_cpu.grid), generator=gen)
    want = p_cpu(text, neg, init_latents=init)
    got = WanPipeline(model=gpu, device=DEV, **kw)(
        text, neg, init_latents=init).cpu()
    if dtype == torch.float32:
        return held_f32("small Wan pipeline fp32 GPU vs CPU", got, want)
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

def joint_jobs(name: str, csites: dict, model: str = "cog") -> dict:
    """The kernel's jobs at a joint site (both regimes) for the kernels
    line: the CogVideoX site's at head_dim 64 (``model`` "cog") or Flux's
    4096^2 site's ("flux")."""
    jobs = {"K1": ("visual_rows_g1", "text_rows", "dense_bm1024"),
            "K2": ("visual_g2",), "K1_merge": ("merge",)}[name]
    out = {}
    for regime, kern in csites.items():
        for job in jobs:
            key = {"visual_rows_g1": "K1_visual_g1",
                   "text_rows": "K1_text_rows",
                   "dense_bm1024": "K1_dense_bm1024",
                   "visual_g2": "K2_visual_g2",
                   "merge": "K1_merge"}[job]
            label = "cogvideox_d64" if model == "cog" else model
            out[f"{label}_{job}_{regime}"] = kern[f"{model}_{key}"]
    return out


# -------------------------------------------------------------------- e2e ---

def e2e_leg(kernels, name: str, run, used: tuple, unused: tuple = ()):
    """One leg: ``run(latents_out)`` with the launch counters zeroed just
    before and read just after, and every plan it built kept (its counts);
    raises unless each kernel of ``used`` launched, none of ``unused``
    did, and every latent is finite.  The plans' densities are taken after
    the leg.  Returns (the bench's line, the leg's fields)."""
    latents = {}
    plans, restore = record_plan_counts()
    try:
        line, launches, mem = counted_run(kernels, lambda: run(latents))
    finally:
        restore()
    if any(launches[n] == 0 for n in used) or any(launches[n]
                                                  for n in unused):
        raise AssertionError(f"{name}: launches {launches}, want {used} > 0 "
                             f"and {unused} = 0")
    for mode, lat in latents.items():
        if not torch.isfinite(lat).all():
            raise AssertionError(f"{name}: {mode} latents not finite")
    d = plan_densities(plans) if plans else None
    return line, {
        "launches": launches, **mem,
        "latents": {m: list(lat.shape) for m, lat in latents.items()},
        "plan_density": None if d is None else {
            "mean": float(d.mean()), "min": float(d.min()),
            "max": float(d.max()), "plans": len(plans)}}


def finite_times(name: str, line: dict) -> None:
    """Every mode's s/step finite and positive, and the ratio where both
    modes ran."""
    times = [m["s_per_step"] for m in line["modes"].values()]
    if "speedup" in line:
        times.append(line["speedup"])
    if not times or not all(0 < t < float("inf") for t in times):
        raise AssertionError(f"{name}: times {line['modes']}")


# the sparse site against the windowed dense, far above the readings
# (rel-L1 2.4-2.7e-5, cosine 0.9999992-0.9999994 at 115k tokens)
FIDELITY_LIMITS = dict(rel_l1=1e-3, cosine=0.9999)


def fidelity_check(name: str, lines) -> None:
    for g in lines:
        if not (g["cosine"] > FIDELITY_LIMITS["cosine"]
                and g["rel_l1"] < FIDELITY_LIMITS["rel_l1"]
                and 0 < g["density"] <= 1):
            raise AssertionError(f"{name}: beyond {FIDELITY_LIMITS}: {g}")


def held_on_path(kernels, heads: int = 2, extra=()):
    """Hold the site's kernels to their plain versions on the main path's
    own calls: K1 and K2 wrapped where the rectified site looks them up,
    K1 where the windowed dense does, and each (module, name, kind,
    role) of ``extra`` (a bench's own K1 or K3 call).  The first call of
    each role (K1's visual rows, K1's text rows, which split their keys
    and merge them with the merge kernel, K2, the windowed dense at each
    block_m, the extra roles) has its output on the first and the last
    ``heads`` // 2 heads (the last lie farthest into K and V) held, right
    after the call, against the plain version on those heads of the same
    inputs, to the site phases' limits.  The plain versions launch no
    kernel; in a bench that times after one warm-up call, the checks fall
    in the warm-up.  Returns (results by role, restore)."""
    from rectified_spaattn_tpu_torch.attention import modes, rectified

    res = {}
    merge = kernels.block_sparse.merge_splits
    plain = {"K1": kernels.block_sparse_flash_attention_torch,
             "K2": kernels.block_sparse_flash_attention_grouped_torch,
             # K3's in chunks of one head x 8,192 rows (a 115k-key row
             # block's fp32 scores: 3.8 GB)
             "K3": lambda q, k, v, **kw: plain_dense(kernels, q, k, v,
                                                     heads=1, rows=8192)}

    def wrap(orig, kind, role_of):
        def call(*args, **kw):
            role = role_of(args[0], kw)
            if role in res:
                return orig(*args, **kw)
            merges = merge.launches
            out = orig(*args, **kw)
            h = args[0].shape[1]
            hs = torch.tensor(sorted({*range(heads // 2),
                                      *range(h - heads // 2, h)}),
                              device=args[0].device)
            cut = lambda t: (t.index_select(1, hs) if torch.is_tensor(t)
                             and t.dim() >= 3 and t.shape[1] == h else t)
            t0 = time.perf_counter()
            want = plain[kind](*map(cut, args),
                               **{k: cut(x) for k, x in kw.items()})
            torch.cuda.synchronize()
            r = {"heads": hs.tolist(), "q_shape": list(args[0].shape),
                 "plain_ms": (time.perf_counter() - t0) * 1e3,
                 **held_to_scale(f"{role} on the path", cut(out), want)}
            if role == "K1_text_rows":
                r["merge_launches"] = merge.launches - merges
                if not r["merge_launches"]:
                    raise AssertionError("the text rows did not split and "
                                         "merge their keys")
            res[role] = r
            return out
        return call

    visual_or_text = lambda q, kw: ("K1_text_rows"
                                    if q.shape[2] < kw["visual_len"]
                                    else "K1_visual_g1")
    saved = [(rectified, "block_sparse_flash_attention", "K1",
              visual_or_text),
             (rectified, "block_sparse_flash_attention_grouped", "K2",
              lambda q, kw: "K2_visual_g2"),
             (modes, "block_sparse_flash_attention", "K1",
              lambda q, kw: f"K1_dense_bm{kw['block_m']}"),
             *((mod, n, kind, lambda q, kw, role=role: role)
               for mod, n, kind, role in extra)]
    origs = [getattr(mod, n) for mod, n, _, _ in saved]
    for (mod, n, kind, role_of), orig in zip(saved, origs):
        setattr(mod, n, wrap(orig, kind, role_of))

    def restore():
        for (mod, n, _, _), orig in zip(saved, origs):
            setattr(mod, n, orig)
    return res, restore


def e2e_phase(kernels):
    """Phase 15 (module docstring): one JSON line a leg; returns each leg's
    launches for the kernels line."""
    from rectified_spaattn_tpu_torch.bench import (
        ab_eval, e2e, e2e_cog, e2e_flux, e2e_wan, fidelity_gate, longctx)

    smi = smi_line()
    launches = {}

    def leg(name, run, used, unused=(), check=None):
        t0 = time.perf_counter()
        line, fields = e2e_leg(kernels, name, run, used, unused)
        if check is not None:
            check(name, line)
        launches[name] = fields["launches"]
        emit(name, t0, nvidia_smi=smi, line=line, **fields)
        torch.cuda.empty_cache()

    drive = lambda mod, kw: lambda lat: mod.run(latents_out=lat, **kw)
    leg("e2e_hunyuan", drive(e2e, E2E["hunyuan"]), ("K1", "K1_merge"),
        ("K2", "K3"), finite_times)
    leg("e2e_wan", drive(e2e_wan, E2E["wan"]), ("K1", "K3"), ("K2",),
        finite_times)
    # the complete model: its weights are drawn leaf by leaf onto the card
    # inside the leg, as the bench does (one numpy normal a leaf)
    leg("e2e_cog", drive(e2e_cog, E2E["cog"]), ("K1", "K1_merge"),
        ("K2", "K3"), finite_times)
    leg("e2e_flux", drive(e2e_flux, E2E["flux"]), ("K1", "K1_merge"),
        ("K2", "K3"), finite_times)

    def fidelity(lat):
        return [fidelity_gate.run(**kw) for kw in E2E["fidelity"]]

    leg("fidelity", fidelity, ("K1", "K1_merge"), ("K2", "K3"),
        fidelity_check)

    def long_points(lat):
        held, restore = held_on_path(kernels)
        try:
            points = [p for kw in E2E["longctx"] for p in longctx.run(**kw)]
        finally:
            restore()
        if sorted(held) != sorted(LONGCTX_HELD):
            raise AssertionError(f"longctx: held {sorted(held)}, want "
                                 f"{sorted(LONGCTX_HELD)}")
        # the sparse site against the windowed dense at this point (the
        # longctx points' inputs: the same site, seed and smooth q / k / v)
        gate = fidelity_gate.run(frames=E2E["longctx"][0]["frames"])
        return {"points": points, "held_to_plain": held, "fidelity": gate}

    def long_check(name, line):
        for p in line["points"]:
            ms = [p[k] for k in ("sparse_ms", "dense_ms") if k in p]
            if not all(0 < t < float("inf") for t in ms) \
                    or not 0 < p["density"] <= 1:
                raise AssertionError(f"{name}: {p}")
        fidelity_check(name, [line["fidelity"]])

    leg("longctx", long_points, ("K1", "K2", "K1_merge"), ("K3",),
        long_check)

    def ab_check(name, line):
        keys = ("ssim", "psnr", "cosine", "relative_l1", "rmse",
                "dense_seconds", "sparse_seconds")
        if not all(line[k] == line[k] for k in keys):
            raise AssertionError(f"{name}: {line}")

    leg("ab_eval", drive(ab_eval, E2E["ab_eval"]), ("K1",), ("K2", "K3"),
        ab_check)
    return {"cut": E2E["cut"], "launches": launches}


# ------------------------------------------------------------------- diag ---

# the diag phase: the diagnostic benches of bench/ (ports of the last
# scripts of scripts/) at their defaults; planstages also at the CogVideoX
# site (COG_SITE: 24,480 visual tokens padded to 192 blocks, 226 of 256
# text tokens valid); grouped once more with K1q ("int8") at G = 1 and a
# chunk_blocks 16 run
DIAG_COG = ["--grid", ",".join(map(str, COG_SITE["grid"])),
            "--heads", str(COG_SITE["heads"]),
            "--head_dim", str(COG_SITE["head_dim"]),
            "--drop", str(COG_SITE["sa_drop_rate"]),
            "--tlen", str(COG_SITE["tlen"])]
DIAG_K1Q = dict(groups=(1,), kv_quant="int8", chunks=(16,))
# the bench calls held to their plain versions: kernel's K1, dense's K3
# and its windowed dense at each block_m
DIAG_HELD = ("K1_kernel", "K3_dense", "K1_dense_bm256", "K1_dense_bm512",
             "K1_dense_bm1024")
NO_KERNEL = ("K1", "K2", "K3", "K1q_int8", "K1q_mxu8", "K1_merge")


def within_scale(name: str, errs: dict) -> None:
    """Each rel_err entry within REL_MAX / REL_RMS of its reference."""
    for run, r in errs.items():
        if not (r["max_abs_err"] <= REL_MAX * r["ref_max_abs"]
                and r["rms_err"] <= REL_RMS * r["ref_std"]):
            raise AssertionError(f"{name} {run}: beyond {REL_MAX} x max "
                                 f"|ref| or {REL_RMS} x std(ref): {r}")


def planstages_child(argv) -> dict:
    """bench.planstages' line from a process of its own: the profiler
    traces of this long process lose device records late in the run
    (stages traced with no kernel; kernelvars' nulls), a fresh process's
    hold them all.  The plan launches no attention kernel."""
    out = subprocess.run(
        [sys.executable, "-m", "rectified_spaattn_tpu_torch.bench.planstages",
         *argv], cwd=ROOT, stdout=subprocess.PIPE, text=True, check=True,
        timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def check_planstages(name, line):
    if not (all(line["staged_equals_plan"].values())
            and line["int16_sort_equals_indices"]):
        raise AssertionError(f"{name}: the stages do not recompose "
                             f"build_sparse_plan: {line}")
    if not all(r["kernels"] and r["kernel_ms"] for r in line["stages"]):
        raise AssertionError(f"{name}: a stage's trace holds no kernel: "
                             f"{line['stages']}")


def check_planopts(name, line):
    t, m = line["topp"], line["mask2idx"]
    if not (t["a_equals_c"] and t["counts_equal"]
            and m["sort_equals_scatter"] and m["sort_equals_int16"]):
        raise AssertionError(f"{name}: {t} {m}")


def check_grouped(name, line):
    """Every G and chunk run but the first against the first."""
    if len(line["err_vs_g1"]) != len(line["groups"]) \
            + len(line.get("chunks", {})) - 1:
        raise AssertionError(f"{name}: {line['err_vs_g1']}")
    within_scale(name, line["err_vs_g1"])


def check_groupfull(name, line):
    rel = {k: r for k, r in line.items() if k.endswith("_rel")}
    if not rel:
        raise AssertionError(f"{name}: no run against G = 1: {line}")
    within_scale(name, rel)


def check_runstats(name, line):
    for regime in ("peaked", "random"):
        share = sum(line[regime]["run_size_share"].values())
        if abs(share - 1.0) > 1e-9:
            raise AssertionError(f"{name} {regime}: histogram shares sum "
                                 f"to {share}")


def diag_phase(kernels):
    """Phase 16 (module docstring): one JSON line a leg, each with its
    launch counters (K1q's too) zeroed just before and read just after;
    returns each leg's launches and the held calls."""
    from rectified_spaattn_tpu_torch.bench import (
        ab_randreg, coalesce, dense, fullpath, groupfull, grouped, kernel,
        planopts, runstats)

    smi = smi_line()
    launches = {}

    def leg(name, run, used, unused=(), check=None):
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_launches(kernels)
        line = run()
        torch.cuda.synchronize()
        counts = quant_launches(kernels)
        if any(counts[n] == 0 for n in used) or any(counts[n]
                                                    for n in unused):
            raise AssertionError(f"{name}: launches {counts}, want {used} "
                                 f"> 0 and {unused} = 0")
        if check is not None:
            check(name, line)
        launches[name] = counts
        emit(name, t0, nvidia_smi=smi, line=line, launches=counts,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.empty_cache()

    leg("diag_planstages_hunyuan", lambda: planstages_child([]), (), (),
        check_planstages)
    leg("diag_planstages_cogvideox", lambda: planstages_child(DIAG_COG), (),
        (), check_planstages)
    leg("diag_planopts", lambda: planopts.run(), (), NO_KERNEL,
        check_planopts)
    leg("diag_runstats", lambda: runstats.run(), (), NO_KERNEL,
        check_runstats)
    leg("diag_grouped", lambda: grouped.run(), ("K1", "K2", "K1_merge"),
        ("K3", "K1q_int8", "K1q_mxu8"), check_grouped)
    leg("diag_grouped_k1q", lambda: grouped.run(**DIAG_K1Q),
        ("K1q_int8", "K1"), ("K2", "K3", "K1q_mxu8"), check_grouped)
    leg("diag_groupfull", lambda: groupfull.run(), ("K1", "K2", "K1_merge"),
        ("K3",), check_groupfull)
    leg("diag_coalesce", lambda: coalesce.run(), ("K1", "K1_merge"),
        ("K2", "K3"))
    held, restore = held_on_path(kernels, extra=(
        (kernel, "block_sparse_flash_attention", "K1", "K1_kernel"),
        (dense, "dense_attention", "K3", "K3_dense")))
    try:
        leg("diag_dense", lambda: dense.run(), ("K1", "K3"), ("K2",))
        leg("diag_kernel", lambda: kernel.run(), ("K1", "K3"), ("K2",))
    finally:
        restore()
    if sorted(held) != sorted(DIAG_HELD):
        raise AssertionError(f"diag: held {sorted(held)}, want "
                             f"{sorted(DIAG_HELD)}")
    leg("diag_fullpath", lambda: fullpath.run(), ("K1", "K1_merge"),
        ("K2", "K3"))
    leg("diag_ab_randreg", lambda: ab_randreg.run(), ("K1", "K1_merge"),
        ("K2", "K3"))
    return {"launches": launches, "held_to_plain": held}


# ------------------------------------------------------------------- fp32 ---
#
# The widths and types the JAX kernels take beyond the paths above: fp32
# q, K and V on the mainloop's split route (K1/K1s, K2, K3, the merge),
# K1q / K1q-s at head_dim 64 and with an fp16 or fp32 q, K3 at head_dim 64;
# and the pipelines with fp32 weights on the card.

# the fp32 full-width run: HunyuanVideoConfig() cut to 2 dual + 2 single
# blocks (as PIPE), fp32 weights, at the ckpt phase's 480x832x33, 3 steps,
# TeaCache on, G = 2
FP32_FULL = dict(cfg=dict(num_dual_blocks=2, num_single_blocks=2),
                 height=480, width=832, frames=33, steps=3, group_rows=2)


def sdpa_efficient(*args, **kw):
    """scaled_dot_product_attention on its memory-efficient backend (the
    one that takes fp32 and a mask), the yardstick of the fp32 jobs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return torch.nn.functional.scaled_dot_product_attention(*args, **kw)


def fp32_small_cases(kernels, ops):
    """(a) Small shapes.  In fp32 at head_dim 128 and 64, against the plain
    versions at F32_TOL (TF32 off): K1 and K1s (the text window at B=2, a
    count-0 and a degenerate row, chunk_blocks 2 and 16, the packed K|V
    stream), K2 at G = 2 and 4, the key split (16 row tiles, merged by the
    merge kernel), full lists at block_m 1024, K3 off its tiles and with a
    kv_valid mask at B=2, the merge writing fp32 rows.  Then K1q / K1q-s
    in both modes at head_dim 64 (bf16 q) and with an fp16 or fp32 q at 64
    and 128, and K3 in bf16 at 64, at phase 2's limits.  Returns max
    errors by kernel and the cases."""
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3232)
    rnd = lambda *s, dt=torch.float32: torch.randn(
        s, generator=gen, device=dev).to(dt)
    bs, k1 = kernels.block_sparse, kernels.block_sparse_flash_attention
    errs, cases = {}, []

    def check(name, kern, got, want, f32=True):
        if f32:
            r = held_f32(name, got, want, F32_TOL)
        else:
            e = max_err(got, want)
            if not (torch.isfinite(got.float()).all() and e <= TOL):
                raise AssertionError(f"{name}: max abs err {e} > {TOL}")
            r = held_to_scale(name, got, want)
        errs[kern] = max(errs.get(kern, 0.0), r["max_abs_err"])
        cases.append({"case": name, **r})

    for d in (128, 64):
        b, h, nq, nb = 2, 3, 4, 10
        q, k, v = rnd(b, h, nq * 128, d), rnd(b, h, nb * 128, d), \
            rnd(b, h, nb * 128, d)
        m = torch.rand((b, h, nq, nb), generator=gen, device=dev) < 0.4
        m[..., 0] = m[..., -1] = True
        m[0, 1, 0] = False                       # count 0
        m[1, 2, 1] = False
        m[1, 2, 1, -1] = True                    # only batch 1's text
        tl = torch.tensor([90, 0], dtype=torch.int32, device=dev)
        kw = dict(visual_len=(nb - 1) * 128 - 50, text_start=(nb - 1) * 128)
        idx, cnt = ops.mask_to_indices(m)
        for cb in (2, 16):
            args, ckw = (q, k, v, idx, cnt, tl), dict(chunk_blocks=cb, **kw)
            check(f"k1_fp32_d{d}_chunk{cb}", f"K1_d{d}", k1(*args, **ckw),
                  kernels.block_sparse_flash_attention_torch(*args, **ckw))
        packed = dict(packed_kv=torch.cat([k, v], dim=-1), **kw)
        check(f"k1_fp32_d{d}_packed_kv", f"K1_d{d}",
              k1(q, k, v, idx, cnt, tl, **packed),
              kernels.block_sparse_flash_attention_torch(
                  q, k, v, idx, cnt, tl, **packed))
        o, mo, lo = k1(q, k, v, idx, cnt, tl, return_stats=True, **kw)
        wo, wm, wl = kernels.block_sparse_flash_attention_torch(
            q, k, v, idx, cnt, tl, return_stats=True, **kw)
        live = lo > 0
        check(f"k1s_fp32_d{d}", f"K1s_d{d}", o, wo)
        check(f"k1s_fp32_d{d}_m", f"K1s_d{d}", mo[live], wm[live])
        check(f"k1s_fp32_d{d}_l", f"K1s_d{d}", lo, wl)
        for grp in (2, 4):
            ui, uc, rb, cl = ops.group_rows(m, grp,
                                            clean_blocks=kw["visual_len"] // 128)
            gkw = dict(group=grp, **kw)
            check(f"k2_fp32_d{d}_g{grp}", f"K2_d{d}",
                  kernels.block_sparse_flash_attention_grouped(
                      q, k, v, ui, uc, rb, cl, tl, **gkw),
                  kernels.block_sparse_flash_attention_grouped_torch(
                      q, k, v, ui, uc, rb, cl, tl, **gkw))
        # the key split: 16 row tiles over lists of 40 blocks, merged
        ms = torch.rand((2, 4, 2, 40), generator=gen, device=dev) < 0.5
        ms[..., -1] = True
        ms[1, 2, 1] = False
        ms[1, 2, 1, -1] = True
        qs, ks, vs = rnd(2, 4, 256, d), rnd(2, 4, 40 * 128, d), \
            rnd(2, 4, 40 * 128, d)
        sidx, scnt = ops.mask_to_indices(ms)
        skw = dict(visual_len=39 * 128 - 40, text_start=39 * 128,
                   chunk_blocks=4)
        merges = bs.merge_splits.launches
        check(f"k1_fp32_d{d}_split", f"K1_d{d}",
              k1(qs, ks, vs, sidx, scnt, tl, **skw),
              kernels.block_sparse_flash_attention_torch(
                  qs, ks, vs, sidx, scnt, tl, **skw))
        if bs.merge_splits.launches != merges + 1:
            raise AssertionError(f"k1_fp32_d{d}_split did not split")
        # full lists at block_m 1024 (the windowed dense)
        qd, kd, vd = rnd(1, 4, 1024, d), rnd(1, 4, nb * 128, d), \
            rnd(1, 4, nb * 128, d)
        full = torch.ones((1, 4, 1, nb), dtype=torch.bool, device=dev)
        fidx, fcnt = ops.mask_to_indices(full)
        dargs, dkw = (qd, kd, vd, fidx, fcnt, tl[:1]), dict(block_m=1024, **kw)
        check(f"k1_fp32_d{d}_full_lists_bm1024", f"K1_d{d}", k1(*dargs, **dkw),
              kernels.block_sparse_flash_attention_torch(*dargs, **dkw))
        # K3: Sq and Sk off the tiles; a kv_valid mask at B=2 with a row of
        # no valid key
        valid = torch.rand((2, 257), generator=gen, device=dev) < 0.6
        valid[1] = False
        for name, bb, vm in (("tails", 1, None), ("mask_b2", 2, valid)):
            q3, k3, v3 = rnd(bb, 3, 200, d), rnd(bb, 3, 257, d), \
                rnd(bb, 3, 257, d)
            check(f"k3_fp32_d{d}_{name}", f"K3_d{d}",
                  kernels.dense_attention(q3, k3, v3, vm, mode="flash"),
                  kernels.flash._vanilla_attention(q3, k3, v3, vm))
        # the merge kernel writing fp32 rows
        o_p, m_p = rnd(3, 512, d), rnd(3, 512)
        l_p = rnd(3, 512).abs() * 50
        m_p[1, :7], l_p[1, :7] = -torch.inf, 0.0
        got = bs.merge_splits(o_p, m_p, l_p, torch.float32,
                              return_stats=True)
        want = bs._merge_splits(list(o_p), list(m_p), list(l_p))
        for part, g_, w_ in zip("oml", got, want):
            check(f"merge_fp32_d{d}_{part}", f"K1_merge_d{d}", g_, w_)

    # K1q / K1q-s: head_dim 64 (bf16 q) and fp16 / fp32 q at 64 and 128
    for d, qdt in ((64, torch.bfloat16), (64, torch.float16),
                   (64, torch.float32), (128, torch.float16),
                   (128, torch.float32)):
        b, h, nq, nb = 2, 3, 6, 12
        q, k, v = rnd(b, h, nq * 128, d, dt=qdt), \
            rnd(b, h, nb * 128, d, dt=torch.bfloat16), \
            rnd(b, h, nb * 128, d, dt=torch.bfloat16)
        m = torch.rand((b, h, nq, nb), generator=gen, device=dev) < 0.4
        m[..., 0] = m[..., -1] = True
        m[0, 1, 3] = False
        m[1, 2, 4] = False
        m[1, 2, 4, -1] = True
        tl = torch.tensor([90, 0], dtype=torch.int32, device=dev)
        idx, cnt = ops.mask_to_indices(m)
        zero = (cnt == 0).repeat_interleave(128, dim=2)
        payload = ops.quantize_kv_blocks(k, v, 128)
        for mode in ("int8", "mxu8"):
            for cb in (2, 24):
                kw = dict(visual_len=(nb - 1) * 128 - 50,
                          text_start=(nb - 1) * 128, chunk_blocks=cb,
                          kv_quant=payload, quant_mode=mode)
                name = f"k1q_{mode}_d{d}_q_{str(qdt)[6:]}_chunk{cb}"
                got = k1(q, k, v, idx, cnt, tl, **kw)
                o, mo, lo = k1(q, k, v, idx, cnt, tl, return_stats=True, **kw)
                wo, wm, wl = kernels.block_sparse_flash_attention_torch(
                    q, k, v, idx, cnt, tl, return_stats=True, **kw)
                if got.dtype != qdt or not torch.equal(o, got) \
                        or got[zero].abs().max() != 0:
                    raise AssertionError(f"{name}: dtype {got.dtype}, K1q-s's "
                                         "o not K1q's, or a count-0 row not 0")
                kern = f"K1q_d{d}" if qdt == torch.bfloat16 else \
                    f"K1q_q_{str(qdt)[6:]}"
                check(name, kern, got, wo, f32=False)
                if not (max_err(mo[~zero], wm[~zero]) <= M_TOL and float(
                        ((lo - wl).abs() / wl.clamp(min=1e-30))[~zero].max())
                        <= L_REL):
                    raise AssertionError(f"{name}: K1q-s's m / l off the plain")
    # K3 in bf16 at head_dim 64
    for name, bb, sq, sk in (("tails", 1, 200, 257), ("sk512", 1, 256, 512)):
        q3, k3, v3 = (rnd(bb, 4, n, 64, dt=torch.bfloat16)
                      for n in (sq, sk, sk))
        check(f"k3_bf16_d64_{name}", "K3_d64_bf16",
              kernels.dense_attention(q3, k3, v3, mode="flash"),
              kernels.flash._vanilla_attention(q3, k3, v3), f32=False)
    return errs, cases


def fp32_site_phase(kernels, ops):
    """(b) Site shapes, random inputs, each job against its plain version
    on the full inputs (fp32 at F32_REL; K1q and K3 in bf16 at the
    relative limits), its CUDA-event time, bound and library time.  The
    fp32 bounds count 4 bytes an element and the operations of the split
    route: three bf16 products for each product, at the bf16 rate.
      HunyuanVideo (115,200 + 256 tokens, 24 x 128, build_site(32, 45,
    80), the single-row plan of site_inputs): K1 visual rows (G = 1), K2
    at G = 2, K1 and K1s on the text rows (split into key ranges and
    merged), the merge kernel writing fp32 rows, the windowed dense at
    block_m 1024 (beside SDPA in fp32 with the same key mask); K1q in both
    modes with an fp32 and an fp16 q on the same plan.
      Wan2.1's text cross (q [1,40,75648,128] x 512 keys): K3 in fp32,
    beside SDPA in fp32.
      CogVideoX1.5 (joint_site_inputs(COG_SITE); 48 x 64): K1q and K1q-s
    in both modes on the visual rows' plan at head_dim 64, and K3 at 64
    unmasked over the 24,736 tokens (beside SDPA)."""
    dev = torch.device(DEV)
    kern, res = {}, {"launches": {}}
    k1 = kernels.block_sparse_flash_attention
    k3 = kernels.dense_flash_attention
    # fp32's bound: each product counted once, at the TF32 tensor-core
    # rate; route_bound_ms: the split route's three bf16 products for one
    f32 = dict(limits=F32_REL, peak=PEAK_TF32_FLOPS, route_ops=3)
    # the launches of K1s, K1q, K1q-s and K3 a block of jobs below makes
    counts = lambda: {"K1s": k1.stats_launches,
                      "K1q": sum(k1.quant_launches.values()),
                      "K1q-s": sum(k1.quant_stats_launches.values()),
                      "K3": k3.launches}

    def launched(name, before):
        res["launches"][name] = {n: c - before[n]
                                 for n, c in counts().items()}
    idx_bytes = lambda *ts: sum(t.numel() * 4 for t in ts)

    # HunyuanVideo
    b, h, d, text_len = 1, SITE["heads"], SITE["head_dim"], SITE["text_len"]
    st = site_inputs("random")
    site, tlen, valid, plan = (st[n] for n in ("site", "tlen", "valid",
                                               "plan"))
    sv = site.visual_len
    s = sv + text_len
    nbt = s // 128
    q, kz, vz = (st[n].float() for n in ("q", "kz", "vz"))
    q_vis, q_txt = q[:, :, :sv], q[:, :, sv:]
    pairs = float(plan.counts.sum())
    used = torch.zeros((b * h, nbt), dtype=torch.int32, device=dev)
    used.scatter_add_(1, plan.indices.reshape(b * h, -1).long(),
                      (torch.arange(plan.indices.shape[-1], device=dev)
                       < plan.counts[..., None]).reshape(b * h, -1).int())
    vis_blocks = float((used > 0).sum())
    del used
    qo4 = lambda rows: 2 * b * h * rows * d * 4
    kv4 = lambda blocks: 2 * blocks * 128 * d * 4
    kw = dict(visual_len=sv, text_start=sv)
    res["hunyuan"] = {"pairs": pairs, "visual_kv_blocks": vis_blocks}
    measure(kern, "K1_fp32_visual_g1", "random", True,
            lambda: k1(q_vis, kz, vz, plan.indices, plan.counts, tlen, **kw),
            lambda: kernels.block_sparse_flash_attention_torch(
                q_vis, kz, vz, plan.indices, plan.counts, tlen, **kw),
            flops=pairs * 4.0 * 128 * 128 * d,
            nbytes=qo4(sv) + kv4(vis_blocks)
            + idx_bytes(plan.indices, plan.counts), **f32)
    ui, uc, rb, cl = ops.group_rows(plan.block_mask, 2,
                                    clean_blocks=sv // 128)
    g2 = dict(group=2, **kw)
    measure(kern, "K2_fp32_visual_g2", "random", True,
            lambda: kernels.block_sparse_flash_attention_grouped(
                q_vis, kz, vz, ui, uc, rb, cl, tlen, **g2),
            lambda: kernels.block_sparse_flash_attention_grouped_torch(
                q_vis, kz, vz, ui, uc, rb, cl, tlen, **g2),
            flops=pairs * 4.0 * 128 * 128 * d,
            nbytes=qo4(sv) + kv4(vis_blocks) + idx_bytes(ui, uc, rb, cl),
            **f32)
    del ui, uc, rb, cl
    nt = text_len // 128
    fidx = torch.arange(nbt, dtype=torch.int32, device=dev).expand(
        b, h, nt, nbt)
    fcnt = torch.full((b, h, nt), nbt, dtype=torch.int32, device=dev)
    amask = valid[:, None, None, :]
    txt = (q_txt, kz, vz, fidx, fcnt, tlen)
    merges = kernels.block_sparse.merge_splits.launches
    before = counts()
    for name, stats in (("K1_fp32_text_rows", False),
                        ("K1s_fp32_text_rows", True)):
        pick = (lambda r: r[0]) if stats else (lambda r: r)
        measure(kern, name, "random", True,
                lambda: pick(k1(*txt, return_stats=stats, **kw)),
                lambda: pick(kernels.block_sparse_flash_attention_torch(
                    *txt, return_stats=stats, **kw)),
                flops=b * h * nt * nbt * 4.0 * 128 * 128 * d,
                nbytes=qo4(text_len) + kv4(b * h * nbt)
                + idx_bytes(fidx, fcnt)
                + (2 * b * h * text_len * 4 if stats else 0),
                library=lambda: sdpa_efficient(q_txt, kz, vz,
                                               attn_mask=amask), **f32)
    launched("hunyuan_text_rows", before)
    if kernels.block_sparse.merge_splits.launches == merges:
        raise AssertionError("the fp32 text rows did not split")
    merge_at_site(kernels, kern, "random", b * h * nt, nbt,
                  name="K1_merge_fp32", out_dtype=torch.float32)
    nqd = -(-s // 1024)
    qd = torch.nn.functional.pad(q, (0, 0, 0, nqd * 1024 - s))
    kf, vf = st["k"].float(), st["v"].float()
    didx = torch.arange(nbt, dtype=torch.int32, device=dev).expand(
        b, h, nqd, nbt)
    dcnt = torch.full((b, h, nqd), nbt, dtype=torch.int32, device=dev)
    dkw = dict(block_m=1024, **kw)
    measure(kern, "K1_fp32_dense_bm1024", "random", True,
            lambda: k1(qd, kf, vf, didx, dcnt, tlen, **dkw),
            lambda: kernels.block_sparse_flash_attention_torch(
                qd, kf, vf, didx, dcnt, tlen, **dkw),
            flops=b * h * nqd * nbt * 4.0 * 1024 * 128 * d,
            nbytes=qo4(nqd * 1024) + kv4(b * h * nbt)
            + idx_bytes(didx, dcnt),
            library=lambda: sdpa_efficient(q, kf, vf, attn_mask=amask),
            **f32)
    del qd, kf, vf, didx, dcnt
    torch.cuda.empty_cache()
    # K1q with an fp32 and an fp16 q on the same plan and payload
    payload = ops.quantize_kv_blocks(st["kz"], st["vz"], 128)
    qkw = dict(chunk_blocks=site.cfg.kernel_chunk_blocks, kv_quant=payload,
               **kw)
    before = counts()
    for qdt in (torch.float32, torch.float16):
        qq = q_vis.to(qdt)
        for mode in ("int8", "mxu8"):
            args = (qq, kz, vz, plan.indices, plan.counts, tlen)
            mkw = dict(quant_mode=mode, **qkw)
            # the plain version on the fp32 q (the small cases hold fp16)
            measure(kern, f"K1q_{mode}_q_{str(qdt)[6:]}_visual", "random",
                    qdt == torch.float32, lambda: k1(*args, **mkw),
                    lambda: kernels.block_sparse_flash_attention_torch(
                        *args, **mkw),
                    flops=pairs * 4.0 * 128 * 128 * d,
                    nbytes=2 * b * h * sv * d * qq.element_size()
                    + 2 * vis_blocks * 128 * d + 2 * b * h * nbt * 4
                    + idx_bytes(plan.indices, plan.counts),
                    peak=PEAK_INT8_OPS if mode == "mxu8" else PEAK_BF16_FLOPS)
        del qq
    launched("hunyuan_k1q_q_types", before)
    del st, q, q_vis, q_txt, kz, vz, payload, plan
    torch.cuda.empty_cache()

    # Wan2.1's text cross in fp32
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    before = counts()
    wh, ws, wk = WAN_SITE["heads"], 75648, WAN_SITE["text_len"]
    qx = torch.randn((1, ws, wh, d), generator=gen, device=dev).transpose(1, 2)
    kx, vx = (torch.randn((1, wk, wh, d), generator=gen, device=dev
                          ).transpose(1, 2) for _ in range(2))
    measure(kern, "K3_fp32_t2v_text", "random", True,
            lambda: kernels.dense_attention(qx, kx, vx, mode="flash"),
            lambda: plain_dense(kernels, qx, kx, vx),
            flops=4.0 * wh * ws * wk * d,
            nbytes=2 * wh * (ws + wk) * d * 4,
            library=lambda: sdpa_efficient(qx, kx, vx), **f32)
    launched("wan_text_cross", before)
    del qx, kx, vx
    torch.cuda.empty_cache()

    # CogVideoX1.5 at head_dim 64: K1q / K1q-s on the visual rows' plan,
    # K3 unmasked over every token
    c = COG_SITE
    cst = joint_site_inputs(c, "random")
    h, d = c["heads"], c["head_dim"]
    cq, ck, cv, qp, kz, vz, tlen, plan, sv_pad = (
        cst[n] for n in ("q", "k", "v", "qp", "kz", "vz", "tlen", "plan",
                         "sv_pad"))
    sv = cst["site"].visual_len
    nbt = (sv_pad + c["text_len"]) // 128
    q_vis = qp[:, :, :sv_pad]
    pairs = float(plan.counts.sum())
    used = torch.zeros((h, nbt), dtype=torch.int32, device=dev)
    used.scatter_add_(1, plan.indices.reshape(h, -1).long(),
                      (torch.arange(plan.indices.shape[-1], device=dev)
                       < plan.counts[..., None]).reshape(h, -1).int())
    vis_blocks = float((used > 0).sum())
    kw = dict(visual_len=sv, text_start=sv_pad)
    args = (q_vis, kz, vz, plan.indices, plan.counts, tlen)
    ref = k1(*args, **kw)
    qkw = dict(chunk_blocks=cst["site"].cfg.kernel_chunk_blocks, **kw)
    k1q_bytes = (2 * h * sv_pad * d * 2 + 2 * vis_blocks * 128 * d
                 + 2 * h * nbt * 4 + idx_bytes(plan.indices, plan.counts))
    cog = {}
    before = counts()
    for mode in ("int8", "mxu8"):
        k1q_at_site(kernels, ops, cog, mode, "random", True, ref, args, qkw,
                    flops=pairs * 4.0 * 128 * 128 * d, nbytes=k1q_bytes)
    for mode in ("int8", "mxu8"):
        k1q_stats_at_site(kernels, ops, cog, mode, "random", True, args, qkw,
                          flops=pairs * 4.0 * 128 * 128 * d,
                          nbytes=k1q_bytes + 2 * h * sv_pad * 4)
    kern.update({f"cog_{n}": r for n, r in cog.items()})
    del ref, args, kz, vz, qp, q_vis
    torch.cuda.empty_cache()
    tok = cq.shape[2]                            # 24,736
    launched("cogvideox_k1q", before)
    before = counts()
    measure(kern, "cog_K3_self_24736", "random", True,
            lambda: kernels.dense_attention(cq, ck, cv, mode="flash"),
            lambda: plain_dense(kernels, cq, ck, cv, heads=8, rows=4096),
            flops=4.0 * h * tok * tok * d, nbytes=4 * h * tok * d * 2,
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                cq, ck, cv))
    launched("cogvideox_k3", before)
    res["cogvideox"] = {"pairs": pairs, "tokens": tok,
                        "chunk_blocks": qkw["chunk_blocks"]}
    return res, kern


def fp32_small_pipelines(kernels):
    """(c) The small HunyuanVideo, Wan and CogVideoX T2V pipelines with the
    GPU model in fp32 against the CPU in fp32, held to PIPE_F32 (CogVideoX
    again with TeaCache on, held to PIPE_BF16); the launch counters zeroed
    just before and read just after."""
    kerns = path_kernels(kernels)
    for f in kerns.values():
        f.launches = 0
    res = {"hunyuan": small_pipeline_check(dtype=torch.float32),
           "wan": small_wan_pipeline_check(dtype=torch.float32),
           "cogvideox_t2v": small_cog_check(False, dtype=torch.float32),
           "cogvideox_t2v_teacache": small_cog_check(
               False, dtype=torch.float32, teacache=True)}
    res["launches"] = {n: f.launches for n, f in kerns.items()}
    if min(res["launches"][n] for n in ("K1", "K2", "K3")) == 0:
        raise AssertionError(f"fp32 small pipelines: {res['launches']}")
    return res


def fp32_full_width(kernels):
    """(d) HunyuanVideoConfig() at full width cut to 2 + 2 blocks with fp32
    weights, FP32_FULL's 480x832x33, 3 steps, TeaCache on, G = 2: s/step,
    peak memory, launches per computed call (counters zeroed just before,
    read just after); then the same weights in bf16 on the same noise, and
    the largest difference of the two outputs (reported, not held: the two
    types may select other blocks)."""
    from rectified_spaattn_tpu_torch.cli.generate import _random_text
    from rectified_spaattn_tpu_torch.pipelines import HunyuanVideoPipeline

    dev = torch.device(DEV)
    model = hunyuan_full_model(dtype=torch.float32)
    cfg = model.cfg
    kerns = path_kernels(kernels)
    text, mask = _random_text("several hot air balloons flying over a city.",
                              256, cfg.text_dim, device=dev)
    res, outs = {"cut": "2 dual + 2 single of 20 + 40 blocks"}, {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        model.to(dt)
        pipe = HunyuanVideoPipeline(
            model=model, height=FP32_FULL["height"], width=FP32_FULL["width"],
            frames=FP32_FULL["frames"], num_steps=FP32_FULL["steps"],
            sa_drop_rate=0.8, p_remain_rates=0.3, mode="sparse",
            enable_teacache=True, rel_l1_thresh=0.15,
            group_rows=FP32_FULL["group_rows"], device=dev)
        noise = torch.Generator(device=dev)
        noise.manual_seed(42)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f in kerns.values():
            f.launches = 0
        out = pipe(text, mask, generator=noise)
        torch.cuda.synchronize()
        launches = {n: f.launches for n, f in kerns.items()}
        if not torch.isfinite(out).all() or min(
                launches["K1"], launches["K2"], launches["K1_merge"]) == 0:
            raise AssertionError(f"fp32 full width ({name}): launches "
                                 f"{launches}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
        computed = pipe.teacache_stats["computed"]
        res[name] = {
            "step_seconds": pipe.step_seconds,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "weight_gb": sum(p.numel() * p.element_size()
                             for p in model.parameters()) / 2**30,
            "launches": launches,
            "launches_per_computed_call": {
                n: c / computed for n, c in launches.items()},
            "teacache_decisions": pipe.teacache.decisions,
            "visual_tokens": pipe.site.visual_len}
        outs[name] = out.float()
        del pipe, out
        torch.cuda.empty_cache()
    res["max_abs_diff_fp32_vs_bf16"] = max_err(outs["float32"],
                                               outs["bfloat16"])
    res["ref_max_abs"] = float(outs["float32"].abs().max())
    del model, outs
    torch.cuda.empty_cache()
    return res


def fp32_entries(errs, site, res, pipes, full) -> list:
    """The {"kernels": ...} line's entries of the fp32 phase's
    instantiations: fp32 K1/K1s, K2, K3 and the merge (the split route),
    K1q / K1q-s at head_dim 64, K3 at 64, K1q with an fp16 / fp32 q.  The
    fp32 kernels' launches are the fp32 pipelines' (small and full
    width); the others run on no pipeline of either package, so theirs
    are the site jobs'."""
    src = "rectified_spaattn_tpu_torch/csrc/block_sparse.cu"
    src3 = "rectified_spaattn_tpu_torch/csrc/dense_flash.cu"
    split = ("the mainloop's split route (csrc/hopper_attn.cuh): fp32 rows "
             "read by the producer warpgroup into bf16 hi / lo tiles, three "
             "bf16 wgmma a product; bound: 4 bytes an element, the "
             "products counted once at the TF32 rate; route_bound_ms: 3x "
             "them at the bf16 rate")
    pipe_paths = lambda n: {"small_pipelines_fp32": pipes["launches"][n],
                            "hunyuan_full_width_fp32":
                                full["float32"]["launches"][n]}
    site_paths = lambda window, kern: {f"fp32_site_{window}":
                                       res["launches"][window][kern]}

    def entry(name, r, source, replaces, by_path, err, shape, design,
              **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err,
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": shape,
                "design": design, **extra,
                **({"route_bound_ms": r["route_bound_ms"]}
                   if "route_bound_ms" in r else {})}

    e = lambda *keys: max(errs.get(k, 0.0) for k in keys)
    hq = "q [1,24,115200,128]"
    k1q = "rectified_spaattn_tpu/kernels/block_sparse.py:176"
    entries = [
        entry("K1_fp32", site["K1_fp32_visual_g1"], src,
              "rectified_spaattn_tpu/kernels/block_sparse.py:89",
              pipe_paths("K1"), max(e("K1_d128", "K1_d64"),
                                    site["K1_fp32_visual_g1"]["max_abs_err"]),
              f"fp32 visual rows: {hq}, the single-row plan", split,
              other_jobs={"text_rows": site["K1_fp32_text_rows"],
                          "dense_bm1024": site["K1_fp32_dense_bm1024"]}),
        entry("K1s_fp32", site["K1s_fp32_text_rows"], src,
              "rectified_spaattn_tpu/kernels/block_sparse.py:311",
              site_paths("hunyuan_text_rows", "K1s"),
              max(e("K1s_d128", "K1s_d64"),
                  site["K1s_fp32_text_rows"]["max_abs_err"]),
              "fp32 text rows: q [1,24,256,128] x full lists over 902 "
              "blocks, split and merged", split),
        entry("K2_fp32", site["K2_fp32_visual_g2"], src,
              "rectified_spaattn_tpu/kernels/block_sparse.py:317",
              pipe_paths("K2"), max(e("K2_d128", "K2_d64"),
                                    site["K2_fp32_visual_g2"]["max_abs_err"]),
              f"fp32 visual rows: {hq}, G=2 union lists", split),
        entry("K3_fp32", site["K3_fp32_t2v_text"], src3,
              "rectified_spaattn_tpu/kernels/flash.py:49", pipe_paths("K3"),
              max(e("K3_d128", "K3_d64"),
                  site["K3_fp32_t2v_text"]["max_abs_err"]),
              "fp32 Wan T2V text cross: q [1,40,75648,128] x 512 keys",
              split + ", persistent CTAs"),
        entry("K1_merge_fp32", site["K1_merge_fp32"], src,
              "rectified_spaattn_tpu/kernels/block_sparse.py:89 (K1/K1s's "
              "key split; the merge of "
              "rectified_spaattn_tpu/attention/ring.py:48)",
              pipe_paths("K1_merge"),
              max(e("K1_merge_d128", "K1_merge_d64"),
                  site["K1_merge_fp32"]["max_abs_err"]),
              f"{site['K1_merge_fp32']['n_split']} ranges x 6,144 rows x "
              "128, fp32 rows", "one warp a row"),
        entry("K1q_d64", site["cog_K1q_mxu8_visual"], src, k1q,
              site_paths("cogvideox_k1q", "K1q"),
              max(e("K1q_d64"), site["cog_K1q_mxu8_visual"]["max_abs_err"],
                  site["cog_K1q_int8_visual"]["max_abs_err"]),
              "mxu8, CogVideoX visual rows: q [1,48,24576,64], int8 K|V "
              "[48,24832,128]",
              "hopper_attn_q_kernel_at<*, *, 64, bf16>: one TMA box holds a "
              "row's K8 and V8",
              other_jobs={"int8": site["cog_K1q_int8_visual"]}),
        entry("K1q-s_d64", site["cog_K1q-s_mxu8_visual"], src,
              "rectified_spaattn_tpu/kernels/block_sparse.py:606",
              site_paths("cogvideox_k1q", "K1q-s"),
              max(e("K1q_d64"),
                  site["cog_K1q-s_mxu8_visual"]["max_abs_err"]),
              "mxu8 with m and l, CogVideoX visual rows",
              "K1q_d64 with STATS",
              other_jobs={"int8": site["cog_K1q-s_int8_visual"]}),
        entry("K3_d64", site["cog_K3_self_24736"], src3,
              "rectified_spaattn_tpu/kernels/flash.py:49",
              site_paths("cogvideox_k3", "K3"),
              max(e("K3_d64_bf16"),
                  site["cog_K3_self_24736"]["max_abs_err"]),
              "bf16, unmasked self-attention over CogVideoX's 24,736 "
              "tokens: q [1,48,24736,64]", "DenseTilesAt<T, 64>"),
        entry("K1q_q_fp32", site["K1q_mxu8_q_float32_visual"], src, k1q,
              site_paths("hunyuan_k1q_q_types", "K1q"),
              max(e("K1q_q_float32", "K1q_q_float16"),
                  site["K1q_mxu8_q_float32_visual"]["max_abs_err"],
                  site["K1q_int8_q_float32_visual"]["max_abs_err"]),
              f"mxu8, fp32 {hq} over the int8 payload, chunk_blocks 24",
              "hopper_attn_q_kernel_at<*, *, *, QT>: q read from global "
              "memory at the tile's start, no tensor map",
              other_jobs={n: site[f"K1q_{n}_visual"] for n in (
                  "int8_q_float32", "int8_q_float16", "mxu8_q_float16")}),
    ]
    idle = [e["name"] for e in entries if not e["launches"]]
    if idle:
        raise AssertionError(f"kernels never launched on their path: {idle}")
    return entries


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
    psel = plan_select_leg(kernels, ops)
    emit("plan_select", t0, **psel)

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
    small["cogvideox_t2v"] = small_cog_check(i2v=False)
    small["cogvideox_i2v"] = small_cog_check(i2v=True)
    small["flux_upscale"] = small_flux_check(pixels=False)
    small["flux_upscale_pixels"] = small_flux_check(pixels=True)
    emit("small_pipeline_gpu_vs_cpu", t0, **small)

    t0 = time.perf_counter()
    pipe, pipe_latents = pipeline_phase(kernels)
    emit("pipeline", t0, **pipe)

    t0 = time.perf_counter()
    i2v = pipeline_i2v_phase(kernels, pipe)
    emit("pipeline_i2v", t0, nvidia_smi=smi, **i2v)

    t0 = time.perf_counter()
    probe = int8_probe_phase()
    emit("int8_probe", t0, **probe)

    t0 = time.perf_counter()
    small4 = small_int4_check(kernels)
    emit("small_pipeline_int4_gpu_vs_cpu", t0, **small4)

    t0 = time.perf_counter()
    pipe8 = pipeline_int8_phase(kernels, pipe["peak_mem_gb"])
    emit("pipeline_int8", t0, **pipe8)

    t0 = time.perf_counter()
    # the snapshots the ckpt phase writes serve the eval phases too
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    atexit.register(shutil.rmtree, ckpt_root, True)
    ckpt = ckpt_phase(kernels, ckpt_root)
    emit("ckpt", t0, nvidia_smi=smi, **ckpt)

    wsites = {}
    for regime in ("random", "smooth"):
        t0 = time.perf_counter()
        res, wsites[regime] = wan_site_phase(kernels, regime)
        emit(f"wan_site_{regime}", t0, **res)

    t0 = time.perf_counter()
    small = small_wan_pipeline_check()
    emit("small_wan_pipeline_gpu_vs_cpu", t0, **small)

    t0 = time.perf_counter()
    wpipe, wan_latents = wan_pipeline_phase(kernels)
    emit("wan_pipeline", t0, **wpipe)

    t0 = time.perf_counter()
    a14b = wan22_a14b_phase(kernels)
    emit("wan22_a14b", t0, nvidia_smi=smi, **a14b)

    csites = {}
    for regime in ("random", "smooth"):
        t0 = time.perf_counter()
        res, csites[regime], _ = joint_site_phase(kernels, ops, COG_SITE,
                                                  regime, "cog_")
        emit(f"cog_site_{regime}", t0, nvidia_smi=smi, **res)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cpipe = pipeline_cogvideox_phase(kernels)
    emit("pipeline_cogvideox", t0, nvidia_smi=smi, **cpipe)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ci2v = pipeline_cogvideox_i2v_phase(kernels)
    emit("pipeline_cogvideox_i2v", t0, nvidia_smi=smi, **ci2v)
    torch.cuda.empty_cache()

    fsites = {}
    for regime in ("random", "smooth"):
        t0 = time.perf_counter()
        res, fsites[regime] = flux_site_phase(kernels, ops, regime)
        emit(f"flux_site_{regime}", t0, nvidia_smi=smi, **res)
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    fpipe = pipeline_flux_phase(kernels)
    emit("pipeline_flux", t0, nvidia_smi=smi, **fpipe)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    scan = scan_phase(kernels, pipe, pipe_latents, wpipe, wan_latents)
    emit("scan", t0, nvidia_smi=smi, **scan)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ehun = eval_hunyuan_phase(kernels, ckpt_root)
    emit("eval_hunyuan", t0, nvidia_smi=smi, **ehun)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    emit("eval_multihost", t0, nvidia_smi=smi,
         **eval_multihost_phase(ckpt_root))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    eflux = eval_flux_phase(kernels, ckpt_root)
    emit("eval_flux", t0, nvidia_smi=smi, **eflux)
    torch.cuda.empty_cache()

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

    # the fp32 phase: (a) small shapes, (b) site shapes, (c) the small
    # pipelines in fp32 on the GPU, (d) full width in fp32
    t0 = time.perf_counter()
    f32errs, f32cases = fp32_small_cases(kernels, ops)
    emit("fp32_small", t0, tolerance=F32_TOL, max_abs_err=f32errs,
         cases=f32cases)
    t0 = time.perf_counter()
    f32res, f32site = fp32_site_phase(kernels, ops)
    emit("fp32_site", t0, nvidia_smi=smi, limits=F32_REL, **f32res)
    t0 = time.perf_counter()
    f32pipes = fp32_small_pipelines(kernels)
    emit("fp32_small_pipelines", t0, tolerance=PIPE_F32, **f32pipes)
    t0 = time.perf_counter()
    f32full = fp32_full_width(kernels)
    emit("fp32_full_width", t0, nvidia_smi=smi, **f32full)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    e2e_res = e2e_phase(kernels)
    emit("e2e", t0, cut=e2e_res["cut"])
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    diag = diag_phase(kernels)
    emit("diag", t0, held_to_plain=diag["held_to_plain"])

    site, smooth = sites["random"], sites["smooth"]
    wsite = wsites["random"]
    src = "rectified_spaattn_tpu_torch/csrc/block_sparse.cu"
    k1, k2, k1t = (site["K1_visual_g1"], site["K2_visual_g2"],
                   site["K1_text_rows"])
    k3, k3i = wsite["K3_t2v_text"], wsite["K3_i2v_image"]
    by_path = lambda n: {"hunyuan": pipe["launches"][n],
                         "hunyuan_i2v": i2v["launches"][n],
                         "wan": wpipe["launches"][n],
                         "wan22_a14b": a14b["launches"][n],
                         "hunyuan_ckpt": ckpt["cli"]["launches"].get(n, 0),
                         "hunyuan_i2v_ckpt":
                             ckpt["cli_i2v"]["launches"].get(n, 0),
                         "cogvideox": cpipe["launches"][n],
                         "cogvideox_i2v": ci2v["launches"][n],
                         "cogvideox_ckpt":
                             ckpt["cogvideox"]["cli"]["launches"][n],
                         "flux": fpipe["launches"][n],
                         "flux_ckpt": ckpt["flux"]["cli"]["launches"][n],
                         "eval_hunyuan": ehun["launches"][n],
                         "eval_flux": eflux["launches"][n],
                         **{f"scan_{r}": c[n] for r, c in
                            scan["launches_by_run"].items()},
                         **{leg: c[n] for leg, c in
                            e2e_res["launches"].items()},
                         **{leg: c[n] for leg, c in
                            diag["launches"].items()}}
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
    diag_k1q = diag["launches"]["diag_grouped_k1q"]
    # every sparse pipeline run plans, each plan through P1: none reads 0
    p1_paths = by_path("P1")
    unplanned = [path for path in ("hunyuan", "hunyuan_i2v", "wan",
                                   "wan22_a14b", "hunyuan_ckpt",
                                   "hunyuan_i2v_ckpt", "cogvideox",
                                   "cogvideox_i2v", "cogvideox_ckpt", "flux",
                                   "flux_ckpt", "eval_hunyuan", "eval_flux")
                 if not p1_paths[path]]
    unplanned += [path for path, c in p1_paths.items()
                  if path.startswith("scan_") and not c]
    if unplanned:
        raise AssertionError(f"sparse pipeline paths without a P1 launch: "
                             f"{unplanned} ({p1_paths})")
    p1 = psel["hunyuan"]
    line = {"kernels": [
        {"name": "K1", "route": "cuda", "source": src,
         "replaces": "rectified_spaattn_tpu/kernels/block_sparse.py:89",
         "launches": sum(by_path("K1").values()),
         "launches_by_path": by_path("K1"),
         "max_abs_err": max(errs["K1"], errs["K1_d64"], k1t["max_abs_err"]),
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
                        "wan_dense_bm1024": wsite["K1_wan_dense_bm1024"],
                        **joint_jobs("K1", csites),
                        **joint_jobs("K1", fsites, "flux")}},
        {"name": "K2", "route": "cuda", "source": src,
         "replaces": "rectified_spaattn_tpu/kernels/block_sparse.py:317",
         "launches": sum(by_path("K2").values()),
         "launches_by_path": by_path("K2"),
         "max_abs_err": max(errs["K2"], errs["K2_d64"], k2["max_abs_err"],
                            site["K2_visual_g4"]["max_abs_err"]),
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None,
         "shape": "visual rows: q [1,24,115200,128], G=2 union lists",
         "design": design + ", member slots of the union list only",
         "kernel_ab": ab_of("K2_visual_g2"),
         "other_jobs": {"visual_rows_g2_smooth": smooth["K2_visual_g2"],
                        "visual_rows_g4": site["K2_visual_g4"],
                        "visual_rows_g4_smooth": smooth["K2_visual_g4"],
                        **joint_jobs("K2", csites),
                        **joint_jobs("K2", fsites, "flux")}},
        {"name": "K3", "route": "cuda",
         "source": "rectified_spaattn_tpu_torch/csrc/dense_flash.cu",
         "replaces": "rectified_spaattn_tpu/kernels/flash.py:49",
         "launches": sum(by_path("K3").values()),
         "launches_by_path": by_path("K3"),
         "max_abs_err": max(errs["K3"], k3["max_abs_err"],
                            k3i["max_abs_err"]),
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": k3["library_ms"],
         "shape": "Wan T2V text cross: q [1,40,75648,128] x 512 keys",
         "design": design + ", persistent CTAs",
         "kernel_ab": ab_of("K3_t2v_text", "K3_i2v_image"),
         "other_jobs": {"i2v_image_cross_257": k3i,
                        **{f"flux_controlnet_self_66048_{r}":
                           fsites[r]["flux_K3_self"] for r in fsites}}},
        {"name": "K1q", "route": "cuda", "source": src,
         "replaces": "rectified_spaattn_tpu/kernels/block_sparse.py:176",
         "launches": (pipe8["launches"]["K1q_mxu8"]
                      + small4["launches"]["K1q_int8"]
                      + diag_k1q["K1q_int8"]),
         "launches_by_path": {
             "hunyuan_int8_pipeline_mxu8": pipe8["launches"]["K1q_mxu8"],
             "small_int4_pipeline_int8": small4["launches"]["K1q_int8"],
             "diag_grouped_k1q_int8": diag_k1q["K1q_int8"]},
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
         "launches": sum(by_path("K1_merge").values()),
         "launches_by_path": by_path("K1_merge"),
         "max_abs_err": merge["max_abs_err"], "ms": merge["ms"],
         "plain_ms": merge["plain_ms"], "bound_ms": merge["bound_ms"],
         "bound_by": merge["bound_by"], "library_ms": None,
         "shape": f"{merge['n_split']} ranges x 6,144 rows x 128 (the "
                  "Hunyuan text rows' split)",
         "design": "one warp a row",
         "other_jobs": {**joint_jobs("K1_merge", csites),
                        **joint_jobs("K1_merge", fsites, "flux")}},
        {"name": "P1", "route": "cuda",
         "source": "rectified_spaattn_tpu_torch/csrc/plan_select.cu",
         "replaces": "none (new on the port): "
                     "rectified_spaattn_tpu/sparse/ops.py:146 "
                     "topp_threshold_onehot_bisect, XLA operations",
         "launches": sum(p1_paths.values()),
         "launches_by_path": p1_paths,
         "rows_apart": sum(r["rows_apart"] for r in psel.values()),
         "max_cut_gap": max(r["max_cut_gap"] for r in psel.values()),
         "ms": p1["ms"], "host_paced_ms": p1["host_paced_ms"],
         "plain_ms": p1["plain_ms"], "bound_ms": p1["bound_ms"],
         "bound_by": p1["bound_by"], "library_ms": None,
         "shape": "HunyuanVideo's probs [1,24,900,901] fp32",
         "design": "one warp a row in registers (one 16-warp CTA a row "
                   "past 2,048 columns), fixed-order fp32 mass, bounds "
                   "snapped to the row's values",
         "other_jobs": {n: r for n, r in psel.items() if n != "hunyuan"}},
        k1q_stats_entry(src, site, smooth, qserrs),
        *variant_entries(s3, s2, ptxas["sass"]),
        *fp32_entries(f32errs, f32site, f32res, f32pipes, f32full),
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
