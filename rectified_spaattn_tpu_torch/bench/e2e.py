"""End-to-end HunyuanVideo step, sparse against dense (port of
scripts/bench_e2e.py:160-386).

The published token count (720p x 128 frames: 115,200 visual + 256 text
tokens) and width (hidden 3072, 24 heads x 128) at a configurable depth:
the whole layer mix (attention, MLP, plan build, rectification) a
denoise step, not the attention alone.  Depth is the only axis cut; the
full model is ``--dual 20 --single 40``, which with ``--quant 4
--scan_blocks`` fits one card.

    python -m rectified_spaattn_tpu_torch.bench.e2e --dual 20 --single 40 \\
        --scan_blocks --quant 4 --p_remain 0.05 --steps 1
    python -m rectified_spaattn_tpu_torch.bench.e2e --device cpu --small

Each mode of ``--modes`` builds its pipeline over the one model, runs one
warm-up step (the curve cache, the kernels' first launches), then times
``--steps`` steps from smooth initial latents (``pipe.denoise_seconds``,
bounded by device syncs).  ``--teacache`` / ``--replay_trace`` time the
sparse + TeaCache tier after a warm-up that runs both branches.  Prints
ONE JSON line with the quantities the script logs: seconds a step per
mode with the 60-block 50-step extrapolation, the executed mask density
(``--density``), the dense / sparse ratio, the TeaCache tier's seconds a
step, skips and its projections at the reference's skip rates.
``--small`` (a CPU rehearsal of the plain versions) cuts the width to
one head of 128 and the video to 128 x 256 x 16.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..cache import schedule_from_trace
from ..cache import teacache as tc_mod
from ..models import HunyuanVideoConfig, HunyuanVideoDiT, quantized_nbytes
from ..pipelines import HunyuanVideoPipeline
from .common import density_stats, device_info, mode_list, resolve
from .e2e_weights import n_params, random_model, random_text, smooth_latents

SMALL = dict(hidden=128, dual=1, single=1, height=128, width=256, frame=16,
             steps=1)


def run(*, dual: int = 6, single: int = 12, steps: int = 3,
        height: int = 720, width: int = 1280, frame: int = 128,
        sa_drop_rate: float = 0.8, hidden: int = 3072,
        modes: str = "sparse,flash", p_remain: float = 0.3,
        teacache: bool = False, teacache_thresh: float = 0.15,
        teacache_residual: str = "bf16", teacache_offload: bool = False,
        replay_trace=None, density: bool = False, tea_steps: int = 0,
        trace_out=None, dense_ref=None, scan_blocks: bool = False,
        mlp_chunk: int = 1, quant: int = 0, group_rows: int = 1,
        head_chunk: int = 0, kv_pack: bool = False, plan_row_chunk: int = 0,
        signal_stride: int = 1, dispatch_segments: int = 1,
        small: bool = False, device="cuda", latents_out=None) -> dict:
    """The bench's line as a dict (module docstring).  ``latents_out``, a
    dict, receives each timed run's final latents by mode ("teacache" for
    the TeaCache tier)."""
    if small:
        hidden, dual, single, height, width, frame, steps = (
            SMALL[k] for k in ("hidden", "dual", "single", "height", "width",
                               "frame", "steps"))
    dev = resolve(device)
    cfg = HunyuanVideoConfig(
        hidden_dim=hidden, heads=hidden // 128, num_dual_blocks=dual,
        num_single_blocks=single, text_dim=1024, pooled_dim=256,
        num_refiner_blocks=1, mlp_chunk=mlp_chunk)
    model = random_model(HunyuanVideoDiT, cfg, quant, device=dev)
    n = n_params(HunyuanVideoDiT, cfg)
    out = {"bench": "e2e", "model": "hunyuan",
           "blocks": [dual, single], "tokens": None, "params": n,
           "params_gb_bf16": n * 2 / 1e9,
           "resident_gb": quantized_nbytes(model) / 1e9, "quant": quant,
           "steps": steps, "p_remain": p_remain,
           "sa_drop_rate": sa_drop_rate, "group_rows": group_rows,
           "scan_blocks": scan_blocks, "modes": {}}

    text = random_text((1, 256, cfg.text_dim), 0, dev)
    mask = torch.zeros((1, 256), dtype=torch.bool, device=dev)
    mask[:, :40] = True
    t_lat = (frame - 1) // 4 + 1
    init = smooth_latents(cfg.in_channels, t_lat, height // 8, width // 8,
                          device=dev)
    common = dict(model=model, height=height, width=width, frames=frame,
                  num_steps=steps, sa_drop_rate=sa_drop_rate,
                  p_remain_rates=p_remain, scan_blocks=scan_blocks,
                  dispatch_segments=dispatch_segments,
                  plan_row_chunk=plan_row_chunk, kv_pack=kv_pack,
                  head_chunk=head_chunk, group_rows=group_rows,
                  teacache_signal_stride=signal_stride, device=dev)
    depth = dual + single
    results = {}
    for mode in mode_list(modes):
        pipe = HunyuanVideoPipeline(
            mode=mode, density_probe=density and mode == "sparse", **common)
        out["tokens"] = pipe.site.visual_len + pipe.text_len
        pipe(text, mask, seed=1, num_steps=1, init_latents=init)   # warm-up
        lat = pipe(text, mask, seed=1, init_latents=init)
        per_step = pipe.denoise_seconds / steps
        results[mode] = per_step
        out["modes"][mode] = {
            "s_per_step": per_step,
            "extrapolated_60_block_50_step_s": per_step * 60 / depth * 50,
            "density": density_stats(pipe.density_samples)}
        if latents_out is not None:
            latents_out[mode] = lat
        del pipe, lat
    if "sparse" in results and "flash" in results:
        out["speedup"] = results["flash"] / results["sparse"]

    if teacache or replay_trace:
        out["teacache"] = _teacache_tier(
            common, text, mask, init, results, steps=steps,
            teacache=teacache, thresh=teacache_thresh,
            residual=teacache_residual, offload=teacache_offload,
            replay_trace=replay_trace, density=density,
            tea_steps=tea_steps, trace_out=trace_out, dense_ref=dense_ref,
            latents_out=latents_out)
    out.update(device_info(dev))
    return out


def _teacache_tier(common, text, mask, init, results, *, steps, teacache,
                   thresh, residual, offload, replay_trace, density,
                   tea_steps, trace_out, dense_ref, latents_out) -> dict:
    """bench_e2e.py:322-383: the sparse + TeaCache run, organic or replayed,
    and its split into compute and skip steps."""
    schedule = schedule_from_trace(replay_trace) if replay_trace else None
    pipe = HunyuanVideoPipeline(
        mode="sparse", enable_teacache=teacache, rel_l1_thresh=thresh,
        teacache_residual=residual, teacache_offload=offload,
        teacache_schedule=schedule, density_probe=density, **common)
    # the warm-up runs both branches (compute, then apply_residual)
    pipe.teacache_schedule = [True, False]
    pipe(text, mask, seed=1, num_steps=2, init_latents=init)
    pipe.teacache_schedule = schedule
    n = tea_steps or max(steps, 6)
    with tc_mod.trace_to(trace_out):      # enabled after the warm-up
        lat = pipe(text, mask, seed=1, num_steps=n, init_latents=init)
    if latents_out is not None:
        latents_out["teacache"] = lat
    per_step = pipe.denoise_seconds / n
    st = pipe.teacache_stats
    skipped, computed = st["skipped"], st["computed"]
    res = {"tag": "replay" if schedule is not None else f"thresh={thresh}",
           "residual": residual, "offload": offload, "steps": n,
           "s_per_step": per_step, "skipped": skipped,
           "calls": skipped + computed,
           "density": density_stats(pipe.density_samples),
           "trace_out": trace_out}
    if schedule is not None:
        res["replayed"] = {"compute": sum(schedule),
                           "skip": len(schedule) - sum(schedule)}
    results = dict(results)
    if dense_ref is not None:
        results.setdefault("flash", dense_ref)
    if skipped:
        # the skip step's cost from the mix: total = c t_c + s t_s
        t_c = results.get("sparse", per_step * (skipped + computed)
                          / max(computed, 1))
        t_s = max((pipe.denoise_seconds - computed * t_c) / skipped, 0)
        res["compute_s"], res["skip_s"] = t_c, t_s
        dense = results.get("flash")
        res["at_skip_rate"] = {}
        for frac in (0.5, 0.54):
            t_tea = (1 - frac) * t_c + frac * t_s
            entry = {"s_per_step": t_tea}
            if dense is not None and "sparse" in results:
                entry["speedup_vs_dense"] = dense / t_tea
            res["at_skip_rate"][str(frac)] = entry
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dual", type=int, default=6)
    ap.add_argument("--single", type=int, default=12)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--frame", type=int, default=128)
    ap.add_argument("--sa_drop_rate", type=float, default=0.8)
    ap.add_argument("--hidden", type=int, default=3072)
    ap.add_argument("--modes", type=str, default="sparse,flash")
    ap.add_argument("--p_remain", type=float, default=0.3,
                    help="top-p mass threshold; 0.05 pins counts to the "
                         "top-k floor (random weights spread the mass)")
    ap.add_argument("--teacache", action="store_true",
                    help="also time the sparse + TeaCache tier")
    ap.add_argument("--teacache_thresh", type=float, default=0.15)
    ap.add_argument("--teacache_residual", type=str, default="bf16",
                    choices=("bf16", "int8"))
    ap.add_argument("--teacache_offload", action="store_true")
    ap.add_argument("--replay_trace", type=str, default=None,
                    help="replay a recorded TeaCache schedule")
    ap.add_argument("--density", action="store_true",
                    help="the executed mask density of every sparse step")
    ap.add_argument("--tea_steps", type=int, default=0,
                    help="steps of the TeaCache run (default max(--steps, "
                         "6))")
    ap.add_argument("--trace_out", type=str, default=None,
                    help="write the TeaCache run's schedule trace as JSON")
    ap.add_argument("--dense_ref", type=float, default=None,
                    help="dense s/step of an earlier run")
    ap.add_argument("--scan_blocks", action="store_true",
                    help="stacked block execution (models/scan.py)")
    ap.add_argument("--mlp_chunk", type=int, default=1)
    ap.add_argument("--quant", type=int, default=0, choices=(0, 4, 8))
    ap.add_argument("--group_rows", type=int, default=1)
    ap.add_argument("--head_chunk", type=int, default=0)
    ap.add_argument("--kv_pack", action="store_true")
    ap.add_argument("--plan_row_chunk", type=int, default=0)
    ap.add_argument("--signal_stride", type=int, default=1)
    ap.add_argument("--dispatch_segments", type=int, default=1)
    ap.add_argument("--small", action="store_true",
                    help="1 head of 128, 1 + 1 blocks, 128 x 256 x 16, 1 "
                         "step (a CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    line = run(**vars(ap.parse_args(argv)))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
