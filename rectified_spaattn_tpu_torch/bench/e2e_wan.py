"""End-to-end Wan step at full width, sparse against dense (port of
scripts/bench_e2e_wan.py:80-497).

Wan2.1-T2V-14B by default: hidden 5120 / 40 heads, the published 720p x
81-frame token count (75,600 visual + 512 cross-attention text tokens),
UniPC + CFG (two transformer calls a step), random bf16 weights at a
configurable depth.  ``--i2v`` is Wan2.1-I2V (in_channels 36, the CLIP
image cross-attention), ``--ti2v`` Wan2.2-TI2V-5B's shape (hidden 3072,
704 x 1280 x 121, VAE stride 32), ``--a14b`` Wan2.2 A14B's two
transformers routed at the boundary step (``--share_tree``: one tree for
both, timing only; ``--host_swap``: both trees on the host, the low-noise
one swapped in at the boundary).  The warm gates are zeroed for the
timing slice (the reference keeps 2 of 40 layers and the first 10 calls
dense, which at an 8-block slice would weigh the dense share 5x).

    python -m rectified_spaattn_tpu_torch.bench.e2e_wan --blocks 8 --steps 2
    python -m rectified_spaattn_tpu_torch.bench.e2e_wan --blocks 8 \\
        --modes "" --teacache --signal_scale 0.0979
    python -m rectified_spaattn_tpu_torch.bench.e2e_wan --device cpu --small

Each mode builds its pipeline over the one model, runs a one-step warm-up
and times ``--steps`` steps (``pipe.denoise_seconds``); A14B runs at
least 8 steps, so that both transformers run.  ``--teacache`` times the
sparse + TeaCache tier (thresh 0.2, ``use_ret_steps``, the raw signal
times ``--signal_scale``; A14B thresh 0.2, I2V 0.3) after a warm-up that
runs both branches.  Prints ONE JSON line with the quantities the script
logs.  ``--small`` (a CPU rehearsal of the plain versions) cuts the width
to one head of 128, the depth to 2 blocks, the steps to 1 and the video
to 128 x 256 x 13 (TI2V 256 x 512 x 13).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..cache import schedule_from_trace
from ..cache import teacache as tc_mod
from ..models import WanConfig, WanDiT, quantized_nbytes
from ..pipelines import Wan22A14BPipeline, WanPipeline
from .common import density_stats, device_info, mode_list, resolve
from .e2e_weights import n_params, random_model, random_text, weight_dtype

SMALL = dict(hidden_dim=128, heads=1, ffn_dim=256)
SMALL_DEPTH = (2, 1)              # blocks, steps
SMALL_VIDEO = (128, 256, 13)
SMALL_TI2V_VIDEO = (256, 512, 13)


def wan_config(blocks: int, mlp_chunk: int = 1, i2v: bool = False,
               a14b: bool = False, ti2v: bool = False, small: bool = False):
    """The script's WanConfig for the chosen variant and its VAE stride."""
    width = dict(SMALL) if small else {}
    if ti2v:
        if not small:
            width = dict(hidden_dim=3072, heads=24, ffn_dim=14336)
        cfg = WanConfig(in_channels=48, out_channels=48, head_dim=128,
                        num_blocks=blocks, mlp_chunk=mlp_chunk, **width)
        return cfg, (4, 32, 32)
    if i2v:
        # Wan2.2 I2V-A14B: conditioned latents without the CLIP branch
        cfg = WanConfig(in_channels=36, num_blocks=blocks,
                        image_cross=not a14b, mlp_chunk=mlp_chunk, **width)
    else:
        cfg = WanConfig(num_blocks=blocks, mlp_chunk=mlp_chunk, **width)
    return cfg, (4, 16, 16)


def run(*, blocks: int = 8, steps: int = 2, height: int = 720,
        width: int = 1280, frame: int = 81, sa_drop_rate: float = 0.75,
        p_remain: float = 0.05, modes: str = "sparse,flash", trace_out=None,
        teacache: bool = False, teacache_residual: str = "bf16",
        teacache_offload: bool = False, replay_trace=None,
        density: bool = False, a14b: bool = False, i2v: bool = False,
        ti2v: bool = False, scan_blocks: bool = False, group_rows: int = 1,
        plan_row_chunk: int = 0, head_chunk: int = 0, kv_pack: bool = False,
        mlp_chunk: int = 1, quant: int = 0, signal_scale: float = 1.0,
        tea_steps: int = 0, dispatch_segments: int = 1,
        share_tree: bool = False, host_swap: bool = False,
        small: bool = False, device="cuda", latents_out=None) -> dict:
    """The bench's line as a dict (module docstring).  ``latents_out``, a
    dict, receives each timed run's final latents by mode ("teacache" for
    the TeaCache tier)."""
    if share_tree and host_swap:
        raise ValueError("--share_tree and --host_swap do not compose: "
                         "host_swap moves each tree off the card in turn")
    dev = resolve(device)
    if small:
        blocks, steps = SMALL_DEPTH
    cfg, vae_stride = wan_config(blocks, mlp_chunk, i2v, a14b, ti2v, small)
    if ti2v:
        height, width, frame = SMALL_TI2V_VIDEO if small else (704, 1280,
                                                               121)
    elif small:
        height, width, frame = SMALL_VIDEO
    # host_swap keeps both trees on the host, in the card's dtype
    where = "cpu" if host_swap else dev
    model = random_model(WanDiT, cfg, quant, seed=0, device=where,
                         dtype=weight_dtype(dev))
    n = n_params(WanDiT, cfg)
    out = {"bench": "e2e_wan",
           "model": ("wan2.2-ti2v" if ti2v else "wan2.2-a14b" if a14b
                     else "wan2.1-i2v" if i2v else "wan2.1-t2v"),
           "variant": "i2v" if i2v else "t2v",
           "blocks": blocks, "tokens": None, "params": n,
           "params_gb_bf16": n * 2 / 1e9,
           "resident_gb": quantized_nbytes(model) / 1e9, "quant": quant,
           "steps": steps, "p_remain": p_remain,
           "sa_drop_rate": sa_drop_rate, "group_rows": group_rows,
           "scan_blocks": scan_blocks, "modes": {}}
    text = random_text((1, 512, cfg.text_dim), 0, dev)
    neg = random_text((1, 512, cfg.text_dim), 1, dev)
    common = dict(height=height, width=width, frames=frame, num_steps=steps,
                  sa_drop_rate=sa_drop_rate, p_remain_rates=p_remain,
                  warm_layers=0, warm_calls=0, vae_stride=vae_stride,
                  scan_blocks=scan_blocks,
                  dispatch_segments=dispatch_segments, group_rows=group_rows,
                  plan_row_chunk=plan_row_chunk, kv_pack=kv_pack,
                  head_chunk=head_chunk, device=dev)
    if a14b:
        model2 = model if share_tree else random_model(
            WanDiT, cfg, quant, seed=1, device=where,
            dtype=weight_dtype(dev))
        out.update(_a14b(model, model2, cfg, common, text, neg, out,
                         modes=modes, steps=steps, i2v=i2v,
                         host_swap=host_swap, teacache=teacache,
                         replay_trace=replay_trace, tea_steps=tea_steps,
                         residual=teacache_residual,
                         offload=teacache_offload, trace_out=trace_out,
                         latents_out=latents_out))
        out.update(device_info(dev))
        return out

    image_emb = condition = None
    if i2v:
        image_emb = random_text((1, 257, cfg.image_dim), 2, dev)
        grid = WanPipeline(model=model, mode="sparse", **common).grid
        condition = random_text((1, 20, *grid), 3, dev)
    inputs = dict(image_emb=image_emb, condition=condition)
    full_blocks = 30 if ti2v else 40
    results = {}
    for mode in mode_list(modes):
        pipe = WanPipeline(model=model, mode=mode,
                           density_probe=density and mode == "sparse",
                           **common)
        out["tokens"] = pipe.site.visual_len + 512
        pipe(text, neg, seed=1, num_steps=1, **inputs)       # warm-up
        lat = pipe(text, neg, seed=1, **inputs)
        per_step = pipe.denoise_seconds / steps
        results[mode] = per_step
        out["modes"][mode] = {
            "s_per_step": per_step,
            f"extrapolated_{full_blocks}_block_50_step_s":
                per_step * full_blocks / blocks * 50,
            "density": density_stats(pipe.density_samples)}
        if latents_out is not None:
            latents_out[mode] = lat
        del pipe, lat
    if "sparse" in results and "flash" in results:
        out["speedup"] = results["flash"] / results["sparse"]

    if teacache or replay_trace:
        schedule = schedule_from_trace(replay_trace) if replay_trace \
            else None
        pipe = WanPipeline(
            model=model, mode="sparse", enable_teacache=teacache,
            teacache_thresh=0.2, use_ret_steps=True,
            teacache_signal_scale=signal_scale,
            teacache_residual=teacache_residual,
            teacache_offload=teacache_offload, teacache_schedule=schedule,
            density_probe=density, **common)
        out["tokens"] = pipe.site.visual_len + 512
        # the warm-up runs both branches (compute, then apply_residual)
        pipe.teacache_schedule = [True, True, False, False]
        pipe(text, neg, seed=1, num_steps=2, **inputs)
        pipe.teacache_schedule = schedule
        n_steps = tea_steps or max(steps, 6)
        with tc_mod.trace_to(trace_out):  # enabled after the warm-up
            lat = pipe(text, neg, seed=1, num_steps=n_steps, **inputs)
        if latents_out is not None:
            latents_out["teacache"] = lat
        st = pipe.teacache_stats
        calls = st["skipped"] + st["computed"]
        tea = {"tag": "replay" if schedule is not None else "thresh=0.2",
               "residual": teacache_residual, "offload": teacache_offload,
               "signal_scale": signal_scale, "steps": n_steps,
               "s_per_step": pipe.denoise_seconds / n_steps,
               "skipped": st["skipped"], "calls": calls,
               "skip_share": st["skipped"] / calls,
               "density": density_stats(pipe.density_samples),
               "trace_out": trace_out}
        if schedule is not None:
            tea["replayed"] = {"compute": sum(schedule),
                               "skip": len(schedule) - sum(schedule)}
        if "sparse" in results and "flash" in results and st["skipped"]:
            t_call = results["sparse"] / 2          # a CFG call
            t_skip = max((pipe.denoise_seconds - st["computed"] * t_call)
                         / st["skipped"], 0)
            tea["call_s"], tea["skip_call_s"] = t_call, t_skip
            tea["at_call_skip_rate"] = {}
            for frac in (0.5, 0.68):
                t_step = 2 * ((1 - frac) * t_call + frac * t_skip)
                tea["at_call_skip_rate"][str(frac)] = {
                    "s_per_step": t_step,
                    "speedup_vs_dense": results["flash"] / t_step}
        out["teacache"] = tea
    out.update(device_info(dev))
    return out


def _a14b_inputs(pipe, cfg, i2v: bool, dev):
    """The A14B run's condition (I2V: [mask4 | first-frame latents]) and
    initial noise."""
    cond, noise_ch = None, cfg.in_channels
    if i2v:
        cond = random_text((1, 20, *pipe.high.grid), 4, dev)
        noise_ch = cfg.in_channels - 20
    return cond, random_text((1, noise_ch, *pipe.high.grid), 5, dev)


def _a14b(model, model2, cfg, common, text, neg, out, *, modes, steps, i2v,
          host_swap, teacache, replay_trace, tea_steps, residual, offload,
          trace_out, latents_out) -> dict:
    """bench_e2e_wan.py:232-425: Wan2.2 A14B, each mode over the same two
    pipelines (their ``mode`` set per run), then the TeaCache tier."""
    dev = common["device"]
    mk = lambda m: WanPipeline(model=m, mode="sparse",
                               defer_device=host_swap, **common)
    pipe = Wan22A14BPipeline(high=mk(model), low=mk(model2),
                             host_swap=host_swap)
    cond, lat0 = _a14b_inputs(pipe, cfg, i2v, dev)
    out["tokens"] = pipe.high.site.visual_len + 512
    res = {"modes": {}, "share_tree": model is model2,
           "host_swap": host_swap}
    # at least 8 steps, so that both transformers run (boundary 0.875)
    n = max(steps, 8)
    results = {}
    for mode in mode_list(modes):
        pipe.high.mode = pipe.low.mode = mode
        pipe.denoise(lat0, text, neg, condition=cond, num_steps=n)  # warm-up
        lat = pipe.denoise(lat0, text, neg, condition=cond, num_steps=n)
        per_step = pipe.denoise_seconds / n
        results[mode] = per_step
        entry = {"s_per_step": per_step, "steps": n}
        if host_swap:
            entry.update(swap_s=pipe.swap_seconds,
                         load_s=getattr(pipe, "load_seconds", 0.0),
                         s_per_step_excl_swap=(pipe.denoise_seconds
                                               - pipe.swap_seconds) / n)
        res["modes"][mode] = entry
        if latents_out is not None:
            latents_out[mode] = lat
    if "sparse" in results and "flash" in results:
        res["speedup"] = results["flash"] / results["sparse"]
    if not (teacache or replay_trace):
        return res

    thresh = 0.3 if i2v else 0.2
    schedule = None
    n_tea = max(tea_steps or steps, 8)
    if replay_trace:
        # A14B traces are joint: both transformers' CFG calls in order,
        # the high-noise stream's first
        schedule = schedule_from_trace(replay_trace)
        n_tea = len(schedule) // 2
    for p in (pipe.high, pipe.low):
        p.mode = "sparse"
        p.enable_teacache, p.teacache_thresh = teacache, thresh
        p.teacache_residual, p.teacache_offload = residual, offload
    tea = {"tag": "replay" if schedule is not None else f"thresh={thresh}",
           "residual": residual, "steps": n_tea}
    high_steps = None
    if schedule is not None:
        sched = pipe.high._scheduler(n_tea)
        boundary = pipe.boundary_ratio * pipe.num_train_timesteps
        high_steps = int(np.sum(np.asarray(sched.timesteps) >= boundary))
        tea["boundary_split"] = {
            "high_steps": high_steps,
            "high_computed": sum(schedule[:high_steps * 2]),
            "low_steps": n_tea - high_steps,
            "low_computed": sum(schedule[high_steps * 2:])}
    # the warm-up runs both transformers' compute branches and the skip
    # branch
    pipe.high.teacache_schedule = [True, True]
    pipe.low.teacache_schedule = [True, True, False, False]
    pipe.denoise(lat0, text, neg, condition=cond, num_steps=min(n_tea, 8))
    if schedule is not None:
        pipe.high.teacache_schedule = schedule[:high_steps * 2]
        pipe.low.teacache_schedule = schedule[high_steps * 2:]
    else:
        pipe.high.teacache_schedule = pipe.low.teacache_schedule = None
    with tc_mod.trace_to(trace_out) as trace:
        lat = pipe.denoise(lat0, text, neg, condition=cond,
                           num_steps=n_tea)
    if latents_out is not None:
        latents_out["teacache"] = lat
    st = pipe.teacache_stats
    skipped = st["high"]["skipped"] + st["low"]["skipped"]
    computed = st["high"]["computed"] + st["low"]["computed"]
    tea.update(s_per_step=pipe.denoise_seconds / n_tea, skipped=skipped,
               calls=skipped + computed, trace_out=trace_out)
    if trace is not None:
        calls = [r for r in trace if "call" in r]
        tea["trace_skipped"] = sum(not r["compute"] for r in calls)
        tea["trace_calls"] = len(calls)
    if host_swap:
        tea["swap_s"] = pipe.swap_seconds
        tea["s_per_step_excl_swap"] = (pipe.denoise_seconds
                                       - pipe.swap_seconds) / n_tea
    res["teacache"] = tea
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--frame", type=int, default=81)
    ap.add_argument("--sa_drop_rate", type=float, default=0.75)
    ap.add_argument("--p_remain", type=float, default=0.05)
    ap.add_argument("--modes", type=str, default="sparse,flash")
    ap.add_argument("--trace_out", type=str, default=None,
                    help="write the TeaCache run's schedule trace as JSON")
    ap.add_argument("--teacache", action="store_true",
                    help="also time sparse + TeaCache (CFG dual-stream, "
                         "use_ret_steps, thresh 0.2)")
    ap.add_argument("--teacache_residual", type=str, default="bf16",
                    choices=("bf16", "int8"))
    ap.add_argument("--teacache_offload", action="store_true")
    ap.add_argument("--replay_trace", type=str, default=None,
                    help="replay a recorded TeaCache schedule")
    ap.add_argument("--density", action="store_true")
    ap.add_argument("--a14b", action="store_true",
                    help="Wan2.2 A14B: two transformers, routed at the "
                         "boundary step")
    ap.add_argument("--i2v", action="store_true",
                    help="Wan2.1-I2V (in_channels 36, CLIP image cross)")
    ap.add_argument("--ti2v", action="store_true",
                    help="Wan2.2 TI2V-5B's shape at 704 x 1280 x 121")
    ap.add_argument("--scan_blocks", action="store_true")
    ap.add_argument("--group_rows", type=int, default=1)
    ap.add_argument("--plan_row_chunk", type=int, default=0)
    ap.add_argument("--head_chunk", type=int, default=0)
    ap.add_argument("--kv_pack", action="store_true")
    ap.add_argument("--mlp_chunk", type=int, default=1)
    ap.add_argument("--quant", type=int, default=0, choices=(0, 4, 8))
    ap.add_argument("--signal_scale", type=float, default=1.0,
                    help="TeaCache raw-signal multiplier (bench."
                         "calibrate_teacache; wan21-t2v ret: 0.0979)")
    ap.add_argument("--tea_steps", type=int, default=0)
    ap.add_argument("--dispatch_segments", type=int, default=1)
    ap.add_argument("--share_tree", action="store_true",
                    help="A14B: both transformers on one tree (timing "
                         "only)")
    ap.add_argument("--host_swap", action="store_true",
                    help="A14B: both trees on the host, the low-noise one "
                         "swapped onto the card at the boundary step")
    ap.add_argument("--small", action="store_true",
                    help="1 head of 128, 2 blocks, 128 x 256 x 13, 1 step "
                         "(a CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    line = run(**vars(ap.parse_args(argv)))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
