"""End-to-end CogVideoX1.5-5B step at full depth and width, sparse against
dense (port of scripts/bench_e2e_cog.py:48-148).

At 768 x 1280 x 81 (23,040 visual tokens + the 256-slot text tail) the
whole 42-block, hidden-3072 model fits one card, so nothing is cut: this
is the complete model, with random bf16 weights (one ``default_rng(0)
.normal`` draw a leaf, as the script draws them).  DDIM + dynamic CFG (two
transformer calls a step); the sparse warm calls are zeroed for the
timing window (the reference keeps the first 5 of 50 steps dense).
``--i2v``: the image latents concatenated onto the noise channels of an
in_channels-32 model, sa_drop_rate 0.75.

    python -m rectified_spaattn_tpu_torch.bench.e2e_cog --steps 2
    python -m rectified_spaattn_tpu_torch.bench.e2e_cog --device cpu --small

Each mode builds its pipeline over the one model, runs a one-step warm-up
and times ``--steps`` steps (``pipe.denoise_seconds``); ``--teacache``
times sparse + TeaCache at thresh 0.2.  Prints ONE JSON line with the
quantities the script logs.  ``--small`` (a CPU rehearsal of the plain
versions) cuts the model to 2 heads of 64 and 2 blocks, the video to 128
x 256 x 17 and the steps to 1.
"""

from __future__ import annotations

import argparse
import json

from ..cache import teacache as tc_mod
from ..models import CogVideoXConfig, CogVideoXDiT
from ..pipelines import CogVideoXPipeline
from .common import device_info, mode_list, resolve
from .e2e_weights import n_params, random_normal_model, random_text

SMALL = dict(hidden_dim=128, heads=2, num_blocks=2)
SMALL_VIDEO = (128, 256, 17)


def cog_config(i2v: bool = False, small: bool = False) -> CogVideoXConfig:
    """The script's CogVideoXConfig: the full 1.5-5B shape, in_channels 32
    ([noise | image]) for I2V; ``small`` cuts the width and depth."""
    return CogVideoXConfig(in_channels=32 if i2v else 16,
                           **(SMALL if small else {}))


def random_model(cfg: CogVideoXConfig, device="cuda") -> CogVideoXDiT:
    """The script's random bf16 model: one ``default_rng(0).normal`` draw a
    leaf, each placed on ``device`` as it is drawn."""
    return random_normal_model(CogVideoXDiT, cfg, device=device)


def run(*, steps: int = 2, height: int = 768, width: int = 1280,
        frame: int = 81, sa_drop_rate: float = 0.85, p_remain: float = 0.05,
        modes: str = "sparse,flash", teacache: bool = False, trace_out=None,
        i2v: bool = False, small: bool = False, device="cuda",
        latents_out=None) -> dict:
    """The bench's line as a dict (module docstring).  ``latents_out``, a
    dict, receives each timed run's final latents by mode ("teacache" for
    the TeaCache tier)."""
    dev = resolve(device)
    if small:
        height, width, frame = SMALL_VIDEO
        steps = 1
    cfg = cog_config(i2v, small)
    if i2v:
        sa_drop_rate = 0.75                     # the reference's i2v default
    model = random_model(cfg, dev)
    n = n_params(CogVideoXDiT, cfg)
    out = {"bench": "e2e_cog", "model": "cogvideox1.5-5b",
           "variant": "i2v" if i2v else "t2v", "blocks": cfg.num_blocks,
           "tokens": None, "params": n, "params_gb_bf16": n * 2 / 1e9,
           "steps": steps, "p_remain": p_remain,
           "sa_drop_rate": sa_drop_rate, "modes": {}}
    text = random_text((1, 226, cfg.text_dim), 0, dev)
    neg = random_text((1, 226, cfg.text_dim), 1, dev)
    common = dict(height=height, width=width, frames=frame, num_steps=steps,
                  sa_drop_rate=sa_drop_rate, p_remain_rates=p_remain,
                  sparse_warm_calls=0, device=dev)
    condition = None
    if i2v:
        grid = CogVideoXPipeline(model=model, mode="sparse", **common).grid
        condition = random_text((1, 16, *grid), 3, dev)
    results = {}
    for mode in mode_list(modes):
        pipe = CogVideoXPipeline(model=model, mode=mode, **common)
        out["tokens"] = pipe.site.visual_len + pipe.text_len
        pipe(text, neg, condition=condition, seed=1, num_steps=1)  # warm-up
        lat = pipe(text, neg, condition=condition, seed=1)
        per_step = pipe.denoise_seconds / steps
        results[mode] = per_step
        out["modes"][mode] = {"s_per_step": per_step,
                              "full_50_step_s": per_step * 50}
        if latents_out is not None:
            latents_out[mode] = lat
        del pipe, lat
    if "sparse" in results and "flash" in results:
        out["speedup"] = results["flash"] / results["sparse"]

    if teacache:
        pipe = CogVideoXPipeline(model=model, mode="sparse",
                                 enable_teacache=True, teacache_thresh=0.2,
                                 **common)
        pipe(text, neg, condition=condition, seed=1, num_steps=1)
        n_steps = max(steps, 6)
        with tc_mod.trace_to(trace_out):  # enabled after the warm-up
            lat = pipe(text, neg, condition=condition, seed=1,
                       num_steps=n_steps)
        if latents_out is not None:
            latents_out["teacache"] = lat
        st = pipe.teacache_stats
        tea = {"steps": n_steps, "s_per_step": pipe.denoise_seconds / n_steps,
               "skipped": st["skipped"],
               "calls": st["skipped"] + st["computed"],
               "trace_out": trace_out}
        if "sparse" in results and "flash" in results and st["skipped"]:
            t_call = results["sparse"] / 2
            t_skip = max((pipe.denoise_seconds - st["computed"] * t_call)
                         / st["skipped"], 0)
            tea["call_s"], tea["skip_call_s"] = t_call, t_skip
            tea["at_call_skip_rate"] = {}
            # the reference's caching factor 2.97 / 1.76: ~57 % call skips
            for frac in (0.5, 0.57):
                t_step = 2 * ((1 - frac) * t_call + frac * t_skip)
                tea["at_call_skip_rate"][str(frac)] = {
                    "s_per_step": t_step,
                    "speedup_vs_dense": results["flash"] / t_step}
        out["teacache"] = tea
    out.update(device_info(dev))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--height", type=int, default=768)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--frame", type=int, default=81)
    ap.add_argument("--sa_drop_rate", type=float, default=0.85)
    ap.add_argument("--p_remain", type=float, default=0.05)
    ap.add_argument("--modes", type=str, default="sparse,flash")
    ap.add_argument("--teacache", action="store_true")
    ap.add_argument("--trace_out", type=str, default=None,
                    help="write the TeaCache run's schedule trace as JSON")
    ap.add_argument("--i2v", action="store_true",
                    help="I2V: image latents concatenated onto an "
                         "in_channels-32 model")
    ap.add_argument("--small", action="store_true",
                    help="2 heads of 64, 2 blocks, 128 x 256 x 17, 1 step "
                         "(a CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    line = run(**vars(ap.parse_args(argv)))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
