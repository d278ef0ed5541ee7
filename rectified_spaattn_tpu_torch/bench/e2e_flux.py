"""End-to-end Flux.1-dev step at 4096^2 and full width, sparse against
dense (port of scripts/bench_e2e_flux.py:65-163).

The 4096^2 stage is the workload that matters: 65,536 visual tokens +
512 text, hidden 3072 / 24 heads, at a depth slice of the 19 + 38 model
(a step's cost is linear in depth).  A slice runs every block sparse (the
gate past the last block); at the full ``--dual 19 --single 38`` the
reference's own gate, the dense band [37, 57), applies.

    python -m rectified_spaattn_tpu_torch.bench.e2e_flux --dual 4 --single 8
    python -m rectified_spaattn_tpu_torch.bench.e2e_flux --device cpu --small

Each mode builds its pipeline over the one model, runs a one-step warm-up
and times ``--steps`` steps (``pipe.denoise_seconds``); ``--teacache``
times sparse + TeaCache at rel-L1 0.8.  Prints ONE JSON line with the
quantities the script logs.  ``--small`` (a CPU rehearsal of the plain
versions) cuts the model to one head of 128 and 1 + 1 blocks, the image
to 512^2 and the steps to 1.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..cache import teacache as tc_mod
from ..models import FluxConfig, FluxDiT, quantized_nbytes
from ..pipelines import FluxPipeline
from .common import device_info, mode_list, resolve
from .e2e_weights import n_params, random_model, random_text

SMALL = dict(hidden_dim=128, heads=1)
SMALL_SHAPE = dict(dual=1, single=1, size=512, steps=1)


def run(*, dual: int = 4, single: int = 8, steps: int = 2, size: int = 4096,
        sa_drop_rate: float = 0.9, p_remain: float = 0.05,
        modes: str = "sparse,flash", teacache: bool = False, trace_out=None,
        scan_blocks: bool = False, quant: int = 0, small: bool = False,
        device="cuda", latents_out=None) -> dict:
    """The bench's line as a dict (module docstring).  ``latents_out``, a
    dict, receives each timed run's final latents by mode ("teacache" for
    the TeaCache tier)."""
    dev = resolve(device)
    if small:
        dual, single, size, steps = (SMALL_SHAPE[k] for k in
                                     ("dual", "single", "size", "steps"))
    cfg = FluxConfig(num_dual_blocks=dual, num_single_blocks=single,
                     **(SMALL if small else {}))
    model = random_model(FluxDiT, cfg, quant, device=dev)
    n = n_params(FluxDiT, cfg)
    depth = dual + single
    # at full depth the reference's gate (the dense band [37, 57)); a
    # slice runs every block sparse
    full_depth = (dual, single) == (19, 38)
    gate = FluxPipeline.sparse_layer_gate if full_depth \
        else (depth + 1, depth + 1)
    out = {"bench": "e2e_flux", "model": "flux.1-dev",
           "blocks": [dual, single], "size": size, "tokens": None,
           "params": n, "params_gb_bf16": n * 2 / 1e9,
           "resident_gb": quantized_nbytes(model) / 1e9, "quant": quant,
           "steps": steps, "p_remain": p_remain,
           "sa_drop_rate": sa_drop_rate, "gate": list(gate),
           "scan_blocks": scan_blocks, "modes": {}}
    text = random_text((1, 512, cfg.text_dim), 0, dev)
    mask = torch.ones((1, 512), dtype=torch.bool, device=dev)
    pooled = random_text((1, cfg.pooled_dim), 1, dev)
    common = dict(height=size, width=size, num_steps=steps,
                  sa_drop_rate=sa_drop_rate, p_remain_rates=p_remain,
                  sparse_layer_gate=gate, scan_blocks=scan_blocks,
                  device=dev)
    results = {}
    for mode in mode_list(modes):
        pipe = FluxPipeline(model=model, mode=mode, **common)
        out["tokens"] = pipe.site.visual_len + pipe.text_len
        pipe(text, mask, pooled, seed=1, num_steps=1)          # warm-up
        lat = pipe(text, mask, pooled, seed=1)
        per_step = pipe.denoise_seconds / steps
        results[mode] = per_step
        out["modes"][mode] = {
            "s_per_step": per_step,
            "extrapolated_57_block_28_step_s": per_step * 57 / depth * 28}
        if latents_out is not None:
            latents_out[mode] = lat
        del pipe, lat
    if "sparse" in results and "flash" in results:
        out["speedup"] = results["flash"] / results["sparse"]

    if teacache:
        pipe = FluxPipeline(model=model, mode="sparse", enable_teacache=True,
                            rel_l1_thresh=0.8, **common)
        pipe(text, mask, pooled, seed=1, num_steps=1)
        n_steps = max(steps, 6)
        with tc_mod.trace_to(trace_out):  # enabled after the warm-up
            lat = pipe(text, mask, pooled, seed=1, num_steps=n_steps)
        if latents_out is not None:
            latents_out["teacache"] = lat
        st = pipe.teacache_stats
        tea = {"steps": n_steps, "s_per_step": pipe.denoise_seconds / n_steps,
               "skipped": st["skipped"],
               "calls": st["skipped"] + st["computed"],
               "trace_out": trace_out}
        if "sparse" in results and "flash" in results and st["skipped"]:
            t_c = results["sparse"]
            t_s = max((pipe.denoise_seconds - st["computed"] * t_c)
                      / st["skipped"], 0)
            tea["compute_s"], tea["skip_s"] = t_c, t_s
            tea["at_skip_rate"] = {}
            # the reference's caching factor 4.15 / 1.60: ~61 % step skips
            for frac in (0.5, 0.61):
                t_step = (1 - frac) * t_c + frac * t_s
                tea["at_skip_rate"][str(frac)] = {
                    "s_per_step": t_step,
                    "speedup_vs_dense": results["flash"] / t_step}
        out["teacache"] = tea
    out.update(device_info(dev))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dual", type=int, default=4)
    ap.add_argument("--single", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--sa_drop_rate", type=float, default=0.9)
    ap.add_argument("--p_remain", type=float, default=0.05)
    ap.add_argument("--modes", type=str, default="sparse,flash")
    ap.add_argument("--teacache", action="store_true")
    ap.add_argument("--trace_out", type=str, default=None,
                    help="write the TeaCache run's schedule trace as JSON")
    ap.add_argument("--scan_blocks", action="store_true",
                    help="stacked block execution (models/scan.py)")
    ap.add_argument("--quant", type=int, default=0, choices=(0, 4, 8))
    ap.add_argument("--small", action="store_true",
                    help="1 head of 128, 1 + 1 blocks, 512^2, 1 step (a CPU "
                         "rehearsal)")
    ap.add_argument("--device", default="cuda")
    line = run(**vars(ap.parse_args(argv)))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
