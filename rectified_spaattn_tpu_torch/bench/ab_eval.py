"""Dense-vs-sparse A/B of the HunyuanVideo pipeline (port of
scripts/ab_eval.py:24-90; the reference's workflow, eval/image/evaluation/
eval_image_diff.py: the same seed in two modes, then diff metrics).

The CLI's random-weight model at ``--scale`` runs once dense ("flash")
and once sparse on the same weights, text and seed; the final latents'
channel means, frame by frame, are compared as images (SSIM, PSNR,
cosine, relative L1, RMSE; eval/diff_metrics.py), beside each denoise
loop's seconds.  ``--smooth_init`` starts both from spatially low-pass
latents (e2e_weights.smooth_latents), where pooled attention is peaked.

    python -m rectified_spaattn_tpu_torch.bench.ab_eval [--num_steps 10]
    python -m rectified_spaattn_tpu_torch.bench.ab_eval --device cpu --small

The JAX script builds its CLI namespace by hand and misses attributes the
CLI's build_hunyuan reads (``dispatch_segments``, ``mlp_chunk``); this port starts
from the port CLI's defaults, as ``eval.run_eval`` does.  Prints ONE JSON
line with the script's keys (unrounded).  ``--small`` (a CPU rehearsal of
the plain versions) runs 256 x 256 x 16 for 2 steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from ..cli.generate import build_hunyuan, parse_args
from ..eval import evaluate_pair
from .common import device_info, resolve
from .e2e_weights import smooth_latents

SMALL = dict(height=256, width=256, frame=16, num_steps=2)


def frame_metrics(dense, sparse) -> dict:
    """The mean over frames of each diff metric of the latents [1, C, T,
    H, W] as images: per frame the channel mean, both scaled by the dense
    image's range (the sparse one clipped to [0, 1])."""
    d_img = dense[0].mean(dim=0)[..., None]
    s_img = sparse[0].mean(dim=0)[..., None]
    lo, hi = d_img.min(), d_img.max()
    d01 = (d_img - lo) / (hi - lo + 1e-8)
    s01 = ((s_img - lo) / (hi - lo + 1e-8)).clamp(0, 1)
    per = [evaluate_pair(s01[t], d01[t]) for t in range(d01.shape[0])]
    return {k: sum(m[k] for m in per) / len(per) for k in per[0]}


def run(*, height: int = 256, width: int = 256, frame: int = 16,
        num_steps: int = 10, sa_drop_rate: float = 0.8,
        p_remain_rates: float = 0.3, scale: float = 0.05, seed: int = 42,
        prompt: str = "several hot air balloons flying over a city.",
        smooth_init: bool = False, small: bool = False, device="cuda",
        latents_out=None) -> dict:
    """The A/B line as a dict (module docstring).  ``latents_out``, a dict,
    receives the "flash" and "sparse" final latents."""
    dev = resolve(device)
    if small:
        height, width, frame, num_steps = (
            SMALL[k] for k in ("height", "width", "frame", "num_steps"))
    args = parse_args(["--model", "hunyuan", "--device", str(dev)])
    for k, v in dict(height=height, width=width, frame=frame,
                     num_steps=num_steps, sa_drop_rate=sa_drop_rate,
                     p_remain_rates=p_remain_rates, scale=scale, seed=seed,
                     prompt=prompt, mode="flash", enable_teacache=False,
                     teacache_thresh=0.15).items():
        setattr(args, k, v)
    pipe_d, inputs, _ = build_hunyuan(args)
    init = None
    if smooth_init:
        init = smooth_latents(pipe_d.model.cfg.in_channels, *pipe_d.grid,
                              seed=seed, device=dev)
    dense = pipe_d(*inputs, seed=seed, init_latents=init)
    t_dense = pipe_d.denoise_seconds
    # the sparse pipeline over the same model (the script shares the
    # dense pipeline's params)
    pipe_s = dataclasses.replace(pipe_d, mode="sparse")
    sparse = pipe_s(*inputs, seed=seed, init_latents=init)
    t_sparse = pipe_s.denoise_seconds
    if latents_out is not None:
        latents_out.update(flash=dense, sparse=sparse)
    out = frame_metrics(dense, sparse)
    out.update(dense_seconds=t_dense, sparse_seconds=t_sparse,
               speedup=t_dense / max(t_sparse, 1e-9),
               shape=[height, width, frame], num_steps=num_steps,
               scale=scale, **device_info(dev))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--frame", type=int, default=16)
    ap.add_argument("--num_steps", type=int, default=10)
    ap.add_argument("--sa_drop_rate", type=float, default=0.8)
    ap.add_argument("--p_remain_rates", type=float, default=0.3)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--prompt", type=str,
                    default="several hot air balloons flying over a city.")
    ap.add_argument("--smooth_init", action="store_true",
                    help="spatially low-pass initial latents")
    ap.add_argument("--small", action="store_true",
                    help="256 x 256 x 16, 2 steps (a CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    line = run(**vars(ap.parse_args(argv)))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
