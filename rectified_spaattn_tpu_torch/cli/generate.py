"""Generation CLI of the PyTorch port (port of
rectified_spaattn_tpu/cli/generate.py, ``--model hunyuan``):

    python -m rectified_spaattn_tpu_torch.cli.generate --model hunyuan \
        --height 720 --width 1280 --frame 128 --sa_drop_rate 0.8 \
        --p_remain_rates 0.3 --enable_teacache --mode sparse --group_rows 2

The flags are the JAX CLI's, plus ``--device`` (default cuda; the run
raises without a GPU unless ``--device cpu``).  Without ``--ckpt_dir`` the
run uses seeded random weights at a ``--scale``d config, built as the JAX
CLI builds them; weights and activations are bf16 on the GPU (the CUDA
kernels take bf16) and fp32 on the CPU.  Flags of parts not ported yet
(checkpoints, other model families, multi-GPU, quantization, scan
execution, I2V images, int8/offloaded TeaCache residuals, schedule traces)
raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import zlib
from datetime import datetime

import numpy as np
import torch

MODEL_CHOICES = (
    "hunyuan", "hunyuan-i2v", "wan21-t2v", "wan21-i2v", "wan22-ti2v",
    "wan22-t2v", "wan22-i2v", "cogvideox-t2v", "cogvideox-i2v",
    "flux-upscale",
)

# (sa_drop_rate, teacache_thresh) per reference Inference.md
DEFAULTS = {"hunyuan": (0.8, 0.15)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", choices=MODEL_CHOICES, default="hunyuan")
    p.add_argument("--prompt", type=str,
                   default="several hot air balloons flying over a city.")
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--frame", type=int, default=128)
    p.add_argument("--num_steps", type=int, default=50)
    p.add_argument("--sa_drop_rate", type=float, default=None)
    p.add_argument("--p_remain_rates", type=float, default=0.3)
    p.add_argument("--enable_teacache", action="store_true")
    p.add_argument("--teacache_thresh", "--rel_l1_thresh", type=float,
                   default=None, dest="teacache_thresh")
    p.add_argument("--use_ret_steps", action="store_true")
    p.add_argument("--teacache_signal_scale", type=float, default=1.0)
    p.add_argument("--trace_out", type=str, default=None)
    p.add_argument("--mode", choices=["sparse", "flash", "torch", "vanilla"],
                   default="sparse")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--controlnet_dir", type=str, default=None)
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--out_dir", type=str, default="./outputs")
    p.add_argument("--scale", type=float, default=1.0,
                   help="model-size scale for random-weight smoke runs")
    p.add_argument("--profile", type=str, default=None, metavar="LOG_DIR",
                   help="write a torch.profiler chrome trace to LOG_DIR")
    p.add_argument("--scan_blocks", action="store_true")
    p.add_argument("--dispatch_segments", type=int, default=1)
    p.add_argument("--quant", type=int, default=0, choices=(0, 4, 8))
    p.add_argument("--group_rows", type=int, default=1,
                   help="grouped-row kernel K2: G query blocks per union "
                        "key list (SparseConfig.group_rows)")
    p.add_argument("--plan_row_chunk", type=int, default=0)
    p.add_argument("--head_chunk", type=int, default=0)
    p.add_argument("--kv_pack", action="store_true")
    p.add_argument("--plan_kv_tile", type=int, default=0)
    p.add_argument("--mlp_chunk", type=int, default=1)
    p.add_argument("--image", type=str, default=None)
    p.add_argument("--teacache_residual", choices=("bf16", "int8"),
                   default="bf16")
    p.add_argument("--teacache_offload", action="store_true")
    p.add_argument("--replay_trace", type=str, default=None,
                   help="REPLAY a recorded TeaCache schedule (a trace JSON "
                        "of the JAX CLI's --trace_out)")
    p.add_argument("--density", action="store_true",
                   help="probe the executed mask density once per step")
    p.add_argument("--host_swap", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def _check_ported(args):
    if args.model != "hunyuan":
        raise NotImplementedError(f"--model {args.model} is not ported yet")
    # flags the JAX CLI honours for --model hunyuan; the rest
    # (--use_ret_steps, --teacache_signal_scale, --controlnet_dir,
    # --host_swap) belong to other families and are ignored there too
    unported = {
        "--ckpt_dir (checkpoint loading)": args.ckpt_dir,
        "--tp": args.tp > 1, "--scan_blocks": args.scan_blocks,
        "--dispatch_segments": args.dispatch_segments > 1,
        "--quant": args.quant, "--image": args.image,
        "--teacache_residual int8": args.teacache_residual == "int8",
        "--teacache_offload": args.teacache_offload,
        "--trace_out": args.trace_out,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


def _random_text(prompt: str, length: int, dim: int, batch: int = 1,
                 device="cpu"):
    """Deterministic pseudo-embedding of a prompt (random-weight demos),
    seeded from a stable digest of the prompt."""
    gen = torch.Generator(device=device)
    gen.manual_seed(zlib.crc32(prompt.encode("utf-8")))
    emb = torch.randn((batch, length, dim), generator=gen, device=device)
    n = min(max(len(prompt.split()), 4), length)
    mask = torch.zeros((batch, length), dtype=torch.bool, device=device)
    mask[:, :n] = True
    return emb * mask[..., None], mask


def build_hunyuan(args):
    """Returns (pipe, (text, mask)) with seeded random weights at
    ``--scale`` (the JAX CLI's random-weight config)."""
    from ..models import HunyuanVideoConfig, HunyuanVideoDiT
    from ..models.hunyuan import init_random_weights
    from ..pipelines import HunyuanVideoPipeline
    from ..utils import resolve_device
    device = resolve_device(args.device)
    s = args.scale
    cfg = HunyuanVideoConfig(
        hidden_dim=max(128, int(3072 * s) // 128 * 128),
        heads=max(1, int(24 * s)), num_dual_blocks=max(1, int(20 * s)),
        num_single_blocks=max(1, int(40 * s)), text_dim=512,
        pooled_dim=128, num_refiner_blocks=1, mlp_chunk=args.mlp_chunk)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    with torch.device(device):
        model = HunyuanVideoDiT(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model = init_random_weights(model.to(dtype), gen)
    text, mask = _random_text(args.prompt, 256, cfg.text_dim, device=device)
    schedule = None
    if args.replay_trace:
        with open(args.replay_trace) as f:
            schedule = [bool(r["compute"]) for r in json.load(f) if "call" in r]
    pipe = HunyuanVideoPipeline(
        model=model, height=args.height, width=args.width,
        frames=args.frame, num_steps=args.num_steps,
        sa_drop_rate=args.sa_drop_rate, p_remain_rates=args.p_remain_rates,
        mode="flash" if args.mode == "torch" else args.mode,
        enable_teacache=args.enable_teacache,
        rel_l1_thresh=args.teacache_thresh, group_rows=args.group_rows,
        plan_row_chunk=args.plan_row_chunk, plan_kv_tile=args.plan_kv_tile,
        kv_pack=args.kv_pack, head_chunk=args.head_chunk,
        teacache_schedule=schedule, density_probe=args.density,
        device=device)
    return pipe, (text, mask)


@contextlib.contextmanager
def _profiler(log_dir):
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def main(argv=None):
    args = parse_args(argv)
    _check_ported(args)
    drop, tea = DEFAULTS[args.model]
    if args.sa_drop_rate is None:
        args.sa_drop_rate = drop
    if args.teacache_thresh is None:
        args.teacache_thresh = tea

    from ..utils import set_seed
    pipe, (text, mask) = build_hunyuan(args)
    noise = set_seed(args.seed, pipe.device)
    with _profiler(args.profile):
        latents = pipe(text, mask, generator=noise)

    os.makedirs(args.out_dir, exist_ok=True)
    stamp = datetime.fromtimestamp(time.time()).strftime("%m-%d-%H:%M:%S")
    path = os.path.join(args.out_dir, f"{stamp}_{args.model}_"
                                      f"{pipe.denoise_seconds:.0f}s.npy")
    np.save(path, latents.float().cpu().numpy())
    dens = pipe.density_samples
    result = {
        "output": path,
        "denoise_seconds": round(pipe.denoise_seconds, 2),
        "teacache": pipe.teacache_stats,
        "density": round(float(np.mean(dens)), 4) if dens else None,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
