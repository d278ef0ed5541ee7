"""Generation CLI of the PyTorch port (port of
rectified_spaattn_tpu/cli/generate.py, ``--model hunyuan``, ``wan21-t2v``
and ``wan21-i2v``):

    python -m rectified_spaattn_tpu_torch.cli.generate --model hunyuan \
        --height 720 --width 1280 --frame 128 --sa_drop_rate 0.8 \
        --p_remain_rates 0.3 --enable_teacache --mode sparse --group_rows 2
    python -m rectified_spaattn_tpu_torch.cli.generate --model wan21-t2v \
        --height 720 --width 1280 --frame 81 --enable_teacache

The flags are the JAX CLI's, plus ``--device`` (default cuda; the run
raises without a GPU unless ``--device cpu``).  ``--tp N`` runs the
pipeline tensor-parallel over N processes, one per GPU, launched with
torchrun (NCCL; with ``--device cpu``, gloo); only rank 0 writes the
output and prints the JSON line:

    torchrun --nproc_per_node 4 -m rectified_spaattn_tpu_torch.cli.generate \
        --tp 4 --model hunyuan ...

``--ckpt_dir`` loads a local diffusers snapshot (``transformer/``,
``vae/``, optional ``text_encoder[_2]/`` + ``tokenizer[_2]/``; see
models/pretrained.py): the transformer in bf16 on the GPU (fp32 on the
CPU), the VAE in fp32, and the prompt through the snapshot's text encoders,
or the seeded pseudo-embedding of the random-weight runs when it has none.
The final latents are decoded and saved as ``.mp4`` (``.npy`` of uint8
frames where imageio or its ffmpeg backend is missing).  Without
``--ckpt_dir`` the run uses seeded random weights at a ``--scale``d config,
built as the JAX CLI builds them; weights and activations are bf16 on the
GPU (the CUDA kernels take bf16) and fp32 on the CPU, and the latents are
saved as ``.npy``.  ``--quant 8|4`` quantizes the weights in place, layer by
layer (models/quant.py::quantize_model, the JAX CLI's ``quantize_params``
rules), so the device never holds a second full copy.  ``--trace_out``
writes the TeaCache schedule trace (cache/teacache.py::trace_to),
``--profile`` a torch.profiler chrome trace.  Flags of parts not ported yet
(other model families, scan execution, I2V images) raise
NotImplementedError.  ``wan21-i2v`` without ``--image`` runs the JAX CLI's
neutral conditioning: zero condition channels and, with random weights, a
zero [1, 257, image_dim] CLIP context.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import zlib
from datetime import datetime

import numpy as np
import torch

from ..cache import schedule_from_trace

MODEL_CHOICES = (
    "hunyuan", "hunyuan-i2v", "wan21-t2v", "wan21-i2v", "wan22-ti2v",
    "wan22-t2v", "wan22-i2v", "cogvideox-t2v", "cogvideox-i2v",
    "flux-upscale",
)

# (sa_drop_rate, teacache_thresh) per reference Inference.md
DEFAULTS = {"hunyuan": (0.8, 0.15), "wan21-t2v": (0.75, 0.2),
            "wan21-i2v": (0.75, 0.3)}


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
    p.add_argument("--trace_out", type=str, default=None,
                   help="write the TeaCache schedule trace (raw signals and "
                        "decisions) as JSON")
    p.add_argument("--mode", choices=["sparse", "flash", "torch", "vanilla"],
                   default="sparse")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--controlnet_dir", type=str, default=None)
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="local diffusers snapshot: transformer/, vae/, "
                        "optional text_encoder[_2]/ + tokenizer[_2]/")
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
                        "key list (SparseConfig.group_rows).  On an H100 "
                        "(80GB HBM3, 700 W) at the HunyuanVideo point, K2 "
                        "at G = 2 takes 0.96-1.05x the attention time of "
                        "G = 1 (K1) on the same plan: it saves no work on "
                        "the card (PERF.md)")
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
                   help="REPLAY a recorded TeaCache schedule (a "
                        "--trace_out JSON of either CLI)")
    p.add_argument("--density", action="store_true",
                   help="probe the executed mask density once per step")
    p.add_argument("--host_swap", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    # the tp mesh, which main builds under --tp (not a flag)
    p.set_defaults(mesh=None)
    return p.parse_args(argv)


def _check_ported(args):
    if args.model not in DEFAULTS:
        raise NotImplementedError(f"--model {args.model} is not ported yet")
    # flags the JAX CLI honours for these models; the rest
    # (--controlnet_dir, --host_swap, and --use_ret_steps /
    # --teacache_signal_scale for hunyuan) belong to other families and
    # are ignored there too
    unported = {
        "--scan_blocks": args.scan_blocks,
        "--dispatch_segments": args.dispatch_segments > 1,
        "--image (the I2V conditioning of HunyuanVideo I2V and Wan2.2, "
        "ROADMAP Queue 1 items 2-3)": args.image,
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


def _encode_prompt(encoders, prompt, dim, max_len, device):
    """(cond, mask), (uncond, umask) for the prompt and the empty negative
    prompt, through the primary encoder, or the seeded pseudo-embedding
    when the snapshot has no encoders."""
    if encoders:
        return encoders[0](prompt), encoders[0]("")
    return (_random_text(prompt, max_len, dim, device=device),
            _random_text("", max_len, dim, device=device))


def _from_ckpt(args, family, device):
    """(cfg, model, encoders, vae_decode) from the local
    diffusers snapshot ``--ckpt_dir`` (reference: one from_pretrained call
    gives text-encode -> denoise -> VAE decode -> mp4,
    main_hunyuan.py:232-292)."""
    from ..models.pretrained import (load_text_encoders, load_transformer,
                                     load_vae)
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    cfg, model = load_transformer(family, args.ckpt_dir, dtype=dtype,
                                  device=device, mlp_chunk=args.mlp_chunk)
    _, vae_decode = load_vae(args.ckpt_dir, video=True, device=device)
    encoders = load_text_encoders(family, args.ckpt_dir, device=device)
    return cfg, model, encoders, vae_decode


def _quantized(model, args):
    """--quant: int8 / int4 weights, converted in place one layer at a
    time (the JAX CLI quantizes its host tree for the same reason: no
    second full device copy)."""
    if args.quant:
        from ..models import quant
        quant.quantize_model(model, bits=args.quant)
    return model


def _serving(args) -> dict:
    """Pipeline keywords of the serving levers shared by the families."""
    return dict(group_rows=args.group_rows,
                plan_row_chunk=args.plan_row_chunk,
                plan_kv_tile=args.plan_kv_tile, kv_pack=args.kv_pack,
                head_chunk=args.head_chunk,
                teacache_residual=args.teacache_residual,
                teacache_offload=args.teacache_offload,
                teacache_schedule=(schedule_from_trace(args.replay_trace)
                                   if args.replay_trace else None),
                density_probe=args.density, mesh=args.mesh)


def build_hunyuan(args):
    """Returns (pipe, (text, mask, pooled)): the ``--ckpt_dir`` snapshot's
    model, encoders and VAE decode, or seeded random weights at
    ``--scale`` (the JAX CLI's random-weight config)."""
    from ..models import HunyuanVideoConfig, HunyuanVideoDiT
    from ..models import init_random_weights
    from ..pipelines import HunyuanVideoPipeline
    from ..utils import resolve_device
    device = resolve_device(args.device)
    pooled, vae_decode = None, None
    if args.ckpt_dir:
        cfg, model, encoders, vae_decode = _from_ckpt(args, "hunyuan",
                                                      device)
        (text, mask), _ = _encode_prompt(encoders, args.prompt,
                                         cfg.text_dim, 256, device)
        if len(encoders) > 1:    # CLIP pooled prompt embeds
            pooled = encoders[1].pooled(args.prompt)
        model = _quantized(model, args)
    else:
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
        model = _quantized(init_random_weights(model.to(dtype), gen), args)
        text, mask = _random_text(args.prompt, 256, cfg.text_dim,
                                  device=device)
    pipe = HunyuanVideoPipeline(
        model=model, height=args.height, width=args.width,
        frames=args.frame, num_steps=args.num_steps,
        sa_drop_rate=args.sa_drop_rate, p_remain_rates=args.p_remain_rates,
        mode="flash" if args.mode == "torch" else args.mode,
        enable_teacache=args.enable_teacache,
        rel_l1_thresh=args.teacache_thresh, vae_decode=vae_decode,
        device=device, **_serving(args))
    return pipe, (text, mask, pooled)


def build_wan(args):
    """Returns (pipe, (text, negative text), extra inputs): the
    ``--ckpt_dir`` snapshot's model, encoder and VAE decode, or seeded
    random weights at ``--scale``, built as the JAX CLI builds them
    (text_dim 512; I2V: 36 input channels and the CLIP image branch)."""
    from ..models import WanConfig, WanDiT, init_random_weights
    from ..pipelines import WanPipeline
    from ..utils import resolve_device
    device = resolve_device(args.device)
    is_i2v = args.model == "wan21-i2v"
    latent_ch = 16
    vae_decode = None
    if args.ckpt_dir:
        cfg, model, encoders, vae_decode = _from_ckpt(args, "wan", device)
        (text, _), (neg, _) = _encode_prompt(encoders, args.prompt,
                                             cfg.text_dim, 512, device)
        model = _quantized(model, args)
    else:
        s = args.scale
        cfg = WanConfig(
            # I2V transformers take [noise 16 | mask 4 | image latents 16]
            in_channels=latent_ch + 4 + latent_ch if is_i2v else latent_ch,
            out_channels=latent_ch,
            hidden_dim=max(128, int(5120 * s) // 128 * 128),
            heads=max(1, int(40 * s)), num_blocks=max(2, int(40 * s)),
            ffn_dim=max(256, int(13824 * s)), text_dim=512, freq_dim=256,
            mlp_chunk=args.mlp_chunk, image_cross=is_i2v)
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        with torch.device(device):
            model = WanDiT(cfg)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        model = _quantized(init_random_weights(model.to(dtype), gen), args)
        text, _ = _random_text(args.prompt, 512, cfg.text_dim, device=device)
        neg, _ = _random_text("", 512, cfg.text_dim, device=device)
    pipe = WanPipeline(
        model=model, height=args.height, width=args.width, frames=args.frame,
        num_steps=args.num_steps, sa_drop_rate=args.sa_drop_rate,
        p_remain_rates=args.p_remain_rates,
        mode="flash" if args.mode == "torch" else args.mode,
        enable_teacache=args.enable_teacache,
        teacache_thresh=args.teacache_thresh,
        use_ret_steps=args.use_ret_steps,
        teacache_signal_scale=args.teacache_signal_scale, is_i2v=is_i2v,
        vae_decode=vae_decode, device=device, **_serving(args))
    extra = {}
    if is_i2v:
        # no --image: neutral zero conditioning (a black first frame); the
        # random-weight model also gets a zero CLIP context (the JAX CLI
        # passes none to a checkpoint's)
        extra["condition"] = torch.zeros(
            (1, cfg.in_channels - cfg.out_channels, *pipe.grid),
            device=device)
        if not args.ckpt_dir:
            extra["image_emb"] = torch.zeros((1, 257, cfg.image_dim),
                                             device=device)
    return pipe, (text, neg), extra


def _tp_mesh(args):
    """--tp N: a 1 x N x 1 mesh over the torch.distributed world of N
    processes (torchrun sets it up; a process group the caller already
    initialised is used as it is).  Sets ``args.device`` to this rank's
    device.  Returns (mesh, whether this call initialised the group), or
    (None, False) for one device."""
    if args.tp <= 1:
        return None, False
    import torch.distributed as dist
    from ..parallel import init_distributed, local_device, make_mesh
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if world < args.tp:
        raise SystemExit(f"--tp {args.tp} but only {world} devices")
    if world != args.tp:
        raise SystemExit(f"--tp {args.tp} runs one process per rank: launch "
                         f"it with torchrun --nproc_per_node {args.tp} "
                         f"(the world has {world})")
    device = local_device(args.device)
    args.device = str(device)
    owned = not dist.is_initialized()
    if owned:
        init_distributed(device)
    return make_mesh(dp=1, tp=args.tp, sp=1), owned


def main(argv=None):
    args = parse_args(argv)
    _check_ported(args)
    drop, tea = DEFAULTS[args.model]
    if args.sa_drop_rate is None:
        args.sa_drop_rate = drop
    if args.teacache_thresh is None:
        args.teacache_thresh = tea

    from ..cache.teacache import trace_to
    from ..utils import profiler_trace, set_seed
    args.mesh, owned = _tp_mesh(args)
    try:
        if args.model == "hunyuan":
            pipe, inputs = build_hunyuan(args)
            extra = {}
        else:
            pipe, inputs, extra = build_wan(args)
        noise = set_seed(args.seed, pipe.device)
        with profiler_trace(args.profile), trace_to(args.trace_out):
            out = pipe(*inputs, generator=noise, **extra)
    finally:
        if owned:
            import torch.distributed as dist
            dist.destroy_process_group()
    if args.mesh is not None and args.mesh.group("tp").rank != 0:
        return None

    os.makedirs(args.out_dir, exist_ok=True)
    stamp = datetime.fromtimestamp(time.time()).strftime("%m-%d-%H:%M:%S")
    # elapsed denoise seconds in the filename, as the reference does
    # (main_hunyuan.py:288-292); decoded pixels go to mp4 / png, raw
    # latents to .npy
    stem = os.path.join(args.out_dir, f"{stamp}_{args.model}_"
                                      f"{pipe.denoise_seconds:.0f}s")
    arr = out.float().cpu().numpy()
    if arr.ndim == 5 and arr.shape[1] == 3:          # [B,3,F,H,W] pixels
        from ..utils.video import save_video
        path = save_video(arr[0].transpose(1, 2, 3, 0), stem + ".mp4")
    elif arr.ndim == 4 and arr.shape[1] == 3:        # [B,3,H,W] image
        from ..utils.video import save_image
        path = save_image(arr[0].transpose(1, 2, 0), stem + ".png")
    else:
        path = stem + ".npy"
        np.save(path, arr)
    dens = pipe.density_samples
    result = {
        "output": path,
        "denoise_seconds": round(pipe.denoise_seconds, 2),
        "teacache": pipe.teacache_stats,
        "density": round(float(np.mean(dens)), 4) if dens else None,
    }
    if pipe.vae_decode is not None:
        result["decode_seconds"] = round(pipe.decode_seconds, 2)
    print(json.dumps(result))
    return result

if __name__ == "__main__":
    main()
