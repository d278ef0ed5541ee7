"""Generation CLI of the PyTorch port (port of
rectified_spaattn_tpu/cli/generate.py: ``--model hunyuan``,
``hunyuan-i2v``, ``wan21-t2v``, ``wan21-i2v``, ``wan22-t2v``, ``wan22-i2v``,
``wan22-ti2v``, ``cogvideox-t2v``, ``cogvideox-i2v`` and
``flux-upscale``):

    python -m rectified_spaattn_tpu_torch.cli.generate --model hunyuan \
        --height 720 --width 1280 --frame 128 --sa_drop_rate 0.8 \
        --p_remain_rates 0.3 --enable_teacache --mode sparse --group_rows 2
    python -m rectified_spaattn_tpu_torch.cli.generate --model wan21-t2v \
        --height 720 --width 1280 --frame 81 --enable_teacache
    python -m rectified_spaattn_tpu_torch.cli.generate --model wan22-i2v \
        --height 720 --width 1280 --frame 81 --image first.npy --host_swap
    python -m rectified_spaattn_tpu_torch.cli.generate --model cogvideox-t2v \
        --height 768 --width 1360 --frame 81 --group_rows 2
    python -m rectified_spaattn_tpu_torch.cli.generate --model flux-upscale \
        --height 4096 --width 4096 --num_steps 28 --group_rows 2

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
``--profile`` a torch.profiler chrome trace.  Flags of parts not ported
(scan execution, and for CogVideoX and Flux the port's own levers that
their JAX pipelines lack: ``--mlp_chunk``, ``--teacache_residual int8``,
``--teacache_offload``, ``--replay_trace``, ``--density``) raise
NotImplementedError.

``flux-upscale`` is the two-stage upscale: the base stage at a quarter of
``--height`` x ``--width``, then the ControlNet pass at the full size
(reference: scripts/main_upflux.py:287-328).  ``--controlnet_dir`` (default
``<ckpt_dir>/controlnet``) holds the FluxControlNetModel snapshot; without
one a warning says the up stage falls back to img2img at strength 0.7.
With ``--ckpt_dir`` the control goes through pixels (decode, bicubic
resize, encode) and the up stage is decoded to a ``.png``; with random
weights a ``--scale``d trunk and a ControlNet of ``max(1, int(5 * scale))``
blocks, its parameters nudged off the zero init, and the up stage's
packed tokens are saved.  The JSON line reports the up stage.

``--image`` conditions the image-to-video models: ``.npy`` (HWC or CHW,
in [-1, 1] or 0-255), or ``.png`` / ``.jpg`` through PIL where it is
installed.  The image is encoded by the snapshot's VAE, or with random
weights by a seeded stand-in encoder (``_demo_vae_encoder``), into
HunyuanVideo I2V's held first latent frame (token_replace) or condition
channels (latent_concat), Wan I2V's mask + latent channels, Wan2.2
TI2V's held first frame (per-token timesteps), or CogVideoX I2V's
first-frame latent channels (``cog_i2v_condition``).  Without ``--image``
the I2V models run the JAX CLI's neutral conditioning: a zero first frame
or zero condition channels (CogVideoX too, where the JAX CLI draws noise
for all 32 input channels) and, for ``wan21-i2v`` with random weights, a
zero [1, 257, image_dim] CLIP context.  ``wan22-t2v`` / ``wan22-i2v`` run
Wan2.2 A14B's two transformers (``transformer_2/`` of the snapshot, or a
second random tree); ``--host_swap`` keeps both trees pinned on the host
and holds one on the card at a time (pipelines/wan.py::Wan22A14BPipeline).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import zlib
from datetime import datetime

import numpy as np
import torch
import torch.nn.functional as F

from ..cache import schedule_from_trace

MODEL_CHOICES = (
    "hunyuan", "hunyuan-i2v", "wan21-t2v", "wan21-i2v", "wan22-ti2v",
    "wan22-t2v", "wan22-i2v", "cogvideox-t2v", "cogvideox-i2v",
    "flux-upscale",
)

DEFAULTS = {
    # (sa_drop_rate, teacache_thresh) per reference Inference.md;
    # hunyuan-i2v (token_replace, no reference driver) inherits the
    # hunyuan T2V operating point
    "hunyuan": (0.8, 0.15), "hunyuan-i2v": (0.8, 0.15),
    "wan21-t2v": (0.75, 0.2),
    "wan21-i2v": (0.75, 0.3), "wan22-ti2v": (0.75, 0.1),
    "wan22-t2v": (0.85, 0.2), "wan22-i2v": (0.85, 0.3),
    "cogvideox-t2v": (0.85, 0.2), "cogvideox-i2v": (0.75, 0.2),
    "flux-upscale": (0.9, 0.8),
}


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
    p.add_argument("--controlnet_dir", type=str, default=None,
                   help="FluxControlNetModel snapshot for flux-upscale "
                        "(default: <ckpt_dir>/controlnet)")
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
    p.add_argument("--image", type=str, default=None,
                   help="conditioning image of the I2V / TI2V models "
                        "(.npy; .png / .jpg where PIL is installed)")
    p.add_argument("--teacache_residual", choices=("bf16", "int8"),
                   default="bf16")
    p.add_argument("--teacache_offload", action="store_true")
    p.add_argument("--replay_trace", type=str, default=None,
                   help="REPLAY a recorded TeaCache schedule (a "
                        "--trace_out JSON of either CLI)")
    p.add_argument("--density", action="store_true",
                   help="probe the executed mask density once per step")
    p.add_argument("--host_swap", action="store_true",
                   help="A14B (wan22-t2v / wan22-i2v): keep both "
                        "transformer trees pinned on the host and swap the "
                        "low-noise tree onto the card once, at the boundary "
                        "step")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    # the tp mesh, which main builds under --tp (not a flag)
    p.set_defaults(mesh=None)
    return p.parse_args(argv)


def _check_ported(args):
    if args.model not in DEFAULTS:
        raise NotImplementedError(f"--model {args.model} is not ported yet")
    # flags the JAX CLI honours for these models; the rest
    # (--controlnet_dir outside flux-upscale, and --use_ret_steps /
    # --teacache_signal_scale for hunyuan) belong to other families and
    # are ignored there too
    unported = {
        "--scan_blocks": args.scan_blocks,
        "--dispatch_segments": args.dispatch_segments > 1,
    }
    family = args.model.split("-")[0]
    if family in ("cogvideox", "flux"):
        # the port's levers that the CogVideoX and Flux pipelines (as
        # their JAX counterparts) do not take
        unported.update({
            f"--mlp_chunk for {family}": args.mlp_chunk > 1,
            f"--teacache_residual int8 for {family}":
                args.teacache_residual != "bf16",
            f"--teacache_offload for {family}": args.teacache_offload,
            f"--replay_trace for {family}": args.replay_trace is not None,
            f"--density for {family}": args.density,
        })
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


def _load_image(path: str, height: int, width: int) -> torch.Tensor:
    """[1, 3, H, W] float32 in [-1, 1], on the host.  ``.npy`` needs
    nothing beyond numpy; other formats go through PIL, imported here."""
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.shape[-1] in (3, 4):       # HWC -> CHW
            arr = arr[..., :3].transpose(0, 3, 1, 2)
        if arr.max() > 1.5:
            arr = arr / 127.5 - 1.0
    else:
        from PIL import Image
        img = Image.open(path).convert("RGB").resize((width, height))
        arr = (np.asarray(img, np.float32) / 127.5 - 1.0)
        arr = arr.transpose(2, 0, 1)[None]
    # the triangle filter widened when downsizing: jax.image.resize's
    # "linear"
    return F.interpolate(torch.from_numpy(np.ascontiguousarray(arr)),
                         size=(height, width), mode="bilinear",
                         align_corners=False, antialias=True)


def _demo_vae_encoder(zc: int, grid, device):
    """A seeded random-weight tiny VAEEncoder for checkpoint-less runs:
    pixels [B, 3, F, H, W] -> latents [B, zc, *grid] (fp32 on
    ``device``)."""
    import torch.nn as nn
    from ..models import VAEConfig, VAEEncoder, init_random_weights
    tiny = VAEConfig.tiny(video=True)
    cfg = VAEConfig(latent_channels=zc,
                    block_out_channels=tiny.block_out_channels,
                    layers_per_block=1,
                    temporal_upsample=tiny.temporal_upsample,
                    spatial_upsample=tiny.spatial_upsample,
                    video=True, mid_attention=False)
    with torch.device(device):
        enc = VAEEncoder(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    with torch.no_grad():
        init_random_weights(enc, gen)
        for mod in enc.modules():
            if isinstance(mod, nn.Conv3d):
                mod.weight.normal_(0.0, mod.weight[0].numel() ** -0.5,
                                   generator=gen)
                mod.bias.zero_()

    @torch.no_grad()
    def encode(video_px):
        # the tiny encoder halves T (causally: 2t - 1 -> t), H and W:
        # resize the input so its OUTPUT lands on the latent grid, with
        # the same antialiased linear filter as _load_image, one axis
        # group at a time
        b, c, f, h, w = video_px.shape
        x = video_px.to(device=device, dtype=torch.float32)
        x = F.interpolate(x.reshape(b, c * f, h, w),
                          size=(2 * grid[1], 2 * grid[2]), mode="bilinear",
                          align_corners=False, antialias=True)
        x = F.interpolate(x.reshape(b, c, f, -1),
                          size=(2 * grid[0] - 1, x.shape[-2] * x.shape[-1]),
                          mode="bilinear", align_corners=False,
                          antialias=True)
        return enc(x.reshape(b, c, 2 * grid[0] - 1, 2 * grid[1],
                             2 * grid[2]))

    return encode


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


def _load_tree(args, family, root, device, host: bool = False):
    """(cfg, model) of the snapshot transformer at ``root``: bf16 on the
    GPU, fp32 on the CPU; kept on the host when ``host`` (host_swap)."""
    from ..models.pretrained import load_transformer
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    cfg, model = load_transformer(family, root, dtype=dtype,
                                  device="cpu" if host else device,
                                  mlp_chunk=args.mlp_chunk)
    return cfg, _quantized(model, args)


def _from_ckpt(args, family, device, host: bool = False):
    """(cfg, model, encoders, vae_encode, vae_decode) from the local
    diffusers snapshot ``--ckpt_dir`` (reference: one from_pretrained call
    gives text-encode -> denoise -> VAE decode -> mp4,
    main_hunyuan.py:232-292)."""
    from ..models.pretrained import load_text_encoders, load_vae
    cfg, model = _load_tree(args, family, args.ckpt_dir, device, host)
    vae_encode, vae_decode = load_vae(args.ckpt_dir, video=True,
                                      device=device)
    encoders = load_text_encoders(family, args.ckpt_dir, device=device)
    return cfg, model, encoders, vae_encode, vae_decode


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


def _built(cls, cfg, device):
    """``cls(cfg)`` made on ``device`` in the dtype its weights run in
    there (bf16 on the GPU, fp32 on the CPU): no wider copy of the model
    ever exists (12B Flux is 47 GB in fp32)."""
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        with torch.device(device):
            return cls(cfg)
    finally:
        torch.set_default_dtype(old)


def _random_model(cls, cfg, device, host: bool = False):
    """``cls(cfg)`` with random weights drawn on ``device`` from seed 0
    (``_built``'s dtype); then moved to the host when ``host``
    (host_swap), so both runs hold the same weights."""
    from ..models import init_random_weights
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model = init_random_weights(_built(cls, cfg, device), gen)
    return model.to("cpu") if host else model


def random_flux(cfg, cn_cfg, device):
    """Seeded random-weight flux-upscale models, built as the JAX CLI
    builds them: the FluxDiT from seed 0, and the FluxControlNet from seed
    21 with its zero-initialised outputs and then every parameter nudged
    by 0.02 * N(0, 1), so the conditioned path does something."""
    from ..models import FluxControlNet, FluxDiT, init_controlnet_weights
    model = _random_model(FluxDiT, cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(21)
    cn = init_controlnet_weights(_built(FluxControlNet, cn_cfg, device), gen,
                                 nudge=0.02)
    return model, cn


def build_hunyuan(args):
    """Returns (pipe, (text, mask, pooled), extra): the ``--ckpt_dir``
    snapshot's model, encoders and VAE, or seeded random weights at
    ``--scale`` (the JAX CLI's random-weight config).  ``extra`` carries
    hunyuan-i2v's first frame (token_replace) or condition
    (latent_concat): the encoded ``--image``, or zeros without one."""
    from ..models import HunyuanVideoConfig, HunyuanVideoDiT
    from ..pipelines import HunyuanVideoPipeline
    from ..pipelines.hunyuan import i2v_condition_concat, i2v_first_frame
    from ..utils import resolve_device
    device = resolve_device(args.device)
    is_i2v = args.model == "hunyuan-i2v"
    pooled, vae_encode, vae_decode = None, None, None
    if args.ckpt_dir:
        cfg, model, encoders, vae_encode, vae_decode = _from_ckpt(
            args, "hunyuan", device)
        if is_i2v and cfg.image_condition_type is None:
            # a T2V-shaped snapshot driven as I2V: force token_replace
            # (the 720p I2V snapshot carries the flag itself)
            cfg = model.cfg = dataclasses.replace(
                cfg, image_condition_type="token_replace")
        (text, mask), _ = _encode_prompt(encoders, args.prompt,
                                         cfg.text_dim, 256, device)
        if len(encoders) > 1:    # CLIP pooled prompt embeds
            pooled = encoders[1].pooled(args.prompt)
    else:
        s = args.scale
        cfg = HunyuanVideoConfig(
            hidden_dim=max(128, int(3072 * s) // 128 * 128),
            heads=max(1, int(24 * s)), num_dual_blocks=max(1, int(20 * s)),
            num_single_blocks=max(1, int(40 * s)), text_dim=512,
            pooled_dim=128, num_refiner_blocks=1,
            image_condition_type="token_replace" if is_i2v else None,
            mlp_chunk=args.mlp_chunk)
        model = _quantized(_random_model(HunyuanVideoDiT, cfg, device), args)
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
    extra = {}
    if is_i2v:
        img = (_load_image(args.image, args.height, args.width).to(device)
               if args.image is not None else None)
        if args.image is not None and not args.ckpt_dir:
            vae_encode = _demo_vae_encoder(cfg.in_channels,
                                           (1, *pipe.grid[1:]), device)
        use_image = img is not None and vae_encode is not None
        if cfg.image_condition_type == "latent_concat":
            # v1 (544p): [noise 16 | image latents 16 | mask 1]
            extra["condition"] = (
                i2v_condition_concat(img, args.frame, vae_encode,
                                     pipe.grid[0]) if use_image else
                torch.zeros((1, cfg.in_channels - cfg.out_channels,
                             *pipe.grid), device=device))
        else:
            # no --image: a neutral zero first frame, so the token_replace
            # path still runs
            extra["first_frame"] = (
                i2v_first_frame(img, vae_encode) if use_image else
                torch.zeros((1, cfg.in_channels, 1, *pipe.grid[1:]),
                            device=device))
    return pipe, (text, mask, pooled), extra


def build_wan(args):
    """Returns (pipe, (text, negative text), extra inputs): the
    ``--ckpt_dir`` snapshot's model(s), encoder and VAE, or seeded random
    weights at ``--scale``, built as the JAX CLI builds them (text_dim 512;
    I2V: 36 input channels, and the CLIP image branch for Wan2.1).  The
    A14B models give a Wan22A14BPipeline over two WanPipelines; TI2V a
    (4, 32, 32) VAE stride and, with ``--image``, per-token timesteps."""
    from ..models import WanConfig, WanDiT
    from ..pipelines import Wan22A14BPipeline, WanPipeline
    from ..pipelines.wan import i2v_condition, ti2v_first_frame
    from ..utils import resolve_device
    device = resolve_device(args.device)
    is_22 = args.model.startswith("wan22")
    is_i2v = args.model.endswith("i2v") and args.model != "wan22-ti2v"
    a14b = args.model in ("wan22-t2v", "wan22-i2v")
    ti2v_image = args.model == "wan22-ti2v" and args.image is not None
    latent_ch = 16
    vae_encode, vae_decode, model2 = None, None, None
    t2 = os.path.join(args.ckpt_dir or "", "transformer_2")
    if args.ckpt_dir:
        # host_swap only when the snapshot holds two different trees
        swap = args.host_swap and a14b and os.path.isdir(t2)
        cfg, model, encoders, vae_encode, vae_decode = _from_ckpt(
            args, "wan", device, host=swap)
        if a14b and os.path.isdir(t2):
            # A14B: transformer_2 lives beside transformer in the snapshot
            _, model2 = _load_tree(args, "wan", t2, device, host=swap)
        (text, _), (neg, _) = _encode_prompt(encoders, args.prompt,
                                             cfg.text_dim, 512, device)
    else:
        swap = args.host_swap and a14b
        s = args.scale
        cfg = WanConfig(
            # I2V transformers take [noise 16 | mask 4 | image latents 16]
            in_channels=latent_ch + 4 + latent_ch if is_i2v else latent_ch,
            out_channels=latent_ch,
            hidden_dim=max(128, int(5120 * s) // 128 * 128),
            heads=max(1, int(40 * s)), num_blocks=max(2, int(40 * s)),
            ffn_dim=max(256, int(13824 * s)), text_dim=512, freq_dim=256,
            mlp_chunk=args.mlp_chunk, image_cross=is_i2v and not is_22,
            per_token_timesteps=ti2v_image)
        model = _quantized(_random_model(WanDiT, cfg, device, host=swap),
                           args)
        if a14b:
            # the second tree from the same seed, as the JAX CLI makes it
            model2 = _quantized(_random_model(WanDiT, cfg, device,
                                              host=swap), args)
        text, _ = _random_text(args.prompt, 512, cfg.text_dim, device=device)
        neg, _ = _random_text("", 512, cfg.text_dim, device=device)

    def make_pipe(m, decode):
        return WanPipeline(
            model=m, height=args.height, width=args.width,
            frames=args.frame, num_steps=args.num_steps,
            sa_drop_rate=args.sa_drop_rate,
            p_remain_rates=args.p_remain_rates,
            mode="flash" if args.mode == "torch" else args.mode,
            enable_teacache=args.enable_teacache,
            teacache_thresh=args.teacache_thresh,
            use_ret_steps=args.use_ret_steps,
            teacache_signal_scale=args.teacache_signal_scale,
            vae_stride=(4, 32, 32) if args.model == "wan22-ti2v"
            else (4, 16, 16),
            is_i2v=is_i2v, warm_last_layers=2 if a14b else 0,
            scheduler="euler" if is_22 else "unipc", vae_decode=decode,
            defer_device=swap, device=device, **_serving(args))

    pipe = make_pipe(model, vae_decode)
    extra = {}
    if args.image is not None and (is_i2v or args.model == "wan22-ti2v"):
        img = _load_image(args.image, args.height, args.width).to(device)
        if args.ckpt_dir:
            enc = vae_encode
        elif args.model == "wan22-ti2v":
            enc = _demo_vae_encoder(cfg.in_channels, (1, *pipe.grid[1:]),
                                    device)
        else:
            enc = _demo_vae_encoder(latent_ch, pipe.grid, device)
        if enc is not None and args.model == "wan22-ti2v":
            extra["first_frame"] = ti2v_first_frame(img, enc)
        elif enc is not None:
            extra["condition"] = i2v_condition(img, args.frame, enc,
                                               lt=pipe.grid[0])
        if is_i2v and not is_22 and not args.ckpt_dir:
            # CLIP-vision features for the 2.1 I2V cross branch (a seeded
            # stand-in without a real image encoder)
            gen = torch.Generator(device=device)
            gen.manual_seed(5)
            extra["image_emb"] = torch.randn((1, 257, cfg.image_dim),
                                             generator=gen, device=device)
    if is_i2v and "condition" not in extra:
        # no --image: neutral zero conditioning (a black first frame); the
        # random-weight 2.1 model also gets a zero CLIP context (the JAX
        # CLI passes none to a checkpoint's)
        extra["condition"] = torch.zeros(
            (1, cfg.in_channels - cfg.out_channels, *pipe.grid),
            device=device)
        if cfg.image_cross and not args.ckpt_dir:
            extra.setdefault("image_emb", torch.zeros(
                (1, 257, cfg.image_dim), device=device))
    if a14b:
        # no transformer_2 in the snapshot: one tree serves both phases
        low = make_pipe(model2, vae_decode) if model2 is not None else pipe
        extra.pop("image_emb", None)
        return (Wan22A14BPipeline(high=pipe, low=low, host_swap=swap),
                (text, neg), extra)
    return pipe, (text, neg), extra


def build_cogvideox(args):
    """Returns (pipe, (text, negative text), extra): the ``--ckpt_dir``
    snapshot's model, T5 encoder and VAE, or seeded random weights at
    ``--scale`` (the JAX CLI's config: ``hidden`` from the scale, head_dim
    held at 64, text_dim 512, time_embed_dim 256; I2V takes 32 input
    channels).  ``extra`` carries cogvideox-i2v's condition channels: the
    encoded ``--image`` (the snapshot's VAE, or the seeded stand-in
    encoder), or zeros without one."""
    from ..models import CogVideoXConfig, CogVideoXDiT
    from ..pipelines import CogVideoXPipeline
    from ..pipelines.cogvideox import cog_i2v_condition
    from ..utils import resolve_device
    device = resolve_device(args.device)
    is_i2v = args.model.endswith("i2v")
    latent_ch = 16
    vae_encode, vae_decode = None, None
    if args.ckpt_dir:
        cfg, model, encoders, vae_encode, vae_decode = _from_ckpt(
            args, "cogvideox", device)
        (text, _), (neg, _) = _encode_prompt(encoders, args.prompt,
                                             cfg.text_dim, 226, device)
    else:
        s = args.scale
        hidden = max(128, int(3072 * s) // 64 * 64)
        cfg = CogVideoXConfig(
            in_channels=2 * latent_ch if is_i2v else latent_ch,
            out_channels=latent_ch, hidden_dim=hidden,
            heads=hidden // 64,    # head_dim 64 = the rope axes' sum
            num_blocks=max(2, int(42 * s)), text_dim=512,
            time_embed_dim=256)
        model = _quantized(_random_model(CogVideoXDiT, cfg, device), args)
        text, _ = _random_text(args.prompt, 256, cfg.text_dim, device=device)
        neg, _ = _random_text("", 256, cfg.text_dim, device=device)
    pipe = CogVideoXPipeline(
        model=model, height=args.height, width=args.width,
        frames=args.frame, num_steps=args.num_steps,
        sa_drop_rate=args.sa_drop_rate, p_remain_rates=args.p_remain_rates,
        mode="flash" if args.mode == "torch" else args.mode,
        enable_teacache=args.enable_teacache,
        teacache_thresh=args.teacache_thresh,
        teacache_signal_scale=args.teacache_signal_scale, is_i2v=is_i2v,
        vae_decode=vae_decode, mesh=args.mesh, device=device,
        group_rows=args.group_rows, plan_row_chunk=args.plan_row_chunk,
        plan_kv_tile=args.plan_kv_tile, kv_pack=args.kv_pack,
        head_chunk=args.head_chunk)
    extra = {}
    if is_i2v:
        if args.image is not None and not args.ckpt_dir:
            vae_encode = _demo_vae_encoder(latent_ch, (1, *pipe.grid[1:]),
                                           device)
        extra["condition"] = (
            cog_i2v_condition(
                _load_image(args.image, args.height, args.width).to(device),
                vae_encode, pipe.grid)
            if args.image is not None and vae_encode is not None else
            torch.zeros((1, cfg.in_channels - cfg.out_channels, *pipe.grid),
                        device=device))
    return pipe, (text, neg), extra


def build_flux(args):
    """Returns (FluxUpscalePipeline, (text, mask, pooled), {}): the
    ``--ckpt_dir`` snapshot's trunk, T5 + CLIP encoders, 2-D VAE and
    ControlNet (``--controlnet_dir`` or <ckpt_dir>/controlnet; without one
    the JAX CLI's warning and the img2img fallback), or ``random_flux`` of
    the JAX CLI's ``--scale``d configs with the seeded T5 stand-in (512
    tokens) and a seeded pooled vector.  The base stage runs at a quarter
    of the size and returns tokens; only the up stage decodes (through the
    2x2 unpack).  One trunk serves both stages."""
    import warnings
    from ..pipelines import FluxPipeline, FluxUpscalePipeline
    from ..pipelines.flux import flux_unpack_latents
    from ..utils import resolve_device
    device = resolve_device(args.device)
    vae_encode = vae_decode = cn = None
    if args.ckpt_dir:
        from ..models.pretrained import (load_flux_controlnet,
                                         load_text_encoders, load_vae)
        cfg, model = _load_tree(args, "flux", args.ckpt_dir, device)
        vae_encode, vae_decode = load_vae(args.ckpt_dir, video=False,
                                          device=device)
        encoders = load_text_encoders("flux", args.ckpt_dir, device=device)
        (text, mask), _ = _encode_prompt(encoders, args.prompt, cfg.text_dim,
                                         512, device)
        pooled = torch.zeros((1, cfg.pooled_dim), device=device)
        if len(encoders) > 1:        # CLIP pooled prompt embeds
            pooled = encoders[1].pooled(args.prompt)
        cn_dir = args.controlnet_dir or os.path.join(args.ckpt_dir,
                                                     "controlnet")
        if os.path.isdir(cn_dir):
            _, cn = load_flux_controlnet(
                cn_dir, dtype="bfloat16" if device.type == "cuda"
                else "float32", device=device)
        else:
            warnings.warn(
                "flux-upscale: no ControlNet snapshot found at "
                f"{cn_dir!r}; stage 2 degrades to img2img (strength 0.7) "
                "instead of the reference's ControlNet-conditioned "
                "upscale -- pass --controlnet_dir to match the reference")
    else:
        from ..models import FluxConfig, FluxControlNetConfig
        sc = args.scale
        cfg = FluxConfig(
            hidden_dim=max(128, int(3072 * sc) // 128 * 128),
            heads=max(1, int(24 * sc)), num_dual_blocks=max(1, int(19 * sc)),
            num_single_blocks=max(1, int(38 * sc)), text_dim=512,
            pooled_dim=128)
        model, cn = random_flux(cfg, FluxControlNetConfig(
            in_channels=cfg.in_channels, cond_channels=cfg.in_channels,
            hidden_dim=cfg.hidden_dim, heads=cfg.heads,
            num_dual_blocks=max(1, int(5 * sc)), text_dim=cfg.text_dim,
            pooled_dim=cfg.pooled_dim), device)
        model = _quantized(model, args)
        text, mask = _random_text(args.prompt, 512, cfg.text_dim,
                                  device=device)
        pooled = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (1, cfg.pooled_dim)).astype(np.float32)).to(device)

    def mk(hh, ww, decode=None):
        return FluxPipeline(
            model=model, height=hh, width=ww, num_steps=args.num_steps,
            sa_drop_rate=args.sa_drop_rate,
            p_remain_rates=args.p_remain_rates,
            mode="flash" if args.mode == "torch" else args.mode,
            enable_teacache=args.enable_teacache,
            rel_l1_thresh=args.teacache_thresh, vae_decode=decode,
            mesh=args.mesh, device=device, group_rows=args.group_rows,
            plan_row_chunk=args.plan_row_chunk,
            plan_kv_tile=args.plan_kv_tile, kv_pack=args.kv_pack,
            head_chunk=args.head_chunk)

    gh_u, gw_u = args.height // 16, args.width // 16
    up_decode = ((lambda t: vae_decode(flux_unpack_latents(t, gh_u, gw_u)))
                 if vae_decode is not None else None)
    pipe = FluxUpscalePipeline(
        base=mk(args.height // 4, args.width // 4),
        up=mk(args.height, args.width, up_decode), controlnet=cn,
        vae_encode=vae_encode, vae_decode=vae_decode)
    return pipe, (text, mask, pooled), {}


def _tp_mesh(args):
    """--tp N: a 1 x N x 1 mesh over the torch.distributed world of N
    processes (torchrun sets it up; a process group the caller already
    initialised is used as it is).  Sets ``args.device`` to this rank's
    device.  Returns (mesh, whether this call initialised the group), or
    (None, False) for one device.  A mesh the caller built (``args.mesh``:
    a dp x N mesh of parallel/multihost.py, on the caller's device) is
    returned as it is, its tp group the pipelines'."""
    if args.mesh is not None:
        if args.mesh.shape["tp"] != args.tp or args.mesh.shape["sp"] != 1:
            raise SystemExit(f"--tp {args.tp} but the caller's mesh is "
                             f"{args.mesh.shape}")
        return args.mesh, False
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
        build = {"hunyuan": build_hunyuan, "wan21": build_wan,
                 "wan22": build_wan, "cogvideox": build_cogvideox,
                 "flux": build_flux}[args.model.split("-")[0]]
        pipe, inputs, extra = build(args)
        noise = set_seed(args.seed, pipe.device)
        with profiler_trace(args.profile), trace_to(args.trace_out):
            out = pipe(*inputs, seed=args.seed, generator=noise, **extra)
        if args.model == "flux-upscale":
            pipe = pipe.up       # report the high-res stage, as JAX does
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
    dens = getattr(pipe, "density_samples", None)   # none for A14B
    result = {
        "output": path,
        "denoise_seconds": round(pipe.denoise_seconds, 2),
        "teacache": pipe.teacache_stats,
        "density": round(float(np.mean(dens)), 4) if dens else None,
    }
    if getattr(pipe, "vae_decode", None) is not None:
        result["decode_seconds"] = round(pipe.decode_seconds, 2)
    print(json.dumps(result))
    return result

if __name__ == "__main__":
    main()
