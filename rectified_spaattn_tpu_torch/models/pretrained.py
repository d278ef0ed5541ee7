"""Snapshot -> pipeline parts: one call per part from a local diffusers
snapshot directory to the transformer (with its weights), the VAE's encode
/ decode and the text encoders (port of rectified_spaattn_tpu/models/
pretrained.py; the reference gets them from ``from_pretrained``,
scripts/main_hunyuan.py:232-238).  The module configs are parsed from the
snapshot's own ``config.json`` files.

Layout expected (a diffusers snapshot):
    <root>/transformer/*.safetensors + config.json
    <root>/vae/*.safetensors + config.json
    <root>/text_encoder[_2]/ (+ tokenizer[_2]/)      -- via transformers

Weights are read in the file's dtype (bf16 stays bf16), converted tensor
by tensor and each placed on ``device`` in ``dtype`` as it is made, into a
model built on the meta device: the host never holds a converted copy of
the whole model.  ``load_transformer`` caches the converted weights in
``<transformer>/.rsa_torch_params/`` (the JAX package's cache is
``.rsa_tpu_params``; neither reads the other's).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional

import torch
import torch.nn as nn

from ..utils.device import resolve_device

CACHE_DIR = ".rsa_torch_params"


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _subdir(root: str, name: str) -> Optional[str]:
    p = os.path.join(root, name)
    return p if os.path.isdir(p) else None


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _placer(device, dtype):
    """Move a tensor to ``device``, floating tensors cast to ``dtype``."""
    def place(t):
        return t.to(device=device,
                    dtype=dtype if t.is_floating_point() else t.dtype)
    return place


def _assemble(module_fn, state: dict) -> nn.Module:
    """The module built on the meta device, holding ``state``'s tensors."""
    with torch.device("meta"):
        model = module_fn()
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval()


# ---------------------------------------------------------------------------
# Transformer configs from diffusers config.json
# ---------------------------------------------------------------------------

def wan_config_from_json(cfg: dict):
    from .wan import WanConfig
    heads = cfg["num_attention_heads"]
    hd = cfg["attention_head_dim"]
    return WanConfig(
        in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
        hidden_dim=heads * hd, heads=heads, head_dim=hd,
        num_blocks=cfg["num_layers"], ffn_dim=cfg["ffn_dim"],
        patch_size=tuple(cfg["patch_size"]), text_dim=cfg["text_dim"],
        freq_dim=cfg["freq_dim"],
        rope_axes_dim=tuple(cfg.get("rope_axes_dim", (hd - 2 * (hd // 3),
                                                      hd // 3, hd // 3))),
        image_cross=cfg.get("image_dim") is not None,
        image_dim=cfg.get("image_dim") or 1280,
        per_token_timesteps=bool(cfg.get("expand_timesteps", False)))


def hunyuan_config_from_json(cfg: dict):
    from .hunyuan import HunyuanVideoConfig
    heads = cfg["num_attention_heads"]
    hd = cfg["attention_head_dim"]
    return HunyuanVideoConfig(
        in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
        hidden_dim=heads * hd, heads=heads, head_dim=hd,
        num_dual_blocks=cfg["num_layers"],
        num_single_blocks=cfg["num_single_layers"],
        num_refiner_blocks=cfg.get("num_refiner_layers", 2),
        patch_size=cfg.get("patch_size", 2),
        patch_size_t=cfg.get("patch_size_t", 1),
        text_dim=cfg.get("text_embed_dim", 4096),
        pooled_dim=cfg.get("pooled_projection_dim", 768),
        rope_axes_dim=tuple(cfg.get("rope_axes_dim", (16, 56, 56))),
        guidance_embeds=bool(cfg.get("guidance_embeds", True)),
        # HunyuanVideo-I2V snapshots carry image_condition_type
        image_condition_type=cfg.get("image_condition_type"))


def flux_config_from_json(cfg: dict):
    """A FluxTransformer2DModel config.json."""
    from .flux import FluxConfig
    heads = cfg["num_attention_heads"]
    hd = cfg["attention_head_dim"]
    return FluxConfig(
        in_channels=cfg["in_channels"],
        out_channels=cfg.get("out_channels") or cfg["in_channels"],
        hidden_dim=heads * hd, heads=heads, head_dim=hd,
        num_dual_blocks=cfg["num_layers"],
        num_single_blocks=cfg["num_single_layers"],
        text_dim=cfg.get("joint_attention_dim", 4096),
        pooled_dim=cfg.get("pooled_projection_dim", 768),
        rope_axes_dim=tuple(cfg.get("axes_dims_rope", (16, 56, 56))),
        guidance_embeds=bool(cfg.get("guidance_embeds", True)))


def flux_controlnet_config_from_json(cj: dict):
    """A FluxControlNetModel config.json (the JAX loader's defaults for
    absent keys)."""
    from .flux import FluxControlNetConfig
    heads = cj.get("num_attention_heads", 24)
    return FluxControlNetConfig(
        in_channels=cj.get("in_channels", 64),
        cond_channels=cj.get("in_channels", 64),
        hidden_dim=heads * cj.get("attention_head_dim", 128), heads=heads,
        num_dual_blocks=cj.get("num_layers", 5),
        num_single_blocks=cj.get("num_single_layers", 0),
        text_dim=cj.get("joint_attention_dim", 4096),
        pooled_dim=cj.get("pooled_projection_dim", 768),
        rope_axes_dim=tuple(cj.get("axes_dims_rope", (16, 56, 56))),
        guidance_embeds=cj.get("guidance_embeds", True))


def cogvideox_config_from_json(cfg: dict):
    """A CogVideoXTransformer3DModel config.json (1.5: patch_size_t 2 and
    the ofs embedding; 1.0: neither)."""
    from .cogvideox import CogVideoXConfig
    heads = cfg["num_attention_heads"]
    hd = cfg["attention_head_dim"]
    return CogVideoXConfig(
        in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
        hidden_dim=heads * hd, heads=heads, head_dim=hd,
        num_blocks=cfg["num_layers"],
        text_dim=cfg.get("text_embed_dim", 4096),
        time_embed_dim=cfg.get("time_embed_dim", 512),
        patch_size=cfg.get("patch_size", 2),
        patch_size_t=cfg.get("patch_size_t") or 1,
        use_ofs_embed=cfg.get("ofs_embed_dim") is not None)


CONFIG_PARSERS = {
    "wan": wan_config_from_json,
    "hunyuan": hunyuan_config_from_json,
    "flux": flux_config_from_json,
    "cogvideox": cogvideox_config_from_json,
}


def _model_class(family: str):
    from .cogvideox import CogVideoXDiT
    from .flux import FluxDiT
    from .hunyuan import HunyuanVideoDiT
    from .wan import WanDiT
    return {"wan": WanDiT, "hunyuan": HunyuanVideoDiT, "flux": FluxDiT,
            "cogvideox": CogVideoXDiT}[family]


def _convert_args(family: str, cfg) -> tuple:
    if family == "wan":
        return (cfg.num_blocks,)
    if family == "cogvideox":
        return (cfg.num_blocks, cfg.use_ofs_embed, cfg.patch_size_t,
                cfg.patch_size)
    if family == "flux":
        return (cfg.num_dual_blocks, cfg.num_single_blocks)
    return (cfg.num_dual_blocks, cfg.num_single_blocks,
            cfg.num_refiner_blocks, cfg.pooled_dim, cfg.text_dim)


def load_transformer(family: str, root: str, dtype="bfloat16",
                     cache: bool = True, strict: bool = True,
                     device="cuda", mlp_chunk: int = 1):
    """(config, model with its weights on ``device``) from
    <root>/transformer (or <root>).

    ``strict`` (default) fails when any state-dict key goes unconsumed
    (tests/manifests/*_keys.json pin the expected key sets).  ``cache``
    reads the converted weights from, or else writes them to,
    <transformer>/.rsa_torch_params (a read-only snapshot skips the
    write).  ``device`` defaults to the card and raises without one
    unless it is "cpu".  ``mlp_chunk`` sets the built model's FFN
    sequence chunking (a config field that carries no weights)."""
    from .checkpoint import has_params, load_params, save_params
    from .weights import CONVERTERS, convert_strict, load_safetensors_dir
    device = resolve_device(device)
    place = _placer(device, _dtype(dtype))
    tdir = _subdir(root, "transformer") or root
    cfg = CONFIG_PARSERS[family](_read_json(os.path.join(tdir,
                                                         "config.json")))
    if mlp_chunk > 1:
        cfg = dataclasses.replace(cfg, mlp_chunk=mlp_chunk)
    cache_dir = os.path.join(tdir, CACHE_DIR)
    if cache and has_params(cache_dir):
        state = {k: place(t) for k, t in load_params(cache_dir).items()}
    else:
        sd = load_safetensors_dir(tdir)
        args = _convert_args(family, cfg)
        if strict:
            state = convert_strict(family, sd, *args, place=place)
        else:
            state = CONVERTERS[family](sd, *args, place=place)
        del sd
        if cache:
            try:
                save_params(state, cache_dir)
            except OSError:
                pass            # a read-only snapshot: no cache
    model = _assemble(lambda: _model_class(family)(cfg), state)
    return cfg, model


def load_flux_controlnet(root: str, dtype="bfloat16", device="cuda"):
    """(FluxControlNetConfig, FluxControlNet with its weights on
    ``device``) from a FluxControlNetModel snapshot directory (the jasperai
    Flux.1-dev-Controlnet-Upscaler layout; reference loads it at
    scripts/main_upflux.py:308-311).  Strict, as load_transformer."""
    from .flux import FluxControlNet
    from .weights import convert_strict, load_safetensors_dir
    device = resolve_device(device)
    cfg = flux_controlnet_config_from_json(
        _read_json(os.path.join(root, "config.json")))
    state = convert_strict("flux_controlnet", load_safetensors_dir(root),
                           cfg.num_dual_blocks, cfg.num_single_blocks,
                           place=_placer(device, _dtype(dtype)))
    return cfg, _assemble(lambda: FluxControlNet(cfg), state)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

def vae_config_from_json(cfg: dict, video: bool):
    """A diffusers VAE config.json as VAEConfig (the AutoencoderKL
    skeleton; decoders upsample in their first blocks)."""
    from .vae import VAEConfig
    n = len(cfg["block_out_channels"])
    t_ratio = cfg.get("temporal_compression_ratio", 4)
    s_ratio = cfg.get("spatial_compression_ratio",
                      2 ** (n - 1) if not video else 8)
    n_t = int(math.log2(t_ratio)) if video else 0
    n_s = int(math.log2(s_ratio))
    return VAEConfig(
        latent_channels=cfg.get("latent_channels", 16),
        out_channels=cfg.get("out_channels", 3),
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        temporal_upsample=tuple(i < n_t for i in range(n)),
        spatial_upsample=tuple(i < n_s for i in range(n)),
        video=video,
        mid_attention=bool(cfg.get("mid_block_add_attention", True)),
        quant_conv=bool(cfg.get("use_quant_conv",
                                "quant_conv" in str(cfg))),
        scaling_factor=cfg.get("scaling_factor", 1.0),
        shift_factor=cfg.get("shift_factor") or 0.0,
        latents_mean=(tuple(cfg["latents_mean"])
                      if cfg.get("latents_mean") else None),
        latents_std=(tuple(cfg["latents_std"])
                     if cfg.get("latents_std") else None))


def load_vae(root: str, video: bool = True, dtype="float32", device="cuda"):
    """(encode, decode) from <root>/vae, or (None, None) without one;
    encode is None for a decoder-only snapshot.

    encode: pixels [B, 3, (F,) H, W] in [-1, 1] -> normalised latents.
    decode: latents -> pixels.  Both run on ``device`` in ``dtype`` (the
    weights' dtype) and take inputs on any device."""
    from .vae import VAEDecoder, VAEEncoder
    from .weights import (convert_vae_decoder, convert_vae_encoder,
                          load_safetensors_dir)
    device = resolve_device(device)
    dt = _dtype(dtype)
    vdir = _subdir(root, "vae")
    if vdir is None:
        return None, None
    cfg = vae_config_from_json(_read_json(os.path.join(vdir, "config.json")),
                               video)
    sd = load_safetensors_dir(vdir)
    n = len(cfg.block_out_channels)
    place = _placer(device, dt)
    dec = _assemble(lambda: VAEDecoder(cfg), convert_vae_decoder(
        sd, n, cfg.layers_per_block, cfg.video, place=place))
    try:
        enc_state = convert_vae_encoder(sd, n, cfg.layers_per_block,
                                        cfg.video, place=place)
    except KeyError:
        enc = None               # a decoder-only snapshot
    else:
        enc = _assemble(lambda: VAEEncoder(cfg), enc_state)

    @torch.no_grad()
    def decode(z):
        return dec(z.to(device=device, dtype=dt))

    @torch.no_grad()
    def encode(px):
        return enc(px.to(device=device, dtype=dt))

    return (encode if enc is not None else None), decode


# ---------------------------------------------------------------------------
# Text encoders
# ---------------------------------------------------------------------------

TEXT_ENCODER_KINDS = {
    # family -> [(subfolder, kind, max_len)], primary first
    "wan": [("text_encoder", "umt5", 512)],
    "hunyuan": [("text_encoder", "llama", 256),
                ("text_encoder_2", "clip", 77)],
    "flux": [("text_encoder_2", "t5", 512),
             ("text_encoder", "clip", 77)],
    "cogvideox": [("text_encoder", "t5", 226)],
}


def load_text_encoders(family: str, root: str, device="cuda") -> list:
    """The family's bundled encoders as TransformersTextEncoder (primary
    first, loaded on first use, outputs on ``device``); empty when the
    snapshot has none."""
    from .encoders import TransformersTextEncoder
    device = resolve_device(device)
    out = []
    for sub, kind, max_len in TEXT_ENCODER_KINDS[family]:
        d = _subdir(root, sub)
        if d is None:
            continue
        tok = _subdir(root, "tokenizer_2" if sub.endswith("_2")
                      else "tokenizer")
        out.append(TransformersTextEncoder(d, max_len, kind,
                                           tokenizer_dir=tok, device=device))
    return out
