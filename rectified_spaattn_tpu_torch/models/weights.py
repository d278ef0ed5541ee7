"""Checkpoint loading: diffusers safetensors state dicts -> the port's
``state_dict`` (port of rectified_spaattn_tpu/models/weights.py).

Each ``convert_*`` maps the diffusers names straight onto the port's
module names, one tensor at a time and in the file's dtype; nothing goes
through a Flax-shaped tree.  The torch layouts are kept: an
``nn.Linear`` / ``QLinear`` weight is [out, in] on both sides and a conv
weight [out, in, *k].  The transforms are the JAX converters':

  * the conv3d patch embed [out, in, kt, kh, kw] becomes the Linear weight
    [out, kt*kh*kw*in] in the token feature order of the models'
    ``_patchify`` (kt, kh, kw, in);
  * separate q / k / v projections are concatenated where the port fuses
    them (the token refiner's ``blk{i}_qkv``, the single blocks' ``to_qkv``);
  * a diffusers TimestepEmbedding (linear_1, silu, linear_2) becomes the
    port's (Linear in, MLP(fc1 = identity, silu, fc2 = linear_2)) pair;
  * HunyuanVideo's ``clip_pool_proj`` (no checkpoint counterpart) is zeros;
  * the FluxControlNet's ``controlnet_blocks.{i}`` /
    ``controlnet_single_blocks.{i}`` are the port's ``cn_proj_{i}`` /
    ``cn_single_proj_{i}`` (the Flax names);
  * Wan's [6, d] modulation tables gain a leading axis;
  * CogVideoX 1.5's channel-major patch features (C, pt, p, p) become the
    port's channel-last order (pt, p, p, C) in patch_embed's input and
    proj_out's output features.

``place``, where given, is applied to each tensor as it is made (for
example a move to the device and a cast), so the converted model is never
held twice on the host.  ``convert_strict`` fails on any state-dict key
the converter did not read; a missing key raises ``KeyError``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .safetensors_io import load_safetensors_dir  # noqa: F401 (re-export)

Place = Optional[Callable[[torch.Tensor], torch.Tensor]]


class _Out(dict):
    """The converted state dict; ``place`` runs on every tensor stored."""

    def __init__(self, place: Place):
        super().__init__()
        self._place = place

    def __setitem__(self, key, t):
        if key in self:
            raise KeyError(f"{key!r} converted twice")
        super().__setitem__(key, self._place(t) if self._place else t)

    def linear(self, key, sd, prefix):
        """A diffusers Linear ``prefix`` as the port's Linear ``key``."""
        self[key + ".weight"] = sd[prefix + ".weight"]
        self[key + ".bias"] = sd[prefix + ".bias"]

    def linear_opt_bias(self, key, sd, prefix):
        """A Linear or conv whose bias the state dict may lack."""
        self[key + ".weight"] = sd[prefix + ".weight"]
        if prefix + ".bias" in sd:
            self[key + ".bias"] = sd[prefix + ".bias"]

    def rms(self, key, sd, prefix):
        """An RMSNorm: its weight."""
        self[key + ".weight"] = sd[prefix + ".weight"]

    def norm(self, key, sd, prefix):
        """A LayerNorm / GroupNorm: its weight and bias where the state
        dict has them."""
        for leaf in ("weight", "bias"):
            if f"{prefix}.{leaf}" in sd:
                self[f"{key}.{leaf}"] = sd[f"{prefix}.{leaf}"]

    def fused(self, key, sd, prefixes):
        """Projections concatenated along their outputs."""
        for leaf in ("weight", "bias"):
            self[f"{key}.{leaf}"] = torch.cat(
                [sd[f"{p}.{leaf}"] for p in prefixes], dim=0)

    def folded_embedder(self, lin_in, mlp, sd, prefix):
        """diffusers TimestepEmbedding -> (Linear in, MLP(identity, fc2))."""
        self.linear(lin_in, sd, prefix + ".linear_1")
        w2 = sd[prefix + ".linear_2.weight"]
        self[mlp + ".fc1.weight"] = torch.eye(w2.shape[1], dtype=w2.dtype)
        self[mlp + ".fc1.bias"] = torch.zeros(w2.shape[1], dtype=w2.dtype)
        self.linear(mlp + ".fc2", sd, prefix + ".linear_2")


def _patch_embed(w: torch.Tensor) -> torch.Tensor:
    """[out, in, kt, kh, kw] conv -> [out, kt*kh*kw*in] Linear weight in
    _patchify's (kt, kh, kw, in) feature order."""
    return w.permute(0, 2, 3, 4, 1).reshape(w.shape[0], -1)


def _table(t: torch.Tensor) -> torch.Tensor:
    return t[None] if t.ndim == 2 else t


def convert_wan(sd, num_blocks: int, place: Place = None) -> dict:
    """diffusers WanTransformer3DModel -> WanDiT state_dict."""
    out = _Out(place)
    out["patch_embedding.weight"] = _patch_embed(sd["patch_embedding.weight"])
    out["patch_embedding.bias"] = sd["patch_embedding.bias"]
    ce = "condition_embedder"
    out.linear("text_embedder.fc1", sd, f"{ce}.text_embedder.linear_1")
    out.linear("text_embedder.fc2", sd, f"{ce}.text_embedder.linear_2")
    out.folded_embedder("time_in", "time_embedder", sd,
                        f"{ce}.time_embedder")
    out.linear("time_proj", sd, f"{ce}.time_proj")
    if f"{ce}.image_embedder.norm1.weight" in sd:           # I2V
        ie = f"{ce}.image_embedder"
        out.norm("img_norm1", sd, f"{ie}.norm1")
        out.linear("img_ff.fc1", sd, f"{ie}.ff.net.0.proj")
        out.linear("img_ff.fc2", sd, f"{ie}.ff.net.2")
        out.norm("img_norm2", sd, f"{ie}.norm2")
    for i in range(num_blocks):
        b, o = f"blocks.{i}", f"blocks.{i}"
        out[f"{o}.scale_shift_table"] = _table(sd[f"{b}.scale_shift_table"])
        for a in ("attn1", "attn2"):
            for nm in ("to_q", "to_k", "to_v"):
                out.linear(f"{o}.{a}_{nm}", sd, f"{b}.{a}.{nm}")
            out.linear(f"{o}.{a}_to_out", sd, f"{b}.{a}.to_out.0")
            out.rms(f"{o}.{a}_norm_q", sd, f"{b}.{a}.norm_q")
            out.rms(f"{o}.{a}_norm_k", sd, f"{b}.{a}.norm_k")
        out.norm(f"{o}.norm2", sd, f"{b}.norm2")
        out.linear(f"{o}.ffn.fc1", sd, f"{b}.ffn.net.0.proj")
        out.linear(f"{o}.ffn.fc2", sd, f"{b}.ffn.net.2")
        if f"{b}.attn2.add_k_proj.weight" in sd:          # I2V image branch
            out.linear(f"{o}.attn2_add_k_proj", sd, f"{b}.attn2.add_k_proj")
            out.linear(f"{o}.attn2_add_v_proj", sd, f"{b}.attn2.add_v_proj")
            out.rms(f"{o}.attn2_norm_added_k", sd,
                    f"{b}.attn2.norm_added_k")
    out["scale_shift_table_out"] = _table(sd["scale_shift_table"])
    out.linear("proj_out", sd, "proj_out")
    return dict(out)


def _mmdit_blocks(out, sd, num_dual: int, num_single: int) -> None:
    """The dual- and single-stream blocks of diffusers' HunyuanVideo and
    Flux transformers (the same names in both): the single blocks'
    separate to_q / to_k / to_v are fused into to_qkv, one proj_out over
    [attention ; MLP]."""
    for i in range(num_dual):
        b, o = f"transformer_blocks.{i}", f"dual_blocks.{i}"
        out.linear(f"{o}.norm1.linear", sd, f"{b}.norm1.linear")
        out.linear(f"{o}.norm1_context.linear", sd,
                   f"{b}.norm1_context.linear")
        for ours, theirs in (("to_q", "to_q"), ("to_k", "to_k"),
                             ("to_v", "to_v"), ("add_to_q", "add_q_proj"),
                             ("add_to_k", "add_k_proj"),
                             ("add_to_v", "add_v_proj"),
                             ("to_out", "to_out.0"),
                             ("to_add_out", "to_add_out")):
            out.linear(f"{o}.attn.{ours}", sd, f"{b}.attn.{theirs}")
        for nm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            out.rms(f"{o}.attn.{nm}", sd, f"{b}.attn.{nm}")
        for ff in ("ff", "ff_context"):
            out.linear(f"{o}.{ff}.fc1", sd, f"{b}.{ff}.net.0.proj")
            out.linear(f"{o}.{ff}.fc2", sd, f"{b}.{ff}.net.2")
    for i in range(num_single):
        b, o = f"single_transformer_blocks.{i}", f"single_blocks.{i}"
        out.linear(f"{o}.norm.linear", sd, f"{b}.norm.linear")
        out.fused(f"{o}.to_qkv", sd, [f"{b}.attn.to_{x}" for x in "qkv"])
        out.rms(f"{o}.norm_q", sd, f"{b}.attn.norm_q")
        out.rms(f"{o}.norm_k", sd, f"{b}.attn.norm_k")
        out.linear(f"{o}.proj_mlp", sd, f"{b}.proj_mlp")
        out.linear(f"{o}.proj_out", sd, f"{b}.proj_out")


def convert_hunyuan(sd, num_dual: int, num_single: int, num_refiner: int = 2,
                    pooled_dim: int = 768, text_dim: int = 4096,
                    place: Place = None) -> dict:
    """diffusers HunyuanVideoTransformer3DModel -> HunyuanVideoDiT
    state_dict."""
    out = _Out(place)
    out["x_embedder.weight"] = _patch_embed(sd["x_embedder.proj.weight"])
    out["x_embedder.bias"] = sd["x_embedder.proj.bias"]
    tte = "time_text_embed"
    out.folded_embedder("time_in", "time_mlp", sd,
                        f"{tte}.timestep_embedder")
    out.folded_embedder("pooled_in", "pooled_mlp", sd,
                        f"{tte}.text_embedder")
    if f"{tte}.guidance_embedder.linear_1.weight" in sd:
        out.folded_embedder("guide_in", "guide_mlp", sd,
                            f"{tte}.guidance_embedder")
    # the stand-in projection of a synthesised pooled input (unused when
    # the real CLIP pooled vector is passed; no checkpoint counterpart)
    dt = sd["x_embedder.proj.weight"].dtype
    out["clip_pool_proj.weight"] = torch.zeros((pooled_dim, text_dim),
                                               dtype=dt)
    out["clip_pool_proj.bias"] = torch.zeros(pooled_dim, dtype=dt)

    ce, r = "context_embedder", "context_embedder"
    out.linear(f"{r}.proj_in", sd, f"{ce}.proj_in")
    out.folded_embedder(f"{r}.time_in", f"{r}.time_mlp", sd,
                        f"{ce}.time_text_embed.timestep_embedder")
    out.folded_embedder(f"{r}.pool_in", f"{r}.pool_mlp", sd,
                        f"{ce}.time_text_embed.text_embedder")
    for i in range(num_refiner):
        b = f"{ce}.token_refiner.refiner_blocks.{i}"
        out.norm(f"{r}.blk{i}_norm1", sd, f"{b}.norm1")
        out.fused(f"{r}.blk{i}_qkv", sd,
                  [f"{b}.attn.to_{x}" for x in "qkv"])
        out.linear(f"{r}.blk{i}_proj", sd, f"{b}.attn.to_out.0")
        out.norm(f"{r}.blk{i}_norm2", sd, f"{b}.norm2")
        out.linear(f"{r}.blk{i}_mlp.fc1", sd, f"{b}.ff.net.0.proj")
        out.linear(f"{r}.blk{i}_mlp.fc2", sd, f"{b}.ff.net.2")
        out.linear(f"{r}.blk{i}_ada", sd, f"{b}.norm_out.linear")

    _mmdit_blocks(out, sd, num_dual, num_single)
    out.linear("norm_out.linear", sd, "norm_out.linear")
    out.linear("proj_out", sd, "proj_out")
    return dict(out)


def convert_cogvideox(sd, num_blocks: int, use_ofs: bool = True,
                      patch_size_t: int = 2, patch_size: int = 2,
                      place: Place = None) -> dict:
    """diffusers CogVideoXTransformer3DModel -> CogVideoXDiT state_dict:
    1.5's Linear patch embed, or 1.0's Conv2d one ([out, in, p, p] per
    frame).  diffusers orders a token's features channel-major (C, pt, p,
    p); the port's ``_patchify`` / ``_unpatchify`` channel-last (pt, p,
    p, C), so 1.5's patch_embed input features and proj_out's output
    features are permuted (JAX ``convert_cogvideox``'s transform)."""
    out = _Out(place)
    pt, ps = patch_size_t, patch_size
    w = sd["patch_embed.proj.weight"]
    if w.ndim == 2:        # 1.5 Linear patchify: (C, pt, p, p) -> (pt, p, p, C)
        hid, fin = w.shape
        ch = fin // (pt * ps * ps)
        out["patch_embed.weight"] = w.reshape(hid, ch, pt, ps, ps).permute(
            0, 2, 3, 4, 1).reshape(hid, fin)
    else:                  # 1.0 Conv2d: [out, in, p, p] -> (p, p, in)
        out["patch_embed.weight"] = w.permute(0, 2, 3, 1).reshape(
            w.shape[0], -1)
    out["patch_embed.bias"] = sd["patch_embed.proj.bias"]
    out.linear("text_proj", sd, "patch_embed.text_proj")
    out.folded_embedder("time_in", "time_mlp", sd, "time_embedding")
    if use_ofs and "ofs_embedding.linear_1.weight" in sd:
        out.folded_embedder("ofs_in", "ofs_mlp", sd, "ofs_embedding")
    for i in range(num_blocks):
        b, o = f"transformer_blocks.{i}", f"blocks.{i}"
        for n in ("norm1", "norm2"):
            out.linear(f"{o}.{n}_lin", sd, f"{b}.{n}.linear")
            out.norm(f"{o}.{n}_ln", sd, f"{b}.{n}.norm")
        for nm in ("to_q", "to_k", "to_v"):
            out.linear(f"{o}.{nm}", sd, f"{b}.attn1.{nm}")
        out.norm(f"{o}.norm_q", sd, f"{b}.attn1.norm_q")
        out.norm(f"{o}.norm_k", sd, f"{b}.attn1.norm_k")
        out.linear(f"{o}.to_out", sd, f"{b}.attn1.to_out.0")
        out.linear(f"{o}.ff.fc1", sd, f"{b}.ff.net.0.proj")
        out.linear(f"{o}.ff.fc2", sd, f"{b}.ff.net.2")
    out.norm("norm_final", sd, "norm_final")
    out.linear("norm_out_lin", sd, "norm_out.linear")
    out.norm("norm_out_ln", sd, "norm_out.norm")
    # output features (C, pt, p, p) -> (pt, p, p, C); 1.0: pt == 1
    wo, bo = sd["proj_out.weight"], sd["proj_out.bias"]
    fout, hid = wo.shape
    och = fout // (pt * ps * ps)
    out["proj_out.weight"] = wo.reshape(och, pt, ps, ps, hid).permute(
        1, 2, 3, 0, 4).reshape(fout, hid)
    out["proj_out.bias"] = bo.reshape(och, pt, ps, ps).permute(
        1, 2, 3, 0).reshape(fout)
    return dict(out)


def _flux_embedders(out, sd) -> None:
    """The Flux trunk's conditioning embedders (x / context / time /
    pooled / guidance): the same keys in FluxTransformer2DModel and
    FluxControlNetModel state dicts."""
    out.linear("x_embedder", sd, "x_embedder")
    out.linear("context_embedder", sd, "context_embedder")
    tte = "time_text_embed"
    out.folded_embedder("time_in", "time_mlp", sd,
                        f"{tte}.timestep_embedder")
    out.folded_embedder("pooled_in", "pooled_mlp", sd, f"{tte}.text_embedder")
    if f"{tte}.guidance_embedder.linear_1.weight" in sd:
        out.folded_embedder("guide_in", "guide_mlp", sd,
                            f"{tte}.guidance_embedder")


def convert_flux(sd, num_dual: int, num_single: int,
                 place: Place = None) -> dict:
    """diffusers FluxTransformer2DModel -> FluxDiT state_dict."""
    out = _Out(place)
    _flux_embedders(out, sd)
    _mmdit_blocks(out, sd, num_dual, num_single)
    out.linear("norm_out.linear", sd, "norm_out.linear")
    out.linear("proj_out", sd, "proj_out")
    return dict(out)


def convert_flux_controlnet(sd, num_dual: int, num_single: int,
                            place: Place = None) -> dict:
    """diffusers FluxControlNetModel -> FluxControlNet state_dict (the
    jasperai Flux.1-dev-Controlnet-Upscaler layout: the Flux embedders, a
    truncated trunk, controlnet_x_embedder and one output projection per
    block; reference loads it at scripts/main_upflux.py:308-311)."""
    out = _Out(place)
    _flux_embedders(out, sd)
    _mmdit_blocks(out, sd, num_dual, num_single)
    out.linear("controlnet_x_embedder", sd, "controlnet_x_embedder")
    for i in range(num_dual):
        out.linear(f"cn_proj_{i}", sd, f"controlnet_blocks.{i}")
    for i in range(num_single):
        out.linear(f"cn_single_proj_{i}", sd, f"controlnet_single_blocks.{i}")
    return dict(out)


CONVERTERS: dict[str, Callable] = {
    "wan": convert_wan,
    "flux": convert_flux,
    "flux_controlnet": convert_flux_controlnet,
    "hunyuan": convert_hunyuan,
    "cogvideox": convert_cogvideox,
}


class TrackedStateDict:
    """Mapping wrapper that records every key a converter read.  After the
    conversion, ``unused`` holds the state-dict keys never read: the
    naming-drift failure a real checkpoint would otherwise hit silently."""

    def __init__(self, sd: dict):
        self._sd = sd
        self.used: set = set()

    def __getitem__(self, k):
        v = self._sd[k]
        self.used.add(k)
        return v

    def get(self, k, default=None):
        if k in self._sd:
            return self[k]
        return default

    def __contains__(self, k):
        return k in self._sd

    def __iter__(self):
        return iter(self._sd)

    def __len__(self):
        return len(self._sd)

    def keys(self):
        return self._sd.keys()

    @property
    def unused(self) -> set:
        return set(self._sd) - self.used


def convert_strict(family: str, sd: dict, *args, **kwargs) -> dict:
    """``CONVERTERS[family]`` that fails if any state-dict key went
    unconsumed (unknown or renamed keys)."""
    tracker = TrackedStateDict(sd)
    out = CONVERTERS[family](tracker, *args, **kwargs)
    if tracker.unused:
        sample = sorted(tracker.unused)[:8]
        raise ValueError(
            f"convert_{family}: {len(tracker.unused)} state-dict keys were "
            f"not consumed (name/layout drift?): {sample}")
    return out


# ---------------------------------------------------------------------------
# VAE converters (the diffusers AutoencoderKL / KLHunyuanVideo family
# layout: conv_in -> mid(resnet, attention, resnet) -> up / down blocks ->
# conv_norm_out -> conv_out, plus the optional quant convs)
# ---------------------------------------------------------------------------

def _vae_conv(out, key, sd, prefix, video):
    """A diffusers conv onto the port's: video convs are CausalConv3d
    modules holding an ``nn.Conv3d`` named ``conv``."""
    out.linear_opt_bias(key + ".conv" if video else key, sd, prefix)


def _vae_resnet(out, key, sd, prefix, video):
    out.norm(key + ".norm1", sd, prefix + ".norm1")
    _vae_conv(out, key + ".conv1", sd, prefix + ".conv1", video)
    out.norm(key + ".norm2", sd, prefix + ".norm2")
    _vae_conv(out, key + ".conv2", sd, prefix + ".conv2", video)
    if prefix + ".conv_shortcut.weight" in sd:
        _vae_conv(out, key + ".conv_shortcut", sd, prefix + ".conv_shortcut",
                  video)


def _vae_mid(out, sd, prefix, video):
    _vae_resnet(out, "mid_res1", sd, prefix + ".resnets.0", video)
    _vae_resnet(out, "mid_res2", sd, prefix + ".resnets.1", video)
    attn = prefix + ".attentions.0"
    if attn + ".to_q.weight" in sd:
        out.norm("mid_attn.group_norm", sd, attn + ".group_norm")
        for nm in ("to_q", "to_k", "to_v"):
            out.linear_opt_bias(f"mid_attn.{nm}", sd, f"{attn}.{nm}")
        out.linear_opt_bias("mid_attn.to_out", sd, attn + ".to_out.0")


def convert_vae_decoder(sd, num_up_blocks: int, layers_per_block: int,
                        video: bool = True, place: Place = None) -> dict:
    """diffusers VAE ``decoder.*`` keys -> VAEDecoder state_dict (up-blocks
    carry layers_per_block + 1 resnets)."""
    out = _Out(place)
    _vae_conv(out, "conv_in", sd, "decoder.conv_in", video)
    _vae_mid(out, sd, "decoder.mid_block", video)
    for i in range(num_up_blocks):
        for j in range(layers_per_block + 1):
            _vae_resnet(out, f"up{i}_res{j}", sd,
                        f"decoder.up_blocks.{i}.resnets.{j}", video)
        up = f"decoder.up_blocks.{i}.upsamplers.0.conv"
        if up + ".weight" in sd:
            _vae_conv(out, f"up{i}_conv", sd, up, video)
    out.norm("norm_out", sd, "decoder.conv_norm_out")
    _vae_conv(out, "conv_out", sd, "decoder.conv_out", video)
    if "post_quant_conv.weight" in sd:
        out.linear_opt_bias("post_quant_conv", sd, "post_quant_conv")
    return dict(out)


def convert_vae_encoder(sd, num_down_blocks: int, layers_per_block: int,
                        video: bool = True, place: Place = None) -> dict:
    """diffusers VAE ``encoder.*`` keys -> VAEEncoder state_dict."""
    out = _Out(place)
    _vae_conv(out, "conv_in", sd, "encoder.conv_in", video)
    for i in range(num_down_blocks):
        for j in range(layers_per_block):
            _vae_resnet(out, f"down{i}_res{j}", sd,
                        f"encoder.down_blocks.{i}.resnets.{j}", video)
        dn = f"encoder.down_blocks.{i}.downsamplers.0.conv"
        if dn + ".weight" in sd:
            out.linear_opt_bias(f"down{i}_down.conv", sd, dn)
    _vae_mid(out, sd, "encoder.mid_block", video)
    out.norm("norm_out", sd, "encoder.conv_norm_out")
    _vae_conv(out, "conv_out", sd, "encoder.conv_out", video)
    if "quant_conv.weight" in sd:
        out.linear_opt_bias("quant_conv", sd, "quant_conv")
    return dict(out)
