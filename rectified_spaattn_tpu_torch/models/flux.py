"""Flux.1-dev DiT backbone and its upscaler ControlNet (port of
rectified_spaattn_tpu/models/flux.py; the architecture of diffusers'
``FluxTransformer2DModel`` and ``FluxControlNetModel``, reference script
scripts/main_upflux.py:287-328, attention rectified_flux_attn.py).

19 dual-stream + 38 single-stream blocks (HunyuanVideo's classes), dim
3072 / 24 heads of 128, 2-D RoPE over the (text-id, h, w) axes with the
text tokens at position 0 (so RoPE leaves them as they are), guidance
embedding.  The input is 2x2-packed latent tokens [B, gh*gw, 64]
(pipelines/flux.py::flux_pack_latents).  The sparse layer gate (sparse iff
the fused block index < 37 or >= 57, rectified_flux_attn.py:493) is the
pipeline's per-block attention-function lists.

The forward is split into embed / run_blocks / head, as HunyuanVideo's, so
the TeaCache step skip branches in the host loop.  ``FluxControlNet`` runs
a short dual-stream trunk on [noisy tokens + embedded control tokens] and
emits one residual sample per block; its default attention is the dense
flash kernel K3 over all tokens, padded text slots included (the JAX
module's unmasked "vanilla", computed without a score matrix).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from .layers import (AdaLayerNormContinuous, AttnFn, DualStreamBlock, MLP,
                     QLinear, SingleStreamBlock, init_random_weights,
                     rope_axial_freqs, timestep_embedding)


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64            # 2x2-packed 16-channel latents
    out_channels: int = 64
    hidden_dim: int = 3072
    heads: int = 24
    head_dim: int = 128
    num_dual_blocks: int = 19
    num_single_blocks: int = 38
    mlp_mult: float = 4.0
    text_dim: int = 4096             # T5 hidden
    pooled_dim: int = 768            # CLIP pooled
    rope_axes_dim: tuple = (16, 56, 56)
    rope_theta: float = 10000.0
    guidance_embeds: bool = True

    @classmethod
    def tiny(cls):
        """Small config for CPU tests (the JAX package's)."""
        return cls(in_channels=8, out_channels=8, hidden_dim=64, heads=2,
                   head_dim=32, num_dual_blocks=1, num_single_blocks=1,
                   text_dim=32, pooled_dim=16, rope_axes_dim=(8, 12, 12))


@dataclasses.dataclass(frozen=True)
class FluxControlNetConfig:
    """diffusers FluxControlNetModel's shape (the jasperai
    Flux.1-dev-Controlnet-Upscaler checkpoint: the Flux embedders, a
    truncated dual-stream trunk, a zero-initialised conditioning embedder
    and per-block output projections; reference loads it at
    scripts/main_upflux.py:300-305)."""
    in_channels: int = 64
    cond_channels: int = 64          # packed control-image latent tokens
    hidden_dim: int = 3072
    heads: int = 24
    num_dual_blocks: int = 5
    num_single_blocks: int = 0
    mlp_mult: float = 4.0
    text_dim: int = 4096
    pooled_dim: int = 768
    rope_axes_dim: tuple = (16, 56, 56)
    rope_theta: float = 10000.0
    guidance_embeds: bool = True

    @classmethod
    def tiny(cls):
        return cls(in_channels=8, cond_channels=8, hidden_dim=64, heads=2,
                   num_dual_blocks=2, num_single_blocks=0, text_dim=32,
                   pooled_dim=16, rope_axes_dim=(8, 12, 12))


class _FluxTrunk(nn.Module):
    """The embedders, RoPE and block lists FluxDiT and FluxControlNet
    share (the same state-dict names in both diffusers models).  The
    diffusers TimestepEmbedding (linear_1, silu, linear_2) is the JAX
    package's (Dense in, MLP(fc1, silu, fc2)) pair; a checkpoint's fc1 is
    the identity (models/weights.py)."""

    def __init__(self, c):
        super().__init__()
        self.cfg = c
        hd = c.hidden_dim
        self.x_embedder = QLinear(c.in_channels, hd)
        self.context_embedder = QLinear(c.text_dim, hd)
        self.time_in = QLinear(256, hd)
        self.time_mlp = MLP(hd, 1.0, activation="silu")
        self.pooled_in = QLinear(c.pooled_dim, hd)
        self.pooled_mlp = MLP(hd, 1.0, activation="silu")
        if c.guidance_embeds:
            self.guide_in = QLinear(256, hd)
            self.guide_mlp = MLP(hd, 1.0, activation="silu")
        self.dual_blocks = nn.ModuleList(
            DualStreamBlock(hd, c.heads, c.mlp_mult)
            for _ in range(c.num_dual_blocks))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(hd, c.heads, c.mlp_mult)
            for _ in range(c.num_single_blocks))

    def _temb(self, timestep, pooled, guidance):
        """timestep and guidance [B] in model units (t / 1000, the
        guidance scale); the embedding multiplies them by 1000."""
        temb = self.time_mlp(self.time_in(
            timestep_embedding(timestep * 1000.0, 256)))
        temb = temb + self.pooled_mlp(self.pooled_in(pooled))
        if self.cfg.guidance_embeds and guidance is not None:
            temb = temb + self.guide_mlp(self.guide_in(
                timestep_embedding(guidance * 1000.0, 256)))
        return temb

    def _rope(self, grid_h, grid_w, perm, device):
        """(cos, sin) [gh*gw, D/2] fp32 over (0, y, x), rows permuted by
        ``perm`` (hilbert_to_linear) into the resident order."""
        c = self.cfg
        yy, xx = torch.meshgrid(torch.arange(grid_h, device=device),
                                torch.arange(grid_w, device=device),
                                indexing="ij")
        yy, xx = yy.reshape(-1), xx.reshape(-1)
        cos, sin = rope_axial_freqs((1, grid_h, grid_w), c.rope_axes_dim,
                                    (torch.zeros_like(yy), yy, xx),
                                    theta=c.rope_theta)
        if perm is not None:
            cos, sin = cos[perm], sin[perm]
        return cos, sin


def _vanilla(q, k, v):
    from ..attention import attention
    return attention(q, k, v, mode="vanilla")


def _dense_flash(q, k, v):
    """The ControlNet's attention: exact softmax over every token, padded
    text slots included (no key window): K3 on a CUDA tensor, its plain
    version on a CPU one."""
    from ..attention import attention
    return attention(q, k, v, mode="flash")


class FluxDiT(_FluxTrunk):
    """The transformer.  Input: packed latent tokens [B, gh*gw,
    in_channels] in linear order, text [B, St, text_dim], pooled [B,
    pooled_dim]."""

    def __init__(self, cfg: FluxConfig):
        super().__init__(cfg)
        self.norm_out = AdaLayerNormContinuous(cfg.hidden_dim)
        self.proj_out = QLinear(cfg.hidden_dim, cfg.out_channels)

    def embed(self, latent_tokens, timestep, text_emb, pooled, guidance,
              grid_h, grid_w, hilbert_to_linear):
        """Stage 1: (x [B,Sv,C] in curve order, ctx, temb [B,C], rope)."""
        x = self.x_embedder(latent_tokens)
        ctx = self.context_embedder(text_emb)
        temb = self._temb(timestep, pooled, guidance)
        rope = self._rope(grid_h, grid_w, hilbert_to_linear, x.device)
        if hilbert_to_linear is not None:
            x = x.index_select(1, hilbert_to_linear)
        return x, ctx, temb, rope

    def teacache_signal(self, x, temb):
        """Block-0 norm1 modulated input (the TeaCache signal of the
        reference script, scripts/main_upflux.py)."""
        return self.dual_blocks[0].norm1(x, temb)[0]

    def run_blocks(self, x, ctx, temb, rope, attn_fn: AttnFn,
                   dual_attn_fns: Optional[Sequence[AttnFn]] = None,
                   single_attn_fns: Optional[Sequence[AttnFn]] = None,
                   controlnet_dual_residuals=None,
                   controlnet_single_residuals=None):
        """Stage 2: one attention function per block (``attn_fn`` where a
        list is not given), and after block i the ControlNet residual i of
        its kind, in the RESIDENT (curve) token order (the pipeline
        distributes the ControlNet's samples over the blocks, reference:
        scripts/main_upflux.py:163-172)."""
        for i, blk in enumerate(self.dual_blocks):
            fn = dual_attn_fns[i] if dual_attn_fns is not None else attn_fn
            x, ctx = blk(x, ctx, temb, rope, fn)
            if controlnet_dual_residuals is not None:
                x = x + controlnet_dual_residuals[i].to(x.dtype)
        for i, blk in enumerate(self.single_blocks):
            fn = (single_attn_fns[i] if single_attn_fns is not None
                  else attn_fn)
            x, ctx = blk(x, ctx, temb, rope, fn)
            if controlnet_single_residuals is not None:
                x = x + controlnet_single_residuals[i].to(x.dtype)
        return x, ctx

    def head(self, x, temb, linear_to_hilbert):
        """Stage 3: un-permute, final norm and projection."""
        if linear_to_hilbert is not None:
            x = x.index_select(1, linear_to_hilbert)
        return self.proj_out(self.norm_out(x, temb))

    def forward(self, latent_tokens, timestep, text_emb, pooled,
                guidance=None, grid_h=None, grid_w=None,
                hilbert_to_linear=None, linear_to_hilbert=None,
                attn_fn: Optional[AttnFn] = None):
        x, ctx, temb, rope = self.embed(latent_tokens, timestep, text_emb,
                                        pooled, guidance, grid_h, grid_w,
                                        hilbert_to_linear)
        x, ctx = self.run_blocks(x, ctx, temb, rope, attn_fn or _vanilla)
        return self.head(x, temb, linear_to_hilbert)


class FluxControlNet(_FluxTrunk):
    """The ControlNet conditioning network: the trunk on x_embedder(noisy
    tokens) + controlnet_x_embedder(control tokens), one zero-initialised
    projection of x after each block (``cn_proj_{i}``,
    ``cn_single_proj_{i}``, the Flax names).  The main model adds
    sample[i // ceil(n_main / n_samples)] after its block i (reference:
    main_upflux.py:163-172).

    With ``hilbert_to_linear`` the linear-order inputs AND the RoPE rows
    are permuted into the curve order, so the samples come out in the
    trunk's resident order and need no un-permute; attention is
    permutation-equivariant once RoPE moves with the tokens, so this is
    the reference's linear-order ControlNet whose samples are permuted
    afterwards (main_upflux.py:114-116)."""

    def __init__(self, cfg: FluxControlNetConfig):
        super().__init__(cfg)
        hd = cfg.hidden_dim
        self.controlnet_x_embedder = QLinear(cfg.cond_channels, hd)
        for i in range(cfg.num_dual_blocks):
            setattr(self, f"cn_proj_{i}", QLinear(hd, hd))
        for i in range(cfg.num_single_blocks):
            setattr(self, f"cn_single_proj_{i}", QLinear(hd, hd))
        self.zero_outputs_()

    @torch.no_grad()
    def zero_outputs_(self):
        """Zero the conditioning embedder and the output projections
        (diffusers' zero_module): the ControlNet is then an exact
        no-op."""
        for mod in self.output_layers():
            mod.weight.zero_()
            mod.bias.zero_()
        return self

    def output_layers(self):
        c = self.cfg
        return [self.controlnet_x_embedder,
                *(getattr(self, f"cn_proj_{i}")
                  for i in range(c.num_dual_blocks)),
                *(getattr(self, f"cn_single_proj_{i}")
                  for i in range(c.num_single_blocks))]

    def forward(self, latent_tokens, control_tokens, timestep, text_emb,
                pooled, guidance, grid_h, grid_w, hilbert_to_linear=None,
                conditioning_scale: float = 1.0,
                attn_fn: Optional[AttnFn] = None,
                compute_dtype: Optional[torch.dtype] = None):
        """latent_tokens / control_tokens [B, Sv, C] (linear order when
        ``hilbert_to_linear`` is given, else already resident).
        ``compute_dtype``: the activations' dtype after the embedders (the
        CUDA kernels take bf16).  Returns (dual_samples, single_samples),
        lists of [B, Sv, hidden]."""
        c = self.cfg
        attn_fn = attn_fn or _dense_flash
        if hilbert_to_linear is not None:
            latent_tokens = latent_tokens.index_select(1, hilbert_to_linear)
            control_tokens = control_tokens.index_select(1,
                                                         hilbert_to_linear)
        x = (self.x_embedder(latent_tokens)
             + self.controlnet_x_embedder(control_tokens))
        ctx = self.context_embedder(text_emb)
        temb = self._temb(timestep, pooled, guidance)
        if compute_dtype is not None:
            x, ctx, temb = (t.to(compute_dtype) for t in (x, ctx, temb))
        rope = self._rope(grid_h, grid_w, hilbert_to_linear, x.device)
        dual, single = [], []
        for i, blk in enumerate(self.dual_blocks):
            x, ctx = blk(x, ctx, temb, rope, attn_fn)
            dual.append(getattr(self, f"cn_proj_{i}")(x)
                        * conditioning_scale)
        for i, blk in enumerate(self.single_blocks):
            x, ctx = blk(x, ctx, temb, rope, attn_fn)
            single.append(getattr(self, f"cn_single_proj_{i}")(x)
                          * conditioning_scale)
        return dual, single


@torch.no_grad()
def init_controlnet_weights(cn: FluxControlNet, generator: torch.Generator,
                            nudge: float = 0.0) -> FluxControlNet:
    """Seeded random weights for a checkpoint-less ControlNet:
    ``init_random_weights``, the conditioning embedder and the output
    projections zeroed (a no-op ControlNet, as diffusers initialises it),
    then, with ``nudge``, every parameter moved by nudge * N(0, 1) so the
    conditioned path does something (the JAX CLI's random-weight demo:
    0.02)."""
    init_random_weights(cn, generator)
    cn.zero_outputs_()
    if nudge:
        for p in cn.parameters():
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            w.normal_(0.0, 1.0, generator=generator)
            p.add_((nudge * w).to(p.dtype))
    return cn


def distribute_controlnet_samples(samples, num_blocks: int):
    """Expand N ControlNet samples to one residual per main-model block:
    block i gets samples[i // ceil(num_blocks / N)] (reference:
    main_upflux.py:163-172); None for no samples."""
    if not samples:
        return None
    interval = math.ceil(num_blocks / len(samples))
    return [samples[min(i // interval, len(samples) - 1)]
            for i in range(num_blocks)]
