"""Wan 2.1 DiT backbone (port of rectified_spaattn_tpu/models/wan.py; the
architecture of diffusers' ``WanTransformer3DModel``, reference:
rectified_wan21_attn.py:389-632).

  * Wan2.1 T2V / I2V: visual-only self-attention (the sparse site) and
    dense cross-attention to the text; I2V adds a cross branch over the
    CLIP-vision image context (``image_cross``).
  * Wan2.2 TI2V-5B's per-token timesteps (``per_token_timesteps``): the
    ``embed`` and ``head`` branches (its pipeline: pipelines/wan.py).
  * Wan2.2 A14B's two trees are two WanDiTs (in_channels 36 for I2V,
    without the CLIP image branch; pipelines/wan.py::Wan22A14BPipeline).

The forward is split into embed / blocks / head stages so TeaCache's
step-skip branches in the host sampler loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (AttnFn, CrossAttnBlock, QLinear, LayerNorm, MLP,
                     layer_norm, rope_axial_freqs, timestep_embedding)


@dataclasses.dataclass(frozen=True)
class WanConfig:
    in_channels: int = 16
    out_channels: int = 16
    hidden_dim: int = 5120
    heads: int = 40
    head_dim: int = 128
    num_blocks: int = 40
    ffn_dim: int = 13824
    patch_size: tuple = (1, 2, 2)      # (t, h, w)
    text_dim: int = 4096               # umt5 hidden
    freq_dim: int = 256
    rope_axes_dim: tuple = (44, 42, 42)
    rope_theta: float = 10000.0
    image_cross: bool = False          # I2V image-context branch
    image_dim: int = 1280              # CLIP-vision feature dim (I2V)
    per_token_timesteps: bool = False  # Wan2.2 TI2V
    mlp_chunk: int = 1                 # FFN sequence chunking (peak memory)

    @classmethod
    def tiny(cls, **kw):
        """Small config for CPU tests."""
        kw.setdefault("image_dim", 16)
        kw.setdefault("in_channels", 4)
        kw.setdefault("out_channels", 4)
        return cls(hidden_dim=64, heads=2, head_dim=32, num_blocks=2,
                   ffn_dim=128, text_dim=32, freq_dim=32,
                   rope_axes_dim=(12, 10, 10), **kw)


class WanDiT(nn.Module):
    """The transformer.  Latent input [B, C, T, H, W]; text [B, St,
    text_dim]; image context [B, Si, image_dim] (I2V)."""

    def __init__(self, cfg: WanConfig):
        super().__init__()
        c = self.cfg = cfg
        hd = c.hidden_dim
        pt, ph, pw = c.patch_size
        self.patch_embedding = QLinear(pt * ph * pw * c.in_channels, hd)
        # linear(text_dim -> hidden), gelu, linear(hidden -> hidden): the
        # diffusers WanTextEmbedder layout, in the published tanh form of
        # the GELU (Wan2.1's text_embedding, diffusers'
        # PixArtAlphaTextProjection "gelu_tanh"; the JAX package builds
        # the exact form)
        self.text_embedder = MLP(hd, 1.0, activation="gelu_tanh",
                                 in_dim=c.text_dim)
        self.time_in = QLinear(c.freq_dim, hd)
        self.time_embedder = MLP(hd, 1.0, activation="silu")
        # the shared 6-way modulation projection every block consumes
        self.time_proj = QLinear(hd, 6 * hd)
        if c.image_cross:
            # diffusers WanImageEmbedding: norm1 -> ff(gelu) -> norm2 over
            # the CLIP-vision features
            self.img_norm1 = LayerNorm(c.image_dim)
            self.img_ff = MLP(hd, c.image_dim / hd, activation="gelu",
                              in_dim=c.image_dim)
            self.img_norm2 = LayerNorm(hd)
        self.blocks = nn.ModuleList(
            CrossAttnBlock(hd, c.heads, c.ffn_dim / hd,
                           image_cross=c.image_cross, mlp_chunk=c.mlp_chunk)
            for _ in range(c.num_blocks))
        self.scale_shift_table_out = nn.Parameter(torch.zeros(1, 2, hd))
        self.proj_out = QLinear(hd, pt * ph * pw * c.out_channels)

    def _patchify(self, latents):
        pt, ph, pw = self.cfg.patch_size
        b, ch, t, hh, ww = latents.shape
        x = latents.reshape(b, ch, t // pt, pt, hh // ph, ph, ww // pw, pw)
        x = x.permute(0, 2, 4, 6, 3, 5, 7, 1)
        return x.reshape(b, (t // pt) * (hh // ph) * (ww // pw), -1)

    def _unpatchify(self, tokens, t, hh, ww):
        c = self.cfg
        pt, ph, pw = c.patch_size
        b = tokens.shape[0]
        x = tokens.reshape(b, t // pt, hh // ph, ww // pw, pt, ph, pw,
                           c.out_channels)
        x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(b, c.out_channels, t, hh, ww)

    def _rope(self, t, hh, ww, perm, device):
        c = self.cfg
        pt, ph, pw = c.patch_size
        gt, gh, gw = t // pt, hh // ph, ww // pw
        zz, yy, xx = torch.meshgrid(torch.arange(gt, device=device),
                                    torch.arange(gh, device=device),
                                    torch.arange(gw, device=device),
                                    indexing="ij")
        cos, sin = rope_axial_freqs(
            (gt, gh, gw), c.rope_axes_dim,
            (zz.reshape(-1), yy.reshape(-1), xx.reshape(-1)),
            theta=c.rope_theta)
        if perm is not None:
            cos, sin = cos[perm], sin[perm]
        return cos, sin

    def embed(self, latents, timestep, text_emb, hilbert_to_linear,
              image_emb=None):
        """Stage 1.  ``timestep`` is [B] or, with per_token_timesteps,
        [B, Sv].  Returns (x [B,Sv,C] in curve order, ctx, ctx_img or None,
        temb [B(,Sv),C], temb6 [B(,Sv),6,C], rope)."""
        c = self.cfg
        t, hh, ww = latents.shape[2:]
        x = self.patch_embedding(self._patchify(latents))
        ctx = self.text_embedder(text_emb)
        ctx_img = None
        if c.image_cross and image_emb is not None:
            ctx_img = self.img_norm2(self.img_ff(self.img_norm1(image_emb)))
        temb = self.time_embedder(self.time_in(
            timestep_embedding(timestep, c.freq_dim)))
        temb6 = self.time_proj(F.silu(temb))
        temb6 = temb6.reshape(*temb.shape[:-1], 6, c.hidden_dim)
        rope = self._rope(t, hh, ww, hilbert_to_linear, x.device)
        if hilbert_to_linear is not None:
            x = x.index_select(1, hilbert_to_linear)
            if temb.ndim == 3:
                temb = temb.index_select(1, hilbert_to_linear)
                temb6 = temb6.index_select(1, hilbert_to_linear)
        return x, ctx, ctx_img, temb, temb6, rope

    def run_blocks(self, x, ctx, ctx_img, temb6, rope, self_attn_fn: AttnFn,
                   cross_attn_fn: AttnFn, attn_fns=None):
        """Stage 2, the TeaCache-skippable block stack.  ``attn_fns`` may
        give each layer its own self-attention function (the warm-up
        gates, rectified_wan21_attn.py:467)."""
        for i, blk in enumerate(self.blocks):
            fn = attn_fns[i] if attn_fns is not None else self_attn_fn
            x = blk(x, ctx, temb6, rope, fn, cross_attn_fn, ctx_img=ctx_img)
        return x

    def head(self, x, temb, linear_to_hilbert, t, hh, ww):
        """Stage 3: inverse permutation, modulated norm, projection."""
        if linear_to_hilbert is not None:
            x = x.index_select(1, linear_to_hilbert)
            if temb.ndim == 3:
                temb = temb.index_select(1, linear_to_hilbert)
        tm = temb[:, None] if temb.ndim == 2 else temb
        m = self.scale_shift_table_out[:, None] + tm[:, :, None]  # [B,1|S,2,C]
        x = layer_norm(x) * (1 + m[:, :, 1]) + m[:, :, 0]
        return self._unpatchify(self.proj_out(x), t, hh, ww)

    def forward(self, latents, timestep, text_emb, image_emb=None,
                hilbert_to_linear=None, linear_to_hilbert=None,
                self_attn_fn: Optional[AttnFn] = None,
                cross_attn_fn: Optional[AttnFn] = None):
        """Full forward (embed, blocks, head), vanilla attention unless
        told otherwise."""
        from ..attention import attention
        vanilla = lambda q, k, v: attention(q, k, v, mode="vanilla")
        t, hh, ww = latents.shape[2:]
        x, ctx, ctx_img, temb, temb6, rope = self.embed(
            latents, timestep, text_emb, hilbert_to_linear, image_emb)
        x = self.run_blocks(x, ctx, ctx_img, temb6, rope,
                            self_attn_fn or vanilla, cross_attn_fn or vanilla)
        return self.head(x, temb, linear_to_hilbert, t, hh, ww)
