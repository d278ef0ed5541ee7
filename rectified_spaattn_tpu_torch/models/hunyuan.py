"""HunyuanVideo DiT backbone, text-to-video (port of
rectified_spaattn_tpu/models/hunyuan.py; the architecture of diffusers'
``HunyuanVideoTransformer3DModel``, reference driver
scripts/main_hunyuan.py:232-238, patched forward :45-210): 3-D patchify,
token-refined text conditioning, dual-stream + single-stream blocks with
joint visual+text attention, adaLN-continuous head.

The forward is split into embed / blocks / head stages so the TeaCache
step-skip (cache/teacache.py) branches in the host sampler loop.  The I2V
variants (``image_condition_type`` "token_replace" / "latent_concat")
belong to a later slice and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (AdaLayerNormContinuous, AttnFn, Dense, DualStreamBlock,
                     LayerNorm, MLP, RMSNorm, SingleStreamBlock, rope_axial_freqs,
                     timestep_embedding)


@dataclasses.dataclass(frozen=True)
class HunyuanVideoConfig:
    in_channels: int = 16
    out_channels: int = 16
    hidden_dim: int = 3072
    heads: int = 24
    head_dim: int = 128
    num_dual_blocks: int = 20
    num_single_blocks: int = 40
    mlp_mult: float = 4.0
    patch_size: int = 2          # spatial
    patch_size_t: int = 1        # temporal
    text_dim: int = 4096         # llama hidden
    pooled_dim: int = 768        # CLIP pooled projection
    rope_axes_dim: tuple = (16, 56, 56)   # (t, h, w) channels of head_dim
    rope_theta: float = 256.0
    num_refiner_blocks: int = 2
    guidance_embeds: bool = True
    image_condition_type: Optional[str] = None   # I2V: a later slice
    mlp_chunk: int = 1           # FFN sequence chunking (peak-memory lever)

    @classmethod
    def tiny(cls):
        """Small config for CPU tests."""
        return cls(in_channels=4, out_channels=4, hidden_dim=64, heads=2,
                   head_dim=32, num_dual_blocks=1, num_single_blocks=1,
                   text_dim=32, pooled_dim=16, rope_axes_dim=(8, 12, 12),
                   num_refiner_blocks=1)


class TokenRefiner(nn.Module):
    """Text token refiner (diffusers HunyuanVideoTokenRefiner): projects
    llama hidden states and refines them with a small timestep-conditioned
    dense transformer.  Its LayerNorms carry scale and bias."""

    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        c = self.cfg = cfg
        hd = c.hidden_dim
        self.time_in = Dense(256, hd)
        self.time_mlp = MLP(hd, 1.0, activation="silu")
        self.pool_in = Dense(c.text_dim, hd)
        self.pool_mlp = MLP(hd, 1.0, activation="silu")
        self.proj_in = Dense(c.text_dim, hd)
        for i in range(c.num_refiner_blocks):
            setattr(self, f"blk{i}_ada", Dense(hd, 2 * hd))
            setattr(self, f"blk{i}_norm1", LayerNorm(hd))
            setattr(self, f"blk{i}_qkv", Dense(hd, 3 * hd))
            setattr(self, f"blk{i}_proj", Dense(hd, hd))
            setattr(self, f"blk{i}_norm2", LayerNorm(hd))
            setattr(self, f"blk{i}_mlp", MLP(hd, c.mlp_mult))

    def forward(self, text_emb, timestep, text_mask):
        c = self.cfg
        t_emb = self.time_mlp(self.time_in(timestep_embedding(timestep, 256)))
        if text_mask is None:
            pooled = text_emb.mean(dim=1)
        else:
            w = text_mask.to(text_emb.dtype)[..., None]
            pooled = (text_emb * w).sum(dim=1) / torch.clamp(w.sum(dim=1),
                                                             min=1e-3)
        cond = t_emb + self.pool_mlp(self.pool_in(pooled))

        x = self.proj_in(text_emb)
        hd = c.hidden_dim // c.heads
        for i in range(c.num_refiner_blocks):
            blk = lambda n: getattr(self, f"blk{i}_{n}")
            g_attn, g_mlp = blk("ada")(F.silu(cond)).chunk(2, dim=-1)
            q, k, v = (t.reshape(t.shape[0], -1, c.heads, hd).transpose(1, 2)
                       for t in blk("qkv")(blk("norm1")(x)).chunk(3, dim=-1))
            scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / hd ** 0.5
            if text_mask is not None:
                scores = torch.where(
                    text_mask[:, None, None, :].to(torch.bool), scores,
                    torch.tensor(-1e9, dtype=scores.dtype,
                                 device=scores.device))
            attn = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1),
                                v)
            attn = attn.transpose(1, 2).reshape(x.shape)
            x = x + g_attn[:, None] * blk("proj")(attn)
            x = x + g_mlp[:, None] * blk("mlp")(blk("norm2")(x))
        return x


class HunyuanVideoDiT(nn.Module):
    """The transformer.  Latent input [B, C, T, H, W]; text [B, St, text_dim]."""

    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        if cfg.image_condition_type is not None:
            raise NotImplementedError(
                "HunyuanVideo I2V (image_condition_type) is not ported yet")
        c = self.cfg = cfg
        hd = c.hidden_dim
        self.x_embedder = Dense(
            c.patch_size_t * c.patch_size * c.patch_size * c.in_channels, hd)
        self.context_embedder = TokenRefiner(c)
        self.time_in = Dense(256, hd)
        self.time_mlp = MLP(hd, 1.0, activation="silu")
        self.pooled_in = Dense(c.pooled_dim, hd)
        self.pooled_mlp = MLP(hd, 1.0, activation="silu")
        self.clip_pool_proj = Dense(c.text_dim, c.pooled_dim)
        if c.guidance_embeds:
            self.guide_in = Dense(256, hd)
            self.guide_mlp = MLP(hd, 1.0, activation="silu")
        self.dual_blocks = nn.ModuleList(
            DualStreamBlock(hd, c.heads, c.mlp_mult, mlp_chunk=c.mlp_chunk)
            for _ in range(c.num_dual_blocks))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(hd, c.heads, c.mlp_mult, mlp_chunk=c.mlp_chunk)
            for _ in range(c.num_single_blocks))
        self.norm_out = AdaLayerNormContinuous(hd)
        self.proj_out = Dense(
            hd, c.patch_size_t * c.patch_size * c.patch_size * c.out_channels)

    def _patchify(self, latents):
        c = self.cfg
        b, ch, t, hh, ww = latents.shape
        pt, p = c.patch_size_t, c.patch_size
        x = latents.reshape(b, ch, t // pt, pt, hh // p, p, ww // p, p)
        x = x.permute(0, 2, 4, 6, 3, 5, 7, 1)     # [B,T',H',W',pt,p,p,C]
        return x.reshape(b, (t // pt) * (hh // p) * (ww // p), -1)

    def _unpatchify(self, tokens, t, hh, ww):
        c = self.cfg
        pt, p = c.patch_size_t, c.patch_size
        b = tokens.shape[0]
        x = tokens.reshape(b, t // pt, hh // p, ww // p, pt, p, p,
                           c.out_channels)
        x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(b, c.out_channels, t, hh, ww)

    def _rope(self, t, hh, ww, perm, device):
        c = self.cfg
        pt, p = c.patch_size_t, c.patch_size
        gt, gh, gw = t // pt, hh // p, ww // p
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

    def embed(self, latents, timestep, text_emb, text_mask, guidance,
              hilbert_to_linear, pooled=None):
        """Stage 1: embeddings + conditioning.  Returns (hidden_states
        [B,Sv,C] in curve order, ctx [B,St,C], temb [B,C], rope)."""
        c = self.cfg
        b = latents.shape[0]
        t, hh, ww = latents.shape[2:]
        x = self.x_embedder(self._patchify(latents))
        ctx = self.context_embedder(text_emb, timestep, text_mask)
        if pooled is None:
            pooled = (torch.zeros((b, c.pooled_dim), dtype=x.dtype,
                                  device=x.device)
                      if text_mask is None
                      else self.pooled_proj_input(text_emb, text_mask))
        temb = self._temb(timestep, pooled, guidance)
        # Jenga permutation into curve order, applied to tokens AND rope
        # tables (reference: scripts/main_hunyuan.py:87-89)
        rope = self._rope(t, hh, ww, hilbert_to_linear, x.device)
        if hilbert_to_linear is not None:
            x = x.index_select(1, hilbert_to_linear)
        return x, ctx, temb, rope

    def _temb(self, timestep, pooled, guidance):
        c = self.cfg
        temb = self.time_mlp(self.time_in(timestep_embedding(timestep, 256)))
        temb = temb + self.pooled_mlp(self.pooled_in(pooled))
        if c.guidance_embeds and guidance is not None:
            temb = temb + self.guide_mlp(self.guide_in(
                timestep_embedding(guidance, 256)))
        return temb

    def pooled_proj_input(self, text_emb, text_mask):
        """Pooled-projection stand-in: mean over valid text tokens mapped
        to pooled_dim (real checkpoints supply CLIP pooled text)."""
        w = text_mask.to(text_emb.dtype)[..., None]
        pooled = (text_emb * w).sum(dim=1) / torch.clamp(w.sum(dim=1),
                                                         min=1e-3)
        return self.clip_pool_proj(pooled)

    def teacache_signal(self, x, temb):
        """Block-0 norm1 modulated input — the TeaCache change signal
        (reference: scripts/main_hunyuan.py:113)."""
        if len(self.dual_blocks) == 0:          # truncated-depth configs
            return x + temb[:, None]
        return self.dual_blocks[0].norm1(x, temb)[0]

    def run_blocks(self, x, ctx, temb, rope, attn_fn: AttnFn):
        """Stage 2: the TeaCache-skippable block stack (reference:
        scripts/main_hunyuan.py:134-157)."""
        for blk in self.dual_blocks:
            x, ctx = blk(x, ctx, temb, rope, attn_fn)
        for blk in self.single_blocks:
            x, ctx = blk(x, ctx, temb, rope, attn_fn)
        return x, ctx

    def head(self, x, temb, linear_to_hilbert, t, hh, ww):
        """Stage 3: inverse permutation + output projection (reference:
        scripts/main_hunyuan.py:182-193)."""
        if linear_to_hilbert is not None:
            x = x.index_select(1, linear_to_hilbert)
        x = self.proj_out(self.norm_out(x, temb))
        return self._unpatchify(x, t, hh, ww)

    def forward(self, latents, timestep, text_emb, text_mask=None,
                guidance=None, hilbert_to_linear=None,
                linear_to_hilbert=None, attn_fn: Optional[AttnFn] = None):
        """Full forward (embed, blocks, head) — used when TeaCache is off."""
        if attn_fn is None:
            from ..attention import attention
            attn_fn = lambda q, k, v: attention(q, k, v, mode="vanilla")
        t, hh, ww = latents.shape[2:]
        x, ctx, temb, rope = self.embed(latents, timestep, text_emb,
                                        text_mask, guidance,
                                        hilbert_to_linear)
        x, ctx = self.run_blocks(x, ctx, temb, rope, attn_fn)
        return self.head(x, temb, linear_to_hilbert, t, hh, ww)


@torch.no_grad()
def init_random_weights(model: nn.Module, generator: torch.Generator):
    """Seeded random weights for checkpoint-less runs: every dense kernel
    ~ N(0, 1/fan_in) (Flax's lecun_normal scale), biases 0, norm scales 1.
    Draws from ``generator`` on the parameters' device."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            w = torch.empty(mod.weight.shape, dtype=torch.float32,
                            device=mod.weight.device)
            w.normal_(0.0, mod.in_features ** -0.5, generator=generator)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, RMSNorm) and mod.weight is not None:
            mod.weight.fill_(1.0)
    return model
