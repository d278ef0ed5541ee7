"""CogVideoX 1.5 DiT backbone (port of
rectified_spaattn_tpu/models/cogvideox.py; the architecture of diffusers'
``CogVideoXTransformer3DModel``, reference script
scripts/main_cogvideox.py:213-288, attention rectified_cogvideo_attn.py).

Joint attention with SHARED q/k/v projections over the stream
[visual ; text] (the reference processor reorders [text ; visual] to this
before the sparse kernel, rectified_cogvideo_attn.py:433-435; here it is
the resident layout), per-head LayerNorm on q and k, interleaved RoPE on
the visual slice only (:466-469), one MLP for both streams, and the
LayerNormZero modulation of both streams from the time (+ ofs) embedding.
48 heads x head_dim 64 at full width: the attention kernels run their
head_dim-64 instantiation.  The step gate ``call >= 5`` (:478) is the
pipeline's choice of attention function (pipelines/cogvideox.py).

The forward is split into embed / blocks / head stages so TeaCache's
step-skip branches in the host sampler loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (AttnFn, LayerNorm, MLP, QLinear, _merge_heads,
                     _split_heads, apply_rope_interleaved, rope_axial_freqs,
                     timestep_embedding)


@dataclasses.dataclass(frozen=True)
class CogVideoXConfig:
    in_channels: int = 16
    out_channels: int = 16
    hidden_dim: int = 3072
    heads: int = 48
    head_dim: int = 64
    num_blocks: int = 42
    mlp_mult: float = 4.0
    text_dim: int = 4096            # T5-XXL hidden
    time_embed_dim: int = 512
    patch_size: int = 2
    patch_size_t: int = 2
    rope_axes_dim: tuple = (16, 24, 24)
    rope_theta: float = 10000.0
    use_ofs_embed: bool = True      # CogVideoX 1.5 ofs embedding
                                    # (reference: main_cogvideox.py:83-87)

    @classmethod
    def tiny(cls, **kw):
        """Small config for CPU tests."""
        base = dict(in_channels=4, out_channels=4, hidden_dim=64, heads=2,
                    head_dim=32, num_blocks=2, text_dim=32,
                    time_embed_dim=32, patch_size_t=1,
                    rope_axes_dim=(8, 12, 12))
        return cls(**{**base, **kw})


class CogVideoXBlock(nn.Module):
    """One CogVideoX block: LayerNormZero of both streams, the joint
    attention over [visual ; text] with shared projections, gated
    residuals, then LayerNormZero again and the shared MLP."""

    def __init__(self, dim: int, heads: int, mlp_mult: float, temb_dim: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        hd = dim // heads
        for n in ("norm1", "norm2"):
            setattr(self, f"{n}_lin", QLinear(temb_dim, 6 * dim))
            setattr(self, f"{n}_ln", LayerNorm(dim, eps=1e-5))
        for n in ("to_q", "to_k", "to_v", "to_out"):
            setattr(self, n, QLinear(dim, dim))
        # per-head LayerNorm on q / k (diffusers qk_norm="layer_norm")
        self.norm_q = LayerNorm(hd, eps=1e-6)
        self.norm_k = LayerNorm(hd, eps=1e-6)
        self.ff = MLP(dim, mlp_mult)

    def _zero_norm(self, n: str, x, ctx, temb):
        # chunk order of diffusers CogVideoXLayerNormZero: shift, scale,
        # gate, enc_shift, enc_scale, enc_gate
        g = getattr(self, f"{n}_lin")(F.silu(temb))
        shx, sx, gx, shc, sc, gc = (t[:, None] for t in g.chunk(6, dim=-1))
        ln = getattr(self, f"{n}_ln")
        return ln(x) * (1 + sx) + shx, ln(ctx) * (1 + sc) + shc, gx, gc

    def forward(self, x, ctx, temb, rope, attn_fn: AttnFn):
        sv = x.shape[1]
        xn, cn, gx, gc = self._zero_norm("norm1", x, ctx, temb)
        fused = torch.cat([xn, cn], dim=1)
        q, k, v = (_split_heads(m(fused), self.heads)
                   for m in (self.to_q, self.to_k, self.to_v))
        q, k = self.norm_q(q), self.norm_k(k)
        if rope is not None:
            cos, sin = rope
            q = torch.cat([apply_rope_interleaved(q[:, :, :sv], cos, sin),
                           q[:, :, sv:]], dim=2)
            k = torch.cat([apply_rope_interleaved(k[:, :, :sv], cos, sin),
                           k[:, :, sv:]], dim=2)
        attn = self.to_out(_merge_heads(attn_fn(q, k, v)))
        x = x + gx * attn[:, :sv]
        ctx = ctx + gc * attn[:, sv:]
        xn, cn, gx2, gc2 = self._zero_norm("norm2", x, ctx, temb)
        return x + gx2 * self.ff(xn), ctx + gc2 * self.ff(cn)


class CogVideoXDiT(nn.Module):
    """The transformer.  Latent input [B, C, T, H, W] (T a multiple of
    patch_size_t); text [B, St, text_dim]."""

    def __init__(self, cfg: CogVideoXConfig):
        super().__init__()
        c = self.cfg = cfg
        hd, te = c.hidden_dim, c.time_embed_dim
        patch = c.patch_size_t * c.patch_size * c.patch_size
        self.patch_embed = QLinear(patch * c.in_channels, hd)
        self.text_proj = QLinear(c.text_dim, hd)
        self.time_in = QLinear(te, te)
        self.time_mlp = MLP(te, 1.0, activation="silu")
        if c.use_ofs_embed:
            self.ofs_in = QLinear(te, te)
            self.ofs_mlp = MLP(te, 1.0, activation="silu")
        self.blocks = nn.ModuleList(
            CogVideoXBlock(hd, c.heads, c.mlp_mult, te)
            for _ in range(c.num_blocks))
        self.norm_final = LayerNorm(hd, eps=1e-5)
        self.norm_out_lin = QLinear(te, 2 * hd)
        self.norm_out_ln = LayerNorm(hd, eps=1e-5)
        self.proj_out = QLinear(hd, patch * c.out_channels)

    def _patchify(self, latents):
        """Channel-last patches: [B, tokens, (pt, p, p, C)]."""
        c = self.cfg
        pt, p = c.patch_size_t, c.patch_size
        b, ch, t, hh, ww = latents.shape
        x = latents.reshape(b, ch, t // pt, pt, hh // p, p, ww // p, p)
        x = x.permute(0, 2, 4, 6, 3, 5, 7, 1)
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

    def embed(self, latents, timestep, text_emb, hilbert_to_linear,
              ofs=None):
        """Stage 1: (x [B, Sv, C] in curve order, ctx [B, St, C], temb
        [B, time_embed_dim], rope).  ``ofs`` [B]: the 1.5 ofs input (0
        when None)."""
        c = self.cfg
        b, _, t, hh, ww = latents.shape
        x = self.patch_embed(self._patchify(latents))
        ctx = self.text_proj(text_emb)
        temb = self.time_mlp(self.time_in(
            timestep_embedding(timestep, c.time_embed_dim)))
        if c.use_ofs_embed:
            o = ofs if ofs is not None else torch.zeros(
                (b,), dtype=x.dtype, device=x.device)
            temb = temb + self.ofs_mlp(self.ofs_in(
                timestep_embedding(o, c.time_embed_dim)))
        rope = self._rope(t, hh, ww, hilbert_to_linear, x.device)
        if hilbert_to_linear is not None:
            x = x.index_select(1, hilbert_to_linear)
        return x, ctx, temb, rope

    def run_blocks(self, x, ctx, temb, rope, attn_fn: AttnFn, attn_fns=None):
        """Stage 2, the TeaCache-skippable block stack; ``attn_fns`` may
        give each block its own attention function."""
        for i, blk in enumerate(self.blocks):
            fn = attn_fns[i] if attn_fns is not None else attn_fn
            x, ctx = blk(x, ctx, temb, rope, fn)
        return x, ctx

    def head(self, x, ctx, temb, linear_to_hilbert, t, hh, ww):
        """Stage 3: inverse permutation, norm_final over concat(ctx, x)
        (then the visual slice), the modulated output norm, projection."""
        if linear_to_hilbert is not None:
            x = x.index_select(1, linear_to_hilbert)
        st = ctx.shape[1]
        x = self.norm_final(torch.cat([ctx, x], dim=1))[:, st:]
        shift, scale = self.norm_out_lin(F.silu(temb)).chunk(2, dim=-1)
        x = self.norm_out_ln(x) * (1 + scale[:, None]) + shift[:, None]
        return self._unpatchify(self.proj_out(x), t, hh, ww)

    def forward(self, latents, timestep, text_emb, ofs=None,
                hilbert_to_linear=None, linear_to_hilbert=None,
                attn_fn: Optional[AttnFn] = None):
        """Full forward (embed, blocks, head), vanilla attention unless
        told otherwise."""
        if attn_fn is None:
            from ..attention import attention
            attn_fn = lambda q, k, v: attention(q, k, v, mode="vanilla")
        t, hh, ww = latents.shape[2:]
        x, ctx, temb, rope = self.embed(latents, timestep, text_emb,
                                        hilbert_to_linear, ofs)
        x, ctx = self.run_blocks(x, ctx, temb, rope, attn_fn)
        return self.head(x, ctx, temb, linear_to_hilbert, t, hh, ww)
