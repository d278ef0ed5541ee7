"""Shared DiT building blocks, HunyuanVideo subset (port of
rectified_spaattn_tpu/models/layers.py).

All modules operate on [B, S, C] token streams; attention functions are
injected as ``attn_fn(q, k, v)`` on [B, H, S, D].  Parameter names mirror
the Flax modules so models/convert.py maps a Flax tree one to one.

Dtype rules follow Flax's: ``Dense`` and ``LayerNorm`` promote input and
parameters to their common type (an fp32 input meets bf16 weights in fp32,
as ``promote_dtype`` does in the JAX ``QDense``); RMSNorm and RoPE compute
in fp32 and return the input dtype.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

# An attention function: (q, k, v) [B,H,S,D] -> [B,H,S,D].
AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class Dense(nn.Linear):
    """nn.Linear with Flax's dtype promotion (the JAX package's dense
    ``QDense`` path; its int8/int4 variants wait for models/quant.py)."""

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """Affine LayerNorm (eps 1e-6) with Flax's dtype promotion (the
    refiner's norms, which carry scale and bias)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.layer_norm(x.to(dt), self.normalized_shape,
                            self.weight.to(dt), self.bias.to(dt), self.eps)


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Parameter-free LayerNorm over the last dim (the adaLN norms)."""
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep features [B(, S), dim] in fp32 (diffusers)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device)
        / (half - downscale_freq_shift))
    args = t.float()[..., None] * freqs
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class RMSNorm(nn.Module):
    """RMS norm over the trailing dim (q/k norms), computed in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 elementwise_affine: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = (nn.Parameter(torch.ones(dim)) if elementwise_affine
                       else None)

    def forward(self, x):
        dtype = x.dtype
        x = x.float()
        x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + self.eps)
        if self.weight is not None:
            x = x * self.weight.float()
        return x.to(dtype)


def _mods(lin: Dense, emb: torch.Tensor, n: int):
    parts = lin(F.silu(emb)).chunk(n, dim=-1)
    # emb may be [B, C] (broadcast over tokens) or [B, S, C]
    return tuple(v[:, None] if v.ndim == 2 else v for v in parts)


class AdaLayerNormZero(nn.Module):
    """adaLN-Zero: returns (normed_x, gate_msa, shift_mlp, scale_mlp,
    gate_mlp)."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = Dense(dim, 6 * dim)

    def forward(self, x, emb):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            _mods(self.linear, emb, 6)
        x = layer_norm(x) * (1 + scale_msa) + shift_msa
        return x, gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormZeroSingle(nn.Module):
    """3-way (shift, scale, gate) adaLN of the single-stream blocks."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = Dense(dim, 3 * dim)

    def forward(self, x, emb):
        shift, scale, gate = _mods(self.linear, emb, 3)
        return layer_norm(x) * (1 + scale) + shift, gate


class AdaLayerNormContinuous(nn.Module):
    """Final-layer modulated norm: x * (1+scale) + shift."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = Dense(dim, 2 * dim)

    def forward(self, x, emb):
        shift, scale = _mods(self.linear, emb, 2)
        return layer_norm(x) * (1 + scale) + shift


_ACTIVATIONS = {
    "gelu_tanh": lambda h: F.gelu(h, approximate="tanh"),
    "gelu": F.gelu,
    "silu": F.silu,
}


class MLP(nn.Module):
    """Two-layer FFN.  ``chunk > 1`` evaluates it over ``chunk`` sequence
    slices one after another, so only one [rows/chunk, hidden]
    intermediate is live (identical math; a peak-memory lever)."""

    def __init__(self, dim: int, mult: float = 4.0,
                 activation: str = "gelu_tanh", chunk: int = 1):
        super().__init__()
        hidden = int(dim * mult)
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)
        if activation not in _ACTIVATIONS:
            raise ValueError(activation)
        self.act = _ACTIVATIONS[activation]
        self.chunk = chunk

    def forward(self, x):
        s = x.shape[-2]
        if self.chunk <= 1 or s < 2 * self.chunk:
            return self.fc2(self.act(self.fc1(x)))
        bounds = [s * i // self.chunk for i in range(self.chunk + 1)]
        return torch.cat([self.fc2(self.act(self.fc1(x[..., lo:hi, :])))
                          for lo, hi in zip(bounds[:-1], bounds[1:])], dim=-2)


# ----------------------------------------------------------------- RoPE ----

def rope_axial_freqs(dims, head_dim_split, positions,
                     theta: float = 10000.0):
    """Axial multi-dim RoPE tables (Hunyuan style): (cos, sin) [S, D/2] in
    fp32 for the interleaved-pairs convention."""
    del dims
    cos_parts, sin_parts = [], []
    for d_a, pos in zip(head_dim_split, positions):
        half = d_a // 2
        freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                              device=pos.device) * 2 / d_a))
        angles = pos.float()[:, None] * freqs[None, :]
        cos_parts.append(torch.cos(angles))
        sin_parts.append(torch.sin(angles))
    return torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """Rotate channel pairs (x0,x1),(x2,x3)... in fp32 (diffusers
    ``apply_rotary_emb`` interleaved convention).  x [B,H,S,D]; cos/sin
    [S, D/2]."""
    dtype = x.dtype
    xf = x.float()
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[None, None], sin[None, None]
    out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    return out.reshape(xf.shape).to(dtype)


# --------------------------------------------------------------- blocks ----

def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b = t.shape[0]
    return t.reshape(b, -1, heads, t.shape[-1] // heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


class JointAttention(nn.Module):
    """Joint attention over [visual ; text] with per-stream projections
    (the dual-stream pattern of Hunyuan / Flux)."""

    def __init__(self, dim: int, heads: int, qk_norm: bool = True):
        super().__init__()
        self.heads = heads
        hd = dim // heads
        for prefix in ("", "add_"):
            for n in ("to_q", "to_k", "to_v"):
                setattr(self, prefix + n, Dense(dim, dim))
        self.qk_norm = qk_norm
        if qk_norm:
            for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
                setattr(self, n, RMSNorm(hd))
        self.to_out = Dense(dim, dim)
        self.to_add_out = Dense(dim, dim)

    def forward(self, x, ctx, rope, attn_fn: AttnFn):
        sv = x.shape[1]
        h = self.heads
        q_x, k_x, v_x = (_split_heads(m(x), h)
                         for m in (self.to_q, self.to_k, self.to_v))
        q_c, k_c, v_c = (_split_heads(m(ctx), h)
                         for m in (self.add_to_q, self.add_to_k,
                                   self.add_to_v))
        if self.qk_norm:
            q_x, k_x = self.norm_q(q_x), self.norm_k(k_x)
            q_c, k_c = self.norm_added_q(q_c), self.norm_added_k(k_c)
        if rope is not None:
            cos, sin = rope
            q_x = apply_rope_interleaved(q_x, cos, sin)
            k_x = apply_rope_interleaved(k_x, cos, sin)
        q = torch.cat([q_x, q_c], dim=2)
        k = torch.cat([k_x, k_c], dim=2)
        v = torch.cat([v_x, v_c], dim=2)
        out = _merge_heads(attn_fn(q, k, v))            # [B, Sv+St, C]
        return self.to_out(out[:, :sv]), self.to_add_out(out[:, sv:])


class DualStreamBlock(nn.Module):
    """MMDiT block: visual and text streams with separate norms/MLPs and
    one joint attention.  Block 0's ``norm1`` output is the TeaCache
    signal (reference: scripts/main_hunyuan.py:113)."""

    def __init__(self, dim: int, heads: int, mlp_mult: float = 4.0,
                 mlp_chunk: int = 1):
        super().__init__()
        self.norm1 = AdaLayerNormZero(dim)
        self.norm1_context = AdaLayerNormZero(dim)
        self.attn = JointAttention(dim, heads)
        self.ff = MLP(dim, mlp_mult, chunk=mlp_chunk)
        self.ff_context = MLP(dim, mlp_mult)

    def forward(self, x, ctx, temb, rope, attn_fn: AttnFn):
        xn, xg_msa, x_shift, x_scale, xg_mlp = self.norm1(x, temb)
        cn, cg_msa, c_shift, c_scale, cg_mlp = self.norm1_context(ctx, temb)
        attn_x, attn_c = self.attn(xn, cn, rope, attn_fn)
        x = x + xg_msa * attn_x
        ctx = ctx + cg_msa * attn_c
        x = x + xg_mlp * self.ff(layer_norm(x) * (1 + x_scale) + x_shift)
        ctx = ctx + cg_mlp * self.ff_context(
            layer_norm(ctx) * (1 + c_scale) + c_shift)
        return x, ctx


class SingleStreamBlock(nn.Module):
    """Parallel attention + MLP over the fused [visual ; text] stream."""

    def __init__(self, dim: int, heads: int, mlp_mult: float = 4.0,
                 mlp_chunk: int = 1):
        super().__init__()
        self.heads = heads
        self.mlp_chunk = mlp_chunk
        hd = dim // heads
        self.norm = AdaLayerNormZeroSingle(dim)
        self.to_qkv = Dense(dim, 3 * dim)
        self.norm_q = RMSNorm(hd)
        self.norm_k = RMSNorm(hd)
        self.proj_mlp = Dense(dim, int(dim * mlp_mult))
        self.proj_out = Dense(dim + int(dim * mlp_mult), dim)

    def _mlp_out(self, normed, attn):
        mlp_h = F.gelu(self.proj_mlp(normed), approximate="tanh")
        return self.proj_out(torch.cat([attn, mlp_h], dim=-1))

    def forward(self, x, ctx, temb, rope, attn_fn: AttnFn):
        sv = x.shape[1]
        fused = torch.cat([x, ctx], dim=1)
        normed, gate = self.norm(fused, temb)
        q, k, v = (_split_heads(t, self.heads)
                   for t in self.to_qkv(normed).chunk(3, dim=-1))
        q, k = self.norm_q(q), self.norm_k(k)
        if rope is not None:
            cos, sin = rope
            q = torch.cat([apply_rope_interleaved(q[:, :, :sv], cos, sin),
                           q[:, :, sv:]], dim=2)
            k = torch.cat([apply_rope_interleaved(k[:, :, :sv], cos, sin),
                           k[:, :, sv:]], dim=2)
        attn = _merge_heads(attn_fn(q, k, v))
        s = normed.shape[1]
        if self.mlp_chunk <= 1 or s < 2 * self.mlp_chunk:
            out = self._mlp_out(normed, attn)
        else:
            # the fused MLP + output projection over sequence slices: only
            # one [rows/chunk, 4*dim] gelu intermediate is live
            bounds = [s * i // self.mlp_chunk
                      for i in range(self.mlp_chunk + 1)]
            out = torch.cat([self._mlp_out(normed[:, lo:hi], attn[:, lo:hi])
                             for lo, hi in zip(bounds[:-1], bounds[1:])],
                            dim=1)
        fused = fused + gate * out
        return fused[:, :sv], fused[:, sv:]
