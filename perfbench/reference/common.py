"""Plain float32 building blocks of the yardstick's reference (no kernel,
no cache, nothing of the program): linear layers, norms, RoPE, the
timestep features, the samplers, and the low-precision control.

``Numerics`` carries the precision the reference computes in.  "fp32" is
the reference: every product in float32 with TF32 off.  "fp8" is the
control of the benchmark's correctness check: the step that would tempt a
later change below the configuration's bf16, every matrix product's
operands (linear inputs per token, weights per output channel, attention
q, k and v per token) rounded to float8 e4m3 with a scale per row, the
products still taken in float32.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # largest finite float8_e4m3fn


@contextlib.contextmanager
def float32_products():
    """TF32 off for the reference's matrix products (restored after)."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per row (the last dim),
    returned in float32."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Numerics:
    """The reference's weights (a name -> tensor map, read in float32 as
    each is used) and its precision ("fp32" or "fp8")."""

    def __init__(self, weights: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32|fp8, got {precision!r}")
        self.w = weights
        self.lowp = precision == "fp8"

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return fp8_rows(x) if self.lowp else x

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w = self.operand(self.w[name + ".weight"])
        y = self.operand(x) @ w.t()
        bias = self.w.get(name + ".bias")
        return y if bias is None else y + bias.float()

    def mlp(self, x, name: str, act: str = "gelu_tanh"):
        h = self.linear(x, name + ".fc1")
        h = F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")
        return self.linear(h, name + ".fc2")

    def layer_norm(self, x, name: str | None = None, eps: float = 1e-6):
        """LayerNorm over the last dim; affine where ``name`` is given."""
        if name is None:
            return F.layer_norm(x.float(), x.shape[-1:], eps=eps)
        return F.layer_norm(x.float(), x.shape[-1:],
                            self.w[name + ".weight"].float(),
                            self.w[name + ".bias"].float(), eps)

    def rms_norm(self, x, name: str, eps: float = 1e-6):
        x = x.float()
        x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
        return x * self.w[name + ".weight"].float()


def timestep_features(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal features [B, dim], cos first (diffusers' flip_sin_to_cos,
    no frequency shift)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_tables(grid, axes_dim, theta: float, device):
    """(cos, sin) [T*H*W, D/2] of axial RoPE over a (t, h, w) token grid in
    linear order, each axis taking its share of the head's channel pairs."""
    gt, gh, gw = grid
    zz, yy, xx = torch.meshgrid(torch.arange(gt, device=device),
                                torch.arange(gh, device=device),
                                torch.arange(gw, device=device),
                                indexing="ij")
    cos, sin = [], []
    for dim, pos in zip(axes_dim, (zz, yy, xx)):
        freqs = 1.0 / theta ** (torch.arange(dim // 2, dtype=torch.float32,
                                             device=device) * 2 / dim)
        ang = pos.reshape(-1).float()[:, None] * freqs
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate interleaved channel pairs of x [H, S, D] (float32)."""
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                       dim=-1).reshape(x.shape)


def patchify(latents, pt: int, p: int) -> torch.Tensor:
    """[1, C, T, H, W] -> [T/pt * H/p * W/p, pt*p*p*C], channels last."""
    _, c, t, hh, ww = latents.shape
    x = latents.reshape(c, t // pt, pt, hh // p, p, ww // p, p)
    return x.permute(1, 3, 5, 2, 4, 6, 0).reshape(
        (t // pt) * (hh // p) * (ww // p), pt * p * p * c)


def unpatchify(tokens, shape, pt: int, p: int) -> torch.Tensor:
    """The inverse of ``patchify`` for latents of ``shape``."""
    _, c, t, hh, ww = shape
    x = tokens.reshape(t // pt, hh // p, ww // p, pt, p, p, c)
    return x.permute(6, 0, 3, 1, 4, 2, 5).reshape(1, c, t, hh, ww)


def flow_sigmas(steps: int, shift: float) -> np.ndarray:
    """Flow-matching sigmas 1 .. 1/steps, shifted, then 0 (float64)."""
    s = np.linspace(1.0, 1.0 / steps, steps)
    s = shift * s / (1.0 + (shift - 1.0) * s)
    return np.append(s, 0.0)


def ddim_alphas(train_steps: int = 1000, beta_start: float = 0.00085,
                beta_end: float = 0.012) -> np.ndarray:
    """Cumulative alphas of the scaled-linear betas, rescaled to zero
    terminal SNR (float64)."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                        train_steps) ** 2
    ab = np.sqrt(np.cumprod(1.0 - betas))
    ab = (ab - ab[-1]) * ab[0] / (ab[0] - ab[-1])
    return ab ** 2


def ddim_timesteps(steps: int, train_steps: int = 1000) -> np.ndarray:
    """Trailing spacing: round(arange(T, 0, -T/steps)) - 1."""
    return np.round(np.arange(train_steps, 0, -train_steps / steps)
                    ).astype(np.int64) - 1
