"""Input makers of the benchmarks, in torch with an explicit
``torch.Generator`` (ports of bench.py:54-83, scripts/exp_runstats.py:29-44
and scripts/bench_grouped.py:26-51).  The same seed gives other numbers
than JAX's keys; the tests hand both sides the same numpy draws.

- ``smooth_inputs``: a low-frequency field of the 3-D latent position,
  shared by the tensors it makes, plus per-token noise (bench.py's q/k/v,
  exp_runstats.py's q/k): the regime real checkpoints run in, where pooled
  attention concentrates.
- ``random_inputs``: iid normal q/k/v (bench.py's random regime).
- ``realistic_qkv``: a coarse random field trilinearly upsampled over the
  latent grid, in curve order, plus noise and a text tail (the plan
  inputs of the kernel-variant benchmark).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NFREQ = 16


def curve_coords(h2l: torch.Tensor, grid) -> torch.Tensor:
    """[S, 3] fp32 (t/T, h/H, w/W) of each token in curve order."""
    lt, lh, lw = grid
    lin = h2l.long()
    return torch.stack([lin // (lh * lw) / lt, lin // lw % lh / lh,
                        lin % lw / lw], dim=-1).float()


def smooth_field(coords, w, phase, mix) -> torch.Tensor:
    """[H, S, D]: sin and cos of ``coords @ w + phase`` ([S, 3] @ [3, F] +
    [F]) mixed per head by ``mix`` [H, 2F, D] (bench.py:62-67)."""
    proj = coords @ w + phase
    basis = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
    return torch.einsum("sf,hfd->hsd", basis, mix)


def smooth_inputs(gen, h: int, coords, tail: int, d: int, n: int = 3,
                  alpha: float = 4.0, sigma: float = 1.0):
    """``n`` bf16 tensors [1, H, S + tail, D]: ``alpha`` x one shared
    smooth field (0 over the ``tail`` rows: the text slot or padding) plus
    ``sigma`` x noise of their own.  Draws w, phase, mix, then the noises,
    from ``gen`` on ``coords``' device."""
    dev = coords.device
    w = torch.randn((3, NFREQ), generator=gen, device=dev) * 3.0
    phase = torch.rand((NFREQ,), generator=gen, device=dev) * 2 * torch.pi
    mix = torch.randn((h, 2 * NFREQ, d), generator=gen, device=dev) \
        / (2 * NFREQ) ** 0.5
    field = F.pad(smooth_field(coords, w, phase, mix), (0, 0, 0, tail))
    return tuple(
        (alpha * field + sigma * torch.randn(field.shape, generator=gen,
                                             device=dev))[None].to(
            torch.bfloat16) for _ in range(n))


def smooth_qkv(gen, h: int, tail: int, d: int, h2l, grid, alpha: float = 4.0,
               sigma: float = 1.0):
    """Smooth q/k/v over the latent ``grid`` in curve order (``h2l``), then
    ``tail`` rows of noise (bench.py's smooth_inputs)."""
    return smooth_inputs(gen, h, curve_coords(h2l, grid), tail, d, n=3,
                         alpha=alpha, sigma=sigma)


def random_inputs(gen, h: int, s: int, d: int, device=None):
    """iid normal q/k/v [1, H, S, D] bf16 (bench.py's random_inputs)."""
    return tuple(torch.randn((1, h, s, d), generator=gen, device=device).to(
        torch.bfloat16) for _ in range(3))


def upsample_field(coarse: torch.Tensor, grid) -> torch.Tensor:
    """[B, H, t, h, w, D] -> [B, H, *grid, D] by trilinear interpolation
    with half-pixel centres (jax.image.resize "linear" when upsampling:
    its edge samples take the nearest coarse value, as align_corners=False
    clamps them)."""
    b, h, *coarse_grid, d = coarse.shape
    x = coarse.permute(0, 1, 5, 2, 3, 4).reshape(b * h, d, *coarse_grid)
    x = F.interpolate(x, size=tuple(grid), mode="trilinear",
                      align_corners=False)
    return x.reshape(b, h, d, *grid).permute(0, 1, 3, 4, 5, 2)


def realistic_qkv(gen, b: int, h: int, grid, text_len: int, d: int, h2l,
                  smooth: float = 1.0, noise: float = 0.5):
    """q/k/v [B, H, S + text_len, D] bf16: per tensor a coarse normal field
    over (T/4, H/8, W/8) (at least 2 each) upsampled over ``grid``, in curve
    order, times ``smooth``, plus ``noise`` x normal noise; then a shared
    normal text tail (scripts/bench_grouped.py:26-51)."""
    lt, lh, lw = grid
    dev = h2l.device
    coarse_grid = (max(2, lt // 4), max(2, lh // 8), max(2, lw // 8))

    def field():
        coarse = torch.randn((b, h, *coarse_grid, d), generator=gen,
                             device=dev)
        f = upsample_field(coarse, grid).reshape(b, h, lt * lh * lw, d)
        f = f[:, :, h2l.long()]                    # linear -> curve order
        return smooth * f + noise * torch.randn(f.shape, generator=gen,
                                                device=dev)

    fields = [field() for _ in range(3)]
    text = torch.randn((b, h, text_len, d), generator=gen, device=dev)
    return tuple(torch.cat([f, text], dim=2).to(torch.bfloat16)
                 for f in fields)
