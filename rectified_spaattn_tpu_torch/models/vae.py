"""Latent VAE decoder and encoder (port of rectified_spaattn_tpu/models/
vae.py), the pixel end of every pipeline: a causal-3D video decoder and a
2-D image decoder on one resnet / upsample skeleton, the mirror encoder,
and spatial tiling (the reference calls ``vae.enable_tiling()``,
scripts/main_hunyuan.py:236).

Tensors are NCTHW (video) or NCHW (image).  The JAX modules' semantics,
each of which is a silent ~1e-3 error if missed:

  * GroupNorm eps 1e-6 (Flax's; torch's default is 1e-5), statistics over
    every frame of a clip;
  * CausalConv3d pads by repeating the edge on all three axes when causal
    (time (kt-1, 0), space SAME) and with zeros when not;
  * Downsample pads time (2, 0) by the edge when causal and temporal;
  * the decoder's temporal upsample repeats each frame and drops the first
    ``rt - 1`` frames when causal;
  * up-blocks carry ``layers_per_block + 1`` resnets, down-blocks
    ``layers_per_block``;
  * MidAttention is one head with biased projections and scale
    ``features ** -0.5``, over the tokens of each frame.

Module names are the Flax ones (``conv_in``, ``mid_res1``, ``up0_res1``,
``up0_conv`` ...), so models/convert.py carries a JAX parameter tree across
and models/weights.py maps a diffusers state dict onto them.

Convolutions are ``nn.Conv3d`` / ``nn.Conv2d``.  Padding is written into
one preallocated tensor, nearest upsampling is an expand + reshape, and a
large 3-D convolution runs over slices of output frames, each padded on
its own (exact: each output frame sees ``kt`` input frames), so a
full-width decode at video size stays inside 32-bit indexing and holds no
padded copy of a whole activation.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

_MAX_ELEMS = 2 ** 31 - 1
# the largest padded input one 3-D conv call takes (4 GiB in fp32)
_CHUNK_ELEMS = 2 ** 30


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 16
    out_channels: int = 3
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    temporal_upsample: tuple = (False, True, True, False)  # per up-block
    spatial_upsample: tuple = (True, True, True, False)
    causal: bool = True            # causal temporal convs (video VAEs)
    video: bool = True             # [B,C,T,H,W] vs [B,C,H,W]
    mid_attention: bool = True     # spatial self-attention in the mid block
    quant_conv: bool = False       # AutoencoderKL 1x1 (post_)quant_conv
    scaling_factor: float = 0.476986
    # scalar latent shift applied before scaling (Flux AutoencoderKL)
    shift_factor: float = 0.0
    # per-channel latent normalisation (AutoencoderKLWan latents_mean/std;
    # None = scalar scaling_factor only)
    latents_mean: tuple | None = None
    latents_std: tuple | None = None

    @classmethod
    def tiny(cls, video=True, **kw):
        kw.setdefault("mid_attention", False)
        return cls(latent_channels=4, block_out_channels=(8, 16),
                   layers_per_block=1, temporal_upsample=(True, False),
                   spatial_upsample=(True, False), video=video, **kw)


def _channel_stats(z, values):
    return torch.as_tensor(values, dtype=z.dtype, device=z.device).reshape(
        1, -1, *([1] * (z.ndim - 2)))


def normalize_latents(z, cfg: VAEConfig):
    """Raw encoder output -> model latent space (diffusers: subtract
    latents_mean and divide by latents_std, or multiply scaling_factor)."""
    if cfg.latents_mean is not None:
        return ((z - _channel_stats(z, cfg.latents_mean))
                / _channel_stats(z, cfg.latents_std))
    return (z - cfg.shift_factor) * cfg.scaling_factor


def denormalize_latents(z, cfg: VAEConfig):
    if cfg.latents_mean is not None:
        return (z * _channel_stats(z, cfg.latents_std)
                + _channel_stats(z, cfg.latents_mean))
    return z / cfg.scaling_factor + cfg.shift_factor


def _pad(x: torch.Tensor, pads, edge: bool) -> torch.Tensor:
    """Pad the trailing len(pads) dims by (lo, hi) each, with zeros or by
    repeating the edge (numpy's "edge", dim by dim), in one allocation."""
    first = x.ndim - len(pads)
    shape = list(x.shape)
    for i, (lo, hi) in enumerate(pads):
        shape[first + i] += lo + hi
    out = x.new_zeros(shape) if not edge else x.new_empty(shape)
    centre = [slice(None)] * x.ndim
    for i, (lo, hi) in enumerate(pads):
        centre[first + i] = slice(lo, lo + x.shape[first + i])
    out[tuple(centre)] = x
    if edge:
        # dim d's pad copies its edge slice across the full extent of the
        # dims already padded and the centre of the dims still to pad
        for i, (lo, hi) in enumerate(pads):
            d, n = first + i, x.shape[first + i]
            idx = [slice(None)] * x.ndim
            for j in range(i + 1, len(pads)):
                idx[first + j] = centre[first + j]
            for dst, src in ((slice(0, lo), lo),
                             (slice(lo + n, lo + n + hi), lo + n - 1)):
                if dst.stop > dst.start:
                    to, frm = list(idx), list(idx)
                    to[d], frm[d] = dst, slice(src, src + 1)
                    out[tuple(to)] = out[tuple(frm)]
    return out


def _conv3d(conv: nn.Conv3d, x: torch.Tensor, pads, edge: bool
            ) -> torch.Tensor:
    """``conv`` (no padding of its own) over ``x`` padded by ``pads`` (as
    _pad).  Where the padded input passes _CHUNK_ELEMS elements or the
    output 2**31 - 1, it runs over slices of output frames, each slice's
    input padded on its own: no padded copy of the whole input is made and
    every call stays inside 32-bit indexing (exact: an output frame sees
    only its ``kt`` input frames)."""
    (t_lo, t_hi), (h_lo, h_hi), (w_lo, w_hi) = pads
    kt, st = conv.kernel_size[0], conv.stride[0]
    t_in = x.shape[2] + t_lo + t_hi
    t_out = (t_in - kt) // st + 1
    hp, wp = x.shape[3] + h_lo + h_hi, x.shape[4] + w_lo + w_hi
    h_out = (hp - conv.kernel_size[1]) // conv.stride[1] + 1
    w_out = (wp - conv.kernel_size[2]) // conv.stride[2] + 1
    in_frame = x.shape[0] * x.shape[1] * hp * wp
    out_frame = x.shape[0] * conv.out_channels * h_out * w_out
    n = max(1, min(_MAX_ELEMS // out_frame,
                   (_CHUNK_ELEMS // in_frame - kt) // st + 1))
    if n >= t_out:
        return conv(_pad(x, pads, edge))
    out = x.new_empty((x.shape[0], conv.out_channels, t_out, h_out, w_out))
    for t0 in range(0, t_out, n):
        m = min(n, t_out - t0)
        a, b = t0 * st, (t0 + m - 1) * st + kt      # padded frames [a, b)
        lo, hi = max(a - t_lo, 0), min(b - t_lo, x.shape[2])
        piece = ((max(t_lo - a, 0), max(b - t_lo - x.shape[2], 0)),
                 (h_lo, h_hi), (w_lo, w_hi))
        out[:, :, t0:t0 + m] = conv(_pad(x[:, :, lo:hi], piece, edge))
    return out


def _group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, channels), channels, eps=1e-6)


class CausalConv3d(nn.Module):
    """3-D conv with causal temporal padding (frames see only the past)
    and SAME spatial padding; edge padding when causal, zeros when not."""

    def __init__(self, in_ch: int, out_ch: int, kernel=(3, 3, 3),
                 causal: bool = True):
        super().__init__()
        self.kernel, self.causal = tuple(kernel), causal
        self.conv = nn.Conv3d(in_ch, out_ch, self.kernel)

    def forward(self, x):                       # [B, C, T, H, W]
        kt, kh, kw = self.kernel
        pad_t = (kt - 1, 0) if self.causal else ((kt - 1) // 2, kt // 2)
        return _conv3d(self.conv, x, (pad_t, ((kh - 1) // 2, kh // 2),
                                      ((kw - 1) // 2, kw // 2)), self.causal)


def _conv(in_ch, out_ch, video, causal, kernel=3):
    if video:
        return CausalConv3d(in_ch, out_ch, (kernel,) * 3, causal=causal)
    # Flax nn.Conv(padding="SAME") at stride 1 (odd kernels)
    return nn.Conv2d(in_ch, out_ch, kernel, padding=(kernel - 1) // 2)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, video: bool, causal: bool):
        super().__init__()
        self.norm1 = _group_norm(in_ch)
        self.conv1 = _conv(in_ch, features, video, causal)
        self.norm2 = _group_norm(features)
        self.conv2 = _conv(features, features, video, causal)
        if in_ch != features:
            self.conv_shortcut = _conv(in_ch, features, video, causal, 1)
        else:
            self.conv_shortcut = None

    def forward(self, x):
        # in-place SiLU and sum: one full-size activation fewer at a time
        h = self.conv1(F.silu(self.norm1(x), inplace=True))
        h = self.conv2(F.silu(self.norm2(h), inplace=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return h.add_(x)


class MidAttention(nn.Module):
    """Single-head spatial self-attention over each frame (the diffusers
    mid-block Attention of AutoencoderKL / KLHunyuanVideo / KLWan); the
    GroupNorm's statistics span the whole clip, as Flax's do."""

    def __init__(self, features: int):
        super().__init__()
        self.group_norm = _group_norm(features)
        self.to_q = nn.Linear(features, features)
        self.to_k = nn.Linear(features, features)
        self.to_v = nn.Linear(features, features)
        self.to_out = nn.Linear(features, features)

    def forward(self, x):               # [B, C, (T,) H, W]
        h = self.group_norm(x)
        b, c = h.shape[:2]
        if h.ndim == 5:                 # frames batched: [B*T, H*W, C]
            t = h.shape[2]
            h = h.permute(0, 2, 3, 4, 1).reshape(b * t, -1, c)
        else:
            h = h.permute(0, 2, 3, 1).reshape(b, -1, c)
        q, k, v = (self.to_q(h)[:, None], self.to_k(h)[:, None],
                   self.to_v(h)[:, None])
        o = F.scaled_dot_product_attention(q, k, v, scale=c ** -0.5)[:, 0]
        o = self.to_out(o)
        if x.ndim == 5:
            o = o.reshape(b, t, *x.shape[3:], c).permute(0, 4, 1, 2, 3)
        else:
            o = o.reshape(b, *x.shape[2:], c).permute(0, 3, 1, 2)
        return x + o


def _upsample(x, rt: int, rs: int):
    """Nearest upsample: each frame rt times, each pixel rs x rs times."""
    if x.ndim == 4:
        b, c, h, w = x.shape
        return x[:, :, :, None, :, None].expand(b, c, h, rs, w, rs).reshape(
            b, c, h * rs, w * rs)
    b, c, t, h, w = x.shape
    return x[:, :, :, None, :, None, :, None].expand(
        b, c, t, rt, h, rs, w, rs).reshape(b, c, t * rt, h * rs, w * rs)


class VAEDecoder(nn.Module):
    """latents [B, C, T, H, W] (video) or [B, C, H, W] (image) -> pixels in
    [-1, 1] with the configured upsampling factors."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        c = self.cfg = cfg
        ch = list(reversed(c.block_out_channels))
        conv = lambda i, o: _conv(i, o, c.video, c.causal)
        if c.quant_conv:
            # AutoencoderKL post_quant_conv: 1x1 over latent channels
            k1 = (1, 1, 1) if c.video else (1, 1)
            cls = nn.Conv3d if c.video else nn.Conv2d
            self.post_quant_conv = cls(c.latent_channels, c.latent_channels,
                                       k1)
        self.conv_in = conv(c.latent_channels, ch[0])
        self.mid_res1 = ResnetBlock(ch[0], ch[0], c.video, c.causal)
        if c.mid_attention:
            self.mid_attn = MidAttention(ch[0])
        self.mid_res2 = ResnetBlock(ch[0], ch[0], c.video, c.causal)
        prev = ch[0]
        for i, f in enumerate(ch):
            for j in range(c.layers_per_block + 1):
                setattr(self, f"up{i}_res{j}",
                        ResnetBlock(prev, f, c.video, c.causal))
                prev = f
            if c.spatial_upsample[i] or (c.video and c.temporal_upsample[i]):
                setattr(self, f"up{i}_conv", conv(f, f))
        self.norm_out = _group_norm(prev)
        self.conv_out = conv(prev, c.out_channels)

    def forward(self, latents):
        c = self.cfg
        x = denormalize_latents(latents, c)
        if c.quant_conv:
            x = self.post_quant_conv(x)
        x = self.conv_in(x)
        x = self.mid_res1(x)
        if c.mid_attention:
            x = self.mid_attn(x)
        x = self.mid_res2(x)
        for i in range(len(c.block_out_channels)):
            for j in range(c.layers_per_block + 1):
                x = getattr(self, f"up{i}_res{j}")(x)
            s_up = c.spatial_upsample[i]
            t_up = c.video and c.temporal_upsample[i]
            if s_up or t_up:
                if c.video:
                    rt = 2 if t_up else 1
                    x = _upsample(x, rt, 2 if s_up else 1)
                    if t_up and c.causal:
                        x = x[:, :, rt - 1:]   # the first frame not doubled
                else:
                    x = _upsample(x, 1, 2)
                x = getattr(self, f"up{i}_conv")(x)
        return self.conv_out(F.silu(self.norm_out(x), inplace=True))


class Downsample(nn.Module):
    """Stride-2 conv downsample; the causal temporal stride maps T = 2t-1
    to t (the inverse of the decoder's causal repeat-and-trim)."""

    def __init__(self, features: int, video: bool, causal: bool,
                 t_down: bool, s_down: bool):
        super().__init__()
        self.video, self.causal, self.t_down = video, causal, t_down
        if video:
            st, ss = (2 if t_down else 1), (2 if s_down else 1)
            self.conv = nn.Conv3d(features, features, 3, stride=(st, ss, ss))
        else:
            self.conv = nn.Conv2d(features, features, 3, stride=2)

    def forward(self, x):
        if self.video:
            pad_t = (2, 0) if (self.t_down and self.causal) else (1, 1)
            return _conv3d(self.conv, x, (pad_t, (1, 1), (1, 1)),
                           self.causal)
        return self.conv(_pad(x, ((1, 1), (1, 1)), edge=False))


class VAEEncoder(nn.Module):
    """pixels [B, C, T, H, W] (video) or [B, C, H, W] in [-1, 1] ->
    NORMALISED latents [B, latent_C, t, h, w] (the distribution's mode),
    the mirror of VAEDecoder (the image-to-video conditioning spine)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        c = self.cfg = cfg
        ch = list(c.block_out_channels)
        n = len(ch)
        conv = lambda i, o: _conv(i, o, c.video, c.causal)
        self.conv_in = conv(c.out_channels, ch[0])
        prev = ch[0]
        for i, f in enumerate(ch):
            for j in range(c.layers_per_block):
                setattr(self, f"down{i}_res{j}",
                        ResnetBlock(prev, f, c.video, c.causal))
                prev = f
            # mirror the decoder: up-block (n-1-i) upsamples these flags
            s_dn = c.spatial_upsample[n - 1 - i]
            t_dn = c.video and c.temporal_upsample[n - 1 - i]
            if s_dn or t_dn:
                setattr(self, f"down{i}_down",
                        Downsample(f, c.video, c.causal, t_dn, s_dn))
        self.mid_res1 = ResnetBlock(prev, ch[-1], c.video, c.causal)
        if c.mid_attention:
            self.mid_attn = MidAttention(ch[-1])
        self.mid_res2 = ResnetBlock(ch[-1], ch[-1], c.video, c.causal)
        self.norm_out = _group_norm(ch[-1])
        self.conv_out = conv(ch[-1], 2 * c.latent_channels)
        if c.quant_conv:
            k1 = (1, 1, 1) if c.video else (1, 1)
            cls = nn.Conv3d if c.video else nn.Conv2d
            self.quant_conv = cls(2 * c.latent_channels,
                                  2 * c.latent_channels, k1)

    def forward(self, pixels):
        c = self.cfg
        x = self.conv_in(pixels)
        for i in range(len(c.block_out_channels)):
            for j in range(c.layers_per_block):
                x = getattr(self, f"down{i}_res{j}")(x)
            down = getattr(self, f"down{i}_down", None)
            if down is not None:
                x = down(x)
        x = self.mid_res1(x)
        if c.mid_attention:
            x = self.mid_attn(x)
        x = self.mid_res2(x)
        x = self.conv_out(F.silu(self.norm_out(x), inplace=True))
        if c.quant_conv:
            x = self.quant_conv(x)
        return normalize_latents(x[:, :c.latent_channels], c)


def _ramp(n: int, cap: int, device) -> torch.Tensor:
    """min(i + 1, n - i, cap) for i in [0, n): the linear blend weights."""
    i = torch.arange(n, device=device, dtype=torch.float32)
    return torch.minimum(torch.minimum(i + 1, n - i),
                         torch.tensor(float(cap), device=device))


def tiled_decode(decoder_apply, latents, tile: int = 32, overlap: int = 4):
    """Spatially tiled decode (reference: pipe.vae.enable_tiling()): tiles
    of the last two latent dims, overlaps blended linearly; accumulates in
    fp32 on the latents' device."""
    lh, lw = latents.shape[-2], latents.shape[-1]
    if lh <= tile and lw <= tile:
        return decoder_apply(latents)
    step = tile - overlap
    outs = weight = None
    for y0 in range(0, lh, step):
        for x0 in range(0, lw, step):
            y1, x1 = min(y0 + tile, lh), min(x0 + tile, lw)
            part = decoder_apply(latents[..., y0:y1, x0:x1])
            scale_h = part.shape[-2] // (y1 - y0)
            scale_w = part.shape[-1] // (x1 - x0)
            if outs is None:
                full = (*part.shape[:-2], lh * scale_h, lw * scale_w)
                outs = torch.zeros(full, dtype=torch.float32,
                                   device=part.device)
                weight = torch.zeros(full[-2:], dtype=torch.float32,
                                     device=part.device)
            py0, px0 = y0 * scale_h, x0 * scale_w
            ph, pw = part.shape[-2], part.shape[-1]
            wmask = (_ramp(ph, overlap * scale_h, part.device)[:, None]
                     * _ramp(pw, overlap * scale_w, part.device)[None, :])
            outs[..., py0:py0 + ph, px0:px0 + pw] += part.float() * wmask
            weight[py0:py0 + ph, px0:px0 + pw] += wmask
    return outs / torch.clamp(weight, min=1e-8)
