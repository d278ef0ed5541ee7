"""Flux.1-dev pipelines (port of rectified_spaattn_tpu/pipelines/flux.py;
reference script scripts/main_upflux.py).

The reference's headline Flux workload is the two-stage 4096^2 upscale:
base generation at 1024^2, then a ControlNet-conditioned pass at 4096^2
(65,536 visual + 512 text tokens).  Every step of the sparse mode is
sparse; the gate is per block: fused index < 37 or >= 57 runs the
rectified site, the 20 single blocks between run the windowed dense K1
(rectified_flux_attn.py:493; the ids count 19 dual + 38 single blocks).
The mu-shifted Euler keeps its sigmas near 1 until the last step at
4096^2 (mu = 11.55), so the update stays fp32.

With ``mesh`` (parallel.make_mesh, sp = 1) the trunk (and the
ControlNet) is sliced once for this rank of the tp group; the two stages
share one trunk.  ``scan_blocks`` runs the trunk's stacks through
models/scan.py (stacked once for both stages; one segment per run of
equal gates; the ControlNet's raw samples indexed per block); the
ControlNet itself runs unrolled, as in the JAX pipeline.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from ..models import scan
from ..models.flux import (FluxControlNet, FluxDiT,
                           distribute_controlnet_samples)
from ..cache import TeaCache
from ..cache.teacache import residual_value
from ..utils.device import resolve_device
from ..utils.timing import device_sync
from .base import (build_site, decode_timed, param_compute_dtype,
                   shard_tensor_parallel, teacache_decision)
from .schedulers import FlowMatchEulerScheduler, flux_mu_shift


def flux_unpack_latents(tokens: torch.Tensor, gh: int,
                        gw: int) -> torch.Tensor:
    """[B, gh*gw, 4C] 2x2-packed tokens -> [B, C, 2gh, 2gw] latents
    (inverse of diffusers FluxPipeline._pack_latents: feature index =
    c*4 + dy*2 + dx)."""
    b, _, f = tokens.shape
    c = f // 4
    x = tokens.reshape(b, gh, gw, c, 2, 2)
    x = x.permute(0, 3, 1, 4, 2, 5)                # [B, C, gh, 2, gw, 2]
    return x.reshape(b, c, 2 * gh, 2 * gw)


def flux_pack_latents(lat: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] latents -> [B, (H/2)(W/2), 4C] packed tokens."""
    b, c, hh, ww = lat.shape
    x = lat.reshape(b, c, hh // 2, 2, ww // 2, 2)
    x = x.permute(0, 2, 4, 1, 3, 5)                # [B, gh, gw, C, 2, 2]
    return x.reshape(b, (hh // 2) * (ww // 2), c * 4)


def _cubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] fp32 rows of jax.image.resize's "bicubic": Keys'
    cubic (a = -0.5) at half-pixel centres, the kernel widened by the
    ratio when shrinking (antialias), taps outside the image dropped and
    each row renormalised; a sample outside the input range gets a zero
    row."""
    inv = n_in / n_out
    kscale = max(inv, 1.0)
    f32 = torch.float32
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv - 0.5
    x = (sample[:, None] - torch.arange(n_in, dtype=f32,
                                        device=device)[None, :]).abs() / kscale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def resize_bicubic(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Resize the last two axes of ``x`` as jax.image.resize(...,
    method="bicubic") does (``F.interpolate``'s bicubic is another
    function: a = -0.75 with the border clamped): two products with the
    per-axis weight matrices, in fp32."""
    wh = _cubic_weights(x.shape[-2], height, x.device)
    ww = _cubic_weights(x.shape[-1], width, x.device)
    y = torch.matmul(wh, x.float())
    return torch.matmul(y, ww.T).to(x.dtype)


def _shard_once(model, mesh):
    """This rank's slice of ``model`` under ``mesh`` (made once: the two
    stages share one trunk) and the tp group, or None without a mesh."""
    if mesh is None:
        return None
    group = getattr(model, "tp_group", None)
    if group is None:
        group = shard_tensor_parallel(model, mesh)
        model.tp_group = group
    return group


@dataclasses.dataclass
class FluxPipeline:
    """One Flux stage.  ``model`` carries its weights; it is moved to
    ``device`` (default "cuda"; raises without a GPU unless
    ``device="cpu"``).  ``mode`` "sparse" gates every step's blocks by
    ``sparse_layer_gate``, "flash" runs every block dense (K1 windowed),
    "vanilla" the fp32 oracle."""
    model: FluxDiT
    height: int = 1024
    width: int = 1024
    num_steps: int = 28
    sa_drop_rate: float = 0.9
    p_remain_rates: float = 0.3
    mode: str = "sparse"
    enable_teacache: bool = False
    rel_l1_thresh: float = 0.8
    text_len: int = 512
    guidance_scale: float = 3.5
    sparse_layer_gate: tuple = (37, 57)   # the dense band [37, 57)
    vae_decode: Optional[Callable] = None
    # tensor-parallel process groups (parallel.make_mesh; tp only)
    mesh: Optional[object] = None
    # run the trunk's block stacks stacked (models/scan.py)
    scan_blocks: bool = False
    plan_row_chunk: int = 0              # SparseConfig.plan_row_chunk
    plan_kv_tile: int = 0                # SparseConfig.plan_kv_tile
    group_rows: int = 1                  # SparseConfig.group_rows (K2 if > 1)
    kv_pack: bool = False                # SparseConfig.kv_pack
    head_chunk: int = 0                  # SparseConfig.head_chunk
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        # shard before the move (only this rank's slices reach the device)
        self.tp = _shard_once(self.model, self.mesh)
        self.model = self.model.to(self.device).eval()
        # stack after sharding and quantizing, on the device; the other
        # stage's stacks are reused
        self.stacks = (scan.stack_model_blocks(self.model, "dual_blocks",
                                               "single_blocks")
                       if self.scan_blocks else None)
        # latent grid: 2x2-packed 16-channel latents -> h/16 x w/16 tokens
        self.gh = self.height // 16
        self.gw = self.width // 16
        self.site, self.l2h, self.h2l = build_site(
            1, self.gh, self.gw, sa_drop_rate=self.sa_drop_rate,
            p_remain=self.p_remain_rates, layout="joint",
            text_len=self.text_len, plan_row_chunk=self.plan_row_chunk,
            plan_kv_tile=self.plan_kv_tile, group_rows=self.group_rows,
            kv_pack=self.kv_pack, head_chunk=self.head_chunk,
            device=self.device)
        # activations run in the parameter dtype; RoPE tables stay fp32
        self.compute_dtype = param_compute_dtype(self.model)
        self.step_seconds = []

    def _embed(self, tokens, t, text, pooled, guidance):
        m = self.model
        x, ctx, temb, rope = m.embed(tokens, t, text, pooled, guidance,
                                     self.gh, self.gw, self.h2l)
        # the dual blocks are HunyuanVideo's: the same block-0 signal
        sig = (scan.hunyuan_teacache_signal_scan(m.cfg, self.stacks[0], x,
                                                 temb)
               if self.scan_blocks else m.teacache_signal(x, temb))
        cd = self.compute_dtype
        return x.to(cd), ctx.to(cd), temb.to(cd), rope, sig.to(cd)

    def attn_fns(self, tlen):
        """(dual, single) attention functions, one per block: under
        "sparse" the rectified site outside the gate's dense band and the
        windowed dense inside it."""
        n_dual = self.model.cfg.num_dual_blocks
        n_single = self.model.cfg.num_single_blocks
        dense = self.site.attn_fn("vanilla" if self.mode == "vanilla"
                                  else "flash", text_len_rt=tlen)
        if self.mode != "sparse":
            return [dense] * n_dual, [dense] * n_single
        sparse = self.site.attn_fn("sparse", text_len_rt=tlen)
        lo, hi = self.sparse_layer_gate
        gate = lambda pid: sparse if (pid < lo or pid >= hi) else dense
        return ([gate(i) for i in range(n_dual)],
                [gate(n_dual + i) for i in range(n_single)])

    def _as_tensor(self, x, dtype=None):
        return None if x is None else torch.as_tensor(
            x, dtype=dtype, device=self.device)

    def _run_blocks(self, x, ctx, temb, rope, dual_fns, single_fns,
                    controlnet_fn, tokens, t):
        """The trunk's blocks with the ControlNet's samples of this step:
        unrolled over the per-block residual lists, or stacked over the
        raw sample lists."""
        m = self.model
        dual_s = single_s = None
        if controlnet_fn is not None:
            dual_s, single_s = controlnet_fn(tokens, t)
        if self.scan_blocks:
            segs = [scan.gate_segments(len(fns), fns.__getitem__)
                    for fns in (dual_fns, single_fns)]
            return scan.flux_run_blocks_scan(m.cfg, *self.stacks, x, ctx,
                                             temb, rope, *segs, dual_s,
                                             single_s)
        return m.run_blocks(
            x, ctx, temb, rope, None, dual_fns, single_fns,
            distribute_controlnet_samples(dual_s, m.cfg.num_dual_blocks),
            distribute_controlnet_samples(single_s,
                                          m.cfg.num_single_blocks))

    @torch.no_grad()
    def denoise(self, tokens, text_emb, text_mask, pooled,
                controlnet_fn: Optional[Callable] = None,
                num_steps: Optional[int] = None):
        """The Euler loop over packed tokens [B, gh*gw, C] (linear order);
        returns the final tokens.  ``controlnet_fn(tokens, t) ->
        (dual_samples, single_samples)`` in the RESIDENT (curve) order,
        distributed over the blocks; it runs on the steps that compute."""
        tokens = self._as_tensor(tokens, torch.float32)
        text_emb = self._as_tensor(text_emb, torch.float32)
        text_mask = self._as_tensor(text_mask, torch.bool)
        pooled = self._as_tensor(pooled, torch.float32)
        steps = num_steps or self.num_steps
        sched = FlowMatchEulerScheduler(
            steps, use_mu=True, mu=flux_mu_shift(self.gh * self.gw))
        tea = TeaCache(self.rel_l1_thresh if self.enable_teacache else 0.0,
                       steps, coefficients="flux-dev")
        self.teacache = tea
        b = tokens.shape[0]
        tlen = text_mask.to(torch.int32).sum(dim=1).to(torch.int32)
        guidance = torch.full((b,), self.guidance_scale, dtype=torch.float32,
                              device=self.device)
        dual_fns, single_fns = self.attn_fns(tlen)
        m = self.model
        self.step_seconds = []      # wall-clock per step, device-synced
        device_sync(tokens)
        t0 = time.perf_counter()
        for i, t in enumerate(sched.timesteps):
            ts = torch.full((b,), float(t) / 1000.0, dtype=torch.float32,
                            device=self.device)
            x, ctx, temb, rope, sig = self._embed(tokens, ts, text_emb,
                                                  pooled, guidance)
            if tea.enabled and not teacache_decision(tea, sig, self.tp,
                                                     self.device):
                x = tea.apply_residual(x)
            else:
                x_in = x
                x, ctx = self._run_blocks(x, ctx, temb, rope, dual_fns,
                                          single_fns, controlnet_fn, tokens,
                                          float(t))
                if tea.enabled:
                    tea.record_residual_value(residual_value(x, x_in))
            v = m.head(x, temb, self.l2h)
            tokens = sched.step(v, tokens, i)
            device_sync(tokens)
            self.step_seconds.append(time.perf_counter() - t0
                                     - sum(self.step_seconds))
        self.denoise_seconds = time.perf_counter() - t0
        self.teacache_stats = tea.stats()
        return tokens

    def noise(self, batch: int, seed: int = 42,
              generator: Optional[torch.Generator] = None):
        """[B, gh*gw, in_channels] fp32 noise from ``generator`` (default:
        a generator on the pipeline's device seeded with ``seed``)."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        return torch.randn((batch, self.gh * self.gw,
                            self.model.cfg.in_channels), generator=generator,
                           dtype=torch.float32, device=self.device)

    def __call__(self, text_emb, text_mask, pooled, seed: int = 42,
                 controlnet_fn=None, init_tokens=None,
                 num_steps: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        """Denoise ``init_tokens`` or fresh noise; returns the tokens, or
        ``vae_decode``'s pixels of them."""
        if init_tokens is None:
            init_tokens = self.noise(text_emb.shape[0], seed, generator)
        tokens = self.denoise(init_tokens, text_emb, text_mask, pooled,
                              controlnet_fn, num_steps)
        out, self.decode_seconds = decode_timed(self.vae_decode, tokens)
        return out


@dataclasses.dataclass
class FluxUpscalePipeline:
    """Two-stage upscale: base generation at the base size, then the
    high-res pass (reference: scripts/main_upflux.py:287-328 with
    jasperai/Flux.1-dev-Controlnet-Upscaler).

    With a ControlNet the second stage starts from pure noise and the base
    image shapes the output through the ControlNet's residuals, as the
    reference's FluxControlNetPipeline does.  Without one, the fallback is
    img2img: the upsampled base latents seed the init at ``strength``.
    The control is the base image decoded to pixels, resized (bicubic) to
    the upscaled size and encoded again (``vae_decode`` / ``vae_encode``
    on UNPACKED latents), or without a VAE the nearest latent upsample."""
    base: FluxPipeline
    up: FluxPipeline
    controlnet: Optional[FluxControlNet] = None
    conditioning_scale: float = 1.0
    strength: float = 0.7                 # the no-ControlNet fallback
    vae_decode: Optional[Callable] = None
    vae_encode: Optional[Callable] = None

    def __post_init__(self):
        if self.controlnet is not None:
            _shard_once(self.controlnet, self.up.mesh)
            self.controlnet = self.controlnet.to(self.up.device).eval()
            self.controlnet_dtype = param_compute_dtype(self.controlnet)

    @property
    def device(self):
        return self.up.device

    def control_tokens(self, base_tokens):
        """The upscaled control as packed tokens in linear order."""
        b = base_tokens.shape[0]
        gh_b, gw_b = self.base.gh, self.base.gw
        gh_u, gw_u = self.up.gh, self.up.gw
        ry, rx = gh_u // gh_b, gw_u // gw_b
        if self.vae_decode is not None and self.vae_encode is not None:
            # the reference's control prep: pixels, resized to the
            # upscaled size (main_upflux.py:326-328), encoded again
            pixels = self.vae_decode(flux_unpack_latents(base_tokens, gh_b,
                                                         gw_b))
            hi = resize_bicubic(pixels, pixels.shape[2] * ry,
                                pixels.shape[3] * rx)
            return flux_pack_latents(self.vae_encode(hi)).to(
                device=self.up.device, dtype=torch.float32)
        grid = base_tokens.reshape(b, gh_b, gw_b, -1)
        grid = grid.repeat_interleave(ry, dim=1).repeat_interleave(rx, dim=2)
        return grid.reshape(b, gh_u * gw_u, -1)

    def controlnet_fn(self, control, text_emb, pooled):
        """``fn(tokens, t)`` -> the ControlNet's samples in the curve
        order: its linear-order inputs and RoPE permuted by the up stage's
        hilbert_to_linear."""
        up, cn = self.up, self.controlnet
        text_emb = up._as_tensor(text_emb, torch.float32)
        pooled = up._as_tensor(pooled, torch.float32)
        b = control.shape[0]
        guidance = torch.full((b,), up.guidance_scale, dtype=torch.float32,
                              device=up.device)

        def fn(tokens, t):
            ts = torch.full((b,), float(t) / 1000.0, dtype=torch.float32,
                            device=up.device)
            return cn(tokens, control, ts, text_emb, pooled, guidance, up.gh,
                      up.gw, up.h2l, self.conditioning_scale,
                      compute_dtype=self.controlnet_dtype)

        return fn

    @torch.no_grad()
    def __call__(self, text_emb, text_mask, pooled, seed: int = 42,
                 controlnet_fn=None,
                 generator: Optional[torch.Generator] = None,
                 base_init=None, up_noise=None):
        """The base stage from ``base_init`` or noise (``generator``, else
        ``seed``), then the up stage from ``up_noise`` or noise of its own
        (a generator on the up device seeded with ``seed + 1``)."""
        base_tokens = self.base(text_emb, text_mask, pooled, seed=seed,
                                init_tokens=base_init, generator=generator)
        control = self.control_tokens(base_tokens)
        noise = (self.up._as_tensor(up_noise, torch.float32)
                 if up_noise is not None else
                 self.up.noise(control.shape[0], seed + 1))
        if controlnet_fn is None and self.controlnet is not None:
            controlnet_fn = self.controlnet_fn(control, text_emb, pooled)
        if controlnet_fn is not None:
            init = noise                    # the reference: pure noise
        else:
            init = (1 - self.strength) * control + self.strength * noise
        return self.up(text_emb, text_mask, pooled,
                       controlnet_fn=controlnet_fn, init_tokens=init)
