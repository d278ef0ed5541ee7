"""Wan 2.1 / 2.2 pipelines (port of rectified_spaattn_tpu/pipelines/wan.py;
reference drivers scripts/main_wan21t2v.py, main_wan21i2v.py,
main_wan22ti2v.py, main_wan22t2v.py, main_wan22i2v.py).

Wan specifics:
  * classifier-free guidance with TWO transformer calls per step and
    even/odd TeaCache state (main_wan21t2v.py:105-133);
  * visual-only sparse self-attention with first-frame block retention
    and the warm-up gates: dense for the first ``warm_layers`` and last
    ``warm_last_layers`` layers and, T2V only, for every layer until call
    ``warm_calls`` (rectified_wan21_attn.py:467; I2V gates layers only,
    :591);
  * the cross-attention (text, and the CLIP image context for I2V) is
    dense: kernel K3;
  * Wan2.2 A14B (``Wan22A14BPipeline``): two transformers selected by a
    timestep boundary (main_wan22t2v.py:57-61), each with its own TeaCache,
    optionally swapped in and out of the card from pinned host copies
    (``host_swap``);
  * Wan2.2 TI2V-5B: VAE stride 32 and per-token timesteps;
  * image-to-video: ``i2v_condition`` (the mask + latent channels of the
    in_channels-36 transformers) and ``ti2v_first_frame`` (TI2V's held
    first latent frame).

The visual token stream is padded once in embed to a multiple of the mask
block, so every layer's attention sees block-aligned shapes, and sliced
back in head.

With ``mesh`` (parallel.make_mesh, sp = 1) the model is sliced once at
setup for this rank of the tp group; the sparse site runs head-parallel,
the dense warm layers and the cross-attention on the rank's heads, and the
TeaCache decisions are checked to agree across ranks each call.

``vae_decode`` (models/pretrained.py::load_vae) turns the final latents
into pixels.  ``scan_blocks`` runs the block stack through models/scan.py
(the blocks' weights stacked leaf-wise, one segment per run of equal
warm gates); ``dispatch_segments`` is checked as the JAX pipeline checks
it and needs no split here, since windows run back to back in eager
PyTorch are the one pass.  Under
``host_swap`` the tree swapped is the stacked one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models import scan
from ..models.wan import WanDiT
from ..attention import attention
from ..cache import TeaCache
from ..cache.teacache import residual_value
from ..utils.device import resolve_device
from ..utils.timing import device_sync
from .base import (build_site, decode_timed, classifier_free_guidance,
                   param_compute_dtype, rank_mean, shard_tensor_parallel,
                   teacache_decision)
from .schedulers import FlowMatchEulerScheduler, UniPCScheduler


def i2v_condition(image, frames: int, vae_encode, lt: int,
                  temporal_stride: int = 4):
    """Wan I2V conditioning channels (diffusers WanImageToVideoPipeline
    prepare_latents; reference driver main_wan21i2v.py:230-248 feeds the
    resulting in_channels-36 transformer).

    The conditioning image is VAE-encoded as a video whose first frame is
    the image and the rest zeros; a 4-channel mask marks the first latent
    frame.  Returns [B, 4 + Cz, lt, lh, lw] to concatenate onto the noise
    channels every denoise call.

    Args:
      image: [B, 3, H, W] pixels in [-1, 1].
      frames: pixel-frame count F (lt = (F + 3) // temporal_stride).
      vae_encode: pixels [B,3,F,H,W] -> normalised latents [B,Cz,lt,lh,lw].
    """
    b = image.shape[0]
    video = torch.cat(
        [image[:, :, None],
         image.new_zeros((b, image.shape[1], frames - 1, *image.shape[2:]))],
        dim=2)
    z = vae_encode(video)
    assert z.shape[2] == lt, (z.shape, lt)
    # ones on the first latent frame (temporal_stride pixel-frame flags
    # folded into channels), zeros after
    mask = z.new_zeros((b, temporal_stride, lt, *z.shape[3:]))
    mask[:, :, 0] = 1.0
    return torch.cat([mask, z], dim=1)


def ti2v_first_frame(image, vae_encode):
    """Wan2.2 TI2V-5B image mode: the encoded image becomes the FIRST
    latent frame, held fixed during denoising while its tokens take
    per-token timestep 0 (diffusers WanImageToVideoPipeline's
    expand_timesteps branch for the 5B checkpoint).

    Returns [B, Cz, 1, lh, lw]."""
    return vae_encode(image[:, :, None])


@dataclasses.dataclass
class WanPipeline:
    """Wan2.1 T2V / I2V (single transformer).  ``model`` carries its
    weights; it is moved to ``device`` (default "cuda"; raises without a
    GPU unless ``device="cpu"``).  ``mode`` "sparse" runs the rectified
    site past the warm gates, "flash" dense everywhere (K1 windowed, K3
    cross), "vanilla" the fp32 oracle everywhere."""
    model: WanDiT
    height: int = 720
    width: int = 1280
    frames: int = 81
    num_steps: int = 50
    sa_drop_rate: float = 0.75
    p_remain_rates: float = 0.3
    mode: str = "sparse"                 # sparse | flash | vanilla
    enable_teacache: bool = False
    teacache_thresh: float = 0.2
    use_ret_steps: bool = False
    # None: the per-checkpoint polynomial, resolved as the reference
    # drivers do (tea_coefficients)
    teacache_coefficients: Optional[str] = None
    teacache_signal_scale: float = 1.0
    guidance_scale: float = 5.0
    flow_shift: float = 5.0
    vae_stride: tuple = (4, 16, 16)
    warm_layers: int = 2
    warm_last_layers: int = 0
    warm_calls: int = 10
    scheduler: str = "unipc"             # unipc | euler
    is_i2v: bool = False
    plan_row_chunk: int = 0              # SparseConfig.plan_row_chunk
    plan_kv_tile: int = 0                # SparseConfig.plan_kv_tile
    group_rows: int = 1                  # SparseConfig.group_rows (K2 if > 1)
    kv_pack: bool = False                # SparseConfig.kv_pack
    head_chunk: int = 0                  # SparseConfig.head_chunk
    # int8 K|V gather, kernel K1q: "none" | "int8" | "mxu8"
    # (SparseConfig.kv_quant; needs group_rows 1)
    kv_quant: str = "none"
    # TeaCache residual encode: "bf16" (the reference's format) or "int8"
    # (per-row absmax, half the bytes; cache/teacache.py::residual_value)
    teacache_residual: str = "bf16"
    # keep the TeaCache residual in pinned host memory between calls
    teacache_offload: bool = False
    # replay a recorded per-call compute/skip list instead of deciding
    teacache_schedule: Optional[list] = None
    # probe the executed mask density of the first sparse layer per call
    density_probe: bool = False
    # tensor-parallel process groups (parallel.make_mesh; tp only)
    mesh: Optional[object] = None
    # latents -> pixels, applied to the final latents (None: latents out)
    vae_decode: Optional[Callable] = None
    # run the block stack stacked (models/scan.py); the JAX pipeline's
    # ``dispatch_segments`` windows a segment are that one pass here
    scan_blocks: bool = False
    dispatch_segments: int = 1
    # leave the model's weights where they are (the host) instead of
    # moving them to ``device``: for pipelines whose residency a
    # coordinator manages (Wan22A14BPipeline host_swap); the pipeline must
    # not run until its weights are placed
    defer_device: bool = False
    device: str = "cuda"

    def __post_init__(self):
        if self.dispatch_segments > 1 and not self.scan_blocks:
            raise ValueError("dispatch_segments > 1 requires scan_blocks")
        if self.defer_device and self.mesh is not None:
            raise ValueError("defer_device does not compose with a mesh")
        self.device = resolve_device(self.device)
        # shard before the move (only this rank's slices reach the device)
        self.tp = (shard_tensor_parallel(self.model, self.mesh)
                   if self.mesh is not None else None)
        if not self.defer_device:
            self.model = self.model.to(self.device)
        self.model.eval()
        # stack after sharding and quantizing, where the weights live
        self.stack = (scan.stack_model_blocks(self.model, "blocks")[0]
                      if self.scan_blocks else None)
        cfg = self.model.cfg
        self.lt = (self.frames + 3) // self.vae_stride[0]
        self.lh = self.height // self.vae_stride[1]
        self.lw = self.width // self.vae_stride[2]
        pt, ph, pw = cfg.patch_size
        self.grid = (self.lt * pt, self.lh * ph, self.lw * pw)
        self.site, self.l2h, self.h2l = build_site(
            self.lt, self.lh, self.lw, sa_drop_rate=self.sa_drop_rate,
            p_remain=self.p_remain_rates, layout="visual",
            first_frame_retention=True, plan_row_chunk=self.plan_row_chunk,
            plan_kv_tile=self.plan_kv_tile, group_rows=self.group_rows,
            kv_pack=self.kv_pack, head_chunk=self.head_chunk,
            kv_quant=self.kv_quant, device=self.device)
        self.pad = (-self.site.visual_len) % self.site.cfg.block_m
        # activations run in the parameter dtype; RoPE tables stay fp32
        self.compute_dtype = param_compute_dtype(self.model)
        self.density_samples = []
        self.step_seconds = []

    def _embed(self, latents, t, text, image_emb):
        x, ctx, ctx_img, temb, temb6, rope = self.model.embed(
            latents, t, text, self.h2l, image_emb)
        if self.pad:
            # pad the token stream ONCE so every layer's attention sees
            # block-aligned shapes
            p = self.pad
            x = F.pad(x, (0, 0, 0, p))
            rope = tuple(F.pad(r, (0, 0, 0, p)) for r in rope)
            if temb.ndim == 3:
                temb = F.pad(temb, (0, 0, 0, p))
            if temb6.ndim == 4:
                temb6 = F.pad(temb6, (0, 0, 0, 0, 0, p))
        cd = self.compute_dtype
        return (x.to(cd), ctx.to(cd),
                ctx_img.to(cd) if ctx_img is not None else None,
                temb.to(cd), temb6.to(cd), rope)

    def _cross(self, q, k, v):
        return attention(q, k, v, mode="vanilla" if self.mode == "vanilla"
                         else "flash")

    def _run_blocks(self, x, ctx, ctx_img, temb6, rope, sparse: bool):
        dense = self.site.attn_fn("vanilla" if self.mode == "vanilla"
                                  else "flash")
        n = self.model.cfg.num_blocks
        if sparse:
            sp = self.site.attn_fn("sparse")
            fns = [dense if (i < self.warm_layers
                             or i >= n - self.warm_last_layers) else sp
                   for i in range(n)]
        else:
            fns = [dense] * n
        if not self.scan_blocks:
            return self.model.run_blocks(x, ctx, ctx_img, temb6, rope, dense,
                                         self._cross, fns)
        # dispatch_segments windows of a segment, run back to back, are
        # the one pass (models/scan.py)
        return scan.wan_run_blocks_scan(self.model.cfg, self.stack, x, ctx,
                                        ctx_img, temb6, rope,
                                        scan.gate_segments(n, fns.__getitem__),
                                        self._cross)

    def _head(self, x, temb):
        sv = self.site.visual_len
        if self.pad:
            x = x[:, :sv]
            if temb.ndim == 3:
                temb = temb[:, :sv]
        return self.model.head(x, temb, self.l2h, *self.grid)

    def _density(self, x, ctx, ctx_img, temb6, rope) -> float:
        """Mean executed density of the first sparse layer's plan on this
        call's activations: that block runs with a probe attention
        function that builds the plan only (density_only) and returns
        zeros."""
        from ..attention.rectified import rectified_sparse_attention
        site, got = self.site, {}

        def attn_probe(q, k, v):
            got["d"] = rectified_sparse_attention(
                q, k, v, site.cfg, site.neighbor_mask,
                visual_len=site.visual_len, density_only=True)
            return torch.zeros_like(q)

        # under scan_blocks the block runs on its views of the stack
        self.model.blocks[self.warm_layers](x, ctx, temb6, rope, attn_probe,
                                            self._cross, ctx_img=ctx_img)
        return rank_mean(self.tp, float(got["d"]), self.device)

    def _scheduler(self, steps):
        if self.scheduler == "unipc":
            return UniPCScheduler(steps, shift=self.flow_shift)
        return FlowMatchEulerScheduler(steps, shift=self.flow_shift)

    def tea_coefficients(self) -> str:
        """Per-checkpoint rescale polynomial, resolved as the reference
        drivers hard-code it: -ret sets under use_ret_steps
        (main_wan21t2v.py:273-286), a 480p/720p split for I2V
        (main_wan21i2v.py), the TI2V-5B table for Wan2.2-TI2V.  An explicit
        ``teacache_coefficients`` wins."""
        if self.teacache_coefficients is not None:
            return self.teacache_coefficients
        if self.model.cfg.per_token_timesteps or self.vae_stride[1] == 32:
            return "wan2.2-ti2v-5b"
        if self.is_i2v:
            base = ("wan2.1-i2v-480p" if self.height <= 480
                    else "wan2.1-i2v-720p")
        else:
            base = "wan2.1-t2v-14b"
        return base + ("-ret" if self.use_ret_steps else "")

    def _as_tensor(self, x, dtype=None):
        return None if x is None else torch.as_tensor(
            x, dtype=dtype, device=self.device)

    @torch.no_grad()
    def denoise(self, latents, text_cond, text_uncond, image_emb=None,
                condition=None, first_frame=None,
                num_steps: Optional[int] = None):
        """The CFG loop: cond (even) and uncond (odd) calls per step with
        dual-stream TeaCache, the reference's call pattern.

        ``condition``: I2V channels, concatenated onto the noise channels
        every call (in_channels-36 models).  ``first_frame``: TI2V image
        mode, the first latent frame held at this value while its tokens
        denoise at timestep 0 (needs ``cfg.per_token_timesteps``)."""
        latents, text_cond, text_uncond, image_emb, condition, first_frame = (
            self._as_tensor(a, torch.float32) for a in (
                latents, text_cond, text_uncond, image_emb, condition,
                first_frame))
        cfg = self.model.cfg
        steps = num_steps or self.num_steps
        sched = self._scheduler(steps)
        use_sparse = self.mode == "sparse"
        self.density_samples = []
        tea = TeaCache(
            self.teacache_thresh if self.enable_teacache else 0.0,
            steps * 2, coefficients=self.tea_coefficients(),
            ret_steps=(5 * 2 if self.use_ret_steps else 1 * 2),
            cutoff_steps=(steps * 2 if self.use_ret_steps
                          else steps * 2 - 2),
            cfg_streams=2, signal_scale=self.teacache_signal_scale,
            forced_schedule=self.teacache_schedule,
            offload_residual=self.teacache_offload)
        self.teacache = tea

        b = latents.shape[0]
        ff_tokens = 0
        if first_frame is not None:
            if not cfg.per_token_timesteps:
                raise ValueError("TI2V image mode needs per_token_timesteps")
            latents = latents.clone()
            latents[:, :, :1] = first_frame
            # linear token order: latent frame 0 holds the first
            # (H'/ph)*(W'/pw) tokens (patch_size[0] == 1 for Wan)
            ph, pw = cfg.patch_size[1:]
            ff_tokens = (self.grid[1] // ph) * (self.grid[2] // pw)
            n_tok = ff_tokens * self.lt

        self.step_seconds = []      # wall-clock per step, device-synced
        device_sync(latents)
        t0 = time.perf_counter()
        call = 0
        for i, t in enumerate(sched.timesteps):
            if first_frame is not None:
                ts = torch.full((b, n_tok), float(t), device=self.device)
                ts[:, :ff_tokens] = 0.0
            else:
                ts = torch.full((b,), float(t), device=self.device)
            model_in = (latents if condition is None
                        else torch.cat([latents, condition], dim=1))
            outs = []
            for text in (text_cond, text_uncond):
                x, ctx, ctx_img, temb, temb6, rope = self._embed(
                    model_in, ts, text, image_emb)
                if self.density_probe:
                    self.density_samples.append(self._density(
                        x, ctx, ctx_img, temb6, rope))
                # the reference's signal: timestep_proj under use_ret_steps,
                # else temb (main_wan21t2v.py:103)
                sig = temb6 if self.use_ret_steps else temb
                if tea.enabled and not teacache_decision(
                        tea, sig, self.tp, self.device):
                    x = tea.apply_residual(x)
                else:
                    sparse_now = use_sparse and (
                        self.is_i2v or call >= self.warm_calls)
                    x_in = x
                    x = self._run_blocks(x, ctx, ctx_img, temb6, rope,
                                         sparse_now)
                    if tea.enabled:
                        tea.record_residual_value(residual_value(
                            x, x_in, self.teacache_residual))
                outs.append(self._head(x, temb))
                call += 1
            v = classifier_free_guidance(outs[0], outs[1],
                                         self.guidance_scale)
            latents = sched.step(v, latents, i)
            if first_frame is not None:
                latents[:, :, :1] = first_frame
            device_sync(latents)
            self.step_seconds.append(time.perf_counter() - t0
                                     - sum(self.step_seconds))
        self.denoise_seconds = time.perf_counter() - t0
        self.teacache_stats = tea.stats()
        return latents

    def __call__(self, text_cond, text_uncond, image_emb=None,
                 condition=None, first_frame=None, seed: int = 42,
                 num_steps: Optional[int] = None, init_latents=None,
                 generator: Optional[torch.Generator] = None):
        """Draw the initial noise from ``generator`` (default: a generator
        on the pipeline's device seeded with ``seed``) unless
        ``init_latents`` is given, and denoise; returns the latents, or
        ``vae_decode``'s pixels of them."""
        cfg = self.model.cfg
        if init_latents is not None:
            latents = init_latents
        else:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(seed)
            noise_ch = cfg.in_channels - (
                condition.shape[1] if condition is not None else 0)
            latents = torch.randn((text_cond.shape[0], noise_ch, *self.grid),
                                  generator=generator, dtype=torch.float32,
                                  device=self.device)
        latents = self.denoise(latents, text_cond, text_uncond, image_emb,
                               condition, first_frame, num_steps)
        out, self.decode_seconds = decode_timed(self.vae_decode, latents)
        return out


def _host_tree(model: torch.nn.Module, pin: bool) -> dict:
    """The model's weights as host tensors (pinned for fast copies when
    ``pin``), which the caller keeps; each tensor is replaced in the
    module as it is pinned, so the host holds one copy.  A stacked model
    (scan_blocks) gives its stacked tree (models/scan.py::
    stacked_state_dict), each stack pinned whole and its blocks rebound
    to the pinned views."""
    for v in [*model.parameters(), *model.buffers()]:
        if v.device.type != "cpu":
            raise ValueError("host_swap: construct both pipelines with "
                             "defer_device=True on host weights")
    if pin:
        for st in scan.model_stacks(model).values():
            st.bind({n: t if t.is_pinned() else t.pin_memory()
                     for n, t in st.params.items()})
        for v in [*model.parameters(), *model.buffers()]:
            if not v.is_pinned():
                v.data = v.data.pin_memory()
    return scan.stacked_state_dict(model)


@dataclasses.dataclass
class Wan22A14BPipeline:
    """Wan2.2 A14B dual-transformer pipeline: high-noise steps run
    ``high`` (the snapshot's ``transformer``), low-noise steps ``low``
    (``transformer_2``), split by ``boundary_ratio`` over the train
    timesteps (reference: scripts/main_wan22t2v.py:57-61); each keeps its
    own TeaCache (:83-127).

    ``host_swap``: the routing is sequential (every high-noise step, then
    every low-noise one), so both trees stay on the host, pinned, for the
    pipeline's life (construct both pipelines with ``defer_device=True``);
    the high tree is copied to the card at denoise start and swapped for
    the low one once, at the boundary step.  Freeing a tree drops its
    device tensors (the module goes to the meta device) and never copies
    them back.  ``swap_seconds`` / ``load_seconds`` time the copies,
    bounded by a device sync."""
    high: WanPipeline      # transformer (high noise)
    low: WanPipeline       # transformer_2 (low noise)
    boundary_ratio: float = 0.875
    num_train_timesteps: int = 1000
    host_swap: bool = False

    def __post_init__(self):
        self.device = self.high.device
        self._host = None

    def _swap_in(self, pipe_in: WanPipeline, host_tree: dict,
                 pipe_out: WanPipeline) -> float:
        """Free pipe_out's device tree, then place ``host_tree`` on the
        device for pipe_in; returns the copy seconds (sync-bounded)."""
        pipe_out.model.to("meta")
        scan.release_model_stacks(pipe_out.model)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        device_sync()
        t0 = time.perf_counter()
        dev = {k: v.to(self.device, non_blocking=True)
               for k, v in host_tree.items()}
        if pipe_in.scan_blocks:
            scan.load_stacked_state_dict(pipe_in.model, dev)
        else:
            pipe_in.model.load_state_dict(dev, strict=True, assign=True)
        device_sync()
        return time.perf_counter() - t0

    def _tea(self, pipe: WanPipeline, n_calls: int, ret_steps: int):
        return TeaCache(
            pipe.teacache_thresh if pipe.enable_teacache else 0.0,
            n_calls, coefficients=pipe.teacache_coefficients or "wan2.2-a14b",
            ret_steps=ret_steps, cfg_streams=2,
            signal_scale=pipe.teacache_signal_scale,
            forced_schedule=pipe.teacache_schedule,
            offload_residual=pipe.teacache_offload)

    @torch.no_grad()
    def denoise(self, latents, text_cond, text_uncond, condition=None,
                num_steps: Optional[int] = None):
        """``condition``: the I2V-A14B conditioning channels
        (``i2v_condition``); the A14B I2V transformer is in_channels-36
        with NO CLIP image branch (reference: scripts/main_wan22i2v.py)."""
        hi, lo = self.high, self.low
        latents, text_cond, text_uncond, condition = (
            hi._as_tensor(a, torch.float32)
            for a in (latents, text_cond, text_uncond, condition))
        steps = num_steps or hi.num_steps
        sched = hi._scheduler(steps)
        boundary = self.boundary_ratio * self.num_train_timesteps
        high_steps = int(np.sum(sched.timesteps >= boundary))
        tea_h = self._tea(hi, high_steps * 2, 3 * 2)
        tea_l = self._tea(lo, (steps - high_steps) * 2, 2)
        self.teacache = {"high": tea_h, "low": tea_l}

        self.swap_seconds = 0.0
        swapped = not self.host_swap
        if self.host_swap:
            if self._host is None:
                pin = self.device.type == "cuda"
                self._host = (_host_tree(hi.model, pin),
                              _host_tree(lo.model, pin))
                lo.model.to("meta")
                scan.release_model_stacks(lo.model)
            self.load_seconds = self._swap_in(hi, self._host[0], lo)

        b = latents.shape[0]
        self.step_seconds = []      # wall-clock per step, device-synced
        device_sync(latents)
        t0 = time.perf_counter()
        for i, t in enumerate(sched.timesteps):
            is_high = t >= boundary
            if not is_high and not swapped:
                # the one boundary swap: high tree out, low tree in
                self.swap_seconds = self._swap_in(lo, self._host[1], hi)
                swapped = True
            pipe, tea = (hi, tea_h) if is_high else (lo, tea_l)
            ts = torch.full((b,), float(t), device=self.device)
            model_in = (latents if condition is None
                        else torch.cat([latents, condition], dim=1))
            outs = []
            for text in (text_cond, text_uncond):
                x, ctx, ctx_img, temb, temb6, rope = pipe._embed(
                    model_in, ts, text, None)
                if tea.enabled and not teacache_decision(
                        tea, temb, pipe.tp, self.device):
                    x = tea.apply_residual(x)
                else:
                    x_in = x
                    x = pipe._run_blocks(x, ctx, ctx_img, temb6, rope,
                                         pipe.mode == "sparse")
                    if tea.enabled:
                        tea.record_residual_value(residual_value(
                            x, x_in, pipe.teacache_residual))
                outs.append(pipe._head(x, temb))
            v = classifier_free_guidance(outs[0], outs[1],
                                         pipe.guidance_scale)
            latents = sched.step(v, latents, i)
            device_sync(latents)
            self.step_seconds.append(time.perf_counter() - t0
                                     - sum(self.step_seconds))
        self.denoise_seconds = time.perf_counter() - t0
        self.teacache_stats = (
            {"high": tea_h.stats(), "low": tea_l.stats()}
            if tea_h.enabled or tea_l.enabled else None)
        return latents

    def __call__(self, text_cond, text_uncond, condition=None, seed: int = 42,
                 num_steps: Optional[int] = None, init_latents=None,
                 generator: Optional[torch.Generator] = None):
        """Draw the initial noise from ``generator`` (default: a generator
        on the device seeded with ``seed``) unless ``init_latents`` is
        given, and denoise; returns the latents (the JAX CLI decodes no
        A14B run)."""
        cfg = self.high.model.cfg
        if init_latents is not None:
            latents = init_latents
        else:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(seed)
            noise_ch = cfg.in_channels - (
                condition.shape[1] if condition is not None else 0)
            latents = torch.randn(
                (text_cond.shape[0], noise_ch, *self.high.grid),
                generator=generator, dtype=torch.float32, device=self.device)
        return self.denoise(latents, text_cond, text_uncond, condition,
                            num_steps)
