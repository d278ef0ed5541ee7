"""HunyuanVideo text-to-video pipeline (port of
rectified_spaattn_tpu/pipelines/hunyuan.py; reference driver
scripts/main_hunyuan.py).

Latent geometry (f/4, h/16, w/16); flow-match Euler steps with embedded
guidance (no CFG); the text tokens trail the visual tokens; TeaCache over
the whole block stack with the block-0 norm1 signal.

With ``mesh`` (parallel.make_mesh, sp = 1) the model is sliced once at
setup for this rank of the tp group and the sparse site runs head-parallel;
every rank runs the same loop on replicated activations and makes the same
TeaCache decisions (checked each call).

``vae_decode`` (models/pretrained.py::load_vae) turns the final latents
into pixels.  Image-to-video: ``first_frame`` (token_replace,
``i2v_first_frame``) holds the clean image latent in the stream with its
tokens modulated at t = 0; ``condition`` (latent_concat,
``i2v_condition_concat``) concatenates onto the noise channels at every
call.

``scan_blocks`` runs the block stacks through models/scan.py (the
blocks' weights stacked leaf-wise, each block on its views of the
stacks; the same launches and numbers as the unrolled loop);
``dispatch_segments`` is checked as the JAX pipeline checks it (k > 1
needs ``scan_blocks``) and needs no split here: windows run back to back
in eager PyTorch are the one pass.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from ..models import scan
from ..models.hunyuan import HunyuanVideoDiT
from ..cache import TeaCache
from ..cache.teacache import residual_value
from ..utils.device import resolve_device
from ..utils.timing import device_sync
from .base import (build_site, decode_timed, param_compute_dtype,
                   rank_mean, shard_tensor_parallel, teacache_decision)
from .schedulers import FlowMatchEulerScheduler


def i2v_condition_concat(image, frames: int, vae_encode, lt: int):
    """HunyuanVideo-I2V v1 (544p, image_condition_type "latent_concat"):
    the image VAE-encodes as a video whose first frame is the image and
    the rest zeros; a 1-channel mask marks the first latent frame
    (diffusers HunyuanVideoImageToVideoPipeline.prepare_latents).  The
    result concatenates onto the noise channels every step, feeding the
    in_channels-33 transformer.

    Returns [B, Cz + 1, lt, lh, lw]."""
    b = image.shape[0]
    video = torch.cat(
        [image[:, :, None],
         image.new_zeros((b, image.shape[1], frames - 1, *image.shape[2:]))],
        dim=2)
    z = vae_encode(video)
    assert z.shape[2] == lt, (z.shape, lt)
    mask = z.new_zeros((b, 1, lt, *z.shape[3:]))
    mask[:, :, :1] = 1.0
    return torch.cat([z, mask], dim=1)


def i2v_first_frame(image, vae_encode):
    """HunyuanVideo-I2V (720p, "token_replace"): the conditioning image
    VAE-encodes into the FIRST latent frame, which the pipeline holds
    fixed every step while its tokens are modulated at t=0 (diffusers
    HunyuanVideoImageToVideoPipeline).

    Returns [B, Cz, 1, lh, lw]."""
    return vae_encode(image[:, :, None])


@dataclasses.dataclass
class HunyuanVideoPipeline:
    """Args mirror the reference CLI (scripts/main_hunyuan.py:213-225).
    ``model`` carries its weights; it is moved to ``device`` (default
    "cuda"; raises without a GPU unless ``device="cpu"``)."""
    model: HunyuanVideoDiT
    height: int = 720
    width: int = 1280
    frames: int = 128
    num_steps: int = 50
    sa_drop_rate: float = 0.8
    p_remain_rates: float = 0.3
    mode: str = "sparse"                 # sparse | flash | vanilla
    enable_teacache: bool = False
    rel_l1_thresh: float = 0.15
    text_len: int = 256
    guidance_scale: float = 6.0
    flow_shift: float = 7.0
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
    # keep the TeaCache residual in pinned host memory between steps
    teacache_offload: bool = False
    # replay a recorded per-call compute/skip list instead of deciding
    teacache_schedule: Optional[list] = None
    # keep every n-th token of the TeaCache signal (the stored
    # previous_modulated shrinks n-fold; rel-L1 is a mean over tokens)
    teacache_signal_stride: int = 1
    # latents -> pixels, applied to the final latents (None: latents out)
    vae_decode: Optional[Callable] = None
    # probe the executed mask density of block 0 once per step
    density_probe: bool = False
    # tensor-parallel process groups (parallel.make_mesh; tp only)
    mesh: Optional[object] = None
    # run the block stacks stacked (models/scan.py); the JAX pipeline's
    # ``dispatch_segments`` windows a phase are that one pass here
    scan_blocks: bool = False
    dispatch_segments: int = 1
    device: str = "cuda"

    def __post_init__(self):
        if self.dispatch_segments > 1 and not self.scan_blocks:
            raise ValueError("dispatch_segments > 1 requires scan_blocks")
        self.device = resolve_device(self.device)
        # shard before the move, so a model built on the host sends only
        # this rank's slices to the device
        self.tp = (shard_tensor_parallel(self.model, self.mesh)
                   if self.mesh is not None else None)
        self.model = self.model.to(self.device).eval()
        # stack after sharding and quantizing, on the device
        self.stacks = (scan.stack_model_blocks(self.model, "dual_blocks",
                                               "single_blocks")
                       if self.scan_blocks else None)
        cfg = self.model.cfg
        self.lt = self.frames // 4
        self.lh = self.height // 16
        self.lw = self.width // 16
        self.grid = (self.lt * cfg.patch_size_t, self.lh * cfg.patch_size,
                     self.lw * cfg.patch_size)
        self.site, self.l2h, self.h2l = build_site(
            self.lt, self.lh, self.lw, sa_drop_rate=self.sa_drop_rate,
            p_remain=self.p_remain_rates, layout="joint",
            text_len=self.text_len, plan_row_chunk=self.plan_row_chunk,
            plan_kv_tile=self.plan_kv_tile, group_rows=self.group_rows,
            kv_pack=self.kv_pack, head_chunk=self.head_chunk,
            kv_quant=self.kv_quant, device=self.device)
        # token_replace: the first LATENT frame's tokens, scattered by the
        # curve, are modulated at t=0 (patch_size_t is 1, so they are the
        # first lh*lw linear tokens); the head reads the linear-order mask
        self.token_replace = cfg.image_condition_type == "token_replace"
        if self.token_replace:
            ff_tokens = self.lh * self.lw
            self._ff_mask_curve = self.h2l < ff_tokens
            self._ff_mask_linear = (torch.arange(self.h2l.shape[0],
                                                 device=self.device)
                                    < ff_tokens)
        # activations run in the parameter dtype; RoPE tables stay fp32
        self.compute_dtype = param_compute_dtype(self.model)
        self.density_samples = []
        self.step_seconds = []

    def _embed(self, latents, t, text, mask, guidance, pooled):
        m = self.model
        x, ctx, temb, rope = m.embed(latents, t, text, mask, guidance,
                                     self.h2l, pooled)
        sig = (scan.hunyuan_teacache_signal_scan(m.cfg, self.stacks[0], x,
                                                 temb)
               if self.scan_blocks else m.teacache_signal(x, temb))
        if self.teacache_signal_stride > 1:
            sig = sig[:, ::self.teacache_signal_stride]
        cd = self.compute_dtype
        return x.to(cd), ctx.to(cd), temb.to(cd), rope, sig.to(cd)

    def _density(self, x, ctx, temb, rope, tlen) -> float:
        """Mean executed density of the FIRST block's plan on this step's
        activations: block 0 runs with a probe attention function that
        builds the plan only (density_only) and returns zeros."""
        from ..attention.rectified import rectified_sparse_attention
        site, got = self.site, {}

        def attn_probe(q, k, v):
            got["d"] = rectified_sparse_attention(
                q, k, v, site.cfg, site.neighbor_mask,
                visual_len=site.visual_len, text_len_rt=tlen,
                density_only=True)
            return torch.zeros_like(q)

        m = self.model
        # under scan_blocks the block runs on its views of the stack
        blk = m.dual_blocks[0] if len(m.dual_blocks) else m.single_blocks[0]
        blk(x, ctx, temb, rope, attn_probe)
        return rank_mean(self.tp, float(got["d"]), self.device)

    def _run_blocks(self, x, ctx, temb, rope, fn, temb_tr, mask_curve):
        """The block stacks, unrolled or stacked.  ``dispatch_segments``
        windows run back to back are the one pass, so it takes no branch
        here (models/scan.py)."""
        m = self.model
        if not self.scan_blocks:
            return m.run_blocks(x, ctx, temb, rope, fn, temb_tr, mask_curve)
        return scan.hunyuan_run_blocks_scan(m.cfg, *self.stacks, x, ctx,
                                            temb, rope, fn, temb_tr,
                                            mask_curve)

    def _as_tensor(self, x, dtype=None):
        return None if x is None else torch.as_tensor(
            x, dtype=dtype, device=self.device)

    @torch.no_grad()
    def denoise(self, latents, text_emb, text_mask, pooled=None,
                num_steps: Optional[int] = None, first_frame=None,
                condition=None):
        """Run the scheduler loop; returns the final latents.

        latents [B, C, T', H', W'] initial noise in latent grid units;
        text_emb [B, text_len, text_dim] (padded); text_mask [B, text_len];
        pooled [B, pooled_dim] or None (a learned mean-text projection).
        first_frame [B, C, 1, H', W']: the clean image latent of
        token_replace I2V, written into the stream before every step and
        after the last one.  condition [B, Cz + 1, T', H', W']: the
        latent_concat conditioning (``i2v_condition_concat``),
        concatenated onto the noise channels at every call; latents then
        carry out_channels, the model in_channels."""
        latents = self._as_tensor(latents, torch.float32)
        text_emb = self._as_tensor(text_emb, torch.float32)
        text_mask = self._as_tensor(text_mask, torch.bool)
        pooled = self._as_tensor(pooled, torch.float32)
        first_frame = self._as_tensor(first_frame, torch.float32)
        condition = self._as_tensor(condition, torch.float32)
        steps = num_steps or self.num_steps
        sched = FlowMatchEulerScheduler(steps, shift=self.flow_shift)
        self.density_samples = []
        tea = TeaCache(self.rel_l1_thresh if self.enable_teacache else 0.0,
                       steps, coefficients="hunyuan-video",
                       forced_schedule=self.teacache_schedule,
                       offload_residual=self.teacache_offload)
        self.teacache = tea
        b = latents.shape[0]
        tlen = text_mask.to(torch.int32).sum(dim=1).to(torch.int32)
        guidance = torch.full((b,), self.guidance_scale * 1000.0,
                              dtype=torch.float32, device=self.device)
        fn = self.site.attn_fn(self.mode, text_len_rt=tlen)
        m = self.model
        tr = self.token_replace and first_frame is not None
        temb_tr = mask_curve = mask_linear = None
        if tr:
            temb_tr = m.token_replace_temb(text_emb, text_mask, guidance,
                                           pooled).to(self.compute_dtype)
            mask_curve, mask_linear = self._ff_mask_curve, self._ff_mask_linear

        def hold(lat):
            return torch.cat([first_frame, lat[:, :, 1:]], dim=2)

        self.step_seconds = []      # wall-clock per step, device-synced
        device_sync(latents)
        t0 = time.perf_counter()
        for i, t in enumerate(sched.timesteps):
            if tr:
                latents = hold(latents)
            ts = torch.full((b,), float(t), dtype=torch.float32,
                            device=self.device)
            model_in = (latents if condition is None
                        else torch.cat([latents, condition], dim=1))
            x, ctx, temb, rope, sig = self._embed(
                model_in, ts, text_emb, text_mask, guidance, pooled)
            if self.density_probe:
                self.density_samples.append(
                    self._density(x, ctx, temb, rope, tlen))
            if tea.enabled and not teacache_decision(tea, sig, self.tp,
                                                     self.device):
                x = tea.apply_residual(x)
            else:
                x_in = x
                x, ctx = self._run_blocks(x, ctx, temb, rope, fn, temb_tr,
                                          mask_curve)
                if tea.enabled:
                    tea.record_residual_value(
                        residual_value(x, x_in, self.teacache_residual))
            v_pred = m.head(x, temb, self.l2h, *self.grid, temb_tr,
                            mask_linear)
            latents = sched.step(v_pred, latents, i)
            device_sync(latents)
            self.step_seconds.append(time.perf_counter() - t0
                                     - sum(self.step_seconds))
        if tr:
            latents = hold(latents)
        self.denoise_seconds = time.perf_counter() - t0
        self.teacache_stats = tea.stats()
        return latents

    def __call__(self, text_emb, text_mask, pooled=None, seed: int = 42,
                 num_steps: Optional[int] = None, init_latents=None,
                 generator: Optional[torch.Generator] = None,
                 first_frame=None, condition=None):
        """Draw the initial noise from ``generator`` (default: a generator
        on the pipeline's device seeded with ``seed``) unless
        ``init_latents`` is given, and denoise; returns the latents, or
        ``vae_decode``'s pixels of them.  Under ``condition`` the noise
        carries the channels the condition leaves of in_channels."""
        cfg = self.model.cfg
        b = text_emb.shape[0]
        if init_latents is not None:
            latents = init_latents
        else:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(seed)
            noise_ch = (cfg.in_channels if condition is None
                        else cfg.in_channels - condition.shape[1])
            latents = torch.randn((b, noise_ch, *self.grid),
                                  generator=generator, dtype=torch.float32,
                                  device=self.device)
        latents = self.denoise(latents, text_emb, text_mask, pooled=pooled,
                               num_steps=num_steps, first_frame=first_frame,
                               condition=condition)
        out, self.decode_seconds = decode_timed(self.vae_decode, latents)
        return out
