"""HunyuanVideo text-to-video pipeline (port of
rectified_spaattn_tpu/pipelines/hunyuan.py; reference driver
scripts/main_hunyuan.py).

Latent geometry (f/4, h/16, w/16); flow-match Euler steps with embedded
guidance (no CFG); the text tokens trail the visual tokens; TeaCache over
the whole block stack with the block-0 norm1 signal.

Left out of this slice: the TPU and multi-chip levers ``scan_blocks``,
``dispatch_segments`` and ``mesh``; the I2V conditioning; the int8 and
host-offloaded TeaCache residual.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..models.hunyuan import HunyuanVideoDiT
from ..cache import TeaCache
from ..cache.teacache import residual_value
from ..utils.device import resolve_device
from ..utils.timing import device_sync
from .base import build_site, param_compute_dtype
from .schedulers import FlowMatchEulerScheduler


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
    # replay a recorded per-call compute/skip list instead of deciding
    teacache_schedule: Optional[list] = None
    # probe the executed mask density of block 0 once per step
    density_probe: bool = False
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = self.model.to(self.device).eval()
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
            device=self.device)
        # activations run in the parameter dtype; RoPE tables stay fp32
        self.compute_dtype = param_compute_dtype(self.model)
        self.density_samples = []
        self.step_seconds = []

    def _embed(self, latents, t, text, mask, guidance, pooled):
        m = self.model
        x, ctx, temb, rope = m.embed(latents, t, text, mask, guidance,
                                     self.h2l, pooled)
        sig = m.teacache_signal(x, temb)
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
        blk = m.dual_blocks[0] if len(m.dual_blocks) else m.single_blocks[0]
        blk(x, ctx, temb, rope, attn_probe)
        return float(got["d"])

    def _as_tensor(self, x, dtype=None):
        return None if x is None else torch.as_tensor(
            x, dtype=dtype, device=self.device)

    @torch.no_grad()
    def denoise(self, latents, text_emb, text_mask, pooled=None,
                num_steps: Optional[int] = None):
        """Run the scheduler loop; returns the final latents.

        latents [B, C, T', H', W'] initial noise in latent grid units;
        text_emb [B, text_len, text_dim] (padded); text_mask [B, text_len];
        pooled [B, pooled_dim] or None (a learned mean-text projection)."""
        latents = self._as_tensor(latents, torch.float32)
        text_emb = self._as_tensor(text_emb, torch.float32)
        text_mask = self._as_tensor(text_mask, torch.bool)
        pooled = self._as_tensor(pooled, torch.float32)
        steps = num_steps or self.num_steps
        sched = FlowMatchEulerScheduler(steps, shift=self.flow_shift)
        self.density_samples = []
        tea = TeaCache(self.rel_l1_thresh if self.enable_teacache else 0.0,
                       steps, coefficients="hunyuan-video",
                       forced_schedule=self.teacache_schedule)
        self.teacache = tea
        b = latents.shape[0]
        tlen = text_mask.to(torch.int32).sum(dim=1).to(torch.int32)
        guidance = torch.full((b,), self.guidance_scale * 1000.0,
                              dtype=torch.float32, device=self.device)
        fn = self.site.attn_fn(self.mode, text_len_rt=tlen)
        m = self.model

        self.step_seconds = []      # wall-clock per step, device-synced
        device_sync(latents)
        t0 = time.perf_counter()
        for i, t in enumerate(sched.timesteps):
            ts = torch.full((b,), float(t), dtype=torch.float32,
                            device=self.device)
            x, ctx, temb, rope, sig = self._embed(
                latents, ts, text_emb, text_mask, guidance, pooled)
            if self.density_probe:
                self.density_samples.append(
                    self._density(x, ctx, temb, rope, tlen))
            if tea.enabled and not tea.should_compute(sig):
                x = tea.apply_residual(x)
            else:
                x_in = x
                x, ctx = m.run_blocks(x, ctx, temb, rope, fn)
                if tea.enabled:
                    tea.record_residual_value(residual_value(x, x_in))
            v_pred = m.head(x, temb, self.l2h, *self.grid)
            latents = sched.step(v_pred, latents, i)
            device_sync(latents)
            self.step_seconds.append(time.perf_counter() - t0
                                     - sum(self.step_seconds))
        self.denoise_seconds = time.perf_counter() - t0
        self.teacache_stats = tea.stats()
        return latents

    def __call__(self, text_emb, text_mask, pooled=None, seed: int = 42,
                 num_steps: Optional[int] = None, init_latents=None,
                 generator: Optional[torch.Generator] = None):
        """Draw the initial noise from ``generator`` (default: a generator
        on the pipeline's device seeded with ``seed``) unless
        ``init_latents`` is given, and denoise; returns latents (the VAE
        decode belongs to a later slice)."""
        cfg = self.model.cfg
        b = text_emb.shape[0]
        if init_latents is not None:
            latents = init_latents
        else:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(seed)
            latents = torch.randn((b, cfg.in_channels, *self.grid),
                                  generator=generator, dtype=torch.float32,
                                  device=self.device)
        return self.denoise(latents, text_emb, text_mask, pooled=pooled,
                            num_steps=num_steps)
