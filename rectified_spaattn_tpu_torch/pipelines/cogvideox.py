"""CogVideoX1.5-5B T2V / I2V pipeline (port of
rectified_spaattn_tpu/pipelines/cogvideox.py; reference script
scripts/main_cogvideox.py).

  * DDIM (v-prediction, zero-terminal SNR) with dynamic CFG: two
    transformer calls a step, the scale keyed on the raw timestep
    (use_dynamic_cfg, guidance 6.0, main_cogvideox.py:274-288);
  * latent grid (f - 1) // 8 + 1 frames (rounded up to patch_size_t),
    h / 8, w / 8; tokens (f', h / 16, w / 16), joint layout with a 256-slot
    text tail of which 226 tokens are valid (T5);
  * sparse attention gated by CALL: dense (K1 windowed) until call
    ``sparse_warm_calls`` (5), counting the calls TeaCache skips
    (rectified_cogvideo_attn.py:478), then the rectified site;
  * TeaCache keyed on the time embedding (:106-118), re-applying both the
    visual and the text residual (the head normalises concat(ctx, x));
  * I2V: ``cog_i2v_condition``'s image latents concatenated on the
    channels every call (in_channels 32) and the ofs embedding input 2.0.

With ``mesh`` (parallel.make_mesh, sp = 1) the model is sliced once at
setup for this rank of the tp group and the sparse site runs head-parallel;
every rank runs the same loop on replicated activations and makes the same
TeaCache decisions (checked each call).  ``vae_decode``
(models/pretrained.py::load_vae) turns the final latents into pixels.
``scan_blocks`` runs the block stack through models/scan.py (the blocks'
weights stacked leaf-wise; one scan covers the whole stack, the gate
being by call).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..models import scan
from ..models.cogvideox import CogVideoXDiT
from ..cache import TeaCache
from ..cache.teacache import residual_value
from ..utils.device import resolve_device
from ..utils.timing import device_sync
from .base import (build_site, classifier_free_guidance, decode_timed,
                   param_compute_dtype, shard_tensor_parallel,
                   teacache_decision)
from .schedulers import CogVideoXDDIMScheduler, dynamic_cfg_scale


def cog_i2v_condition(image, vae_encode, grid):
    """CogVideoX I2V conditioning channels (diffusers
    CogVideoXImageToVideoPipeline: image latents concatenated along the
    CHANNEL dim every call, in_channels 32; reference script
    main_cogvideox.py:213-222,274-288).  The image VAE-encodes into the
    first latent frame; the other frames are zeros.  Returns
    [B, Cz, *grid]."""
    z0 = vae_encode(image[:, :, None])          # [B, Cz, 1, h, w]
    b, cz = z0.shape[:2]
    rest = z0.new_zeros((b, cz, grid[0] - 1, *grid[1:]))
    return torch.cat([z0[:, :, :1], rest], dim=2)


@dataclasses.dataclass
class CogVideoXPipeline:
    """Args mirror the reference CLI.  ``model`` carries its weights; it is
    moved to ``device`` (default "cuda"; raises without a GPU unless
    ``device="cpu"``).  ``mode`` "sparse" runs the rectified site from
    call ``sparse_warm_calls`` on, "flash" dense everywhere (K1 windowed),
    "vanilla" the fp32 oracle everywhere."""
    model: CogVideoXDiT
    height: int = 768
    width: int = 1360
    frames: int = 81
    num_steps: int = 50
    sa_drop_rate: float = 0.85
    p_remain_rates: float = 0.3
    mode: str = "sparse"                 # sparse | flash | vanilla
    enable_teacache: bool = False
    teacache_thresh: float = 0.2
    # random-weight calibration only (cache/calibrate.py); real
    # checkpoints keep 1.0
    teacache_signal_scale: float = 1.0
    text_len: int = 256                  # padded T5 tokens (226 used)
    guidance_scale: float = 6.0
    use_dynamic_cfg: bool = True
    sparse_warm_calls: int = 5
    is_i2v: bool = False
    vae_decode: Optional[Callable] = None
    # tensor-parallel process groups (parallel.make_mesh; tp only)
    mesh: Optional[object] = None
    # run the block stack stacked (models/scan.py)
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
        self.tp = (shard_tensor_parallel(self.model, self.mesh)
                   if self.mesh is not None else None)
        self.model = self.model.to(self.device).eval()
        # stack after sharding and quantizing, on the device
        self.stack = (scan.stack_model_blocks(self.model, "blocks")[0]
                      if self.scan_blocks else None)
        cfg = self.model.cfg
        self.lt = (self.frames - 1) // 8 + 1
        self.lh = self.height // 16
        self.lw = self.width // 16
        pt, p = cfg.patch_size_t, cfg.patch_size
        self.grid = ((self.lt + pt - 1) // pt * pt, self.lh * p, self.lw * p)
        self.site, self.l2h, self.h2l = build_site(
            self.grid[0] // pt, self.lh, self.lw,
            sa_drop_rate=self.sa_drop_rate, p_remain=self.p_remain_rates,
            layout="joint", text_len=self.text_len,
            plan_row_chunk=self.plan_row_chunk,
            plan_kv_tile=self.plan_kv_tile, group_rows=self.group_rows,
            kv_pack=self.kv_pack, head_chunk=self.head_chunk,
            device=self.device)
        # activations run in the parameter dtype; RoPE tables stay fp32
        self.compute_dtype = param_compute_dtype(self.model)
        self.step_seconds = []

    def _embed(self, latents, t, text, ofs):
        x, ctx, temb, rope = self.model.embed(latents, t, text, self.h2l, ofs)
        cd = self.compute_dtype
        return x.to(cd), ctx.to(cd), temb.to(cd), rope

    def _as_tensor(self, x, dtype=None):
        return None if x is None else torch.as_tensor(
            x, dtype=dtype, device=self.device)

    def _text_slot(self, text):
        """The prompt embedding in the ``text_len`` slot of the joint
        layout: a shorter one (T5's 226 tokens) is zero-padded, and the
        valid length 226 masks the padding."""
        n = text.shape[1]
        if n > self.text_len:
            raise ValueError(f"{n} text tokens exceed text_len "
                             f"{self.text_len}")
        return F.pad(text, (0, 0, 0, self.text_len - n))

    @torch.no_grad()
    def denoise(self, latents, text_cond, text_uncond, condition=None,
                num_steps: Optional[int] = None):
        """The CFG loop: cond (even) and uncond (odd) calls per step with
        dual-stream TeaCache.  ``condition``: I2V image-latent channels
        (``cog_i2v_condition``), concatenated on the channels every call;
        I2V also sets the ofs embedding input to 2.0 (diffusers: ofs_emb
        fill_value=2.0)."""
        latents, text_cond, text_uncond, condition = (
            self._as_tensor(a, torch.float32) for a in (
                latents, text_cond, text_uncond, condition))
        text_cond, text_uncond = map(self._text_slot, (text_cond, text_uncond))
        m = self.model
        steps = num_steps or self.num_steps
        sched = CogVideoXDDIMScheduler(steps)
        tea = TeaCache(
            self.teacache_thresh if self.enable_teacache else 0.0,
            steps * 2, coefficients="cogvideox1.5-5b", cfg_streams=2,
            signal_scale=self.teacache_signal_scale)
        self.teacache = tea
        b = latents.shape[0]
        tlen = torch.full((b,), min(226, self.text_len), dtype=torch.int32,
                          device=self.device)
        ofs_val = 2.0 if (condition is not None or self.is_i2v) else 0.0
        ofs = (torch.full((b,), ofs_val, device=self.device)
               if m.cfg.use_ofs_embed else None)
        dense = self.site.attn_fn("vanilla" if self.mode == "vanilla"
                                  else "flash", text_len_rt=tlen)
        sparse = self.site.attn_fn("sparse", text_len_rt=tlen)
        self.sparse_calls = []          # the calls that ran the sparse site

        self.step_seconds = []      # wall-clock per step, device-synced
        device_sync(latents)
        t0 = time.perf_counter()
        call = 0
        for i, t in enumerate(sched.timesteps):
            ts = torch.full((b,), float(t), device=self.device)
            model_in = (latents if condition is None
                        else torch.cat([latents, condition], dim=1))
            outs = []
            for text in (text_cond, text_uncond):
                x, ctx, temb, rope = self._embed(model_in, ts, text, ofs)
                if tea.enabled and not teacache_decision(tea, temb, self.tp,
                                                         self.device):
                    # the head normalises concat(ctx, x), so the text
                    # residual is re-applied too (reference:
                    # main_cogvideox.py:129-143 previous_residual_encoder)
                    x, ctx = tea.apply_residual(x, ctx)
                else:
                    sparse_now = (self.mode == "sparse"
                                  and call >= self.sparse_warm_calls)
                    if sparse_now:
                        self.sparse_calls.append(call)
                    x_in, ctx_in = x, ctx
                    fn = sparse if sparse_now else dense
                    x, ctx = (scan.cog_run_blocks_scan(m.cfg, self.stack, x,
                                                       ctx, temb, rope, fn)
                              if self.scan_blocks else
                              m.run_blocks(x, ctx, temb, rope, fn))
                    if tea.enabled:
                        tea.record_residual_value(
                            residual_value(x, x_in),
                            residual_value(ctx, ctx_in))
                outs.append(m.head(x, ctx, temb, self.l2h, *self.grid))
                call += 1
            g = (dynamic_cfg_scale(self.guidance_scale, float(t), steps)
                 if self.use_dynamic_cfg else self.guidance_scale)
            v = classifier_free_guidance(outs[0], outs[1], g)
            latents = sched.step(v, latents, i)
            device_sync(latents)
            self.step_seconds.append(time.perf_counter() - t0
                                     - sum(self.step_seconds))
        self.denoise_seconds = time.perf_counter() - t0
        self.teacache_stats = tea.stats()
        return latents

    def __call__(self, text_cond, text_uncond, condition=None,
                 seed: int = 42, num_steps: Optional[int] = None,
                 init_latents=None,
                 generator: Optional[torch.Generator] = None):
        """Draw the initial noise from ``generator`` (default: a generator
        on the pipeline's device seeded with ``seed``) unless
        ``init_latents`` is given, and denoise; returns the latents, or
        ``vae_decode``'s pixels of them.  Under ``condition`` the noise
        carries the channels the condition leaves of in_channels."""
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
        latents = self.denoise(latents, text_cond, text_uncond, condition,
                               num_steps)
        out, self.decode_seconds = decode_timed(self.vae_decode, latents)
        return out
