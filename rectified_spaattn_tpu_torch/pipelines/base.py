"""Shared generation-pipeline machinery (port of
rectified_spaattn_tpu/pipelines/base.py, single-device: the mesh branch is
a multi-GPU slice of its own)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..curves import cached_curve
from ..sparse import SparseConfig, select_block_num
from ..attention import attention


@dataclasses.dataclass(frozen=True)
class SparseSite:
    """Everything one sparse attention site needs, precomputed."""
    cfg: SparseConfig
    neighbor_mask: torch.Tensor       # [NB, NB] bool
    visual_len: int                   # true visual tokens (pre-padding)

    def attn_fn(self, mode: str, text_len_rt=None):
        site = self

        def fn(q, k, v):
            return attention(q, k, v, mode=mode, cfg=site.cfg,
                             neighbor_mask=site.neighbor_mask,
                             visual_len=site.visual_len,
                             text_len_rt=text_len_rt)
        return fn


def build_site(latent_t: int, latent_h: int, latent_w: int, *,
               sa_drop_rate: float, p_remain: float, layout: str,
               text_len: int = 0, block_size: int = 128,
               first_frame_retention: bool = False,
               curve_variant: str = "full", axis_order=("w", "h", "t"),
               plan_row_chunk: int = 0, plan_kv_tile: int = 0,
               group_rows: int = 1, kv_pack: bool = False,
               head_chunk: int = 0, device="cpu"):
    """Curve + neighbour precompute and sparse config for one geometry
    (reference: build_multi_curve + sparse-param calc,
    scripts/main_hunyuan.py:23-42,249-254).  Returns (site,
    linear_to_hilbert, hilbert_to_linear) with tensors on ``device``."""
    l2h, h2l, neighbors = cached_curve(
        latent_t, latent_h, latent_w, block_size=block_size,
        axis_order=axis_order, variant=curve_variant)
    sv = latent_t * latent_h * latent_w
    img_blocks = sv // block_size
    floor = select_block_num(sa_drop_rate, img_blocks)
    ffb = img_blocks // latent_t if first_frame_retention else 0
    nb_pad = -(-sv // block_size)
    if neighbors.shape[0] < nb_pad:   # pad-block rows (never selected)
        pad = nb_pad - neighbors.shape[0]
        neighbors = np.pad(neighbors, ((0, pad), (0, pad)))
    cfg = SparseConfig(
        top_k_floor=max(floor, 1), p_remain=p_remain, layout=layout,
        text_len=text_len, first_frame_blocks=ffb,
        block_m=block_size, block_n=block_size,
        plan_row_chunk=plan_row_chunk, plan_kv_tile=plan_kv_tile,
        group_rows=group_rows, kv_pack=kv_pack, head_chunk=head_chunk)
    site = SparseSite(cfg=cfg,
                      neighbor_mask=torch.as_tensor(neighbors, device=device),
                      visual_len=sv)
    return (site, torch.as_tensor(l2h, device=device),
            torch.as_tensor(h2l, device=device))


def pad_tokens(x: torch.Tensor, multiple: int, axis: int = 1) -> torch.Tensor:
    """Zero-pad a token axis up to a multiple."""
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis % x.ndim) + [0, pad]
    return F.pad(x, widths)


def classifier_free_guidance(cond, uncond, scale):
    return uncond + scale * (cond - uncond)


def param_compute_dtype(module: torch.nn.Module) -> torch.dtype:
    """Activation dtype for a model: bf16 when its parameters are bf16
    (real checkpoints), else fp32."""
    bf16 = any(p.dtype == torch.bfloat16 for p in module.parameters())
    return torch.bfloat16 if bf16 else torch.float32
