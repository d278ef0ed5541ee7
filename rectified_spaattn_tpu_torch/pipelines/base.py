"""Shared generation-pipeline machinery (port of
rectified_spaattn_tpu/pipelines/base.py).

With a ``mesh`` (parallel.make_mesh) the pipelines run tensor-parallel over
its tp group: ``shard_tensor_parallel`` slices the model once at setup
(JAX ``finalize_params``) and every attention module then holds its rank's
heads.  The sparse mask is built per head, so the site function of
``SparseSite.attn_fn`` runs head-parallel as it is, without a collective
(attention/sharded.py is the same split with global inputs and output)."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..curves import cached_curve
from ..sparse import SparseConfig, select_block_num
from ..attention import attention
from ..utils.device import resolve_device
from ..utils.timing import device_sync, span


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
               head_chunk: int = 0, kv_quant: str = "none", device="cuda"):
    """Curve + neighbour precompute and sparse config for one geometry
    (reference: build_multi_curve + sparse-param calc,
    scripts/main_hunyuan.py:23-42,249-254).  Returns (site,
    linear_to_hilbert, hilbert_to_linear) with tensors on ``device``
    (default "cuda"; raises without a GPU unless ``device="cpu"``)."""
    device = resolve_device(device)
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
        group_rows=group_rows, kv_pack=kv_pack, head_chunk=head_chunk,
        kv_quant=kv_quant)
    site = SparseSite(cfg=cfg,
                      neighbor_mask=torch.as_tensor(neighbors, device=device),
                      visual_len=sv)
    return (site, torch.as_tensor(l2h, device=device),
            torch.as_tensor(h2l, device=device))


def decode_timed(vae_decode, latents):
    """(``vae_decode(latents)``, its device-synced seconds), or (latents,
    None) without a decoder."""
    if vae_decode is None:
        return latents, None
    t0 = time.perf_counter()
    pixels = vae_decode(latents)
    device_sync(pixels)
    return pixels, time.perf_counter() - t0


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


def shard_tensor_parallel(model: torch.nn.Module, mesh):
    """Slice ``model`` for this rank of ``mesh``'s tp group (once, at
    pipeline setup) and return the group.  The pipelines shard over tp
    only: a dp axis is fine (each dp slice runs its own prompts with its
    own tp group, parallel/multihost.py), sp must be 1, and the tp group
    must be a torch.distributed one (an in-process group runs the ring
    alone)."""
    from ..parallel.mesh import DistGroup
    from ..parallel.sharding import shard_model
    if mesh.shape["sp"] != 1:
        raise ValueError(f"the pipelines shard over tp only (dp slices run "
                         f"their own prompts), got the mesh {mesh.shape}")
    group = mesh.group("tp")
    if not isinstance(group, DistGroup):
        raise ValueError("tensor-parallel pipelines need a torch.distributed "
                         "tp group")
    shard_model(model, group)
    return group


def teacache_decision(tea, signal, group, device) -> bool:
    """``tea.should_compute(signal)``; under a tp ``group`` checked to be
    the same on every rank: the ranks compute the signal from replicated
    activations, so a disagreement is a fault, raised on every rank
    alike."""
    compute = tea.should_compute(signal)
    if group is None:
        return compute
    votes = torch.tensor([int(compute), 1 - int(compute)], dtype=torch.int32,
                         device=device)
    group.all_reduce(votes)
    with span("rsa.sync.tp"):
        split = int(votes.min())
    if split != 0:
        raise RuntimeError(f"TeaCache decisions differ across the "
                           f"{group.size} tensor-parallel ranks")
    return compute


def rank_mean(group, value: float, device) -> float:
    """The mean of a per-rank scalar over a tp ``group`` (the density
    probe of a rank covers its own heads), or ``value`` without one."""
    if group is None:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=device)
    return float(group.all_reduce(t)) / group.size
