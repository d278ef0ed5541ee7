"""Head- and batch-parallel rectified sparse attention (port of
rectified_spaattn_tpu/attention/sharded.py).

The sparse mask is built PER HEAD, so splitting the heads over the tp group
leaves the whole site free of collectives: plan, kernel and rectification
act on disjoint heads.  Batch rows are as independent, so the dp group
splits the batch the same way.  ``head_parallel_rectified_attention`` keeps
the JAX package's global-in / global-out signature: each rank runs its
``B // dp`` rows and ``H // tp`` heads, and the outputs are all-gathered
over tp, then over dp.  The tensor-parallel pipelines need no wrapper:
their attention modules already hold ``heads // tp`` heads and call the
single-device site on them (pipelines/base.py), and their dp slices run
prompts of their own (parallel/multihost.py).  Sequence parallelism is
attention/ring.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import check_heads
from ..sparse import SparseConfig
from .rectified import rectified_sparse_attention


def head_parallel_rectified_attention(
    mesh,
    q: torch.Tensor,                 # [B, H, S, D] global
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: SparseConfig,
    neighbor_mask: Optional[torch.Tensor] = None,
    *,
    visual_len: int,
    text_len_rt: Optional[torch.Tensor] = None,
    head_axis: str = "tp",
    batch_axis: Optional[str] = "dp",
) -> torch.Tensor:
    """Rectified sparse attention with the heads split over the
    ``head_axis`` group of ``mesh`` (a torch.distributed ``DistGroup``) and
    the batch over its ``batch_axis`` group (none when ``batch_axis`` is
    None or the mesh has no such axis): each rank runs its ``B // dp`` rows
    (``text_len_rt`` split alike) and ``H // tp`` heads.  Returns the
    global [B, H, S, D] output on every rank."""
    group = mesh.group(head_axis)
    check_heads(q.shape[1], group.size)
    hl = q.shape[1] // group.size
    hs = slice(group.rank * hl, (group.rank + 1) * hl)
    bgroup = (mesh.group(batch_axis) if batch_axis in mesh.shape
              and mesh.shape[batch_axis] > 1 else None)
    bs = slice(None)
    if bgroup is not None:
        if q.shape[0] % bgroup.size:
            raise ValueError(f"batch-parallel sparse attention needs "
                             f"batch % {batch_axis} == 0, got a batch of "
                             f"{q.shape[0]} over {batch_axis}={bgroup.size}")
        bl = q.shape[0] // bgroup.size
        bs = slice(bgroup.rank * bl, (bgroup.rank + 1) * bl)
        if text_len_rt is not None:
            text_len_rt = text_len_rt[bs]
    out = rectified_sparse_attention(q[bs, hs], k[bs, hs], v[bs, hs], cfg,
                                     neighbor_mask, visual_len=visual_len,
                                     text_len_rt=text_len_rt)
    out = group.all_gather(out, dim=1)
    return bgroup.all_gather(out, dim=0) if bgroup is not None else out
