"""Head-parallel rectified sparse attention (port of
rectified_spaattn_tpu/attention/sharded.py).

The sparse mask is built PER HEAD, so splitting the heads over the tp group
leaves the whole site free of collectives: plan, kernel and rectification
act on disjoint heads.  ``head_parallel_rectified_attention`` keeps the JAX
package's global-in / global-out signature: each rank runs its heads and the
outputs are all-gathered.  The tensor-parallel pipelines need no wrapper:
their attention modules already hold ``heads // tp`` heads and call the
single-device site on them (pipelines/base.py).  The JAX function's batch
(dp) split is not ported: the port's pipelines run batch 1.  Sequence
parallelism is attention/ring.py.
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
) -> torch.Tensor:
    """Rectified sparse attention with the heads split over the
    ``head_axis`` group of ``mesh`` (a torch.distributed ``DistGroup``):
    each rank runs its ``H // tp`` heads.  Returns the global [B, H, S, D]
    output on every rank."""
    group = mesh.group(head_axis)
    check_heads(q.shape[1], group.size)
    hl = q.shape[1] // group.size
    hs = slice(group.rank * hl, (group.rank + 1) * hl)
    out = rectified_sparse_attention(q[:, hs], k[:, hs], v[:, hs], cfg,
                                     neighbor_mask, visual_len=visual_len,
                                     text_len_rt=text_len_rt)
    return group.all_gather(out, dim=1)
