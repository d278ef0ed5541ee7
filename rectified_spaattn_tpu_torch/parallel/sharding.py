"""Tensor parallelism for the DiT blocks (port of
rectified_spaattn_tpu/parallel/sharding.py).

The JAX package annotates its parameters with GSPMD shardings and lets XLA
place the collectives.  PyTorch has no counterpart, so ``shard_model``
slices the ``QLinear`` layers of every transformer block in place for one
rank of the tp group:

  * column-parallel (output features split): the projections that produce
    per-head features (``to_q/k/v``, ``add_to_q/k/v``, the fused
    single-stream ``to_qkv`` cut per q/k/v segment, Wan's ``attn1_*`` /
    ``attn2_*`` q/k/v and the I2V ``attn2_add_k/v_proj``, CogVideoX's
    shared ``to_q/k/v``), the blocks' MLP ``fc1`` and ``proj_mlp``;
  * row-parallel (input features split, ``RowParallelLinear``): the
    projections that consume them (``to_out``, ``to_add_out``,
    ``attn1/2_to_out``, the MLP ``fc2``, and ``proj_out``, whose input is
    concat(attention, MLP): both segments are cut).  One ``all_reduce``
    follows each; the bias is added once, after it;
  * replicated: everything else — the embedders, the refiner, the head and
    the adaLN modulation ``linear``s.  JAX's ``_COL_PAT`` names the latter,
    but a GSPMD hint cannot change a result, and an explicit column cut
    would need an all-gather.

Wan normalises q and k over the FULL hidden width before the head split;
``ShardedRMSNorm`` all-reduces the sum of squares for that.  The heads must
divide by tp (the JAX ValueError); an MLP width tp does not divide stays
replicated, as the JAX docstring says of any such axis.  Quantized layouts
follow their axes: int8 per-channel scales their output channel, int4
group scales the input axis (the group size must divide the shard).  The
attention modules then hold ``heads // tp`` heads, so the attention site of
each rank is collective-free (attention/sharded.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..models.cogvideox import CogVideoXBlock
from ..models.layers import (MLP, CrossAttnBlock, DualStreamBlock,
                             JointAttention, RMSNorm, SingleStreamBlock)
from ..models.quant import QLinear
from .mesh import check_heads


def _cut_out(lin: QLinear, rows: torch.Tensor) -> None:
    """Keep the output channels ``rows`` of ``lin``, in place."""
    layout = lin.layout
    if layout == "dense":
        lin.weight = nn.Parameter(lin.weight.detach()[rows].clone())
    elif layout == "int8":
        lin.set_quantized({"weight_q": lin.weight_q[rows].clone(),
                           "scale": lin.scale[rows].clone()})
    else:
        lin.set_quantized({"weight_q4": lin.weight_q4[rows].clone(),
                           "scale": lin.scale[:, rows].clone()})
    if lin.bias is not None:
        lin.bias = nn.Parameter(lin.bias.detach()[rows].clone())
    lin.out_features = len(rows)


def _cut_in(lin: QLinear, lo: int, hi: int) -> QLinear:
    """A bias-free QLinear over the input features [lo, hi) of ``lin``."""
    new = QLinear(hi - lo, lin.out_features, bias=False, device="meta")
    layout = lin.layout
    if layout == "dense":
        new.weight = nn.Parameter(lin.weight.detach()[:, lo:hi].clone())
    elif layout == "int8":
        new.set_quantized({"weight_q": lin.weight_q[:, lo:hi].clone(),
                           "scale": lin.scale.clone()})
    else:
        group = lin.in_features // lin.scale.shape[0]
        if lo % group or hi % group:
            raise ValueError(f"int4 group size {group} does not divide the "
                             f"tensor-parallel shard [{lo}, {hi})")
        new.set_quantized({
            "weight_q4": lin.weight_q4[:, lo // 2:hi // 2].clone(),
            "scale": lin.scale[lo // group:hi // group].clone()})
    return new


def _span(width: int, group) -> tuple:
    n = width // group.size
    return group.rank * n, (group.rank + 1) * n


class RowParallelLinear(nn.Module):
    """A row-parallel QLinear: its input is a concatenation of segments,
    each either cut over the tp group (this rank holds its slice) or
    replicated.  y = all_reduce(sum of the cut segments' products) + the
    replicated segments' products + bias."""

    def __init__(self, lin: QLinear, segments, group):
        super().__init__()
        self.group = group
        self.widths, self.is_cut = [], []
        self.parts = nn.ModuleList()
        lo = 0
        for width, cut in segments:
            a, b = (lo + s for s in _span(width, group)) if cut else (
                lo, lo + width)
            self.parts.append(_cut_in(lin, a, b))
            self.widths.append(b - a)
            self.is_cut.append(cut)
            lo += width
        if lo != lin.in_features:
            raise ValueError(f"segments cover {lo} of {lin.in_features} "
                             "input features")
        self.bias = lin.bias

    def forward(self, x):
        xs = x.split(self.widths, dim=-1)
        y = None
        for part, xi, cut in zip(self.parts, xs, self.is_cut):
            if cut:
                yi = part(xi)
                y = yi if y is None else y + yi
        self.group.all_reduce(y)
        for part, xi, cut in zip(self.parts, xs, self.is_cut):
            if not cut:
                y = y + part(xi)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class ShardedRMSNorm(nn.Module):
    """RMSNorm over a feature axis split over the tp group: this rank's
    slice of the weight, the sum of squares all-reduced (Wan's q/k norms
    over the full hidden width)."""

    def __init__(self, norm: RMSNorm, full_dim: int, group):
        super().__init__()
        lo, hi = _span(full_dim, group)
        self.eps, self.full_dim, self.group = norm.eps, full_dim, group
        self.weight = (None if norm.weight is None else
                       nn.Parameter(norm.weight.detach()[lo:hi].clone()))

    def forward(self, x):
        dtype = x.dtype
        x = x.float()
        ss = self.group.all_reduce(x.square().sum(dim=-1, keepdim=True))
        x = x * torch.rsqrt(ss / self.full_dim + self.eps)
        if self.weight is not None:
            x = x * self.weight.float()
        return x.to(dtype)


def _column(mod, names, width, group, segments: int = 1) -> None:
    """Column-cut each of ``names`` (output width ``width`` per segment)."""
    lo, hi = _span(width, group)
    rows = torch.cat([torch.arange(s * width + lo, s * width + hi)
                      for s in range(segments)])
    for name in names:
        lin = getattr(mod, name)
        dev = next(iter([*lin.parameters(), *lin.buffers()])).device
        _cut_out(lin, rows.to(dev))


def _row(mod, names, segments, group) -> None:
    for name in names:
        setattr(mod, name, RowParallelLinear(getattr(mod, name), segments,
                                             group))


def _shard_mlp(mlp: MLP, group) -> None:
    hidden = mlp.fc1.out_features
    if hidden % group.size:
        return                    # a width tp does not divide: replicated
    _column(mlp, ("fc1",), hidden, group)
    _row(mlp, ("fc2",), [(hidden, True)], group)


def _shard_heads(mod, group) -> None:
    check_heads(mod.heads, group.size)
    mod.heads //= group.size


def shard_model(model: nn.Module, group) -> nn.Module:
    """Slice ``model``'s transformer blocks, in place, to this rank's share
    of the tp ``group`` (a parallel.mesh.DistGroup); see the module
    docstring.  Quantize before sharding: int8 scales are per output
    channel over the full input.  Returns the model."""
    if group.size == 1:
        return model
    for mod in list(model.modules()):
        if isinstance(mod, JointAttention):
            dim = mod.to_q.out_features
            _shard_heads(mod, group)
            _column(mod, ("to_q", "to_k", "to_v", "add_to_q", "add_to_k",
                          "add_to_v"), dim, group)
            _row(mod, ("to_out", "to_add_out"), [(dim, True)], group)
        elif isinstance(mod, DualStreamBlock):
            _shard_mlp(mod.ff, group)
            _shard_mlp(mod.ff_context, group)
        elif isinstance(mod, SingleStreamBlock):
            dim = mod.to_qkv.in_features
            _shard_heads(mod, group)
            _column(mod, ("to_qkv",), dim, group, segments=3)
            hidden = mod.proj_mlp.out_features
            cut_mlp = hidden % group.size == 0
            if cut_mlp:
                _column(mod, ("proj_mlp",), hidden, group)
            _row(mod, ("proj_out",), [(dim, True), (hidden, cut_mlp)], group)
        elif isinstance(mod, CrossAttnBlock):
            dim = mod.attn1_to_q.out_features
            _shard_heads(mod, group)
            cols = ["attn1_to_q", "attn1_to_k", "attn1_to_v", "attn2_to_q",
                    "attn2_to_k", "attn2_to_v"]
            norms = ["attn1_norm_q", "attn1_norm_k", "attn2_norm_q",
                     "attn2_norm_k"]
            if mod.image_cross:
                cols += ["attn2_add_k_proj", "attn2_add_v_proj"]
                norms += ["attn2_norm_added_k"]
            _column(mod, cols, dim, group)
            for name in norms:
                setattr(mod, name, ShardedRMSNorm(getattr(mod, name), dim,
                                                  group))
            _row(mod, ("attn1_to_out", "attn2_to_out"), [(dim, True)], group)
            _shard_mlp(mod.ffn, group)
        elif isinstance(mod, CogVideoXBlock):
            # per-head q/k LayerNorms need no cut; one MLP serves both
            # streams
            dim = mod.to_q.out_features
            _shard_heads(mod, group)
            _column(mod, ("to_q", "to_k", "to_v"), dim, group)
            _row(mod, ("to_out",), [(dim, True)], group)
            _shard_mlp(mod.ff, group)
    return model
