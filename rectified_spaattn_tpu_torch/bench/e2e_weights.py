"""Random weights and initial latents of the end-to-end benches (port of
scripts/bench_e2e.py:33-159, bench_e2e_wan.py:33-78, bench_e2e_cog.py:30-46
and bench_e2e_flux.py:28-63).

The benches time full-width models with random weights, so the weights are
drawn cheaply and leaf by leaf:

- ``pool_normal_sampler``: windows of one pool of 2^26 N(0, scale^2)
  draws, each leaf starting ``n + 9973`` past the last one's start;
- ``random_quantized_model``: int8 / int4 weights drawn directly as bytes
  (uniform values with constant scales that match the N(0, scale^2) std a
  quantized random tree would have), the small leaves from a 2^22 pool;
- ``random_normal_model``: one ``default_rng(seed).normal`` call a leaf
  (bench_e2e_cog.py's init).

The draws are stateful, so a tree equals the JAX scripts' only if the
leaves are visited in their order: ``jax.tree_util``'s order over the Flax
tree, dict keys sorted at every level, with Flax's shapes (a dense kernel
[in, out], a convolution's [*k, in, out]).  ``flax_leaves`` derives the
Flax names and shapes from the port's own modules through the inverse of
models/convert.py's key map, and every leaf is drawn in that order, in
the Flax shape, then turned into the port's layout.  The numpy pools are
the scripts' own; each pool goes to the device once and every leaf is cut
from it there, so no whole tree is ever held on the host.  The model is
made on the meta device and each leaf is placed as it is drawn.

``smooth_latents`` (bench_e2e.py:148-157) draws through ``jax.random``,
which the port cannot reproduce: here the coarse and fine noises come from
an explicit ``torch.Generator`` and ``smooth_from_noise`` does the
deterministic part (the linear resize and the sum).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.convert import _torch_key
from ..models.quant import QLinear

_LIST = re.compile(r"^(dual|single)_blocks$")
# the std of a uniform int8 byte, and of a uniform offset-binary nibble
INT8_STD, INT4_STD = 73.9, 4.61


def _window(pool: torch.Tensor, off: list, shape) -> torch.Tensor:
    """The next window of ``pool`` (cyclic), advancing ``off`` by
    ``n + 9973`` (bench_e2e.py:44-53)."""
    n = int(np.prod(shape))
    size = pool.shape[0]
    s = off[0] % size
    off[0] += n + 9973
    if s + n <= size:
        seg = pool[s:s + n]
    else:
        seg = torch.cat([pool[s:]] + [pool] * ((s + n - size) // size)
                        + [pool[:(s + n) % size]])
    return seg.reshape(tuple(shape))


def pool_normal_sampler(seed: int, scale: float, pool_bits: int = 26,
                        device="cpu"):
    """``draw(shape)`` -> fp32 windows of one pool of 2^pool_bits
    N(0, scale^2) numpy draws, the pool held on ``device``."""
    g = np.random.default_rng(seed)
    pool = torch.from_numpy(
        g.normal(size=1 << pool_bits, scale=scale).astype(np.float32)).to(
        device)
    off = [0]
    return lambda shape: _window(pool, off, shape)


def byte_sampler(seed: int, pool_bits: int = 25, device="cpu"):
    """``draw(shape)`` -> uint8 windows of one pool of 2^pool_bits uniform
    bytes (host_quantized_tree's ``draw_bytes``)."""
    g = np.random.default_rng(seed)
    pool = torch.from_numpy(
        g.integers(0, 256, size=1 << pool_bits, dtype=np.uint8)).to(device)
    off = [0]
    return lambda shape: _window(pool, off, shape)


@dataclasses.dataclass
class Leaf:
    """One parameter: its Flax path and shape, the module holding it and
    its name there."""
    path: tuple
    shape: tuple
    module: nn.Module
    name: str

    @property
    def transposed(self) -> bool:
        return self.path[-1] == "kernel"

    def to_port(self, x: torch.Tensor) -> torch.Tensor:
        """A Flax-shaped value in the port's layout ([in, out] -> [out, in],
        [*k, in, out] -> [out, in, *k])."""
        if not self.transposed:
            return x
        if x.ndim == 2:
            return x.t()
        return x.permute(x.ndim - 1, x.ndim - 2, *range(x.ndim - 2))


def _flax_path(mod_name: str, mod: nn.Module, leaf: str) -> tuple:
    segs, out, i = mod_name.split(".") if mod_name else [], [], 0
    while i < len(segs):
        seg = segs[i]
        if (_LIST.match(seg) or seg == "blocks") and i + 1 < len(segs) \
                and segs[i + 1].isdigit():
            out.append(f"{seg[:-len('_blocks')]}_{segs[i + 1]}"
                       if seg != "blocks" else f"block_{segs[i + 1]}")
            i += 2
            continue
        out.append(seg)
        i += 1
    if leaf == "weight":
        leaf = ("kernel" if isinstance(mod, (nn.Linear, nn.Conv2d,
                                             nn.Conv3d)) else "scale")
    return tuple(out) + (leaf,)


def flax_leaves(model: nn.Module) -> list:
    """Every parameter of ``model`` as a ``Leaf``, in jax.tree_util's order
    over the Flax tree (paths sorted), each checked to map back to its
    port key through models/convert.py's map."""
    leaves = []
    for mod_name, mod in model.named_modules():
        for name, p in list(mod._parameters.items()) + list(
                mod._buffers.items()):
            if p is None:
                continue
            path = _flax_path(mod_name, mod, name)
            key = f"{mod_name}.{name}" if mod_name else name
            if _torch_key(path) != key:
                raise KeyError(f"{key}: no Flax path maps back to it "
                               f"({path})")
            shape = tuple(p.shape)
            if path[-1] == "kernel":
                shape = (shape[2:] + (shape[1], shape[0]) if len(shape) > 2
                         else shape[::-1])
            leaves.append(Leaf(path, shape, mod, name))
    return sorted(leaves, key=lambda lf: lf.path)


def meta_model(cls, cfg) -> nn.Module:
    """``cls(cfg)`` on the meta device: shapes only, no storage."""
    with torch.device("meta"):
        return cls(cfg)


def n_params(cls, cfg) -> int:
    """The parameter count of ``cls(cfg)``'s Flax tree (unquantized, as
    the scripts count it)."""
    return sum(int(np.prod(lf.shape))
               for lf in flax_leaves(meta_model(cls, cfg)))


def weight_dtype(device) -> torch.dtype:
    """The weights' dtype on the device they run on: bf16 on a card; on
    the CPU fp32 (holding the same bf16-rounded values), as the port's CLI
    builds its models."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def _place(leaf: Leaf, value: torch.Tensor, dtype) -> None:
    """Put a Flax-shaped value, rounded to bf16 as the scripts' leaves
    are, into the model in the port's layout."""
    t = leaf.to_port(value.to(torch.bfloat16)).to(dtype).contiguous()
    leaf.module._parameters[leaf.name] = nn.Parameter(t, requires_grad=False)


def random_bf16_model(cls, cfg, seed: int = 0, scale: float = 0.02,
                      device="cuda", pool_bits: int = 26,
                      dtype=None) -> nn.Module:
    """``cls(cfg)`` with every leaf a window of ``pool_normal_sampler``
    (bench_e2e.py::host_bf16_params, bench_e2e_wan.py::host_bf16_params,
    bench_e2e_flux.py::build_params at quant 0), in ``dtype`` (default
    ``weight_dtype(device)``)."""
    model = meta_model(cls, cfg)
    draw = pool_normal_sampler(seed, scale, pool_bits, device)
    dtype = dtype or weight_dtype(device)
    for leaf in flax_leaves(model):
        _place(leaf, draw(leaf.shape), dtype)
    return model


def random_normal_model(cls, cfg, seed: int = 0, scale: float = 0.02,
                        device="cuda", dtype=None) -> nn.Module:
    """``cls(cfg)`` with each leaf one ``default_rng(seed).normal`` draw
    (bench_e2e_cog.py::host_bf16_params)."""
    model = meta_model(cls, cfg)
    g = np.random.default_rng(seed)
    dtype = dtype or weight_dtype(device)
    for leaf in flax_leaves(model):
        x = g.normal(size=leaf.shape, scale=scale).astype(np.float32)
        _place(leaf, torch.from_numpy(x).to(device), dtype)
    return model


def quantized_leaf(leaf: Leaf, min_size: int) -> bool:
    """host_quantized_tree's rule: a kernel of at least ``min_size``
    elements with an even input width."""
    return (leaf.path[-1] == "kernel" and len(leaf.shape) >= 2
            and int(np.prod(leaf.shape)) >= min_size
            and leaf.shape[-2] % 2 == 0)


def random_quantized_model(cls, cfg, bits: int, scale: float = 0.02,
                           seed: int = 0, group_size: int = 128,
                           min_size: int = 1 << 20, device="cuda",
                           pool_bits: int = 22,
                           byte_pool_bits: int = 25,
                           dtype=None) -> nn.Module:
    """``cls(cfg)`` in the QLinear int8 / int4 layouts, drawn directly
    (bench_e2e.py::host_quantized_tree): each selected kernel a window of
    uniform bytes (int8 values, or two offset-binary nibbles a byte) with a
    constant scale ``scale / 73.9`` (int8) or ``scale / 4.61`` per group of
    ``group_size`` input rows (int4); every other leaf a window of a
    2^pool_bits N(0, scale^2) pool seeded ``seed + 1``, in bf16."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    model = meta_model(cls, cfg)
    draw_bytes = byte_sampler(seed, byte_pool_bits, device)
    fdraw = pool_normal_sampler(seed + 1, scale, pool_bits, device)
    dtype = dtype or weight_dtype(device)
    for leaf in flax_leaves(model):
        if not quantized_leaf(leaf, min_size):
            _place(leaf, fdraw(leaf.shape), dtype)
            continue
        if not isinstance(leaf.module, QLinear) or len(leaf.shape) != 2:
            raise TypeError(f"{leaf.path}: only QLinear kernels take the "
                            f"quantized layouts")
        din, dout = leaf.shape
        if bits == 8:
            q = {"weight_q": leaf.to_port(
                draw_bytes(leaf.shape).view(torch.int8)).contiguous(),
                 "scale": torch.full((dout,), scale / INT8_STD,
                                     dtype=torch.float32, device=device)}
        else:
            q = {"weight_q4": leaf.to_port(
                draw_bytes((din // 2, dout))).contiguous(),
                 "scale": torch.full((din // min(group_size, din), dout),
                                     scale / INT4_STD, dtype=torch.float32,
                                     device=device)}
        leaf.module.set_quantized(q)
    return model


def random_model(cls, cfg, quant: int = 0, seed: int = 0, device="cuda",
                 dtype=None) -> nn.Module:
    """The scripts' ``build_params``: the direct int8 / int4 tree at
    ``quant`` 8 / 4, else the pooled bf16 tree."""
    if quant:
        return random_quantized_model(cls, cfg, quant, seed=seed,
                                      device=device, dtype=dtype)
    return random_bf16_model(cls, cfg, seed=seed, device=device, dtype=dtype)


def smooth_from_noise(coarse: torch.Tensor, fine: torch.Tensor
                      ) -> torch.Tensor:
    """The deterministic part of ``smooth_latents``: ``coarse`` [B, C, t,
    h, w] resized linearly to ``fine``'s grid (half-pixel centres, as
    jax.image.resize "linear" when it upsamples) plus 0.5 x ``fine``."""
    size = tuple(fine.shape[2:])
    if any(s < c for s, c in zip(size, coarse.shape[2:])):
        raise ValueError(f"smooth latents upsample only: {tuple(coarse.shape)}"
                         f" -> {size}")
    f = F.interpolate(coarse, size=size, mode="trilinear",
                      align_corners=False)
    return f + 0.5 * fine


def smooth_latents(channels: int, t: int, hh: int, ww: int, seed: int = 1,
                   device="cuda") -> torch.Tensor:
    """Spatially low-pass initial latents [1, channels, t, hh, ww]: a
    coarse normal field over (t/2, hh/4, ww/4) (at least 2 each), resized,
    plus half-scale normal noise; the draws from a ``torch.Generator``
    seeded ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    coarse = torch.randn((1, channels, max(2, t // 2), max(2, hh // 4),
                          max(2, ww // 4)), generator=gen, device=device)
    fine = torch.randn((1, channels, t, hh, ww), generator=gen, device=device)
    return smooth_from_noise(coarse, fine)


def random_text(shape, seed: int, device="cuda") -> torch.Tensor:
    """An fp32 normal text embedding from a ``torch.Generator`` seeded
    ``seed`` (the scripts draw theirs from jax.random keys)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(tuple(shape), generator=gen, device=device)
