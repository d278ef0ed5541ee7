"""What the benchmark makes from ``--seed``: the weights (by the
reference's parameter table, drawn on the device in a few large calls, in
the type they are served in) and the inputs of a generation (smooth
initial latents, prompt embeddings).  The program and the reference are
handed the same; the reference draws the weights again after the window
rather than keep the program's."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# one generator stream per purpose, so that the weights can be drawn
# again without the inputs
WEIGHTS, LATENTS, TEXT = 0, 1, 2
_ALIGN = 64                  # elements: every leaf starts 128-byte aligned
_CHUNK = 1 << 30             # elements per random call


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8 + stream) % (1 << 64))
    return g


def draw_weights(table, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{name: tensor} for [(name, shape)]: one normal draw over all leaves,
    then scaled in place: matrices N(0, 1/fan_in), biases N(0, 0.02^2),
    norm scales 1 + N(0, 0.1^2).  The leaves are views of one buffer."""
    sizes = [math.prod(shape) for _, shape in table]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // _ALIGN) * _ALIGN
    flat = torch.empty(total, dtype=dtype, device=device)
    g = generator(seed, WEIGHTS, device)
    for lo in range(0, total, _CHUNK):
        flat[lo:lo + _CHUNK].normal_(generator=g)
    out = {}
    for (name, shape), off, n in zip(table, offsets, sizes):
        leaf = flat[off:off + n].view(shape)
        if name.endswith(".bias"):
            leaf.mul_(0.02)
        elif len(shape) == 1:
            leaf.mul_(0.1).add_(1.0)
        else:
            leaf.mul_(shape[1] ** -0.5)
        out[name] = leaf
    return out


def smooth_latents(shape, seed: int, device) -> torch.Tensor:
    """[1, C, T, H, W] float32: a coarse normal field over (T/2, H/4, W/4)
    resized trilinearly, plus half-scale normal noise, so that attention
    sees local structure as it does on real latents."""
    g = generator(seed, LATENTS, device)
    _, c, t, hh, ww = shape
    coarse = torch.randn((1, c, max(2, t // 2), max(2, hh // 4),
                          max(2, ww // 4)), generator=g, device=device)
    fine = torch.randn(tuple(shape), generator=g, device=device)
    return F.interpolate(coarse, size=(t, hh, ww), mode="trilinear",
                         align_corners=False) + 0.5 * fine


def text_embeddings(n: int, tokens: int, dim: int, seed: int, device):
    """``n`` prompt embeddings [tokens, dim] float32, N(0, 1)."""
    g = generator(seed, TEXT, device)
    return [torch.randn((tokens, dim), generator=g, device=device)
            for _ in range(n)]
