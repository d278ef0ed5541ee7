"""The gather kernel K1 against the dense flash kernel K3 at HunyuanVideo
scale on a synthetic mask of a given density (port of
scripts/bench_kernel.py).

The mask (bench_kernel.py:60-66, numpy, bit for bit the script's): the
diagonal and its two neighbours, then ``np.random.default_rng(0)``
uniforms below ``--density`` over the visual columns, then every text
column.  q [1, H, 128 V, D] (V = ``--vis-blocks``), k / v [1, H, 128
(V + T), D] (T = ``--text-blocks``), iid normal bf16 from one seeded
generator; all T x 128 text tokens valid.

    python -m rectified_spaattn_tpu_torch.bench.kernel [--heads 24] \\
        [--vis-blocks 900] [--text-blocks 2] [--dim 128] [--density 0.25] \\
        [--iters 3] [--chunk 8] [--skip-dense]
    python -m rectified_spaattn_tpu_torch.bench.kernel --device cpu --small

Times are one-shot ms, each call waited for, over ``--iters`` calls after
one warm-up (the script's ``timed``).  Prints ONE JSON line: the mask's
actual density, K3's ms and TF/s at 4 B H Sq S D, K1's ms and effective
sparse TF/s (the dense count x density), the speedup and the ideal
1 / density.  With ``--skip-dense`` K3 is not run and its time, TF/s and
the speedup are null.  ``--small``: 2 heads, 12 visual blocks.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..kernels import block_sparse_flash_attention, dense_attention
from ..sparse.ops import mask_to_indices
from .common import device_info, oneshot_ms, resolve


def synthetic_mask(b: int, h: int, nq: int, nb: int, density: float,
                   seed: int = 0) -> np.ndarray:
    """bench_kernel.py:60-66: the diagonal +-1, a uniform fill to
    ``density`` over the visual columns, every text column."""
    g = np.random.default_rng(seed)
    mask = np.zeros((b, h, nq, nb), bool)
    for off in (-1, 0, 1):
        idx = np.arange(nq)
        j = np.clip(idx + off, 0, nq - 1)
        mask[:, :, idx, j] = True
    mask[:, :, :, :nq] |= g.uniform(size=(b, h, nq, nq)) < density
    mask[:, :, :, nq:] = True
    return mask


def run(*, heads: int = 24, vis_blocks: int = 900, text_blocks: int = 2,
        dim: int = 128, density: float = 0.25, iters: int = 3,
        chunk: int = 8, skip_dense: bool = False, small: bool = False,
        device="cuda", seed: int = 0) -> dict:
    """The line as a dict (module docstring)."""
    dev = resolve(device)
    if small:
        heads, vis_blocks = 2, 12
    b, h, d = 1, heads, dim
    nq, nb = vis_blocks, vis_blocks + text_blocks
    sq, s = nq * 128, nb * 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = (torch.randn((b, h, n, d), generator=gen, device=dev).to(
        torch.bfloat16) for n in (sq, s, s))
    mask = synthetic_mask(b, h, nq, nb, density)
    actual = float(mask.mean())
    idx, counts = mask_to_indices(torch.from_numpy(mask).to(dev))
    tlen = torch.full((b,), text_blocks * 128, dtype=torch.int32,
                      device=dev)
    t_sparse = oneshot_ms(lambda: block_sparse_flash_attention(
        q, k, v, idx, counts, tlen, visual_len=sq, text_start=sq,
        chunk_blocks=chunk), dev, iters)
    t_dense = None if skip_dense else oneshot_ms(
        lambda: dense_attention(q, k, v, mode="flash"), dev, iters)
    flops_dense = 4 * b * h * sq * s * d
    flops_sparse = flops_dense * actual
    return {
        "shape": {"B": b, "H": h, "Sq": sq, "S": s, "D": d},
        "density_target": density, "mask_density": actual,
        "dense_ms": t_dense,
        "dense_tflops": (None if t_dense is None
                         else flops_dense / t_dense / 1e9),
        "sparse_ms": t_sparse,
        "sparse_effective_tflops": flops_sparse / t_sparse / 1e9,
        "speedup_vs_dense": None if t_dense is None else t_dense / t_sparse,
        "ideal_speedup": 1 / actual, "chunk_blocks": chunk, "iters": iters,
        **device_info(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--heads", type=int, default=24)
    ap.add_argument("--vis-blocks", type=int, default=900)
    ap.add_argument("--text-blocks", type=int, default=2)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--skip-dense", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="2 heads, 12 visual blocks (a CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    line = run(**vars(ap.parse_args(argv)))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
