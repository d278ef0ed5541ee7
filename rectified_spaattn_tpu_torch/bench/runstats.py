"""Contiguous-run statistics of the plan's index lists (port of
scripts/exp_runstats.py): how many gather descriptors a (head, query
block) row issues when contiguous index runs are coalesced into aligned
power-of-two copies, on peaked smooth inputs (one low-frequency field of
the 3-D position shared by q and k plus noise: the real-model regime)
and on iid normal inputs, at the HunyuanVideo grid (32, 45, 80) with 256
text tokens.

The plan is built on the card (``build_sparse_plan``, v = k, as the
script); the statistics are numpy on its indices and counts, the
script's functions: ``dma_decomposition`` (exp_runstats.py:46-79),
``stats`` (:82-100, returned rather than printed: density, mean count,
descriptors before and after coalescing, the run-size histogram as
shares of the coalesced descriptors) and ``union_growth`` (:148-159).

    python -m rectified_spaattn_tpu_torch.bench.runstats [--heads 2] \\
        [--lt 32 --lh 45 --lw 80] [--alpha 4 --sigma 1]
    python -m rectified_spaattn_tpu_torch.bench.runstats --device cpu --small

Prints ONE JSON line: per regime the plan's seconds (host clock, after a
warm-up build), its statistics and union growth.  ``--small``: the
8 x 24 x 32 grid.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..pipelines import build_site
from ..sparse import build_sparse_plan
from .common import SMALL_GRID, device_info, resolve, sync
from .inputs import curve_coords, smooth_inputs


def dma_decomposition(indices: np.ndarray, counts, chunk: int = 16):
    """Hierarchical aligned power-of-two run decomposition: dlen [..., NB]
    int32, slot i issues a copy of dlen[i] blocks (0 = covered by an
    earlier run); runs never cross ``chunk``-slot boundaries and start at
    a multiple of their length (exp_runstats.py:46-79)."""
    nb = indices.shape[-1]
    pad = (-nb) % chunk
    if pad:
        indices = np.concatenate(
            [indices, np.full(indices.shape[:-1] + (pad,), -10,
                              indices.dtype)], axis=-1)
    nbp = nb + pad
    slot = np.arange(nbp)
    contig = np.zeros(indices.shape, bool)
    contig[..., 1:] = indices[..., 1:] == indices[..., :-1] + 1
    contig[..., slot % chunk == 0] = False               # chunk boundary
    dlen = np.zeros(indices.shape, np.int32)
    covered = np.zeros(indices.shape, bool)
    for c in range(int(np.log2(chunk)), -1, -1):
        ln = 1 << c
        # solid iff every interior slot of the aligned 2^c segment
        # continues the run
        solid = np.ones(indices[..., ::ln].shape, bool)
        for off in range(1, ln):
            solid &= contig[..., off::ln]
        sel = solid & ~covered[..., ::ln]
        dlen[..., ::ln] = np.where(sel & (dlen[..., ::ln] == 0), ln,
                                   dlen[..., ::ln])
        for off in range(ln):
            covered[..., off::ln] |= sel
    return dlen[..., :nb]


def stats(idx: np.ndarray, cnt: np.ndarray, chunk: int = 16) -> dict:
    """exp_runstats.py:82-100's numbers: only slots inside issued chunks
    count (the kernel copies the padding lanes of a row's last chunk
    too)."""
    nb = idx.shape[-1]
    dlen = dma_decomposition(idx, cnt, chunk)
    slot = np.arange(nb)
    nchunks = (cnt + chunk - 1) // chunk
    live = slot[None, None, None] < (nchunks * chunk)[..., None]
    n_now = int(live.sum())
    n_coal = int(((dlen > 0) & live).sum())
    sizes, freq = np.unique(dlen[(dlen > 0) & live], return_counts=True)
    return {"density": float(cnt.mean() / nb),
            "mean_count": float(cnt.mean()),
            "descriptors": n_now, "descriptors_coalesced": n_coal,
            "fewer": n_now / n_coal,
            "run_size_share": {int(s): int(f) / n_coal
                               for s, f in zip(sizes, freq)}}


def union_growth(plan_mask, groups=(2, 4, 8)):
    """Mean union size of G adjacent rows against a single row's
    (exp_runstats.py:148-159): (single, {G: (union, union / single)})."""
    m = np.asarray(plan_mask)
    b, h, nq, nb = m.shape
    single = m.sum(-1).mean()
    out = {}
    for g in groups:
        nqg = nq - nq % g
        mg = m[:, :, :nqg].reshape(b, h, nqg // g, g, nb)
        u = mg.any(-2).sum(-1).mean()
        out[g] = (u, u / single)
    return single, out


def run(*, heads: int = 2, lt: int = 32, lh: int = 45, lw: int = 80,
        alpha: float = 4.0, sigma: float = 1.0, small: bool = False,
        device="cuda", seed: int = 0) -> dict:
    """The line as a dict (module docstring)."""
    dev = resolve(device)
    grid = SMALL_GRID if small else (lt, lh, lw)
    text_len, d = 256, 128
    site, _, h2l = build_site(*grid, sa_drop_rate=0.8, p_remain=0.3,
                              layout="joint", text_len=text_len, device=dev)
    sv = site.visual_len
    coords = curve_coords(h2l, grid)
    res = {}
    for label, (a, s) in (("peaked", (alpha, sigma)), ("random", (0.0, 1.0))):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        q, k = smooth_inputs(gen, heads, coords, text_len, d, n=2, alpha=a,
                             sigma=s)
        plan_fn = lambda: build_sparse_plan(q[:, :, :sv], k, k, site.cfg,
                                            neighbor_mask=site.neighbor_mask)
        plan_fn()
        sync(dev)
        t0 = time.perf_counter()
        plan = plan_fn()
        sync(dev)
        plan_s = time.perf_counter() - t0
        single, growth = union_growth(plan.block_mask.cpu().numpy())
        res[label] = {
            "plan_s": plan_s, "alpha": a, "sigma": s,
            **stats(plan.indices.cpu().numpy(), plan.counts.cpu().numpy()),
            "union_single": float(single),
            "union_growth": {g: {"union": float(u), "growth": float(r)}
                             for g, (u, r) in growth.items()}}
    res.update(grid=list(grid), heads=heads, **device_info(dev))
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--lt", type=int, default=32)
    ap.add_argument("--lh", type=int, default=45)
    ap.add_argument("--lw", type=int, default=80)
    ap.add_argument("--alpha", type=float, default=4.0)
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--small", action="store_true",
                    help="the 8 x 24 x 32 grid (a CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    line = run(**vars(ap.parse_args(argv)))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
