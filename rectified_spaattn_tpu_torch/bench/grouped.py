"""Grouped-row execution on model-statistics masks (port of
scripts/bench_grouped.py): the whole sparse site at group_rows G in
{1, 2, 4, 8} (K1 at G = 1, K2 above) on spatially smooth inputs at the
HunyuanVideo point (115,200 visual + 256 text tokens, 24 heads x 128,
sa_drop_rate 0.8, p_remain 0.3).

Grouping fetches the union of G adjacent query blocks' key blocks once;
its gain rests on how much adjacent rows' lists overlap, which the mask
statistics report first, from one ``build_sparse_plan`` of the inputs
(all text valid): ``plan_ms``, the density, the mean count and, per G > 1,
``union_growth_g{G}``: the union's mean size over one row's
(bench_grouped.py:126-150; numpy on the host, as the script).

    python -m rectified_spaattn_tpu_torch.bench.grouped [--groups 1,2,4,8] \\
        [--iters 4] [--drop 0.8] [--kv_quant none|int8|mxu8] \\
        [--chunks 16,24] [--shared_field]
    python -m rectified_spaattn_tpu_torch.bench.grouped --device cpu --small

``--kv_quant`` runs K1q at G = 1 (and in the ``--chunks`` sweep, at G =
1); ``--shared_field`` draws q and k from one smooth field
(exp_runstats.py's inputs, v = k) instead of ``inputs.realistic_qkv``'s
three coarse fields.  Times are one-shot host ms, each call waited for
(the script's ``timed`` over ``--iters`` calls after one warm-up), and
device ms over the same number of back-to-back calls between CUDA
events.  Each run's output is held against the first G's (``err_vs_g1``:
max abs and rms error beside the reference's max |value| and std).
Prints ONE JSON line, the script's {"stats", "groups", "chunks"} plus
those; ``--small``: the 8 x 24 x 32 grid at 4 heads, on the CPU the plain
versions on the host clock.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..attention import rectified_sparse_attention
from ..pipelines import build_site
from ..sparse import build_sparse_plan
from .common import device_info, oneshot_ms, parse_grid, point, rel_err, \
    resolve, time_ms
from .fidelity_gate import SMALL_HEADS
from .inputs import curve_coords, realistic_qkv, smooth_inputs


def mask_stats(mask: np.ndarray, groups, plan_ms: float) -> dict:
    """bench_grouped.py:135-150 on a [B, H, NQ, NB] bool mask."""
    b, h = mask.shape[:2]
    counts = mask.sum(-1)
    stats = {"plan_ms": plan_ms,
             "density": float(counts.mean()) / mask.shape[-1],
             "mean_count": float(counts.mean())}
    for g in groups:
        if g == 1:
            continue
        nq = mask.shape[2]
        nqp = nq - nq % g
        mg = mask[:, :, :nqp].reshape(b, h, nqp // g, g, -1)
        u = mg.any(-2).sum(-1)
        stats[f"union_growth_g{g}"] = float(
            u.mean() / (mg.sum((-1, -2)).mean() / g))
    return stats


def inputs(pt: dict, h2l, *, shared_field: bool, device, seed: int = 0):
    """q, k, v: realistic_qkv's fields, or (``shared_field``) q and k of
    one smooth field (alpha 4, sigma 1) with v = k."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    grid, h, d, text_len = (pt["grid"], pt["heads"], pt["head_dim"],
                            pt["text_len"])
    if shared_field:
        q, k = smooth_inputs(gen, h, curve_coords(h2l, grid), text_len, d,
                             n=2)
        return q, k, k
    return realistic_qkv(gen, 1, h, grid, text_len, d, h2l)


def run(*, groups=(1, 2, 4, 8), iters: int = 4, drop: float = 0.8,
        kv_quant: str = "none", chunks=(), shared_field: bool = False,
        small: bool = False, grid=None, heads=None, device="cuda",
        seed: int = 0) -> dict:
    """The line as a dict (module docstring)."""
    dev = resolve(device)
    if small and heads is None:
        heads = SMALL_HEADS
    pt = point(small, grid, heads)
    site, _, h2l = build_site(*pt["grid"], sa_drop_rate=drop, p_remain=0.3,
                              layout="joint", text_len=pt["text_len"],
                              device=dev)
    cfg0, nbr, sv = site.cfg, site.neighbor_mask, site.visual_len
    if sv % cfg0.block_m:
        raise ValueError("operating point must be 128-aligned")
    q, k, v = inputs(pt, h2l, shared_field=shared_field, device=dev,
                     seed=seed)
    tlen = torch.full((1,), pt["text_len"], dtype=torch.int32, device=dev)
    text_valid = torch.ones((1, pt["text_len"]), dtype=torch.bool,
                            device=dev)

    def plan():
        return build_sparse_plan(q[:, :, :sv], k, v, cfg0,
                                 neighbor_mask=nbr, text_valid=text_valid)

    plan_ms = oneshot_ms(plan, dev, iters)
    stats = mask_stats(plan().block_mask.cpu().numpy(), groups, plan_ms)

    ref = None
    errs = {}

    def timed(cfg, key):
        nonlocal ref
        fn = lambda: rectified_sparse_attention(
            q, k, v, cfg, nbr, visual_len=sv, text_len_rt=tlen)
        out = fn()
        if ref is None:
            ref = out
        else:
            errs[key] = rel_err(out, ref)
        del out
        return {"oneshot_ms": oneshot_ms(fn, dev, iters),
                "event_ms": time_ms(fn, dev, reps=iters)}

    res = {"stats": stats, "groups": {}}
    for g in groups:
        cfg = dataclasses.replace(cfg0, group_rows=g,
                                  kv_quant=kv_quant if g == 1 else "none")
        res["groups"][g] = timed(cfg, f"g{g}")
    if chunks:
        res["chunks"] = {}
        for c in chunks:
            cfg = dataclasses.replace(cfg0, chunk_blocks=c,
                                      kv_quant=kv_quant)
            res["chunks"][c] = timed(cfg, f"chunk{c}")
    res["err_vs_g1"] = errs
    res["reference"] = f"g{groups[0]}"
    res.update(kv_quant=kv_quant, shared_field=shared_field,
               grid=list(pt["grid"]), heads=pt["heads"], sa_drop_rate=drop,
               **device_info(dev))
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="the 8 x 24 x 32 grid at 4 heads (a CPU rehearsal)")
    ap.add_argument("--groups", type=str, default="1,2,4,8")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--drop", type=float, default=0.8)
    ap.add_argument("--kv_quant", default="none",
                    choices=("none", "int8", "mxu8"),
                    help="K1q at G = 1 (int8 K|V gather; mxu8 also runs "
                         "both products in int8)")
    ap.add_argument("--chunks", type=str, default="",
                    help="comma list of chunk_blocks to sweep at G = 1")
    ap.add_argument("--shared_field", action="store_true",
                    help="q / k of one smooth field, v = k")
    ap.add_argument("--grid", default=None,
                    help="latent grid T,H,W (overrides the point's)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    ints = lambda s: tuple(int(x) for x in s.split(",") if x)
    line = run(groups=ints(a.groups), iters=a.iters, drop=a.drop,
               kv_quant=a.kv_quant, chunks=ints(a.chunks),
               shared_field=a.shared_field, small=a.small,
               grid=parse_grid(a.grid), device=a.device)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
