"""The whole rectified site at group_rows 1 on iid random inputs (port of
scripts/bench_fullpath.py): the plan, K1 on the visual rows, the
rectification and the exact text rows at the HunyuanVideo point
(115,200 visual + 256 text tokens, 24 heads x 128, sa_drop_rate 0.8,
p_remain 0.3), with q = k = v one normal draw (the script draws all
three from one key) and all text valid.

    python -m rectified_spaattn_tpu_torch.bench.fullpath [--iters 3]
    python -m rectified_spaattn_tpu_torch.bench.fullpath --device cpu --small

One-shot ms, each call waited for, over ``--iters`` calls after the first
(the script's loop), and the plan's density.  The script's dense figure
is a TPU number and is not printed: ``bench/dense.py`` times the card's
dense kernels.  Prints ONE JSON line; ``--small``: the 8 x 24 x 32 grid at
4 heads.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..attention import rectified_sparse_attention
from ..attention.rectified import plan_density
from ..pipelines import build_site
from ..sparse import build_sparse_plan
from .common import device_info, oneshot_ms, parse_grid, point, resolve
from .fidelity_gate import SMALL_HEADS


def run(*, iters: int = 3, small: bool = False, grid=None, heads=None,
        device="cuda", seed: int = 0) -> dict:
    """The line as a dict (module docstring)."""
    dev = resolve(device)
    if small and heads is None:
        heads = SMALL_HEADS
    pt = point(small, grid, heads)
    site, _, _ = build_site(*pt["grid"], sa_drop_rate=0.8, p_remain=0.3,
                            layout="joint", text_len=pt["text_len"],
                            device=dev)
    sv = site.visual_len
    s = sv + pt["text_len"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = torch.randn((1, pt["heads"], s, pt["head_dim"]), generator=gen,
                    device=dev).to(torch.bfloat16)
    tlen = torch.full((1,), pt["text_len"], dtype=torch.int32, device=dev)
    ms = oneshot_ms(lambda: rectified_sparse_attention(
        q, q, q, site.cfg, site.neighbor_mask, visual_len=sv,
        text_len_rt=tlen), dev, iters)
    counts = build_sparse_plan(q[:, :, :sv], q, q, site.cfg,
                               neighbor_mask=site.neighbor_mask).counts
    return {"sparse_full_ms": ms,
            "mask_density": float(plan_density(counts, s // 128)),
            "tokens": s, "heads": pt["heads"], "grid": list(pt["grid"]),
            "iters": iters, **device_info(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--small", action="store_true",
                    help="the 8 x 24 x 32 grid at 4 heads (a CPU rehearsal)")
    ap.add_argument("--grid", default=None,
                    help="latent grid T,H,W (overrides the point's)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    line = run(**{**vars(a), "grid": parse_grid(a.grid)})
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
