"""The sparse site and its gather kernel at the HunyuanVideo point on
peaked and iid-random inputs (port of scripts/bench_coalesce.py).

Peaked inputs: bench.py's smooth q/k/v (one low-frequency field of the
3-D position shared by q, k and v, alpha 4, plus per-token noise, sigma
1; ``inputs.smooth_qkv``): the real-checkpoint regime, where the top-k
floor sets the counts and the kept blocks cluster into contiguous curve
runs (``bench/runstats.py``).  Random: the same draw at alpha 0.  Per
regime: the plan's density, the whole site (``rectified_sparse_attention``
at group_rows 1), the plan alone, and K1 alone on the plan's ``indices``
/ ``counts`` (bench_coalesce.py:111-114); then the windowed dense (K1 with
full lists) on the random inputs.  115,200 visual + 256 text tokens, 24
heads x 128, sa_drop_rate 0.8, p_remain 0.3.

    python -m rectified_spaattn_tpu_torch.bench.coalesce [--alpha 4] [--reps 4]
    python -m rectified_spaattn_tpu_torch.bench.coalesce --device cpu --small

Times are one-shot host ms, each call waited for, over ``--reps`` calls
after one warm-up (the script's ``timed``).  Prints ONE JSON line;
``--small``: the 8 x 24 x 32 grid at 4 heads.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..attention import rectified_sparse_attention
from ..attention.modes import _windowed_dense_flash
from ..kernels import block_sparse_flash_attention
from ..pipelines import build_site
from ..sparse import build_sparse_plan
from .common import device_info, oneshot_ms, parse_grid, point, resolve
from .fidelity_gate import SMALL_HEADS
from .inputs import smooth_qkv


def run(*, alpha: float = 4.0, reps: int = 4, small: bool = False,
        grid=None, heads=None, device="cuda", seed: int = 0) -> dict:
    """The line as a dict (module docstring)."""
    dev = resolve(device)
    if small and heads is None:
        heads = SMALL_HEADS
    pt = point(small, grid, heads)
    site, _, h2l = build_site(*pt["grid"], sa_drop_rate=0.8, p_remain=0.3,
                              layout="joint", text_len=pt["text_len"],
                              device=dev)
    cfg, nbr, sv = site.cfg, site.neighbor_mask, site.visual_len
    tlen = torch.full((1,), pt["text_len"], dtype=torch.int32, device=dev)

    def qkv(a):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return smooth_qkv(gen, pt["heads"], pt["text_len"], pt["head_dim"],
                          h2l, pt["grid"], alpha=a)

    timed = lambda fn: oneshot_ms(fn, dev, reps)
    res = {}
    for label, a in (("peaked", alpha), ("random", 0.0)):
        q, k, v = qkv(a)
        plan_fn = lambda: build_sparse_plan(q[:, :, :sv], k, v, cfg,
                                            neighbor_mask=nbr)
        sparse_ms = timed(lambda: rectified_sparse_attention(
            q, k, v, cfg, nbr, visual_len=sv, text_len_rt=tlen))
        plan_ms = timed(plan_fn)
        plan = plan_fn()
        kernel_ms = timed(lambda: block_sparse_flash_attention(
            q[:, :, :sv], k, v, plan.indices, plan.counts, tlen,
            visual_len=sv, text_start=sv))
        res[label] = {
            "density": float(plan.counts.float().mean())
            / plan.indices.shape[-1],
            "sparse_full_ms": sparse_ms, "plan_ms": plan_ms,
            "kernel_ms": kernel_ms}
        del q, k, v, plan
    q, k, v = qkv(0.0)
    res["dense_ours_ms"] = timed(lambda: _windowed_dense_flash(
        q, k, v, visual_len=sv, text_start=sv, tlen=tlen))
    res.update(grid=list(pt["grid"]), heads=pt["heads"], reps=reps,
               **device_info(dev))
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--alpha", type=float, default=4.0)
    ap.add_argument("--reps", type=int, default=4)
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
