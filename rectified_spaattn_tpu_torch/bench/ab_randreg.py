"""The random-regime sparse site of one source tree (port of
scripts/ab_randreg.py): the density, one-shot and back-to-back ms of the
whole site at group_rows 1 and of the plan alone, on iid normal q/k/v
(seed 1) at the HunyuanVideo point (115,200 visual + 256 text tokens, 24
heads x 128, sa_drop_rate 0.8, p_remain 0.3).

    python -m rectified_spaattn_tpu_torch.bench.ab_randreg [--root DIR]
    python -m rectified_spaattn_tpu_torch.bench.ab_randreg --device cpu --small

``--root DIR`` times the port's package of another checkout: this file
runs again in a child process whose import path starts at DIR, so each
tree's package is imported in its own process, builds into its own
``build/`` and never shares a ``sys.modules`` with another (an A/B of two
trees is two calls, in turns).  The package is imported by its absolute
name for that reason, and the measurement uses only entry points that
every slice of the port has.

Times: ``oneshot_ms`` each call waited for (2 calls after one warm-up, the
script's ``timed``); ``amortised_ms`` and ``plan_ms`` device ms a call
over 6 back-to-back calls between CUDA events after one warm-up (the
script looped 6 calls inside one jit).  Prints ONE JSON line with the
script's keys (unrounded) and ``repo``, the tree whose package ran;
``--small``: the 8 x 24 x 32 grid at 4 heads.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch


def run(*, small: bool = False, grid=None, device="cuda",
        seed: int = 1) -> dict:
    """The line as a dict (module docstring), for the package this
    process imports."""
    import rectified_spaattn_tpu_torch as pkg
    from rectified_spaattn_tpu_torch.attention import (
        rectified_sparse_attention)
    from rectified_spaattn_tpu_torch.bench.common import (
        device_info, oneshot_ms, point, resolve, time_ms)
    from rectified_spaattn_tpu_torch.bench.inputs import random_inputs
    from rectified_spaattn_tpu_torch.pipelines import build_site
    from rectified_spaattn_tpu_torch.sparse import build_sparse_plan

    dev = resolve(device)
    pt = point(small, grid, heads=4 if small else None)
    site, _, _ = build_site(*pt["grid"], sa_drop_rate=0.8, p_remain=0.3,
                            layout="joint", text_len=pt["text_len"],
                            device=dev)
    cfg, nbr, sv = site.cfg, site.neighbor_mask, site.visual_len
    s = sv + pt["text_len"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = random_inputs(gen, pt["heads"], s, pt["head_dim"], device=dev)
    tlen = torch.full((1,), pt["text_len"], dtype=torch.int32, device=dev)
    sparse = lambda: rectified_sparse_attention(
        q, k, v, cfg, nbr, visual_len=sv, text_len_rt=tlen)
    plan = lambda: build_sparse_plan(q[:, :, :sv], k, v, cfg,
                                     neighbor_mask=nbr)
    p = plan()
    density = float(p.counts.float().mean()) / p.indices.shape[-1]
    del p
    return {"repo": os.path.dirname(os.path.dirname(
                os.path.abspath(pkg.__file__))),
            "density": density,
            "oneshot_ms": oneshot_ms(sparse, dev, 2),
            "amortised_ms": time_ms(sparse, dev, reps=6),
            "plan_ms": time_ms(plan, dev, reps=6),
            "grid": list(pt["grid"]), "heads": pt["heads"],
            **device_info(dev)}


def in_tree(root: str, argv: list) -> dict:
    """This file's ``main(argv)`` in a child process that imports the
    package from ``root``; its JSON line."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(root)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, os.path.abspath(__file__), *argv],
                         env=env, cwd=os.path.abspath(root),
                         stdout=subprocess.PIPE, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="the checkout whose rectified_spaattn_tpu_torch "
                         "runs (default: this process's)")
    ap.add_argument("--small", action="store_true",
                    help="the 8 x 24 x 32 grid at 4 heads (a CPU rehearsal)")
    ap.add_argument("--grid", default=None,
                    help="latent grid T,H,W (overrides the point's)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.root is not None:
        rest = ["--device", a.device] + (["--small"] if a.small else []) \
            + (["--grid", a.grid] if a.grid else [])
        line = in_tree(a.root, rest)
    else:
        # not common.parse_grid: a child imports --root's bench.common,
        # and an older tree's has no parse_grid
        grid = tuple(int(x) for x in a.grid.split(",")) if a.grid else None
        line = run(small=a.small, grid=grid, device=a.device)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
