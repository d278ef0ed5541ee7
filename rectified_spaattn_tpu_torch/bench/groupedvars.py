"""K2's ablation variants (S2) on the plan of smooth inputs at the
HunyuanVideo operating point (port of scripts/bench_groupedvars.py:281-366).

    python -m rectified_spaattn_tpu_torch.bench.groupedvars [--small] \\
        [--groups 2,4] \\
        [--variants k2,full,dma,compute,computeclean,nobias,prefetch] \\
        [--iters 3] [--drop 0.8] [--chunk_blocks 16] [--check] \\
        [--device cuda|cpu]

The plan is build_sparse_plan's on smooth q and k (v = k, as the script
does; exp_runstats.py's field), 1 x 24 heads x 128 at the 32 x 45 x 80
grid (``--small``: 8 x 24 x 32) with 256 valid text tokens.  The baseline
``g1`` is the production K1 over the single-row lists of the same mask.
The script timed it twice, with ``prefetch_next`` on and off; that flag
issues the next grid cell's first DMAs on the TPU, and the port's K1
accepts and ignores it (a GPU thread block cannot fill another's buffer),
so g1_prefetch0 and g1_prefetch1 are one kernel here, timed once.  S2's own
``prefetch`` variant is the GPU's counterpart: a CTA walks 4 consecutive
row tiles, its producer loading the next tile's q and units while the
consumers finish the last.  Then at each G each variant, keyed
g{G}_{variant}, among them (by default first) ``k2``, the production K2 on
the same lists, which the ablations attribute (S2 is K2's mainloop policy
with one part taken out); last one JSON line with every time and the
device.  ``--check`` holds full and
prefetch to K1's single-row output first.  On ``--device cpu`` every
kernel runs its plain version (a rehearsal).
"""

from __future__ import annotations

import argparse
import json

import torch

from ..kernels import (block_sparse_flash_attention,
                       block_sparse_flash_attention_grouped, variants)
from ..pipelines import build_site
from ..sparse import build_sparse_plan, ops
from .common import device_info, point, rel_err, resolve, time_ms
from .inputs import curve_coords, smooth_inputs

DEFAULT = ",".join(["k2", *variants.S2, "k2"])   # K2 first and last


def setup(small: bool = False, *, grid=None, heads=None, drop: float = 0.8,
          device="cuda", seed: int = 0) -> dict:
    """q's visual rows, K (= V), the plan's block mask and the window."""
    dev = resolve(device)
    pt = point(small, grid, heads)
    grid, h, d, text_len = pt["grid"], pt["heads"], pt["head_dim"], \
        pt["text_len"]
    site, _, h2l = build_site(*grid, sa_drop_rate=drop, p_remain=0.3,
                              layout="joint", text_len=text_len, device=dev)
    sv = site.visual_len
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k = smooth_inputs(gen, h, curve_coords(h2l, grid), text_len, d, n=2)
    plan = build_sparse_plan(
        q[:, :, :sv], k, k, site.cfg, neighbor_mask=site.neighbor_mask,
        text_valid=torch.ones((1, text_len), dtype=torch.bool, device=dev))
    return {"dev": dev, "q": q[:, :, :sv], "k": k, "mask": plan.block_mask,
            "tlen": torch.full((1,), text_len, dtype=torch.int32, device=dev),
            "visual_len": sv}


def lists(st: dict, group: int):
    """(indices, counts, rowbits, clean) of group_rows at ``group``."""
    return ops.group_rows(st["mask"], group,
                          clean_blocks=st["visual_len"] // 128)


def call(variant: str, group: int, st: dict, grouped=None, chunk: int = 16):
    """The closure that runs S2 ``variant`` at ``group`` (``grouped``: its
    group_rows lists), for variant "k2" the production K2 on those lists,
    or, for variant "g1", K1 over the single-row lists."""
    kw = dict(visual_len=st["visual_len"], text_start=st["visual_len"],
              chunk_blocks=chunk)
    if variant == "g1":
        idx, cnt = ops.mask_to_indices(st["mask"])
        return lambda: block_sparse_flash_attention(
            st["q"], st["k"], st["k"], idx, cnt, st["tlen"], **kw)
    grouped = grouped if grouped is not None else lists(st, group)
    if variant == "k2":
        return lambda: block_sparse_flash_attention_grouped(
            st["q"], st["k"], st["k"], *grouped, st["tlen"], group=group,
            **kw)
    return lambda: variants.grouped_variant(
        variant, st["q"], st["k"], st["k"], *grouped, st["tlen"],
        group=group, **kw)


def run(groups, names, *, small=False, grid=None, heads=None, drop=0.8,
        chunk_blocks=16, iters=3, check=False, device="cuda", seed=0,
        verbose=True) -> dict:
    """Time g1 and each of ``names`` (S2 variants, "k2") at each G;
    returns {"ms": {key: ms}, "check": {key: errors vs K1}, the mask's
    density and pairs, the union growth per G, the device}.  A name given
    twice is timed twice: "ms" holds the mean, "ms_each" each time."""
    st = setup(small, grid=grid, heads=heads, drop=drop, device=device,
               seed=seed)
    counts = st["mask"].sum(-1)
    res = {"density": float(counts.float().mean()) / st["mask"].shape[-1],
           "mean_count": float(counts.float().mean()),
           "pairs": float(counts.sum()), "visual_tokens": st["visual_len"],
           "chunk_blocks": chunk_blocks, "ms": {}, "check": {},
           "union_slots": {}, **device_info(st["dev"])}
    if verbose:
        print(f"density {res['density']:.4f} mean_count "
              f"{res['mean_count']:.1f}", flush=True)
    want = call("g1", 1, st, chunk=chunk_blocks)() if check else None
    res["ms"]["g1"] = time_ms(call("g1", 1, st, chunk=chunk_blocks),
                              st["dev"], reps=iters)
    if verbose:
        print(f"g1: {res['ms']['g1']:.1f} ms", flush=True)
    each = {}
    for g in groups:
        grouped = lists(st, g)
        res["union_slots"][g] = float(grouped[1].sum())
        for name in names:
            fn = call(name, g, st, grouped, chunk_blocks)
            key = f"g{g}_{name}"
            if check and name in ("full", "prefetch"):
                res["check"][key] = rel_err(fn(), want)
                if verbose:
                    print(f"{name} g={g} vs single-row:",
                          json.dumps(res["check"][key]), flush=True)
            t = time_ms(fn, st["dev"], reps=iters)
            each.setdefault(key, []).append(t)
            res["ms"][key] = sum(each[key]) / len(each[key])
            if verbose:
                print(f"g{g} {name}: {t:.1f} ms", flush=True)
    res["ms_each"] = each
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--groups", default="2,4")
    ap.add_argument("--variants", default=DEFAULT)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--drop", type=float, default=0.8)
    ap.add_argument("--chunk_blocks", type=int, default=16)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    res = run([int(x) for x in a.groups.split(",")], a.variants.split(","),
              small=a.small, drop=a.drop, chunk_blocks=a.chunk_blocks,
              iters=a.iters, check=a.check, device=a.device,
              seed=a.seed)
    print(json.dumps({**res["ms"], "device": res["device"],
                      "nvidia_smi": res.get("nvidia_smi")}), flush=True)
    return res


if __name__ == "__main__":
    main()
