"""K1's ablation variants (S3) on the plan of realistic inputs at the
HunyuanVideo operating point (port of scripts/bench_kernelvars.py:625-684).

    python -m rectified_spaattn_tpu_torch.bench.kernelvars \\
        [--variants base,dma,compute,nomask,noexp] [--drop 0.8] \\
        [--chunk 16] [--check] [--iters 3] [--small] [--device cuda|cpu]

Variants: the S3a names of kernels/variants.py (a trailing 3 runs three
ring stages: ``base3``), ``twophase`` (S3b), ``runsN`` (S3c with max_run
N; ``runs`` is 4), and ``k1``, the production K1 on the same plan, which
the ablations attribute.  The plan is build_sparse_plan's on
``realistic_qkv`` (1 x 24 heads x 128, 115,200 visual + 256 text tokens,
all text valid; ``--small``: the 8 x 24 x 32 grid), the visual rows over
all keys, chunk_blocks ``--chunk``.  Prints the mean count, one line per
variant with its ms, and last one JSON line {variant: ms, ...} with the
device, and on the card each variant's kernel alone (``kernel_ms``: the
median device time of its hopper_attn_kernel in torch.profiler traces of
one call, the variants traced in turns ``--iters`` times; without the
index work its wrapper launches before it).  ``--check``
first holds the checked variants to their reference
on the same plan (``CHECKED``: base to K1's output by max abs and rms
error beside the output's scale; twophase to base's and runs* to K1's
bit for bit, ``equal``).
On ``--device cpu`` every kernel runs its plain version (a rehearsal).
"""

from __future__ import annotations

import argparse
import json

import torch

from ..kernels import block_sparse_flash_attention, variants
from ..pipelines import build_site
from ..sparse import build_sparse_plan
from .common import (device_info, kernel_ms_turns, median, point, rel_err,
                     resolve, time_ms)
from .inputs import realistic_qkv

DEFAULT = "base,dma,compute,nomask,noexp"
ALL = ",".join([*variants.S3A, "base3", "twophase", "runs1", "runs2",
                "runs4"])
# the checked variants and their references ("runs": every runsN).
# twophase is base without the selects that keep every key of its clean
# chunks, runs* K1 with other copies of the same units: each equals its
# reference bit for bit
CHECKED = {"base": "k1", "twophase": "base", "runs": "k1"}


def reference(name: str):
    """The variant ``name`` is checked against, or None."""
    return CHECKED.get("runs" if name.startswith("runs") else name)


def setup(small: bool = False, *, grid=None, heads=None, drop: float = 0.8,
          device="cuda", seed: int = 0) -> dict:
    """The inputs and the plan: q's visual rows, K/V over all tokens, the
    plan's lists, the text lengths and the window."""
    dev = resolve(device)
    pt = point(small, grid, heads)
    grid, h, d, text_len = pt["grid"], pt["heads"], pt["head_dim"], \
        pt["text_len"]
    site, _, h2l = build_site(*grid, sa_drop_rate=drop, p_remain=0.3,
                              layout="joint", text_len=text_len, device=dev)
    sv = site.visual_len
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = realistic_qkv(gen, 1, h, grid, text_len, d, h2l)
    plan = build_sparse_plan(
        q[:, :, :sv], k, v, site.cfg, neighbor_mask=site.neighbor_mask,
        text_valid=torch.ones((1, text_len), dtype=torch.bool, device=dev))
    return {"dev": dev, "q": q[:, :, :sv], "k": k, "v": v,
            "indices": plan.indices, "counts": plan.counts,
            "tlen": torch.full((1,), text_len, dtype=torch.int32, device=dev),
            "visual_len": sv, "grid": grid}


def call(variant: str, st: dict, chunk: int = 16):
    """The closure that runs ``variant`` once on the set-up plan."""
    args = (st["q"], st["k"], st["v"], st["indices"], st["counts"],
            st["tlen"])
    kw = dict(visual_len=st["visual_len"], text_start=st["visual_len"],
              chunk_blocks=chunk)
    if variant == "k1":
        return lambda: block_sparse_flash_attention(*args, **kw)
    if variant == "twophase":
        return lambda: variants.twophase(*args, **kw)
    if variant.startswith("runs"):
        max_run = int(variant[4:]) if len(variant) > 4 else 4
        return lambda: variants.runs(*args, max_run=max_run, **kw)
    variants.parse_s3(variant)
    return lambda: variants.kernel_variant(variant, *args, **kw)


def run(names, *, small=False, grid=None, heads=None, drop=0.8, chunk=16,
        check=False, iters=3, device="cuda", seed=0, verbose=True) -> dict:
    """Time each variant of ``names`` on one plan; returns {"ms":
    {variant: ms}, "check": {variant: errors vs K1}, the plan's mean
    count and pairs, the device}.  A variant named twice (k1 first and
    last, say) is timed twice: "ms" holds the mean, "ms_each" each time;
    on the card "kernel_ms" holds each variant's kernel alone, the median
    of "kernel_ms_each" (``common.kernel_ms_turns``: ``iters`` turns),
    traced after the variants are timed."""
    st = setup(small, grid=grid, heads=heads, drop=drop, device=device,
               seed=seed)
    counts = st["counts"]
    res = {"mean_count": float(counts.float().mean()),
           "pairs": float(counts.sum()),
           "slots": st["indices"].shape[-1], "chunk_blocks": chunk,
           "visual_tokens": st["visual_len"], "ms": {}, "check": {},
           **device_info(st["dev"])}
    if verbose:
        print("mean count:", res["mean_count"], flush=True)
    if check:
        want = {}
        for name in names:
            ref = reference(name)
            if ref is None:
                continue
            if ref not in want:
                want[ref] = call(ref, st, chunk)()
            got = call(name, st, chunk)()
            res["check"][name] = {"ref": ref,
                                  "equal": bool(torch.equal(got, want[ref])),
                                  **rel_err(got, want[ref])}
            if verbose:
                print(f"{name}-vs-{ref}:", json.dumps(res["check"][name]),
                      flush=True)
            del got
        del want
    each = {}
    for name in names:
        t = time_ms(call(name, st, chunk), st["dev"], reps=iters)
        each.setdefault(name, []).append(t)
        res["ms"][name] = sum(each[name]) / len(each[name])
        if verbose:
            print(f"{name}: {t:.1f} ms", flush=True)
    res["ms_each"] = each
    res["kernel_ms_each"] = kernel_ms_turns(
        {name: call(name, st, chunk) for name in names}, st["dev"], iters)
    res["kernel_ms"] = {name: median(v)
                        for name, v in res["kernel_ms_each"].items()}
    if verbose:
        print("kernel_ms:", json.dumps(res["kernel_ms"]), flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=DEFAULT,
                    help=f"comma-separated; all: {ALL},k1")
    ap.add_argument("--drop", type=float, default=0.8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--check", action="store_true",
                    help="hold base and runs* to K1, twophase to base first")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--small", action="store_true",
                    help="the 8 x 24 x 32 latent grid")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    res = run(a.variants.split(","), small=a.small, drop=a.drop,
              chunk=a.chunk, check=a.check, iters=a.iters, device=a.device,
              seed=a.seed)
    print(json.dumps({**res["ms"], "kernel_ms": res["kernel_ms"],
                      "device": res["device"],
                      "nvidia_smi": res.get("nvidia_smi")}), flush=True)
    return res


if __name__ == "__main__":
    main()
