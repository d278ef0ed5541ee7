#!/usr/bin/env python3
"""Times the attention kernels at the shapes of the port's main path on one
card, for the port's package of a given source tree, beside the one PyTorch
call that computes the same function (SDPA) where there is one.

    python3 kernel_ab.py [--root DIR] [--reps 5] [--label NAME] [--build]
        [--ablations]

The package comes from ``--root`` (default: this checkout), so one call
can time two trees in turns (parent, change, change, parent) with the same
script.  The HunyuanVideo inputs are chip_smoke.py's random site
(``site_inputs``: iid q/k/v, seed 7, 100 valid text tokens), loaded from
the file beside this one:

  K1_visual_g1, K2_visual_g2, K1q_{int8,mxu8}_visual  the visual rows at
      group_rows 1 / 2, K1q at chunk_blocks 24;
  K1_text_rows     the 256 text rows over full lists of all 902 blocks;
  K1_dense_bm1024  the windowed dense K1 (full lists, block_m 1024);
  K1s_ring_text    one sp = 4 ring step's text rows: full lists over the
                   first shard's 225 blocks, with the row stats.

The Wan2.1-14B inputs are iid (seed 8) at chip_smoke.py's Wan site,
75,648 tokens x 40 heads:

  K1_wan_dense_bm1024  the windowed dense K1 of the warm layers;
  K3_t2v_text, K3_i2v_image  K3 over 512 / 257 keys, q and k/v head-split
                   views of [B, S, H, D] projections.

With ``--ablations`` it also times K1's and K2's ablations on the visual
rows' plan (S3a base / compute / dma, S3b twophase and S3c runs1 / runs4
beside K1_visual_g1; S2 full / compute / dma at G = 2 beside
K2_visual_g2: kernels/variants.py), the plan that
bench/mainloop_variants.py's edits of the mainloop run on, and under
"kernel_ms" the device time of K1's and each S3 ablation's
hopper_attn_kernel alone, from torch.profiler traces of one wrapper call
each, the calls taken in turns ``--reps`` times (bench/common.py's
``kernel_ms_turns``).

It also records, under "digest", a sha1 of each kernel's output bytes
(the first call's; K1q-s "int8" and K3 on fp16 inputs added), so that
two trees' lines show whether a kernel computes the same bits.

Each time is chip_smoke.py's ``cuda_ms`` over ``--reps`` calls; each
``<name>_sdpa`` is the SDPA call's time on the same inputs (the yardstick
chip_smoke.py reports as ``library_ms``).  Prints one JSON line {"label",
"root", "nvidia_smi", kernel: ms}; with ``--build`` it first builds the
tree's kernels with ptxas -v and adds chip_smoke.py's build table (per
kernel registers, spill bytes, SASS counts and digest) as "build".
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import math
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--label", default="")
    ap.add_argument("--build", action="store_true",
                    help="report the tree's ptxas and SASS table")
    ap.add_argument("--ablations", action="store_true",
                    help="time S3a / S2 on the visual rows' plan too")
    a = ap.parse_args(argv)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    # chip_smoke imports the package only inside its functions: from here
    # on it resolves to --root's
    sys.path.insert(0, os.path.abspath(a.root))
    from rectified_spaattn_tpu_torch import kernels
    from rectified_spaattn_tpu_torch.sparse import ops

    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash = torch.ops.aten._scaled_dot_product_flash_attention
    res = {"label": a.label, "root": a.root, "nvidia_smi": smoke.smi_line()}
    if a.build:
        res["build"] = smoke.build(kernels)[1]

    res["digest"] = {}

    def digest(out):
        h = hashlib.sha1()
        for t in out if isinstance(out, tuple) else (out,):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:12]

    def time_all(calls):
        for name, fn in calls.items():
            if not name.endswith("_sdpa"):
                res["digest"][name] = digest(fn())
            res[name] = smoke.cuda_ms(fn, reps=a.reps)
        print(json.dumps({n: res[n] for n in calls}), file=sys.stderr,
              flush=True)

    st = smoke.site_inputs("random")
    dev = st["q"].device
    sv = st["site"].visual_len
    q, k, v, kz, vz, tlen, plan = (st[n] for n in ("q", "k", "v", "kz", "vz",
                                                   "tlen", "plan"))
    qv, qt = q[:, :, :sv], q[:, :, sv:]
    b, h, s, d = q.shape
    nbt = s // 128
    kw = dict(visual_len=sv, text_start=sv)
    grouped = ops.group_rows(plan.block_mask, 2, clean_blocks=sv // 128)
    payload = ops.quantize_kv_blocks(kz, vz, 128)
    full = lambda rows, nb: (
        torch.arange(nb, dtype=torch.int32, device=dev).expand(b, h, rows,
                                                               nb),
        torch.full((b, h, rows), nb, dtype=torch.int32, device=dev))
    fidx, fcnt = full(qt.shape[2] // 128, nbt)
    nqd = -(-s // 1024)
    qd = torch.nn.functional.pad(q, (0, 0, 0, nqd * 1024 - s))
    didx, dcnt = full(nqd, nbt)
    # one ring step (sp = 4): the first shard's visual keys
    s_l = sv // smoke.RING_SP["hunyuan"]
    k0, v0 = k[:, :, :s_l].contiguous(), v[:, :, :s_l].contiguous()
    ridx, rcnt = full(qt.shape[2] // 128, s_l // 128)
    tl0 = torch.zeros((b,), dtype=torch.int32, device=dev)
    amask = st["valid"][:, None, None, :]
    k1 = kernels.block_sparse_flash_attention
    k1_visual = lambda: k1(qv, kz, vz, plan.indices, plan.counts, tlen, **kw)
    time_all({
        "K1_visual_g1": k1_visual,
        "K2_visual_g2": lambda: kernels.block_sparse_flash_attention_grouped(
            qv, kz, vz, *grouped, tlen, group=2, **kw),
        **{f"K1q_{m}_visual": (
            lambda m=m: k1(qv, kz, vz, plan.indices, plan.counts, tlen,
                           chunk_blocks=24, kv_quant=payload, quant_mode=m,
                           **kw))
           for m in ("int8", "mxu8")},
        "K1_text_rows": lambda: k1(qt, kz, vz, fidx, fcnt, tlen, **kw),
        "K1_text_rows_sdpa": lambda: sdpa(qt, k, v, attn_mask=amask),
        "K1_dense_bm1024": lambda: k1(qd, k, v, didx, dcnt, tlen,
                                      block_m=1024, **kw),
        "K1_dense_bm1024_sdpa": lambda: sdpa(q, k, v, attn_mask=amask),
        "K1s_ring_text": lambda: k1(qt, k0, v0, ridx, rcnt, tl0,
                                    visual_len=s_l, text_start=None,
                                    return_stats=True),
        "K1s_ring_text_sdpa": lambda: flash(qt, k0, v0),
    })
    res["digest"]["K1q-s_int8_visual"] = digest(k1(
        qv, kz, vz, plan.indices, plan.counts, tlen, chunk_blocks=24,
        kv_quant=payload, quant_mode="int8", return_stats=True, **kw))
    if a.ablations:
        from rectified_spaattn_tpu_torch.bench.common import kernel_ms_turns
        kv = kernels.variants
        s3 = {
            **{f"S3a_{n}_visual": (
                lambda n=n: kv.kernel_variant(n, qv, kz, vz, plan.indices,
                                              plan.counts, tlen, **kw))
               for n in ("base", "compute", "dma")},
            "S3b_twophase_visual": lambda: kv.twophase(
                qv, kz, vz, plan.indices, plan.counts, tlen, **kw),
            **{f"S3c_runs{r}_visual": (
                lambda r=r: kv.runs(qv, kz, vz, plan.indices, plan.counts,
                                    tlen, max_run=r, **kw))
               for r in (1, 4)},
        }
        time_all({
            **s3,
            **{f"S2_{n}_visual_g2": (
                lambda n=n: kv.grouped_variant(n, qv, kz, vz, *grouped, tlen,
                                               group=2, **kw))
               for n in ("full", "compute", "dma")},
        })
        res["kernel_ms"] = kernel_ms_turns(
            {"K1_visual_g1": k1_visual, **s3}, dev, a.reps)
        print(json.dumps(res["kernel_ms"]), file=sys.stderr, flush=True)
    del st, q, k, v, kz, vz, plan, grouped, payload, qd, k0, v0
    torch.cuda.empty_cache()

    # the Wan2.1-14B site
    wh = smoke.WAN_SITE["heads"]
    wsv = math.prod(smoke.WAN_SITE["grid"])       # 75,600 visual tokens
    ws = wsv + (-wsv) % 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v = rnd(1, wh, ws, d), rnd(1, wh, ws, d), rnd(1, wh, ws, d)
    nqd = -(-ws // 1024)
    qd = torch.nn.functional.pad(q, (0, 0, 0, nqd * 1024 - ws))
    b, h = 1, wh
    didx, dcnt = full(nqd, ws // 128)
    wvalid = (torch.arange(ws, device=dev) < wsv)[None, None, None, :]
    qx = rnd(1, ws, wh, d).transpose(1, 2)
    cross = {n: [rnd(1, sk, wh, d).transpose(1, 2) for _ in range(2)]
             for n, sk in (("K3_t2v_text", smoke.WAN_SITE["text_len"]),
                           ("K3_i2v_image", smoke.WAN_SITE["image_len"]))}
    time_all({
        "K1_wan_dense_bm1024": lambda: k1(qd, k, v, didx, dcnt, tl0,
                                          block_m=1024, visual_len=wsv,
                                          text_start=None),
        "K1_wan_dense_bm1024_sdpa": lambda: sdpa(q, k, v, attn_mask=wvalid),
        **{n: (lambda kv=kv: kernels.dense_attention(qx, *kv, mode="flash"))
           for n, kv in cross.items()},
        **{f"{n}_sdpa": (lambda kv=kv: sdpa(qx, *kv))
           for n, kv in cross.items()},
    })
    kx = [t.half() for t in cross["K3_t2v_text"]]
    res["digest"]["K3_t2v_text_fp16"] = digest(
        kernels.dense_attention(qx.half(), *kx, mode="flash"))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
