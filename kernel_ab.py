#!/usr/bin/env python3
"""Times the gather kernels K1, K2 and K1q (both modes) at the HunyuanVideo
site on one card, for the port's package of a given source tree.

    python3 kernel_ab.py [--root DIR] [--reps 5] [--label NAME]

The package comes from ``--root`` (default: this checkout), so one call
can time two trees in turns (parent, change, change, parent) with the same
script.  The inputs are chip_smoke.py's random site (``site_inputs``: iid
q/k/v, seed 7, 100 valid text tokens), loaded from the file beside this
one: K1 over the visual rows at group_rows 1, K2 at group_rows 2, K1q at
chunk_blocks 24.  Each time is chip_smoke.py's ``cuda_ms`` over ``--reps``
calls.  Prints one JSON line {"label", "root", "nvidia_smi", kernel: ms}.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--label", default="")
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

    st = smoke.site_inputs("random")
    sv = st["site"].visual_len
    qv, kz, vz, tlen, plan = (st["q"][:, :, :sv], st["kz"], st["vz"],
                              st["tlen"], st["plan"])
    kw = dict(visual_len=sv, text_start=sv)
    grouped = ops.group_rows(plan.block_mask, 2, clean_blocks=sv // 128)
    payload = ops.quantize_kv_blocks(kz, vz, 128)
    calls = {
        "K1_visual_g1": lambda: kernels.block_sparse_flash_attention(
            qv, kz, vz, plan.indices, plan.counts, tlen, **kw),
        "K2_visual_g2": lambda: kernels.block_sparse_flash_attention_grouped(
            qv, kz, vz, *grouped, tlen, group=2, **kw),
        **{f"K1q_{m}_visual": (
            lambda m=m: kernels.block_sparse_flash_attention(
                qv, kz, vz, plan.indices, plan.counts, tlen,
                chunk_blocks=24, kv_quant=payload, quant_mode=m, **kw))
           for m in ("int8", "mxu8")},
    }
    res = {"label": a.label, "root": a.root, "nvidia_smi": smoke.smi_line()}
    for name, fn in calls.items():
        res[name] = smoke.cuda_ms(fn, reps=a.reps)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
