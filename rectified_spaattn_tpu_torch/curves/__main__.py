"""Curve-cache pre-warm CLI (port of rectified_spaattn_tpu/curves/__main__.py).

    python -m rectified_spaattn_tpu_torch.curves warm \
        --geometries 32x45x80,21x44x80 [--variant full] [--block 128]

Builds and disk-caches the Gilbert orderings + block neighbor masks for
each token grid so pipeline startup never pays the host-side walk (the
reference precomputes them each time its script starts,
scripts/main_hunyuan.py:23-42).
"""

from __future__ import annotations

import argparse
import time

from .cache import cached_curve

# the token grids (T', H', W') the pipelines build their sparse sites on at
# the reference's headline operating points (tests/test_torch_curves_tools.py
# derives each one from its pipeline).  Two of the JAX table's entries are
# grids no pipeline builds there: CogVideoXPipeline builds (6, 48, 85) at
# 768x1360x81 (JAX: (11, 48, 80)) and FluxPipeline (1, 256, 256) at 4096^2
# (JAX: (1, 128, 128)).
KNOWN_GEOMETRIES = {
    "hunyuan-720p-128f": (32, 45, 80),
    "wan21-720p-81f": (21, 45, 80),
    "wan22-ti2v-704p-121f": (31, 22, 40),
    "cogvideox-768p-81f": (6, 48, 85),
    "flux-4096": (1, 256, 256),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    warm = sub.add_parser("warm", help="pre-build curve caches")
    warm.add_argument("--geometries", type=str, default=None,
                      help="comma-separated TxHxW token grids "
                           "(default: all known operating points)")
    warm.add_argument("--variant", default="full",
                      choices=("full", "sliced", "linear"))
    warm.add_argument("--block", type=int, default=128)
    args = ap.parse_args(argv)

    if args.geometries:
        geoms = [tuple(int(x) for x in g.split("x"))
                 for g in args.geometries.split(",")]
    else:
        geoms = list(KNOWN_GEOMETRIES.values())
    for t, h, w in geoms:
        t0 = time.time()
        l2h, _, nb = cached_curve(t, h, w, block_size=args.block,
                                  variant=args.variant)
        print(f"{t}x{h}x{w}: {len(l2h)} tokens, {nb.shape[0]} blocks "
              f"({time.time() - t0:.2f}s)")


if __name__ == "__main__":
    main()
