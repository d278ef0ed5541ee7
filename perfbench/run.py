"""The benchmark's command: one run of one cell on the card.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints an information line (per-step seconds, nvidia-smi's clocks and
power beside the window, the plan's density, the numbers compared), then
as its last line the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones), ``device``, ``breakdown`` (traced) and
``checks`` (each number compared, beside its limit), the checks again as
the last lines of standard error.  Without a CUDA card, or with fewer
cards than the cell asks for, or where JAX or the JAX package is loaded
once the window has closed, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()       # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# the JAX package and the libraries that would load JAX, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "rectified_spaattn_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from perfbench import harness
    chips = harness.cell_spec(args.workload)["cell"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 2
    res = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t0=T0)
    print(json.dumps(harness.info_line(res)), flush=True)
    line = harness.result_line(args.workload, res, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: loaded in this process: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
