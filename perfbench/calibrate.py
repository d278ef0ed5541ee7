"""The readings that the limits of ``correct`` are set from (not run by
the benchmark's checks): for each seed, one run of the cell with a short
window, the program's numbers against the reference and, on the seeds of
``--control-seeds``, the control's (the reference in float8 in the
program's place), all in one process so that set-up is paid once.

    python3 -m perfbench.calibrate --workload <name> --seconds <s> \
        --seeds 1,2,3 --control-seeds 1,2,3

Prints one JSON line per seed and a last line with each number's largest
program reading and smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from perfbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    prog, ctl = {}, {}
    for seed in seeds + sorted(control - set(seeds)):
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               control=seed in control)
        print(json.dumps({"seed": seed, "step_s": res["step_s"],
                          "setup_s": res["setup_s"],
                          "reference_s": res.get("reference_s"),
                          "density": res.get("density"),
                          "numbers": res.get("numbers"),
                          "control_numbers": res.get("control_numbers"),
                          "error": res.get("check_error") or res["error"]}),
              flush=True)
        for k, v in (res.get("numbers") or {}).items():
            prog[k] = max(prog.get(k, v), v)
        for k, v in (res.get("control_numbers") or {}).items():
            ctl[k] = min(ctl.get(k, v), v)
        torch.cuda.empty_cache()
    print(json.dumps({"program_max": prog, "control_min": ctl}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
