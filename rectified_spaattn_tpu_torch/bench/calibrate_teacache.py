"""Calibrate random-weight TeaCache signal scales to the reference's
published call-skip regimes (port of scripts/calibrate_teacache.py).

For the timestep-signal families (Wan2.1 T2V / I2V, Wan2.2 TI2V,
CogVideoX) the TeaCache signal is the timestep-embedding trajectory:
independent of the latents, so the organic schedule at tiny spatial
shapes is the schedule at video scale.  For each family, through the
port's CLI:

  1. probe: one organic run at signal_scale 1 with ``--trace_out``;
  2. solve the scale whose simulated schedule hits the published rate
     (cache/calibrate.py::solve_signal_scale: exact, since the raws do not
     depend on the decisions);
  3. run again at the solved scale and write that calibrated trace.

Published call-skip regimes: Wan2.1-T2V ~65 % (thresh 0.2,
``--use_ret_steps``), Wan2.1-I2V ~81 % (thresh 0.3), CogVideoX ~57 %
(thresh 0.2), Wan2.2-TI2V ~32 % (thresh 0.1).

    python -m rectified_spaattn_tpu_torch.bench.calibrate_teacache \\
        --device cpu [--out outputs/teacache_calibration]
    python -m rectified_spaattn_tpu_torch.bench.calibrate_teacache \\
        --device cpu --small --families cogvideox-t2v

The solved scale depends on the CLI's random time-MLP weights, which the
port draws from a ``torch.Generator`` on the run's device: its scales are
its own, not the JAX package's (bench_traces/calibration/summary.json).
The JAX script runs on the CPU; ``--device cpu`` is that setting (the
default, as for every entry point of the port, is the card).  The output
goes under ``--out`` (default ``outputs/teacache_calibration`` in the
checkout): the calibrated traces, ``calibration/summary.json``, and the
probes and CLI outputs in ``work/``.  Prints the summary as ONE JSON
line.  ``--small`` runs 10 steps instead of 50.
"""

from __future__ import annotations

import argparse
import json
import os

from ..cache.calibrate import (realistic_raw_window, skip_rate,
                               solve_signal_scale, trace_raws)
from ..cli.generate import main as cli_main

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "outputs", "teacache_calibration")

FAMILIES = [
    # (name, CLI model, extra argv, target call-skip rate)
    ("wan21-t2v", "wan21-t2v",
     ["--teacache_thresh", "0.2", "--use_ret_steps"], 0.65),
    ("wan21-i2v", "wan21-i2v", ["--teacache_thresh", "0.3"], 0.81),
    ("cogvideox-t2v", "cogvideox-t2v", ["--teacache_thresh", "0.2"], 0.57),
    ("wan22-ti2v", "wan22-ti2v", ["--teacache_thresh", "0.1"], 0.32),
]

BASE = ["--height", "128", "--width", "128", "--frame", "9",
        "--scale", "0.05", "--mode", "sparse", "--enable_teacache"]
STEPS, SMALL_STEPS = 50, 10


def run_cli(model: str, extra: list, trace_path: str, scale: float, *,
            steps: int, device: str, cli_out: str) -> list:
    """One organic CLI run with its TeaCache trace; returns the trace."""
    cli_main(["--model", model, *BASE, "--num_steps", str(steps), *extra,
              "--teacache_signal_scale", str(scale),
              "--trace_out", trace_path, "--out_dir", cli_out,
              "--device", device])
    with open(trace_path) as f:
        return json.load(f)


def calibrate(name: str, model: str, extra: list, target: float, *,
              out: str, steps: int, device: str) -> dict:
    """Probe, solve and re-run one family; its summary entry."""
    work = os.path.join(out, "work")
    kw = dict(steps=steps, device=device, cli_out=work)
    records = run_cli(model, extra, os.path.join(work, f"probe_{name}.json"),
                      1.0, **kw)
    meta, raws = trace_raws(records)
    in_window = sorted(r for r in raws if r is not None)
    scale, predicted = solve_signal_scale(meta, raws, target)
    lo, hi = realistic_raw_window(meta["coefficients"], meta["thresh"])
    thresh = meta["thresh"]
    final_path = os.path.join(out, f"{name}_calibrated_thresh{thresh}.json")
    final = run_cli(model, extra, final_path, scale, **kw)
    fmeta = [r["meta"] for r in final if "meta" in r][0]
    if fmeta.get("signal_scale") != scale:
        raise AssertionError(f"{name}: the calibrated run's trace has "
                             f"scale {fmeta.get('signal_scale')}, not "
                             f"{scale}")
    decisions = [bool(r["compute"]) for r in final if "call" in r]
    return {"target_skip_rate": target, "signal_scale": scale,
            "predicted_skip_rate": predicted,
            "achieved_skip_rate": skip_rate(decisions), "thresh": thresh,
            "raw_median_unscaled": (in_window[len(in_window) // 2]
                                    if in_window else None),
            "realistic_raw_window": [lo, hi],
            "trace": os.path.basename(final_path)}


def run(*, out: str = DEFAULT_OUT, families=None, small: bool = False,
        device="cuda") -> dict:
    """The summary of every family in ``families`` (names; default all),
    also written to ``{out}/calibration/summary.json``."""
    names = [f[0] for f in FAMILIES]
    chosen = families or names
    unknown = set(chosen) - set(names)
    if unknown:
        raise ValueError(f"unknown families {sorted(unknown)}; "
                         f"choose from {names}")
    os.makedirs(os.path.join(out, "work"), exist_ok=True)
    summary = {name: calibrate(name, model, extra, target, out=out,
                               steps=SMALL_STEPS if small else STEPS,
                               device=str(device))
               for name, model, extra, target in FAMILIES
               if name in chosen}
    # the summary lives in a subdirectory, apart from the traces
    os.makedirs(os.path.join(out, "calibration"), exist_ok=True)
    with open(os.path.join(out, "calibration", "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--families", type=lambda s: s.split(","), default=None,
                    help="comma-separated family names (default: all)")
    ap.add_argument("--small", action="store_true",
                    help="10 steps instead of 50 (a quick rehearsal)")
    ap.add_argument("--device", default="cuda")
    summary = run(**vars(ap.parse_args(argv)))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
