"""Signal-scale calibration for random-weight TeaCache benches (port of
rectified_spaattn_tpu/cache/calibrate.py; numpy only).

The Wan/CogVideoX/TI2V TeaCache signal is the TIMESTEP-EMBEDDING
trajectory (reference: scripts/main_wan21t2v.py:103 `timestep_proj if
use_ret_steps else temb`; main_cogvideox.py:107 `emb`) — a pure function
of the sampling schedule and the time-MLP weights, independent of the
latents.  Under RANDOM weights its rel-L1 magnitudes land outside the
rescale polynomial's fitted domain, so poly(raw) stays below threshold
and the organic schedule degenerates to "skip every accumulate-window
call" (RESULTS_r3 organic table).

This module solves for a multiplicative ``signal_scale`` on the raw
rel-L1 signal such that the organic skip rate matches the reference's
published regime (e.g. ~65% call-skips for Wan2.1-T2V at thresh 0.2
--use_ret_steps, Inference.md).  Because the signal is latent-
independent and ``TeaCache`` updates ``previous_modulated`` on EVERY
call, the recorded per-call raw sequence does not depend on the skip
decisions — so one scale-1 probe trace lets us simulate the schedule at
any scale exactly, and the solved scale reproduces the target regime in
a real run bit-for-bit.
"""

from __future__ import annotations

import numpy as np


def simulate_schedule(meta: dict, raws: list, scale: float = 1.0
                      ) -> list[bool]:
    """Replay the TeaCache decision machine over a recorded per-call raw
    sequence (``raws[i]`` is None outside the accumulate window) with the
    raw signal multiplied by ``scale``.  Mirrors
    ``TeaCache.should_compute`` exactly; exactness is pinned by
    tests/test_torch_teacache_trace.py."""
    poly = np.poly1d(meta["coefficients"])
    streams = meta["cfg_streams"]
    thresh = meta["thresh"]
    ret = (meta["ret_steps"] if meta["ret_steps"] is not None else streams)
    cutoff = (meta["cutoff_steps"] if meta["cutoff_steps"] is not None
              else meta["num_steps"] - streams)
    acc = [0.0] * streams
    seen = [False] * streams
    out = []
    for cnt, raw in enumerate(raws):
        s = cnt % streams
        if cnt < ret or cnt >= cutoff or not seen[s]:
            compute = True
            acc[s] = 0.0
        else:
            if raw is None:
                raise ValueError(f"call {cnt}: in-window call without a raw")
            acc[s] += float(poly(raw * scale))
            if acc[s] < thresh:
                compute = False
            else:
                compute = True
                acc[s] = 0.0
        seen[s] = True
        out.append(compute)
    return out


def skip_rate(decisions: list[bool]) -> float:
    return 1.0 - sum(decisions) / max(len(decisions), 1)


def trace_raws(records: list) -> tuple[dict, list]:
    """Split a --trace_out record list (one meta + per-call records) into
    (meta, per-call raw list).  Raws are rescaled back to scale 1 using
    the recorded meta so the simulation can re-apply any scale."""
    metas = [r["meta"] for r in records if "meta" in r]
    calls = [r for r in records if "call" in r]
    if len(metas) != 1:
        raise ValueError("trace_raws expects a single-instance trace")
    meta = metas[0]
    base = meta.get("signal_scale", 1.0)
    raws = [None if r["raw"] is None else r["raw"] / base for r in calls]
    return meta, raws


def solve_signal_scale(meta: dict, raws: list, target_rate: float,
                       lo: float = 1e-4, hi: float = 1e4,
                       samples: int = 4000) -> tuple[float, float]:
    """Find the signal scale whose simulated skip rate is closest to
    ``target_rate``.  The quartic rescale polynomials are non-monotonic
    (several go negative outside their fitted domain), so this is a log-
    grid search, not a bisect; ties prefer the scale closest to the
    polynomial's realistic domain (smallest |log scale - log center|).

    Returns (scale, achieved_rate)."""
    grid = np.geomspace(lo, hi, samples)
    best = (float("inf"), float("inf"), 1.0, 1.0)
    for sc in grid:
        rate = skip_rate(simulate_schedule(meta, raws, sc))
        key = (abs(rate - target_rate), abs(np.log(sc)))
        if key < best[:2]:
            best = (*key, float(sc), rate)
    return best[2], best[3]


def realistic_raw_window(coefficients, thresh: float,
                         target_rate: float = 0.5) -> tuple[float, float]:
    """The raw rel-L1 interval where a CONSTANT signal yields between one
    skip per compute and ``1/(1-target_rate)`` calls per compute — i.e.
    poly(r) in (thresh * (1-target), thresh].  Diagnostic: shows where
    real-checkpoint signals must live for the published regimes."""
    poly = np.poly1d(coefficients)
    rs = np.geomspace(1e-5, 1.0, 100000)
    vals = poly(rs)
    lo_v = thresh * (1.0 - target_rate)
    ok = rs[(vals > lo_v) & (vals <= thresh)]
    if ok.size == 0:
        return (float("nan"), float("nan"))
    return float(ok.min()), float(ok.max())
