"""The traced window's profiler record, read once into plain lists that
the per-layer metric readers (perfbench/metrics/) and the breakdown take
from.  The device-event reading follows rectified_spaattn_tpu_torch/bench/
common.py:91-107 (``_device_events``: the trace's CUDA-side events,
kernels, copies and memsets, by name), kept here as a frozen copy and
extended to the events' times, so that the idle share, the kernels
launched inside a marked host range and the gaps between device work can
be read too.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools

import torch

PLAN_RANGE = "perfbench.plan"      # the host range around each plan build
TRACED_MARK = "perfbench.traced"   # where the traced steps begin
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma")   # cuBLAS's kernels


def is_attention(name: str) -> bool:
    """The site's attention kernels: K1 / K2 (``hopper_attn_kernel<...>``)
    and the key split's merge."""
    return "hopper_attn_kernel" in name or "merge_splits" in name


def is_gemm(name: str) -> bool:
    low = name.lower()
    return not is_attention(name) and any(n in low for n in GEMM_NAMES)


@dataclasses.dataclass
class Op:
    """One device operation: a kernel, a copy or a memset."""
    name: str
    start: int          # ns
    dur: int            # ns
    launch: int         # ns, host time of the runtime call that queued it


@dataclasses.dataclass
class Reading:
    """What a traced window leaves for the metric readers."""
    steps: int                      # denoise steps traced
    window_s: float                 # their host-clock seconds
    step_s: float | None            # a step's seconds, profiler stopped
    ops: list                       # [Op] on the device, by start
    plan_ranges: list               # [(start ns, end ns)] host ranges
    gemm_flops: float               # the traced steps' linear layers
    attn_flops: float               # the site calls' kernels at their plans
    attn_bound_s: float             # their roofline bounds summed
    # host ops for naming idle gaps: [(start ns, end ns, name)]
    host: list = dataclasses.field(default_factory=list)

    def in_plan(self, op: Op) -> bool:
        i = bisect.bisect_right(self.plan_ranges, (op.launch, float("inf")))
        return i > 0 and self.plan_ranges[i - 1][1] >= op.launch

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        return sum(b - a for a, b in merged(self.ops)) / 1e9

    def sum_ms(self, ops) -> float:
        return sum(o.dur for o in ops) / 1e6


def merged(ops):
    """The union of the ops' intervals, [(start, end)] ns in order."""
    out = []
    for o in ops:
        a, b = o.start, o.start + o.dur
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def read(prof, *, steps: int, window_s: float, step_s: float | None,
         gemm_flops: float, attn_flops: float,
         attn_bound_s: float) -> Reading:
    """The profiler's events as a ``Reading``: device operations with the
    host time of the runtime call that queued each (matched by correlation
    id), the plan's host ranges, and the host's ops for labelling gaps."""
    events = prof.profiler.kineto_results.events()
    mark = min((e.start_ns() for e in events
                if e.name() == TRACED_MARK and not _is_device(e)), default=0)
    launches, device, ranges, host = {}, [], [], []
    for e in events:
        if e.start_ns() < mark:
            continue
        name = e.name()
        if _is_device(e):
            if e.is_user_annotation() or name in (PLAN_RANGE, TRACED_MARK):
                continue
            device.append(e)
        elif name == TRACED_MARK:
            continue
        elif name == PLAN_RANGE:
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith(("cuda", "cu")) and e.correlation_id():
            launches[e.correlation_id()] = e.start_ns()
        else:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    ops = sorted((Op(e.name(), e.start_ns(), e.duration_ns(),
                     launches.get(e.correlation_id(), -1)) for e in device),
                 key=lambda o: o.start)
    return Reading(steps=steps, window_s=window_s, step_s=step_s, ops=ops,
                   plan_ranges=sorted(ranges), gemm_flops=gemm_flops,
                   attn_flops=attn_flops, attn_bound_s=attn_bound_s,
                   host=sorted(host))


def _short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def _host_at(r: Reading, t: int) -> str:
    """The innermost host op running at host time ``t`` (with the plan
    range around it, where there is one)."""
    starts = [h[0] for h in r.host]
    inner = None
    for s, e, name in reversed(r.host[:bisect.bisect_right(starts, t)]):
        if e >= t:
            inner = name
            break
    label = inner or "no host op"
    i = bisect.bisect_right(r.plan_ranges, (t, float("inf")))
    if i and r.plan_ranges[i - 1][1] >= t:
        label = f"{PLAN_RANGE}/{label}"
    return _short(label)


def breakdown(r: Reading, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the
    longest idle gaps between device work, each named by what the host
    was doing when the operation that ended it was queued."""
    by_name = {}
    for o in r.ops:
        by_name[o.name] = by_name.get(o.name, 0) + o.dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = merged(r.ops)
    nexts = {}
    for o in r.ops:
        nexts.setdefault(o.start, o)
    gaps = sorted(((b[0] - a[1], nexts[b[0]]) for a, b in
                   itertools.pairwise(spans)), key=lambda g: -g[0])[:top]
    return {"device_ops": [[_short(n), t / 1e9] for n, t in ops],
            "idle_gaps": [[_host_at(r, o.launch), g / 1e9]
                          for g, o in gaps]}
