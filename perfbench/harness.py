"""One run of one cell: set-up, the measured window over the program's
denoise loop, then the check against the plain reference.

The window.  The cell's pipeline runs its published schedule from step 0;
steps before the traffic's ``window_from_step`` are the warm-up (first
launches, cuBLAS heuristics, CogVideoX's dense warm calls) and count as
set-up.  The denoise loop has no per-step hook, so the harness wraps the
sampler class where the pipeline module looks it up: its ``timesteps``
become a walk that opens the window as step ``window_from_step`` begins
and ends the loop after the first step that completes once ``seconds``
have passed, and its ``step`` records each update (non-finite latents
fail the step; the checked steps' latents are kept).  ``build_sparse_plan`` and ``group_rows`` are wrapped
where attention/rectified.py looks them up: a host range around each plan
(the plan's kernels in the trace), and the checked step's first plan and
K2 lists kept for the check.

A traced run's window is ``trace_steps`` steps with no profiler, then
one warm step under the profiler and ``trace_steps`` traced steps: the
per-layer metrics that divide by a step's time take it from the steps
before the profiler (its host instrumentation stretches a traced step,
and a little of it stays once it has stopped), and the traced steps'
time beside them gives the profiler's overhead.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import random
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from rectified_spaattn_tpu_torch.attention import rectified

from . import check, inputs, peaks, smi, trace
from .reference.common import float32_products

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str) -> dict:
    """Everything the files name for workload ``name``: the cell, its
    configuration file, its traffic mix, its limits and its metrics."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def ours(m):
        return name in m.get("workloads", [name])

    return {
        "cell": cell,
        "config": load_json(os.path.join(ROOT, conf["file"])),
        "traffic": load_json(os.path.join(HERE, "traffic",
                                          cell["traffic"] + ".json")),
        "limits": load_json(os.path.join(HERE, "limits", name + ".json")),
        "end_to_end": [m for m in bench["end_to_end"] if ours(m)],
        "per_layer": [m for m in bench["per_layer"] if ours(m)],
    }


def family(name: str):
    return importlib.import_module(f"perfbench.families.{name}")


def metric_reader(name: str):
    """``perfbench/metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kept(t: torch.Tensor) -> torch.Tensor:
    """A copy in host memory of what the check keeps from the window, so
    that which step is checked does not move the window's peak memory."""
    return t.detach().to("cpu", copy=True)


def on(x, dev):
    """``x`` (a tensor, or tuples and dicts of them) on ``dev``."""
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(on(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: on(v, dev) for k, v in x.items()}
    return x


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Window:
    """The measured steps of one denoise loop (see the module's doc)."""

    def __init__(self, dev, start: int, seconds: float, trace_steps: int,
                 keep: set, plan_step: int, multiple: int = 1):
        self.dev, self.start, self.seconds = dev, start, seconds
        self.multiple = multiple
        self.trace_steps, self.keep, self.plan_step = (trace_steps, keep,
                                                       plan_step)
        self.t_begin = self.t_end = None
        self.step = -1
        self.done = []                 # per completed window step: bad flag
        self.states = {}               # step -> (latents in, latents out)
        self.on_profile, self.on_traced, self.on_end = [], [], []
        self.hook_s = {}               # step -> seconds of its hooks
        self.peak_bytes = None

    def walk(self, timesteps):
        for i, t in enumerate(timesteps):
            t_hooks = time.perf_counter()
            if i == self.start:
                self._begin()
            elif i > self.start and self._over(i):
                break
            if self.trace_steps:
                self._trace_hooks(i)
            # the harness's own seconds, taken out of the untraced steps
            self.hook_s[i] = time.perf_counter() - t_hooks
            self.step = i
            yield t
        self.finish()

    def _trace_hooks(self, i: int):
        """The profiler starts after ``trace_steps`` untraced steps; its
        first step pays its own start-up, so the traced steps are the
        ones after it."""
        if i == self.start + self.trace_steps:
            for f in self.on_profile:
                f()
        elif i == self.start + self.trace_steps + 1:
            with record_function(trace.TRACED_MARK):
                pass
            for f in self.on_traced:
                f()

    def untraced_seconds(self, step_seconds: list) -> list:
        """The seconds of a traced window's steps before the profiler
        started, the harness's own seconds taken out."""
        a = self.start
        return [step_seconds[j] - self.hook_s.get(j, 0.0)
                for j in range(a, a + min(self.trace_steps, len(self.done)))]

    def _over(self, i: int) -> bool:
        """Whether the window closes before step i: a traced window after
        ``trace_steps`` untraced steps, one warm traced step and
        ``trace_steps`` traced ones; a timed window once ``seconds`` have
        passed, holding whole multiples of ``multiple`` steps (the
        traffic's step pattern)."""
        if self.trace_steps:
            return i - self.start >= 1 + 2 * self.trace_steps
        if (i - self.start) % self.multiple or i <= max(self.keep,
                                                         default=-1):
            return False     # a slow step stretches the window to the check
        return time.perf_counter() - self.t_begin >= self.seconds

    def _begin(self):
        _sync(self.dev)
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.t_begin = time.perf_counter()

    def finish(self):
        if self.t_begin is None or self.t_end is not None:
            return
        _sync(self.dev)
        self.t_end = time.perf_counter()
        if self.dev.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.dev)
        for f in self.on_end:
            f()

    def after_step(self, i: int, sample, out):
        if i >= self.start and self.t_end is None:
            self.done.append(~torch.isfinite(out).all())
        if i in self.keep:
            self.states[i] = (kept(sample), kept(out))


def windowed(cls, window: Window):
    """``cls`` (a sampler) with its timesteps walked by ``window`` and its
    updates recorded."""

    class Windowed(cls):
        @property
        def timesteps(self):
            return window.walk(super().timesteps)

        def step(self, model_out, sample, i):
            out = super().step(model_out, sample, i)
            window.after_step(i, sample, out)
            return out

    return Windowed


class Taps:
    """The wrappers around the site's plan and K2 grouping."""

    def __init__(self, window: Window):
        self.window = window
        self.kept = {}
        self.want_groups = False
        self.calls = None              # traced: per-call accounting

    def plan(self, orig):
        def build_sparse_plan(query, key, value, cfg, *a, **kw):
            with record_function(trace.PLAN_RANGE):
                plan = orig(query, key, value, cfg, *a, **kw)
            w = self.window
            if w.step == w.plan_step and "mask" not in self.kept:
                self.kept["mask"] = kept(plan.block_mask)
                self.want_groups = True
            if self.calls is not None:
                m = plan.block_mask
                self.calls.append((m.sum(), m.any(dim=2).sum(),
                                   tuple(query.shape), cfg.text_len,
                                   m.shape[-1]))
            return plan
        return build_sparse_plan

    def groups(self, orig):
        def group_rows(mask, group, clean_blocks=0):
            out = orig(mask, group, clean_blocks)
            if self.want_groups:
                self.kept["groups"] = (tuple(kept(t) for t in out), group,
                                       clean_blocks)
                self.want_groups = False
            return out
        return group_rows

    def outputs(self, orig):
        """A function the loop calls with a step's model outputs (the
        family's ``OUTPUTS``): its arguments kept at the checked steps."""
        def keep(*args):
            w = self.window
            if w.step in w.keep:
                self.kept.setdefault("outputs", {})[w.step] = tuple(
                    kept(a) if torch.is_tensor(a) else a
                    for a in args)
            return orig(*args)
        return keep

    def attention(self):
        """(flops, bound seconds) of the traced calls' attention kernels."""
        flops = bound = 0.0
        for pairs, used, (b, h, rows, d), text_len, nbt in self.calls or ():
            f, s = peaks.attention_call(float(pairs), float(used), b=b, h=h,
                                        rows_visual=rows, d=d,
                                        text_len=text_len, key_blocks=nbt)
            flops, bound = flops + f, bound + s
        return flops, bound


class Patched:
    """Installs the window's sampler and the taps where the port looks
    them up, and takes them out again."""

    def __init__(self, fam, window: Window, taps: Taps):
        mod, attr = fam.SCHEDULER
        self.items = [
            (mod, attr, windowed(getattr(mod, attr), window)),
            (rectified, "build_sparse_plan",
             taps.plan(rectified.build_sparse_plan)),
            (rectified, "group_rows", taps.groups(rectified.group_rows))]
        for m, a in getattr(fam, "OUTPUTS", ()):
            self.items.append((m, a, taps.outputs(getattr(m, a))))

    def __enter__(self):
        self.saved = [(m, a, getattr(m, a)) for m, a, _ in self.items]
        for m, a, new in self.items:
            setattr(m, a, new)

    def __exit__(self, *exc):
        for m, a, old in self.saved:
            setattr(m, a, old)


class Tracer:
    """The traced window's profiler and FLOP count of the linear layers."""

    def __init__(self, model, taps: Taps):
        self.model, self.taps = model, taps
        self.gemm_flops = 0.0
        self.prof, self.hooks = None, []

    def _count(self, mod, args, _out):
        x = args[0]
        self.gemm_flops += 2.0 * x.numel() * mod.out_features

    def begin(self):
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()

    def traced(self):
        """The traced steps start: count from here."""
        self.taps.calls = []
        self.hooks = [m.register_forward_hook(self._count)
                      for m in self.model.modules()
                      if isinstance(m, torch.nn.Linear)]

    def end(self):
        if self.prof is None:
            return                     # the window closed before it began
        self.prof.__exit__(None, None, None)
        for h in self.hooks:
            h.remove()


def checked_steps(traffic: dict, computed: list, seed: int, trace: bool):
    """The steps whose updates are checked, drawn from the seed among the
    first ones every window holds: one computed step, or a skipped step
    and the computed step before it (its residual)."""
    start = traffic["window_from_step"]
    span = 1 + traffic["trace_steps"] if trace else traffic["check_within"]
    rng = random.Random(seed)
    cand = list(range(start, start + span))
    skips = [i for i in cand if not computed[i] and computed[i - 1]]
    if skips:
        j = rng.choice(skips)
        return [j - 1, j]
    return [rng.choice([i for i in cand if computed[i]])]


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", overrides=None, fault=None,
             control: bool = False, t0: float | None = None) -> dict:
    """One run of cell ``name``.  ``overrides`` replaces keys of the
    configuration file (the CPU tests' tiny sizes); ``fault`` is called
    with the pipeline before the window (the tests break the timed path
    underneath with it); ``control`` also computes the control's numbers
    (the reference in float8 in the program's place).  Returns the result
    line's fields, the numbers and the information lines.  Set-up counts
    from ``t0`` (the process's start)."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = cell_spec(name)
    overrides = dict(overrides or {})
    traffic = {**spec["traffic"], **overrides.pop("traffic", {})}
    c = {**spec["config"], **overrides}
    fam = family(c["family"])
    dev = torch.device(device)
    dtype = getattr(torch, c["precision"])     # weights' served type
    weights = inputs.draw_weights(fam.param_table(c), seed, dev, dtype)
    inp = fam.make_inputs(c, traffic, seed, dev)
    pipe = fam.build(c, traffic, weights, dev, ROOT)
    del weights
    if fault is not None:
        fault(pipe)
    steps = traffic["num_steps"]
    computed = fam.computed_steps(traffic, ROOT, steps)
    checked = checked_steps(traffic, computed, seed, traced)
    window = Window(dev, traffic["window_from_step"], seconds,
                    traffic["trace_steps"] if traced else 0, set(checked),
                    min(i for i in checked if computed[i]),
                    traffic["window_multiple"])
    taps = Taps(window)
    tracer = None
    if traced:
        tracer = Tracer(pipe.model, taps)
        window.on_profile.append(tracer.begin)
        window.on_traced.append(tracer.traced)
        window.on_end.append(tracer.end)
    smi_before = smi.reading() if dev.type == "cuda" else "cpu"
    error = None
    with Patched(fam, window, taps):
        try:
            fam.denoise(pipe, inp)
        except Exception as exc:          # a failed step: report, not crash
            error = f"{type(exc).__name__}: {exc}"
            window.finish()
    smi_after = smi.reading() if dev.type == "cuda" else "cpu"
    if window.t_begin is None:
        raise RuntimeError(f"the window never opened: {error}")

    n = len(window.done)
    failed = int(sum(int(b) for b in window.done)) + (error is not None)
    attempted = n + (error is not None)
    start = traffic["window_from_step"]
    step_s = (sum(pipe.step_seconds[start:start + n]) / n) if n else None
    res = {"setup_s": window.t_begin - t0, "step_s": step_s,
           "peak_bytes": window.peak_bytes, "attempted": attempted,
           "failed": failed, "error": error,
           "step_seconds": pipe.step_seconds,
           "smi": [smi_before, smi_after], "checked": checked}
    if traced:
        fl, bound = taps.attention()
        ts = traffic["trace_steps"]
        traced_s = pipe.step_seconds[start + ts + 1:start + 2 * ts + 1]
        plain_s = window.untraced_seconds(pipe.step_seconds)
        step_plain = (sum(plain_s) / len(plain_s)
                      if len(plain_s) == ts else None)
        res["reading"] = trace.read(
            tracer.prof, steps=len(traced_s), window_s=sum(traced_s),
            step_s=step_plain, gemm_flops=tracer.gemm_flops, attn_flops=fl,
            attn_bound_s=bound)
        res["traced_step_s"], res["untraced_step_s"] = traced_s, plain_s
        if step_plain and traced_s:
            res["trace_overhead_pct"] = 100.0 * (
                sum(traced_s) / len(traced_s) / step_plain - 1.0)

    # the program's side, then its state freed before the reference runs
    prog = {"c2l": pipe.h2l.cpu().numpy(),
            "neighbors": pipe.site.neighbor_mask.cpu().numpy()}
    prog.update(taps.kept)
    missing = [i for i in checked if i not in window.states]
    ins = {i: window.states[i][0] for i in checked if i in window.states}
    outs = {i: window.states[i][1] for i in ins}
    prog.update(ins=ins, outs=outs, delta={i: outs[i] - ins[i] for i in ins})
    del pipe, window, taps, tracer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    prog = on(prog, dev)
    states = prog["ins"]
    res["density"] = (float(prog["mask"][..., :prog["mask"].shape[-2]]
                            .float().mean()) if "mask" in prog else None)
    if missing or "mask" not in prog:
        res["numbers"] = {}
        res["limits_ok"], res["checks"] = check.verdict({}, spec["limits"])
        res["check_error"] = f"checked steps not reached: {missing}"
        return res

    weights = inputs.draw_weights(fam.param_table(c), seed, dev, dtype)
    t_ref = time.perf_counter()
    with torch.no_grad(), float32_products():
        ref = fam.reference(c, traffic, weights, inp, states, computed, dev,
                            "fp32")
        res["numbers"] = fam.numbers(prog, ref, checked, computed)
        if control:
            ctl = fam.reference(c, traffic, weights, inp, states, computed,
                                dev, "fp8")
            res["control_numbers"] = fam.numbers(ctl, ref, checked,
                                                 computed)
    res["reference_s"] = time.perf_counter() - t_ref
    res["limits_ok"], res["checks"] = check.verdict(res["numbers"],
                                                    spec["limits"])
    return res


def result_line(name: str, res: dict, traced: bool) -> dict:
    """The result line (the benchmark's last line of output) from
    ``run_cell``'s result."""
    spec = cell_spec(name)
    dev = torch.device("cuda") if torch.cuda.is_available() else None
    metrics = {}
    if traced:
        for m in spec["per_layer"]:
            value = metric_reader(m["name"])(res["reading"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"setup_s": res["setup_s"], "step_s": res["step_s"],
               "peak_mem_gb": (res["peak_bytes"] / 1e9
                               if res["peak_bytes"] is not None else None)}
        for m in spec["end_to_end"]:
            value = e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name(dev) if dev else "cpu",
              "count": 1, "memory_peak_bytes": res["peak_bytes"]}
    line = {"correct": bool(res["limits_ok"] and res["failed"] == 0
                            and res["attempted"] > 0),
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if traced:
        r = res["reading"]
        device["busy_s"] = r.busy_s()
        device["window_s"] = r.window_s
        line["breakdown"] = trace.breakdown(r)
    line["checks"] = res.get("checks", {})
    return line


def info_line(res: dict) -> dict:
    """The earlier line: per-step seconds, clocks and power, density."""
    keep = ("step_seconds", "smi", "checked", "density", "reference_s",
            "traced_step_s", "untraced_step_s", "trace_overhead_pct",
            "error", "check_error", "numbers", "control_numbers")
    out = {k: res[k] for k in keep if k in res}
    if res.get("step_seconds"):
        out["step_seconds_median"] = statistics.median(res["step_seconds"])
    return {"info": out}
