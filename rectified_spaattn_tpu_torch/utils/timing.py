"""Wall-clock probes for the denoise loop (reference: utils/variable.py,
scripts/main_hunyuan.py:105-108,199-202): CUDA work is asynchronous, so
every stage boundary synchronises the device before reading the clock."""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


def device_sync(x=None):
    """Wait for all queued work on the device of ``x`` (default: the
    current CUDA device, if any).  A no-op for CPU tensors."""
    dev = getattr(x, "device", None)
    if dev is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    elif dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class StageTimer:
    """Accumulates wall-clock per named stage."""
    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        device_sync(sync_on)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {k: {"total_s": round(v, 3), "calls": self.counts[k]}
                for k, v in self.totals.items()}


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Optional torch.profiler trace around a region (CPU, and CUDA where
    there is a GPU), written as a chrome trace to ``log_dir``/trace.json;
    a no-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
