"""What the benchmarks share: the HunyuanVideo operating point, the device
they run on, and how they time a call.

On a CUDA device a time is CUDA-event time over back-to-back calls after a
warm-up, or (``kernel_ms``) one attention kernel's device time from a
profiler trace; on the CPU (a rehearsal at a tiny grid, the kernels'
plain versions) it is the host clock, and the output names the device so
that no CPU number passes for a card's.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

# bench.py's operating point: 720p, 128 frames -> latent (32, 45, 80), 24
# heads x 128, 256 text tokens; --small: the scripts' 1/8-scale grid
HUNYUAN = dict(grid=(32, 45, 80), heads=24, head_dim=128, text_len=256)
SMALL_GRID = (8, 24, 32)


def point(small: bool = False, grid=None, heads=None) -> dict:
    """The operating point; ``grid`` / ``heads`` override it (a CPU
    rehearsal at a tiny size)."""
    pt = {**HUNYUAN, "grid": SMALL_GRID} if small else dict(HUNYUAN)
    if grid is not None:
        pt["grid"] = tuple(grid)
    if heads is not None:
        pt["heads"] = heads
    return pt


def resolve(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for a "
                           "rehearsal with the plain versions")
    return dev


def device_info(dev: torch.device) -> dict:
    """The device's name and, on a card, its power limit as nvidia-smi
    reports them."""
    if dev.type != "cuda":
        return {"device": "cpu", "note": "plain versions, host clock"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    line = smi.stdout.strip().splitlines()
    return {"device": torch.cuda.get_device_name(dev),
            "nvidia_smi": line[dev.index or 0] if line else None}


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev: torch.device, reps: int = 3, warmup: int = 1) -> float:
    """Mean ms per call over ``reps`` back-to-back calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_ms(fn, dev: torch.device) -> float | None:
    """Device ms of one call's hopper_attn_kernel, from a torch.profiler
    trace of that call after one warm-up: the kernel alone, without the
    work the wrapper launches around it.  None off the card, or where the
    trace holds no such kernel."""
    if dev.type != "cuda":
        return None
    fn()
    sync(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        sync(dev)
    us = [getattr(e, "self_device_time_total",
                  getattr(e, "self_cuda_time_total", 0))
          for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "hopper_attn_kernel<" in e.key]
    return sum(us) / 1e3 if us else None


def kernel_ms_turns(calls: dict, dev: torch.device, rounds: int = 5) -> dict:
    """{name: [ms, ...]}: each call's kernel alone (``kernel_ms``), the
    calls taken in turns ``rounds`` times, so that a change of the card's
    speed during the run reaches every call alike."""
    each = {name: [] for name in calls}
    for _ in range(rounds):
        for name, fn in calls.items():
            each[name].append(kernel_ms(fn, dev))
    return each


def median(xs):
    """The median of the values of ``xs`` that are not None (a trace
    without the kernel), or None where there is none (off the card)."""
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def oneshot_ms(fn, dev: torch.device, n: int = 4) -> float:
    """Host-clock ms per call, each call waited for (bench.py's ``timed``:
    what one dispatch costs, launch overhead included)."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        sync(dev)
    return (time.perf_counter() - t0) * 1e3 / n


def rel_err(got, want) -> dict:
    """Max abs and rms error beside the reference's max |value| and std."""
    diff = got.float() - want.float()
    ref = want.float()
    return {"max_abs_err": float(diff.abs().max()),
            "rms_err": float(diff.square().mean().sqrt()),
            "ref_max_abs": float(ref.abs().max()), "ref_std": float(ref.std())}
