"""What the benchmarks share: the HunyuanVideo operating point, the device
they run on, and how they time a call.

On a CUDA device a time is CUDA-event time over back-to-back calls after a
warm-up; on the CPU (a rehearsal at a tiny grid, the kernels' plain
versions) it is the host clock, and the output names the device so that
no CPU number passes for a card's.
"""

from __future__ import annotations

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
