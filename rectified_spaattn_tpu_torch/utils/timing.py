"""The device sync of the denoise loops' step clock (reference:
utils/variable.py, scripts/main_hunyuan.py:105-108,199-202: CUDA work is
asynchronous, so a step synchronises the device before reading the
clock), the port's named host ranges (``span``) and the CLI's profiler
trace."""

from __future__ import annotations

import contextlib
import os

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


_OFF = contextlib.nullcontext()


def span(name: str):
    """A host range ``name`` on the profiler's clock while a torch profiler
    records (``profiler_trace``, the benchmark's traced steps): the trace
    files each device operation under the ranges around its launch.  With
    no profiler it is one shared null context: no ``record_function`` is
    entered, and the check costs a small fraction of entering one."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def attention_span(name: str, q: torch.Tensor, k: torch.Tensor):
    """``span`` around an attention call on q, k [B, H, S, D], its range
    named with the call's sizes, ``<name>:b=1,h=40,q=75648,k=512,d=128``,
    so that a reader of the trace can count its operations and bytes.
    The name is built only while a profiler records."""
    if torch.autograd._profiler_enabled():
        b, h, sq, d = q.shape
        return torch.profiler.record_function(
            f"{name}:b={b},h={h},q={sq},k={k.shape[2]},d={d}")
    return _OFF


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
