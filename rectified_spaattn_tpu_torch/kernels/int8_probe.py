"""S1: the int8 tensor-core probe (port of scripts/bench_int8mxu.py).

    python -m rectified_spaattn_tpu_torch.kernels.int8_probe   # one GPU

The JAX script's Pallas kernel ``_loop_kernel`` (:30, launched at :50)
asks whether int8 x int8 -> int32 dots run natively on the matrix unit at
the gather kernel's tile shape; the "mxu8" mode of K1q depends on it.  One
launch of ``loop_dots`` computes, for each of a batch of independent
(a [128, 128], b [128, 2048]) pairs, ``_loop_kernel``'s output: REPS = 64
dots a @ b, each adding its first 128 columns times (i + 1) to an fp32
[128, 128] accumulator; bf16 dots accumulate in fp32, int8 dots in int32.

The kernel is hand-written CUDA C++ for sm_90a (``csrc/int8_probe.cu``:
the attention mainloop's CTA, TMA copies and wgmma shapes,
m64n128k32 s8 and m64n128k16 bf16, on a persistent grid of at most one
CTA an SM).  A CPU tensor runs the plain version ``loop_dots_torch``; a
CUDA tensor launches the kernel or raises.  ``loop_dots.launches`` counts
launches.  With as many pairs as fill the card, ``check()`` holds both
types against the plain version (int8 bit for bit) and ``measure()``
times them (back-to-back calls over 500 ms after a warm-up as long, with
nvidia-smi's SM clock and power draw during the timed calls) against the
H100's dense peaks (989 TFLOP/s bf16, 1,979 TOP/s int8; a share above
1.05 raises: work was skipped) and against two
library calls at the same per-pair shapes, cuBLAS ``torch.bmm`` in bf16
and ``torch._int_mm`` in int8 (yardsticks only: the port calls neither).
One such call does one dot per pair; the yardstick for the kernel's work
is REPS of them back to back (``library_ms``), the single call's time
beside it (``library_one_dot_ms``).
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import time

import torch

from . import cuda_build

M, D, N, REPS = 128, 128, 2048, 64
PEAK = {"bf16": 989e12, "int8": 1979e12}     # H100 SXM dense (data sheet)
MAX_PEAK_SHARE = 1.05   # a reading above the peak means skipped work
WINDOW_MS = 500.0       # each timed run of back-to-back calls


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rsa_s1_launch.argtypes = [p, p, p, i, i, p]
    lib.rsa_s1_launch.restype = i


def loop_dots_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: a [P, M, D], b [P, D, N] (bf16 or int8) -> [P, M, 128]
    fp32, summed in the Pallas kernel's order (int8 products are exact in
    float64, so the int32 dot is too)."""
    if a.dtype == torch.int8:
        s = torch.bmm(a.double(), b.double()).float()
    else:
        s = torch.bmm(a.float(), b.float())
    s = s[..., :128]
    acc = torch.zeros_like(s)
    for i in range(REPS):
        acc = acc + s * float(i + 1)
    return acc


def loop_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """S1 over a batch of pairs: a [P, 128, 128], b [P, 128, 2048], both
    bf16 or both int8.  Returns [P, 128, 128] fp32."""
    if a.dtype not in (torch.bfloat16, torch.int8) or b.dtype != a.dtype:
        raise TypeError(f"S1 takes bf16 or int8 a and b, got {a.dtype} / "
                        f"{b.dtype}")
    p = a.shape[0]
    if tuple(a.shape) != (p, M, D) or tuple(b.shape) != (p, D, N):
        raise ValueError(f"S1 takes a [P, {M}, {D}] and b [P, {D}, {N}], got "
                         f"{tuple(a.shape)} / {tuple(b.shape)}")
    if a.device.type == "cpu":
        return loop_dots_torch(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"unsupported device {a.device} / {b.device}")
    return _launch(a.contiguous(), b.transpose(1, 2).contiguous())


def _launch(a, bt):
    """The kernel on a and b^T [P, N, D] (k contiguous: the K-major B
    operand of wgmma, which takes no transposed 8-bit operand)."""
    lib = cuda_build.load("int8_probe", _declare)
    out = torch.empty((a.shape[0], M, 128), dtype=torch.float32,
                      device=a.device)
    rc = lib.rsa_s1_launch(a.data_ptr(), bt.data_ptr(), out.data_ptr(),
                           a.shape[0], int(a.dtype == torch.int8),
                           torch.cuda.current_stream(a.device).cuda_stream)
    if rc:
        raise RuntimeError(
            f"S1 launch failed: {lib.rsa_error_string(rc).decode()}")
    loop_dots.launches += 1
    return out


loop_dots.launches = 0


def random_pairs(kind: str, pairs: int, generator: torch.Generator,
                 device="cpu"):
    """(a, b) as the JAX script draws them: int8 uniform in [-127, 127),
    bf16 standard normal."""
    if kind == "int8":
        draw = lambda *s: torch.randint(-127, 127, s, generator=generator,
                                        device=device, dtype=torch.int8)
    else:
        draw = lambda *s: torch.randn(s, generator=generator,
                                      device=device).to(torch.bfloat16)
    return draw(pairs, M, D), draw(pairs, D, N)


def _card_clocks() -> str:
    """nvidia-smi's SM clock and power draw of the first card, now."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                           "--format=csv,noheader"], capture_output=True,
                          text=True)
    return (proc.stdout.strip().splitlines() or ["not read"])[0]


def _cuda_ms(fn, window_ms: float = WINDOW_MS, clocks: bool = False):
    """fn's mean time on the card over back-to-back calls that fill about
    ``window_ms``, after a warm-up as long (the clocks and the power draw
    settle); with ``clocks`` also nvidia-smi's reading while the timed
    calls run."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(3, math.ceil(window_ms / 1e3 / (time.perf_counter() - t0)))
    for _ in range(reps):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    smi = _card_clocks() if clocks else None
    e1.synchronize()
    ms = e0.elapsed_time(e1) / reps
    return (ms, smi) if clocks else ms


def _pairs(pairs):
    if pairs is None:
        pairs = 2 * torch.cuda.get_device_properties(
            torch.device("cuda")).multi_processor_count
    return pairs


def check(pairs: int | None = None, seed: int = 0) -> dict:
    """Both types on the card against the plain version on the same
    inputs (int8 bit for bit, bf16 within 1e-4 of the output's scale);
    returns the errors and the plain version's time.  ``pairs`` defaults
    to two per SM."""
    dev = torch.device("cuda")
    pairs = _pairs(pairs)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    res = {}
    for kind in ("bf16", "int8"):
        a, b = random_pairs(kind, pairs, gen, dev)
        got = loop_dots(a, b)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        want = loop_dots_torch(a, b)
        e1.record()
        e1.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ok = (torch.equal(got, want) if kind == "int8"
              else err <= 1e-4 * scale)
        if not ok:
            raise AssertionError(f"S1 {kind}: max abs err {err} against the "
                                 f"plain version (max |ref| {scale})")
        res[kind] = {"max_abs_err": err, "exact": err == 0.0,
                     "ref_max_abs": scale, "plain_ms": e0.elapsed_time(e1)}
    return res


def measure(pairs: int | None = None, seed: int = 1) -> dict:
    """Both types' kernel time and rate against the dense peak (with the
    card's SM clock and power draw during the timed calls), and the
    library yardsticks at the same per-pair shapes for the same operations
    (REPS calls of one dot per pair)."""
    dev = torch.device("cuda")
    pairs = _pairs(pairs)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ops = 2.0 * M * D * N * REPS * pairs
    res = {"pairs": pairs, "shape": f"[{M},{D}]@[{D},{N}] x {REPS}"}
    for kind in ("bf16", "int8"):
        a, b = random_pairs(kind, pairs, gen, dev)
        bt = b.transpose(1, 2).contiguous()
        ms, smi = _cuda_ms(lambda: _launch(a, bt), clocks=True)
        if kind == "bf16":
            dot = lambda: torch.bmm(a, b)
            lib = "torch.bmm (cuBLAS) bf16, [P,128,128]@[P,128,2048]"
        else:
            # torch._int_mm is 2-D: the pairs' rows against one b
            a2 = a.reshape(pairs * M, D)
            dot = lambda: torch._int_mm(a2, b[0])
            lib = "torch._int_mm int8, [P*128,128]@[128,2048]"

        def dots():
            for _ in range(REPS):
                dot()

        lib_ms = _cuda_ms(dots)
        share = ops / ms * 1e3 / PEAK[kind]
        if share > MAX_PEAK_SHARE:
            raise AssertionError(
                f"S1 {kind}: {share:.3f} of the dense peak in {ms} ms: more "
                f"than the card can do, so work was skipped")
        res[kind] = {"ms": ms, "rate_t": ops / ms / 1e9,
                     "peak_share": share, "sm_clock_power": smi,
                     "bound_ms": ops / PEAK[kind] * 1e3,
                     "library": f"{lib}, {REPS} calls",
                     "library_ms": lib_ms,
                     "library_one_dot_ms": _cuda_ms(dot),
                     "library_rate_t": ops / lib_ms / 1e9}
    res["int8_over_bf16"] = res["int8"]["rate_t"] / res["bf16"]["rate_t"]
    return res


def main():
    if not torch.cuda.is_available():
        raise SystemExit("int8_probe needs a CUDA GPU (the kernel is CUDA "
                         "C++ for sm_90a)")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "check": check(), **measure()}))


if __name__ == "__main__":
    main()
