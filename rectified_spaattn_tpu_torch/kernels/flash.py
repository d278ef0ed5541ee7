"""Dense attention (port of rectified_spaattn_tpu/kernels/flash.py).

  "vanilla"          explicit softmax attention in fp32, the numerical
                     oracle (reference: attn.py:121-149).
  "flash", "torch"   kernel K3, ``dense_flash_attention``: replaces the JAX
                     package's stock Pallas TPU flash kernel (JAX
                     kernels/flash.py:49-102), used where there is no
                     visual/text window (``visual_len=None``: Wan's text and
                     CLIP-image cross-attention).  Hand-written CUDA C++ for
                     sm_90a in ``csrc/dense_flash.cu`` (its header gives the
                     design and what bounds it on the H100), built and
                     loaded by kernels/cuda_build.py.

K3 takes arbitrary Sq and Sk without padding the caller's tensors, an
optional ``kv_valid`` [B, S] bool and ``sm_scale`` (default 1/sqrt(D)),
bf16 or fp16 with head_dim 128.  A CPU tensor runs the plain version,
``_vanilla_attention`` (the tests' path); a CUDA tensor launches the
kernel or raises; nothing falls back.  ``dense_flash_attention.launches``
counts its launches.  Invalid keys score the finite MASK_VALUE in both, so
a row with no valid key averages V uniformly over all keys.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}


def _vanilla_attention(q, k, v, kv_valid=None, sm_scale=None):
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if kv_valid is not None:
        scores = torch.where(kv_valid[:, None, None, :], scores,
                             torch.tensor(MASK_VALUE, device=scores.device))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _declare(lib):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.rsa_k3_launch.argtypes = [p] * 5 + [ll] * 12 + [i] * 4 + [f] \
        + [i] * 2 + [p]
    lib.rsa_k3_launch.restype = i


def _strided(x):
    """``x`` as the kernel reads it: [B, H, S, D] with D contiguous and
    (batch, head, row) strides that keep 16-byte copies aligned; a view
    that does not qualify is copied."""
    if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:3]):
        x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("q/k/v/out must start on a 16-byte boundary")
    return x


def dense_flash_attention(q, k, v, kv_valid=None, *, sm_scale=None):
    """K3: exact attention of every query over all (valid) keys.

    q [B,H,Sq,D]; k/v [B,H,Sk,D]; kv_valid [B,Sk] bool or None.  Any
    (batch, head, row) strides with D contiguous are read in place (a
    head-split [B,S,H,D] projection needs no copy); the output takes q's
    layout.  Returns [B,H,Sq,D] in q.dtype."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape or sk == 0:
        raise ValueError(f"k/v {tuple(k.shape)} / {tuple(v.shape)} must be "
                         f"[B,H,Sk>0,D] with q's B, H and D {tuple(q.shape)}")
    if kv_valid is not None and tuple(kv_valid.shape) != (b, sk):
        raise ValueError(f"kv_valid {tuple(kv_valid.shape)} must be [B, Sk] "
                         f"= {(b, sk)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return _vanilla_attention(q, k, v, kv_valid, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA kernels take bf16 or fp16, got {q.dtype} "
                        "(fp32 inputs are not supported yet)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if d != 128:
        raise ValueError(f"the CUDA kernels take head_dim 128, got {d}")
    if any(t is not None and t.device != q.device for t in (k, v, kv_valid)):
        raise ValueError("all operands must be on one CUDA device")
    q, k, v = _strided(q), _strided(k), _strided(v)
    out = _strided(torch.empty_like(q))
    if sq == 0:
        return out
    valid = (kv_valid.to(torch.bool).contiguous()
             if kv_valid is not None else None)
    lib = cuda_build.load("dense_flash", _declare)
    rc = lib.rsa_k3_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        valid.data_ptr() if valid is not None else None,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], b * h, h, sq, sk, float(sm_scale), d,
        _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(
            f"K3 launch failed: {lib.rsa_error_string(rc).decode()}")
    dense_flash_attention.launches += 1
    return out


dense_flash_attention.launches = 0


def dense_attention(q, k, v, kv_valid=None, *, mode: str = "flash",
                    sm_scale: float | None = None):
    """Exact attention of every query over all (valid) keys: "vanilla" is
    the fp32 oracle, "flash" (and the reference's "torch") is K3."""
    if mode == "vanilla":
        return _vanilla_attention(q, k, v, kv_valid, sm_scale)
    if mode in ("flash", "torch"):
        return dense_flash_attention(q, k, v, kv_valid, sm_scale=sm_scale)
    raise ValueError(f"unknown dense attention mode: {mode!r}")
