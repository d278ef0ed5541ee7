"""Dense-vs-sparse reference-parity metrics (port of
rectified_spaattn_tpu/eval/diff_metrics.py; reference:
eval/image/evaluation/eval_image_diff.py:22-69).

The reference's closest thing to a functional test: compare sparse-mode
outputs against dense outputs of the same seed via SSIM / PSNR / cosine /
relative-L1 / RMSE (LPIPS needs the ``lpips`` package, behind a feature
gate).  Inputs are [..., H, W, C] float images or frames in [0, 1] or
[-1, 1], as tensors or numpy arrays; every metric runs in float64 on the
input's device (numpy arrays: the CPU).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float64)


def _to01(x) -> torch.Tensor:
    x = _f64(x)
    if x.min() < -0.01:
        x = (x + 1.0) / 2.0
    return x.clamp(0.0, 1.0)


def rmse(a, b) -> float:
    a, b = _to01(a), _to01(b)
    return float(((a - b) ** 2).mean().sqrt())


def psnr(a, b) -> float:
    m = rmse(a, b) ** 2
    if m == 0:
        return float("inf")
    return 10.0 * math.log10(1.0 / m)


def relative_l1(a, b) -> float:
    a, b = _f64(a), _f64(b)
    return float((a - b).abs().sum() / (b.abs().sum() + 1e-12))


def cosine_similarity(a, b) -> float:
    a, b = _f64(a).flatten(), _f64(b).flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-12))


def ssim(a, b, window: int = 7) -> float:
    """Mean local SSIM with a uniform window (channel-averaged)."""
    a, b = _to01(a), _to01(b)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    c1, c2 = 0.01 ** 2, 0.03 ** 2

    def box(x):
        # the mean over each window x window patch of the two spatial axes
        # of [..., H, W, C], edge-padded by window // 2: a stride-1
        # avg_pool2d over replicate-padded [N, C, H, W]
        lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
        y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        p = window // 2
        y = F.avg_pool2d(F.pad(y, (p, p, p, p), mode="replicate"), window,
                         stride=1)
        return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[2:], c)

    mu_a, mu_b = box(a), box(b)
    var_a = box(a * a) - mu_a ** 2
    var_b = box(b * b) - mu_b ** 2
    cov = box(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(s.mean())


def lpips(a, b) -> float | None:
    """Learned perceptual distance; needs the optional ``lpips`` package
    and its weights.  Returns None when unavailable (the harness reports
    the metric as skipped rather than failing)."""
    try:
        import lpips as lpips_pkg
    except Exception:
        return None
    ta, tb = _to01(a), _to01(b)
    net = lpips_pkg.LPIPS(net="vgg").to(ta.device)
    ta = ta.float().permute(2, 0, 1)[None] * 2 - 1
    tb = tb.float().permute(2, 0, 1)[None] * 2 - 1
    with torch.no_grad():
        return float(net(ta, tb))


def evaluate_pair(sparse_out, dense_out) -> dict:
    """All reference diff metrics for one (sparse, dense) sample pair."""
    out = {
        "ssim": ssim(sparse_out, dense_out),
        "psnr": psnr(sparse_out, dense_out),
        "cosine": cosine_similarity(sparse_out, dense_out),
        "relative_l1": relative_l1(sparse_out, dense_out),
        "rmse": rmse(sparse_out, dense_out),
    }
    lp = lpips(sparse_out, dense_out)
    if lp is not None:
        out["lpips"] = lp
    return out
