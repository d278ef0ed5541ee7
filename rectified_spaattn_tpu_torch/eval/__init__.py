"""Batch evaluation of the port (port of rectified_spaattn_tpu/eval):
dense-vs-sparse diff metrics, the generation loop, the gated quality
adapters and the ``run_eval`` entry point."""

from .diff_metrics import (
    evaluate_pair, ssim, psnr, rmse, relative_l1, cosine_similarity, lpips)
from .generation import generate_batch, load_prompts, safe_name
from .quality import (
    run_vbench, run_visionreward, clip_score, fid_score, image_reward,
    pick_score, write_scores, VBENCH_DIMENSIONS)

__all__ = [
    "evaluate_pair", "ssim", "psnr", "rmse", "relative_l1",
    "cosine_similarity", "lpips",
    "generate_batch", "load_prompts", "safe_name",
    "run_vbench", "run_visionreward", "clip_score", "fid_score",
    "image_reward", "pick_score",
    "write_scores", "VBENCH_DIMENSIONS",
]
