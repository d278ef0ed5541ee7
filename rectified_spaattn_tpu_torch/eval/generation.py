"""Batch evaluation generation loop (port of
rectified_spaattn_tpu/eval/generation.py; reference:
eval/video/experiments/generation.py:69-93 + multigpu_*.py prompt
sharding).

Per-prompt seeded generation with outputs named ``{prompt}-{loop}``; shards
the prompt list across workers with the reference's interleaving.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..parallel.multihost import shard_prompts
from ..utils.video import save_image, save_video

log = logging.getLogger(__name__)


def safe_name(prompt: str, maxlen: int = 120) -> str:
    s = re.sub(r"[^\w\s-]", "", prompt).strip().replace(" ", "_")
    return s[:maxlen]


def to_host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a float numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def generate_batch(pipeline: Callable, prompts: Sequence[str], out_dir: str,
                   *, loops: int = 1, fps: int = 24, is_video: bool = True,
                   shard_index: int | None = None,
                   num_shards: int | None = None,
                   encode_fn: Callable | None = None,
                   write: bool = True) -> list[str]:
    """Run ``pipeline`` over this worker's prompt shard.

    ``pipeline(text_inputs..., seed=loop)`` must return decoded frames
    [T,H,W,C] (video) or [H,W,C] (image), as a tensor or an array; they are
    moved to the host and saved (utils/video.py: .mp4 / .png, or the uint8
    .npy fallback).  ``encode_fn(prompt)`` maps a prompt string to the
    pipeline's text inputs (tuple).  ``write`` False runs the pipeline and
    saves nothing (the tensor-parallel ranks past 0); the paths returned
    are those a writer would use."""
    if write:
        os.makedirs(out_dir, exist_ok=True)
    mine = shard_prompts(prompts, shard_index, num_shards)
    written = []
    for prompt in mine:
        inputs = encode_fn(prompt) if encode_fn else (prompt,)
        for loop in range(loops):
            t0 = time.time()
            out = to_host(pipeline(*inputs, seed=loop))
            path = os.path.join(out_dir, f"{safe_name(prompt)}-{loop}"
                                         + (".mp4" if is_video else ".png"))
            if write:
                path = (save_video(out, path, fps=fps) if is_video
                        else save_image(out, path))
            log.info("generated %s in %.1fs", path, time.time() - t0)
            written.append(path)
    return written


def center_crop_16_9(image: np.ndarray) -> np.ndarray:
    """Center-crop a [H,W,C] image to 16:9 (reference I2V prep:
    eval/video/vbench/crop_image.py)."""
    h, w = image.shape[:2]
    target = 16 / 9
    if w / h > target:
        new_w = int(round(h * target))
        x0 = (w - new_w) // 2
        return image[:, x0:x0 + new_w]
    new_h = int(round(w / target))
    y0 = (h - new_h) // 2
    return image[y0:y0 + new_h]


def load_prompt_image_pairs(path: str) -> list[tuple[str, str]]:
    """[(prompt, image_path)] pairs from a json list of dicts
    (reference: eval/video/vbench/get_prompt-image_pair.py)."""
    with open(path) as f:
        data = json.load(f)
    return [(d["prompt"], d.get("image", d.get("image_path", "")))
            for d in data]


def load_prompts(path: str, limit: int | None = None,
                 seed: int = 42) -> list[str]:
    """Prompt list from .json (list or [{'prompt': ...}]) or .txt lines;
    optional seeded subsample (reference samples 600 with seed 42,
    eval/video/vbench/get_prompts.py:14-52).  The subsample draws with
    numpy's ``default_rng(seed).choice``, as the JAX package does, so the
    same seed picks the same prompts."""
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        prompts = [d["prompt"] if isinstance(d, dict) else d for d in data]
    else:
        with open(path) as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
    if limit is not None and limit < len(prompts):
        rng = np.random.default_rng(seed)
        idx = rng.choice(len(prompts), size=limit, replace=False)
        prompts = [prompts[i] for i in sorted(idx)]
    return prompts
