"""Video/image export (port of rectified_spaattn_tpu/utils/video.py;
reference: utils/save_video.py:11-31).

mp4 export needs imageio with an ffmpeg backend and png export needs PIL;
where either is missing (or fails), the frames are saved as a uint8
``.npy`` beside the requested path, so a run never fails on its I/O
dependencies.  Frames are numpy arrays: move tensors to the host first.
"""

from __future__ import annotations

import os

import numpy as np


def to_uint8(frames: np.ndarray) -> np.ndarray:
    """[-1,1] or [0,1] float frames [T,H,W,C] -> uint8."""
    frames = np.asarray(frames, dtype=np.float32)
    if frames.min() < -0.01:
        frames = (frames + 1.0) / 2.0
    return (np.clip(frames, 0.0, 1.0) * 255).round().astype(np.uint8)


def save_video(frames: np.ndarray, path: str, fps: int = 24) -> str:
    """Save [T,H,W,C] frames; returns the path actually written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames = to_uint8(frames)
    try:
        import imageio.v2 as imageio
        writer = imageio.get_writer(path, fps=fps, codec="libx264",
                                    quality=8)
        try:
            for f in frames:
                writer.append_data(f)
        finally:
            writer.close()
        return path
    except Exception:   # no imageio, no ffmpeg backend, or a codec error
        alt = os.path.splitext(path)[0] + ".npy"
        np.save(alt, frames)
        return alt


def save_image(image: np.ndarray, path: str) -> str:
    """Save one [H,W,C] frame as png (PIL) or the .npy fallback."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    img = to_uint8(image[None])[0]
    try:
        from PIL import Image
        Image.fromarray(img).save(path)
        return path
    except Exception:   # no PIL, or an encoder error
        alt = os.path.splitext(path)[0] + ".npy"
        np.save(alt, img)
        return alt
