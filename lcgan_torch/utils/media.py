"""Image grids and video writing (replaces torchvision make_grid/save_image
and the PyAV mp4 writer, worker.py:365-379).

A copy of ``lcgan_tpu.utils.media``: that package's ``utils`` cannot be
imported without orbax. Video backend order: OpenCV ``VideoWriter`` (mp4v)
→ imageio → animated GIF via PIL as the last resort.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import numpy as np
from PIL import Image


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float [0,1] HWC -> uint8."""
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 0) -> np.ndarray:
    """torchvision.utils.make_grid semantics for NHWC float [0,1] arrays."""
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nr = math.ceil(n / ncol)
    grid = np.zeros((nr * (h + padding), ncol * (w + padding), c), images.dtype)
    for idx in range(n):
        r, col = divmod(idx, ncol)
        grid[r * (h + padding) : r * (h + padding) + h, col * (w + padding) : col * (w + padding) + w] = images[idx]
    return grid


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8, padding: int = 0):
    """images: NHWC float in [0,1]."""
    grid = make_grid(images, nrow=nrow, padding=padding)
    Image.fromarray(to_uint8(grid)).save(path)


def resize_frame(img: np.ndarray, size_hw) -> np.ndarray:
    """Bilinear resize of a float [0,1] HWC frame (monitor downscaling,
    worker.py:286)."""
    pil = Image.fromarray(to_uint8(img))
    pil = pil.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
    return np.asarray(pil, np.uint8)


def save_video(frames: Sequence[np.ndarray], path: str, fps: int):
    """frames: list of uint8 RGB HWC arrays, all same size."""
    if not frames:
        return
    h, w = frames[0].shape[:2]
    try:
        import cv2

        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if writer.isOpened():
            for f in frames:
                writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            writer.release()
            if os.path.getsize(path) > 0:
                return
    except Exception:  # a missing or broken cv2 or codec: the next backend
        pass
    try:
        import imageio

        imageio.mimwrite(path, list(frames), fps=fps)
        return
    except Exception:  # a missing imageio or writer plugin: the GIF below
        pass
    gif_path = os.path.splitext(path)[0] + ".gif"
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(gif_path, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0)
