"""Image grids (replaces torchvision make_grid/save_image, worker.py:365-379).

A copy of ``lcgan_tpu.utils.media``'s image half: that package's ``utils``
cannot be imported without orbax. PIL only.
"""

from __future__ import annotations

import math

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
