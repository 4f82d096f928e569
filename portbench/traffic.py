"""The general generator of the benchmark's inputs: a mix's parameters come
from ``traffic/<name>.json``; what they describe is made here from the run's
seed."""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent


def load(name: str, root: Path = HERE) -> dict:
    with open(root / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _jpeg(path: str, seed: int, index: int, size: int, quality: int) -> None:
    """A smooth colour field with grain, as photos compress."""
    rng = np.random.default_rng((seed, index))
    low = Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).resize((size, size), Image.BICUBIC)
    img = np.asarray(low, np.int16) + rng.integers(-8, 9, (size, size, 3))
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, quality=quality)


def jpeg_folder(root: str, seed: int, count: int, size: int, quality: int, threads: int = 4) -> List[str]:
    """``count`` seeded size² JPEGs under ``root/train/x`` (the image-folder
    layout the port reads), pre-resized as a prepared dataset is. Returns
    their paths in the folder's sorted order."""
    d = os.path.join(root, "train", "x")
    os.makedirs(d, exist_ok=True)
    paths = [os.path.join(d, f"{i:05d}.jpg") for i in range(count)]
    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(lambda i: _jpeg(paths[i], seed, i, size, quality), range(count)))
    return paths
