"""Triple-view augmentations (custom_dataset.py:19-49), numpy/cv2 host ops:
a copy of ``lcgan_tpu.data.augment``, which the port may not import. The
random draws are the same, so both packages make the same bytes.

The reference composes albumentations transforms; albumentations is not a
dependency here, so the same transform families are implemented directly on
numpy arrays (cv2 does the heavy lifting in C++ and releases the GIL):

  * geometry view  = random Perspective, two variants — fit_output=True
    (whole warped quad fits the frame, then resized back) and
    fit_output=False (warp in place), p=0.5 each
    (custom_dataset.py:22-23,27-33)
  * appearance view = CoarseDropout (1 hole, 30–50% of each side) OR
    ColorJitter (brightness/contrast/saturation/hue = 0.2, torchvision
    semantics, random order), p=0.5 each (custom_dataset.py:19-24,35-49)

Distributional note: exact per-sample parity with albumentations is neither
needed nor testable (the reference trains on random draws), but the
DISTRIBUTIONS are matched op by op: Perspective reproduces the 1.3-era
algorithm (inward |N(0, scale)| mod 0.32 corner jitter, quad→rect mapping,
keep_size resize, fit_output expand — see random_perspective), CoarseDropout
the inclusive placement bounds, ColorJitter the uint8 HSV hue semantics.

All functions take uint8 RGB HWC arrays and a ``numpy.random.Generator``.
"""

from __future__ import annotations

import cv2
import numpy as np


# ----------------------------------------------------------------------
# geometry view
# ----------------------------------------------------------------------
def random_perspective(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """albumentations.Perspective(scale=(0.05, 0.1), keep_size=True) parity.

    The reference applies exactly one of two variants per sample —
    fit_output=True or False, p=0.5 each (custom_dataset.py:22-23,29-33).
    albumentations (1.3-era, the reference installs -U) jitters each corner
    INWARD by |N(0, scale)| mod 0.32 of the side and maps that source quad
    TO an output rectangle sized by the quad's own extents:

      * fit_output=False → a border-free perspective crop-zoom of the quad
      * fit_output=True  → the transform is expanded so the whole warped
        source frame is visible (black wedges at the corners)

    then keep_size resizes back to (w, h) with bilinear. (An earlier
    implementation here drew SIGNED offsets and mapped frame→quad — the
    inverse direction, leaving black wedges in half the non-fit draws; a
    systematic distribution mismatch for the contrastive geometry view.)
    """
    fit_output = bool(rng.random() < 0.5)  # variant 1 vs 2 (p=0.5 each)
    h, w = img.shape[:2]
    scale = rng.uniform(0.05, 0.1)
    pts = np.mod(np.abs(rng.normal(0.0, scale, (4, 2))), 0.32)
    # inward corner jitter: tl, tr, br, bl. (albumentations re-orders the
    # points geometrically; with jitter < 0.32 of the side the natural
    # order is always already correct, so the sort is a no-op here.)
    quad = np.array(
        [
            [pts[0, 0], pts[0, 1]],
            [1.0 - pts[1, 0], pts[1, 1]],
            [1.0 - pts[2, 0], 1.0 - pts[2, 1]],
            [pts[3, 0], 1.0 - pts[3, 1]],
        ],
        np.float32,
    ) * np.array([w, h], np.float32)
    tl, tr, br, bl = quad
    mw = max(int(np.hypot(*(br - bl))), int(np.hypot(*(tr - tl))))
    mh = max(int(np.hypot(*(tr - br))), int(np.hypot(*(tl - bl))))
    dst = np.array([[0, 0], [mw - 1, 0], [mw - 1, mh - 1], [0, mh - 1]], np.float32)
    m = cv2.getPerspectiveTransform(quad, dst)
    if fit_output:
        # albumentations._expand_transform: carry the warped source frame
        # into view and size the output to its (rounded) extents
        rect = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], np.float32)
        tc = cv2.perspectiveTransform(rect[None], m)[0]
        tc -= tc.min(axis=0, keepdims=True)
        tc = np.around(tc, decimals=0)
        m = cv2.getPerspectiveTransform(rect, tc.astype(np.float32))
        mw, mh = (int(v) for v in (tc.max(axis=0) + 1))
    out = cv2.warpPerspective(img, m, (mw, mh), flags=cv2.INTER_LINEAR, borderValue=0)
    if (mh, mw) != (h, w):  # keep_size=True
        out = cv2.resize(out, (w, h), interpolation=cv2.INTER_LINEAR)
    return out


# ----------------------------------------------------------------------
# appearance view
# ----------------------------------------------------------------------
def coarse_dropout(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One black hole covering 30–50% of each side (custom_dataset.py:24)."""
    h, w = img.shape[:2]
    hole_h = int(rng.uniform(0.3, 0.5) * h)
    hole_w = int(rng.uniform(0.3, 0.5) * w)
    # +1: random.randint's INCLUSIVE upper bound (albumentations) — the hole
    # can sit flush with the bottom/right edge
    y = int(rng.integers(0, max(h - hole_h, 0) + 1))
    x = int(rng.integers(0, max(w - hole_w, 0) + 1))
    out = img.copy()
    out[y : y + hole_h, x : x + hole_w] = 0
    return out


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    out = a.astype(np.float32) * factor + b.astype(np.float32) * (1.0 - factor)
    return np.clip(out, 0, 255).astype(np.uint8)


def color_jitter(img: np.ndarray, rng: np.random.Generator, strength: float = 0.2) -> np.ndarray:
    """torchvision-style ColorJitter(b=c=s=h=0.2), ops in random order."""
    ops = list(rng.permutation(4))
    out = img
    for op in ops:
        if op == 0:  # brightness
            f = rng.uniform(1 - strength, 1 + strength)
            out = np.clip(out.astype(np.float32) * f, 0, 255).astype(np.uint8)
        elif op == 1:  # contrast: blend with (scalar) mean gray
            f = rng.uniform(1 - strength, 1 + strength)
            m = round(float(cv2.cvtColor(out, cv2.COLOR_RGB2GRAY).mean()))
            out = np.clip(
                out.astype(np.float32) * f + m * (1.0 - f), 0, 255
            ).astype(np.uint8)
        elif op == 2:  # saturation: blend with per-pixel gray
            f = rng.uniform(1 - strength, 1 + strength)
            gray = cv2.cvtColor(out, cv2.COLOR_RGB2GRAY)[..., None].repeat(3, axis=2)
            out = _blend(out, gray, f)
        else:  # hue shift in [-0.2, 0.2] of the wheel
            f = rng.uniform(-strength, strength)
            hsv = cv2.cvtColor(out, cv2.COLOR_RGB2HSV)
            # cv2 uint8 hue range is [0,180); float shift + truncating cast
            # (albumentations' uint8 LUT semantics, not a pre-rounded int)
            hsv[..., 0] = ((hsv[..., 0].astype(np.float32) + f * 180.0) % 180.0).astype(
                np.uint8
            )
            out = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    return out


def random_appearance_transform(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """CoarseDropout or ColorJitter, p=0.5 each (custom_dataset.py:35-41)."""
    if rng.random() < 0.5:
        return coarse_dropout(img, rng)
    return color_jitter(img, rng)


def random_geometry_transform(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return random_perspective(img, rng)


def to_model_range(img: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1,1], clamped (custom_dataset.py:81-86)."""
    out = img.astype(np.float32) / 255.0 * 2.0 - 1.0
    return np.clip(out, -1.0, 1.0)
