"""The training views, worked out again from the JPEGs: decode, the shared
flip, the geometry view and the appearance view, in plain Python, numpy
and OpenCV.

The port's input pipeline has two paths, and the reference follows each:

* the Python path (``numpy.random.default_rng((seed, epoch, index))``, PIL
  and OpenCV), taken where the port's native loader cannot be built, as on a
  host without libjpeg's headers: ``python_triple``;
* the native loader (its own xoshiro256++ stream per sample, seeded from
  ``hash((seed, epoch, index))``): ``native_triple``, with the same draws in
  the same order, the same float widths and the same order of operations,
  and its scalars through the C library (``libm``), so that the views come
  out byte for byte.

The sampling order is the one of a distributed sampler at world size 1: a
permutation from ``numpy.random.default_rng((seed, epoch))``, batches in
order, the remainder dropped. Only pre-resized images are covered: a JPEG
whose side is not the configuration's resolution raises.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import List, Sequence, Tuple

import cv2
import numpy as np
from PIL import Image

_M64 = (1 << 64) - 1
_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
for _name, _n in (("log", 1), ("cos", 1), ("sqrt", 1), ("fmod", 2), ("hypot", 2), ("round", 1), ("floor", 1)):
    getattr(_LIBM, _name).restype = ctypes.c_double
    getattr(_LIBM, _name).argtypes = [ctypes.c_double] * _n
F32 = np.float32


def _rotl(v: int, k: int) -> int:
    return ((v << k) | (v >> (64 - k))) & _M64


class Rng:
    """splitmix64-seeded xoshiro256++, doubles from the top 53 bits."""

    def __init__(self, seed: int):
        x = seed & _M64
        self.s = []
        for _ in range(4):
            x = (x + 0x9E3779B97F4A7C15) & _M64
            z = x
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
            self.s.append(z ^ (z >> 31))

    def next(self) -> int:
        s = self.s
        r = (_rotl((s[0] + s[3]) & _M64, 23) + s[0]) & _M64
        t = (s[1] << 17) & _M64
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = _rotl(s[3], 45)
        return r

    def uniform(self, lo: float = 0.0, hi: float = 1.0) -> float:
        u = (self.next() >> 11) * (1.0 / 9007199254740992.0)
        return u if (lo, hi) == (0.0, 1.0) else lo + u * (hi - lo)

    def normal(self) -> float:
        u1 = max(self.uniform(), 1e-12)
        u2 = self.uniform()
        return _LIBM.sqrt(-2.0 * _LIBM.log(u1)) * _LIBM.cos(6.283185307179586 * u2)


def _clamp_u8(v: np.ndarray) -> np.ndarray:
    return np.minimum(F32(255), np.maximum(F32(0), v + F32(0.5))).astype(np.uint8)


def _solve_homography(src, dst):
    a = []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1.0, 0.0, 0.0, 0.0, -u * x, -u * y, u])
        a.append([0.0, 0.0, 0.0, x, y, 1.0, -v * x, -v * y, v])
    for col in range(8):
        piv = col
        for r in range(col + 1, 8):
            if abs(a[r][col]) > abs(a[piv][col]):
                piv = r
        if abs(a[piv][col]) < 1e-12:
            return None
        a[piv], a[col] = a[col], a[piv]
        for r in range(8):
            if r == col:
                continue
            f = a[r][col] / a[col][col]
            for k in range(col, 9):
                a[r][k] -= f * a[col][k]
    return [a[i][8] / a[i][i] for i in range(8)] + [1.0]


def _invert3x3(m):
    det = (m[0] * (m[4] * m[8] - m[5] * m[7]) - m[1] * (m[3] * m[8] - m[5] * m[6])
           + m[2] * (m[3] * m[7] - m[4] * m[6]))
    i = 1.0 / det
    return [(m[4] * m[8] - m[5] * m[7]) * i, (m[2] * m[7] - m[1] * m[8]) * i, (m[1] * m[5] - m[2] * m[4]) * i,
            (m[5] * m[6] - m[3] * m[8]) * i, (m[0] * m[8] - m[2] * m[6]) * i, (m[2] * m[3] - m[0] * m[5]) * i,
            (m[3] * m[7] - m[4] * m[6]) * i, (m[1] * m[6] - m[0] * m[7]) * i, (m[0] * m[4] - m[1] * m[3]) * i]


def _warp_perspective(img: np.ndarray, out_w: int, out_h: int, h) -> np.ndarray:
    """Inverse-mapped bilinear warp with a black border."""
    size = img.shape[0]
    hi = _invert3x3(h)
    y, x = np.meshgrid(np.arange(out_h, dtype=np.float64), np.arange(out_w, dtype=np.float64), indexing="ij")
    d = hi[6] * x + hi[7] * y + hi[8]
    horizon = np.abs(d) < 1e-12
    d = np.where(horizon, 1.0, d)
    sx = np.clip((hi[0] * x + hi[1] * y + hi[2]) / d, -2.0, size + 2.0)
    sy = np.clip((hi[3] * x + hi[4] * y + hi[5]) / d, -2.0, size + 2.0)
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = (sx - x0).astype(F32), (sy - y0).astype(F32)
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    src = img.astype(F32)
    acc = np.zeros((out_h, out_w, 3), F32)
    for dy, wy in ((0, F32(1) - fy), (1, fy)):
        yy = y0 + dy
        for dx, wx in ((0, F32(1) - fx), (1, fx)):
            xx = x0 + dx
            ok = (yy >= 0) & (yy < size) & (xx >= 0) & (xx < size)
            tap = src[np.clip(yy, 0, size - 1), np.clip(xx, 0, size - 1)]
            acc = acc + np.where(ok[..., None], (wy * wx)[..., None] * tap, F32(0))
    out = _clamp_u8(acc)
    out[horizon] = 0
    return out


def _bilinear_resize(img: np.ndarray, w_out: int, h_out: int) -> np.ndarray:
    """Half-pixel centres, edge clamp."""
    h_in, w_in = img.shape[:2]
    sxr, syr = w_in / w_out, h_in / h_out
    sy = (np.arange(h_out, dtype=np.float64) + 0.5) * syr - 0.5
    sx = (np.arange(w_out, dtype=np.float64) + 0.5) * sxr - 0.5
    y0, x0 = np.floor(sy), np.floor(sx)
    fy, fx = (sy - y0).astype(F32)[:, None, None], (sx - x0).astype(F32)[None, :, None]
    y0, x0 = y0.astype(np.int64), x0.astype(np.int64)
    ya, yb = np.clip(y0, 0, h_in - 1), np.clip(y0 + 1, 0, h_in - 1)
    xa, xb = np.clip(x0, 0, w_in - 1), np.clip(x0 + 1, 0, w_in - 1)
    src = img.astype(F32)
    r0, r1 = src[ya], src[yb]
    top = r0[:, xa] * (F32(1) - fx) + r0[:, xb] * fx
    bot = r1[:, xa] * (F32(1) - fx) + r1[:, xb] * fx
    return _clamp_u8(top * (F32(1) - fy) + bot * fy)


def _native_perspective(img: np.ndarray, rng: Rng) -> np.ndarray:
    size = img.shape[0]
    fit_output = rng.uniform() < 0.5
    scale = rng.uniform(0.05, 0.1)
    p = [[_LIBM.fmod(abs(rng.normal() * scale), 0.32) for _ in range(2)] for _ in range(4)]
    quad = [[p[0][0] * size, p[0][1] * size], [(1.0 - p[1][0]) * size, p[1][1] * size],
            [(1.0 - p[2][0]) * size, (1.0 - p[2][1]) * size], [p[3][0] * size, (1.0 - p[3][1]) * size]]

    def dist(a, b):
        return _LIBM.hypot(a[0] - b[0], a[1] - b[1])

    mw = max(2, int(max(float(int(dist(quad[2], quad[3]))), float(int(dist(quad[1], quad[0]))))))
    mh = max(2, int(max(float(int(dist(quad[1], quad[2]))), float(int(dist(quad[0], quad[3]))))))
    rect = [[0.0, 0.0], [mw - 1.0, 0.0], [mw - 1.0, mh - 1.0], [0.0, mh - 1.0]]
    h = _solve_homography(quad, rect)
    if h is None:
        return img.copy()
    if fit_output:
        frame = [[0.0, 0.0], [size - 1.0, 0.0], [size - 1.0, size - 1.0], [0.0, size - 1.0]]
        tc = []
        for fxy in frame:
            d = h[6] * fxy[0] + h[7] * fxy[1] + h[8]
            tc.append([(h[0] * fxy[0] + h[1] * fxy[1] + h[2]) / d, (h[3] * fxy[0] + h[4] * fxy[1] + h[5]) / d])
        mnx = min(1e30, *(t[0] for t in tc))
        mny = min(1e30, *(t[1] for t in tc))
        tc = [[_LIBM.round(t[0] - mnx), _LIBM.round(t[1] - mny)] for t in tc]
        mxx = max(0.0, *(t[0] for t in tc))
        mxy = max(0.0, *(t[1] for t in tc))
        h = _solve_homography(frame, tc)
        if h is None:
            return img.copy()
        mw, mh = int(mxx) + 1, int(mxy) + 1
    out = _warp_perspective(img, mw, mh, h)
    if (mw, mh) != (size, size):
        out = _bilinear_resize(out, size, size)
    return out


def _native_dropout(img: np.ndarray, rng: Rng) -> np.ndarray:
    size = img.shape[0]
    out = img.copy()
    hh = int(rng.uniform(0.3, 0.5) * size)
    ww = int(rng.uniform(0.3, 0.5) * size)
    y0 = int(rng.uniform() * (max(size - hh, 0) + 1))
    x0 = int(rng.uniform() * (max(size - ww, 0) + 1))
    out[y0:y0 + hh, x0:x0 + ww] = 0
    return out


def _rgb2hsv(r, g, b):
    mx = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    d = mx - mn
    s = np.where(mx > 0, d / np.where(mx > 0, mx, F32(1)), F32(0))
    safe = np.where(d > 0, d, F32(1))
    hh = np.where(mx == r, (g - b) / safe, np.where(mx == g, F32(2) + (b - r) / safe, F32(4) + (r - g) / safe))
    hh = hh / F32(6)
    hh = np.where(hh < 0, hh + F32(1), hh)
    return np.where(d > 0, hh, F32(0)).astype(F32), s.astype(F32), mx


def _hsv2rgb(h, s, v):
    h = h - np.floor(h)
    i = np.floor(h * F32(6))
    f = h * F32(6) - i
    p = v * (F32(1) - s)
    q = v * (F32(1) - f * s)
    t = v * (F32(1) - (F32(1) - f) * s)
    k = (i.astype(np.int64) % 6)[..., None]
    table = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = np.zeros(h.shape + (3,), F32)
    for case, rgb in enumerate(table):
        out = np.where(k == case, np.stack(rgb, axis=-1), out)
    return out


def _native_jitter(img: np.ndarray, rng: Rng) -> np.ndarray:
    strength = F32(0.2)
    order = [0, 1, 2, 3]
    for i in range(3, 0, -1):
        j = int(rng.uniform() * (i + 1))
        order[i], order[j] = order[j], order[i]
    lo, hi = float(F32(1) - strength), float(F32(1) + strength)
    fb = F32(rng.uniform(lo, hi))
    fc = F32(rng.uniform(lo, hi))
    fs = F32(rng.uniform(lo, hi))
    fh = F32(rng.uniform(-float(strength), float(strength)))
    buf = img.astype(F32)
    zero, top = F32(0), F32(255)
    for op in order:
        if op == 0:  # brightness
            buf = np.minimum(top, np.maximum(zero, buf * fb))
        elif op == 1:  # contrast: blend with the rounded mean grey, summed in order in double
            terms = 0.299 * buf[..., 0].astype(np.float64) + 0.587 * buf[..., 1] + 0.114 * buf[..., 2]
            mean = np.cumsum(terms.reshape(-1))[-1]
            gray = F32(_LIBM.round(mean / terms.size))
            buf = np.minimum(top, np.maximum(zero, buf * fc + gray * (F32(1) - fc)))
        elif op == 2:  # saturation: blend with the grey of each pixel
            gray = (F32(0.299) * buf[..., 0] + F32(0.587) * buf[..., 1] + F32(0.114) * buf[..., 2])[..., None]
            buf = np.minimum(top, np.maximum(zero, buf * fs + gray * (F32(1) - fs)))
        else:  # hue
            h, s, v = _rgb2hsv(buf[..., 0] / top, buf[..., 1] / top, buf[..., 2] / top)
            buf = _hsv2rgb(h + fh, s, v) * top
    return _clamp_u8(buf)


def decode(path: str, size: int) -> np.ndarray:
    img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
    if img.shape[:2] != (size, size):
        raise ValueError(f"{path}: {img.shape[1]}x{img.shape[0]}, the reference takes pre-resized {size}² images")
    return img


def native_triple(path: str, size: int, seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(image, geometry view, appearance view) of one file as the native
    loader makes them, uint8 HWC."""
    img = decode(path, size)
    rng = Rng(seed)
    if rng.uniform() < 0.5:
        img = img[:, ::-1].copy()
    geo = _native_perspective(img, rng)
    app = _native_dropout(img, rng) if rng.uniform() < 0.5 else _native_jitter(img, rng)
    return img, geo, app


# ----------------------------------------------------------------------
# the Python path: numpy's generator and OpenCV
# ----------------------------------------------------------------------
def _cv_perspective(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    fit_output = bool(rng.random() < 0.5)
    h, w = img.shape[:2]
    scale = rng.uniform(0.05, 0.1)
    pts = np.mod(np.abs(rng.normal(0.0, scale, (4, 2))), 0.32)
    quad = np.array([[pts[0, 0], pts[0, 1]], [1.0 - pts[1, 0], pts[1, 1]],
                     [1.0 - pts[2, 0], 1.0 - pts[2, 1]], [pts[3, 0], 1.0 - pts[3, 1]]],
                    np.float32) * np.array([w, h], np.float32)
    tl, tr, br, bl = quad
    mw = max(int(np.hypot(*(br - bl))), int(np.hypot(*(tr - tl))))
    mh = max(int(np.hypot(*(tr - br))), int(np.hypot(*(tl - bl))))
    dst = np.array([[0, 0], [mw - 1, 0], [mw - 1, mh - 1], [0, mh - 1]], np.float32)
    m = cv2.getPerspectiveTransform(quad, dst)
    if fit_output:  # the whole warped frame in view, sized to its rounded extents
        rect = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], np.float32)
        tc = cv2.perspectiveTransform(rect[None], m)[0]
        tc -= tc.min(axis=0, keepdims=True)
        tc = np.around(tc, decimals=0)
        m = cv2.getPerspectiveTransform(rect, tc.astype(np.float32))
        mw, mh = (int(v) for v in (tc.max(axis=0) + 1))
    out = cv2.warpPerspective(img, m, (mw, mh), flags=cv2.INTER_LINEAR, borderValue=0)
    if (mh, mw) != (h, w):
        out = cv2.resize(out, (w, h), interpolation=cv2.INTER_LINEAR)
    return out


def _cv_dropout(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    h, w = img.shape[:2]
    hole_h = int(rng.uniform(0.3, 0.5) * h)
    hole_w = int(rng.uniform(0.3, 0.5) * w)
    y = int(rng.integers(0, max(h - hole_h, 0) + 1))
    x = int(rng.integers(0, max(w - hole_w, 0) + 1))
    out = img.copy()
    out[y:y + hole_h, x:x + hole_w] = 0
    return out


def _cv_jitter(img: np.ndarray, rng: np.random.Generator, strength: float = 0.2) -> np.ndarray:
    out = img
    for op in list(rng.permutation(4)):
        if op == 0:  # brightness
            f = rng.uniform(1 - strength, 1 + strength)
            out = np.clip(out.astype(np.float32) * f, 0, 255).astype(np.uint8)
        elif op == 1:  # contrast: blend with the mean grey
            f = rng.uniform(1 - strength, 1 + strength)
            m = round(float(cv2.cvtColor(out, cv2.COLOR_RGB2GRAY).mean()))
            out = np.clip(out.astype(np.float32) * f + m * (1.0 - f), 0, 255).astype(np.uint8)
        elif op == 2:  # saturation: blend with the grey of each pixel
            f = rng.uniform(1 - strength, 1 + strength)
            gray = cv2.cvtColor(out, cv2.COLOR_RGB2GRAY)[..., None].repeat(3, axis=2)
            blend = out.astype(np.float32) * f + gray.astype(np.float32) * (1.0 - f)
            out = np.clip(blend, 0, 255).astype(np.uint8)
        else:  # hue, on OpenCV's uint8 wheel of 180
            f = rng.uniform(-strength, strength)
            hsv = cv2.cvtColor(out, cv2.COLOR_RGB2HSV)
            hsv[..., 0] = ((hsv[..., 0].astype(np.float32) + f * 180.0) % 180.0).astype(np.uint8)
            out = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    return out


def python_triple(path: str, size: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(image, geometry view, appearance view) of one file as the Python
    path makes them, uint8 HWC."""
    img = decode(path, size)
    if rng.random() < 0.5:
        img = img[:, ::-1].copy()
    geo = _cv_perspective(img, rng)
    app = _cv_dropout(img, rng) if rng.random() < 0.5 else _cv_jitter(img, rng)
    return img, geo, app


def to_model_range(img: np.ndarray) -> np.ndarray:
    out = img.astype(F32) / F32(255.0) * F32(2.0) - F32(1.0)
    return np.clip(out, F32(-1.0), F32(1.0))


def batch_indices(n_files: int, batch: int, seed: int, count: int) -> List[Tuple[int, np.ndarray]]:
    """(data epoch, file indices) of the first ``count`` batches."""
    out, epoch = [], 0
    while len(out) < count:
        order = np.random.default_rng((seed, epoch)).permutation(n_files)
        for b in range(n_files // batch):
            if len(out) == count:
                break
            out.append((epoch, order[b * batch:(b + 1) * batch]))
        epoch += 1
    return out


def batches(files: Sequence[str], size: int, batch: int, seed: int, count: int, native: bool) -> List[dict]:
    """The first ``count`` batches as (B, 3, H, W) float32 arrays in [-1, 1]:
    ``image``, ``geometry_change``, ``appearance_change``, as the native
    loader or the Python path makes them."""
    def one(epoch: int, i: int):
        if native:
            return native_triple(files[i], size, hash((seed, epoch, i)))
        return python_triple(files[i], size, np.random.default_rng((seed, epoch, i)))

    out = []
    for epoch, idxs in batch_indices(len(files), batch, seed, count):
        views = [one(epoch, int(i)) for i in idxs]
        out.append({key: np.stack([to_model_range(v[k]) for v in views]).transpose(0, 3, 1, 2).copy()
                    for k, key in enumerate(("image", "geometry_change", "appearance_change"))})
    return out
