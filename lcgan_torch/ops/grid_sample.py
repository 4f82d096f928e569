"""Bicubic grid sampling: coordinates and the plain PyTorch warp.

Semantics of torch ``F.grid_sample(x, grid, mode='bicubic',
padding_mode='zeros', align_corners=False)`` (custom_layers.py:162-165):
``fx = ((gx + 1) * W - 1) / 2``, the cubic convolution kernel with
A = -0.75, and zero contribution from taps outside the image.

``grid_sample_bicubic_plain`` is the 16-tap gather of
``lcgan_tpu.ops.grid_sample.grid_sample_bicubic`` written in torch ops, and
``grid_sample_bicubic_plain_backward`` its analytic gradient (the K'
weights of ``lcgan_tpu.ops.warp_pallas._dk``, the chain of ``_vjp_bwd``).
They are the CPU path of ``lcgan_torch.ops.warp.grid_sample_bicubic`` and
the references that the CUDA kernels are held against on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

A = -0.75  # torch cubic convolution constant


def cubic_weights(t: torch.Tensor):
    """The 4 bicubic tap weights for fractional offset t in [0, 1)."""

    def near(x):  # |x| <= 1
        return ((A + 2.0) * x - (A + 3.0)) * x * x + 1.0

    def far(x):  # 1 < |x| < 2
        return ((A * x - 5.0 * A) * x + 8.0 * A) * x - 4.0 * A

    return far(t + 1.0), near(t), near(1.0 - t), far(2.0 - t)


def cubic_weight_derivatives(t: torch.Tensor):
    """d/dt of the 4 tap weights: the analytic K'(t) torch's backward uses."""

    def dnear(x):
        return (3.0 * (A + 2.0) * x - 2.0 * (A + 3.0)) * x

    def dfar(x):
        return (3.0 * A * x - 10.0 * A) * x + 8.0 * A

    return dfar(t + 1.0), dnear(t), -dnear(1.0 - t), -dfar(2.0 - t)


def unnormalize(g: torch.Tensor, size: int) -> torch.Tensor:
    """align_corners=False pixel coordinate of normalized ``g``, clamped to
    [-3, size + 2]: beyond that every tap is off the image either way, and
    the clamp keeps floor() inside int32."""
    return (((g.float() + 1.0) * size - 1.0) * 0.5).clamp(-3.0, size + 2.0)


def grid_sample_bicubic_plain(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample ``x`` (B,C,H,W) at ``grid`` (B,Hg,Wg,2), (x, y) in [-1, 1].

    Interpolates in fp32 and returns the input dtype.
    """
    b, c, h, w = x.shape
    _, hg, wg, _ = grid.shape
    fx = unnormalize(grid[..., 0], w)
    fy = unnormalize(grid[..., 1], h)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = cubic_weights(fx - x0)
    wy = cubic_weights(fy - y0)
    ix0 = x0.long() - 1
    iy0 = y0.long() - 1

    flat = x.float().reshape(b, c, h * w)
    out = torch.zeros((b, c, hg * wg), dtype=torch.float32, device=x.device)
    for m in range(4):
        yy = iy0 + m
        vy = (yy >= 0) & (yy < h)
        for n in range(4):
            xx = ix0 + n
            valid = vy & (xx >= 0) & (xx < w)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(b, 1, hg * wg)
            v = torch.gather(flat, 2, idx.expand(b, c, hg * wg))
            wgt = torch.where(valid, wy[m] * wx[n], 0.0).reshape(b, 1, hg * wg)
            out = out + v * wgt
    return out.reshape(b, c, hg, wg).to(x.dtype)


def grid_sample_bicubic_plain_backward(
    x: torch.Tensor, grid: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of ``grid_sample_bicubic_plain(x, grid)`` for cotangent ``g``
    (B,C,Hg,Wg): ``(dx, dgrid)``.

    Accumulates in fp32 over the same 16 taps as the forward; dx is returned
    in x's dtype (B,C,H,W), dgrid in fp32 (B,Hg,Wg,2), chained through the
    unnormalization as ``(dfx · W/2, dfy · H/2)``. Taps off the image give 0.
    """
    b, c, h, w = x.shape
    _, hg, wg, _ = grid.shape
    fx = unnormalize(grid[..., 0], w)
    fy = unnormalize(grid[..., 1], h)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx, ty = fx - x0, fy - y0
    wx, wy = cubic_weights(tx), cubic_weights(ty)
    dwx, dwy = cubic_weight_derivatives(tx), cubic_weight_derivatives(ty)
    ix0 = x0.long() - 1
    iy0 = y0.long() - 1

    n = hg * wg
    flat = x.float().reshape(b, c, h * w)
    gf = g.float().reshape(b, c, n)
    dx = torch.zeros((b, c, h * w), dtype=torch.float32, device=x.device)
    sx = torch.zeros((b, c, n), dtype=torch.float32, device=x.device)  # d sample / d fx
    sy = torch.zeros((b, c, n), dtype=torch.float32, device=x.device)  # d sample / d fy
    for m in range(4):
        yy = iy0 + m
        vy = (yy >= 0) & (yy < h)
        for k in range(4):
            xx = ix0 + k
            valid = vy & (xx >= 0) & (xx < w)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(b, 1, n).expand(b, c, n)
            v = torch.gather(flat, 2, idx)
            sx = sx + v * torch.where(valid, wy[m] * dwx[k], 0.0).reshape(b, 1, n)
            sy = sy + v * torch.where(valid, dwy[m] * wx[k], 0.0).reshape(b, 1, n)
            dx.scatter_add_(2, idx, gf * torch.where(valid, wy[m] * wx[k], 0.0).reshape(b, 1, n))
    dfx = (gf * sx).sum(dim=1)
    dfy = (gf * sy).sum(dim=1)
    dgrid = torch.stack([dfx * (w * 0.5), dfy * (h * 0.5)], dim=-1).reshape(b, hg, wg, 2)
    return dx.reshape(b, c, h, w).to(x.dtype), dgrid


def max_warp_displacement(size: int, max_flow_scale: float) -> int:
    """Static displacement bound for the synthesis-block warp: the
    align_corners mismatch (0.5) + the tanh-bounded flow (max_flow_scale ·
    size/2) + the 2-tap cubic support. The CUDA kernels need no bound (the
    dx kernel measures its window from the grid); the tests use it to keep
    flows inside the JAX kernels' domain."""
    return int(math.ceil(0.5 + max_flow_scale * size / 2.0 + 2.0))


def identity_like_coordinates(
    b: int, h: int, w: int, device: Optional[torch.device] = None
) -> torch.Tensor:
    """The reference's coordinate grid (custom_layers.py:127-134).

    The quirk is kept: normalization uses (size-1), an align_corners=True
    grid, but sampling uses align_corners=False, so "identity" flow is a
    slight rescale, exactly as in the reference. Returns (B, H, W, 2) fp32
    with channel order (x, y).
    """
    ys = 2.0 * torch.arange(h, dtype=torch.float32, device=device) / (h - 1) - 1.0
    xs = 2.0 * torch.arange(w, dtype=torch.float32, device=device) / (w - 1) - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)[None].expand(b, h, w, 2)
