"""Spatial filtering primitives (NCHW), PyTorch port of ``lcgan_tpu.ops.filters``.

  * box_filter_3x3 == ``avg_pool2d(k=3, s=1, p=1)`` with count_include_pad=True
    (custom_layers.py:136-138) — zero padding, divisor always 9. The filter
    is its own adjoint, so its gradient is the same filter applied to the
    cotangent: ``BoxFilter3x3`` runs ``avg_pool2d``'s forward both ways.
    PyTorch's own CUDA backward of this pool on channels_last features (the
    NHWC kernel) returned wrong gradients on an H100 (torch 2.11, CUDA
    12.8: max error 1.24 on gradients of magnitude 1.17, against the CPU),
    while its forward is exact.
  * avg_pool_2x2 == ``avg_pool2d(k=2, s=2, p=0)`` (custom_layers.py:202)
  * nearest_upsample_2x == ``F.interpolate(scale_factor=2, mode='nearest')``
    (custom_layers.py:146)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class BoxFilter3x3(torch.autograd.Function):
    """The 3x3 box filter with itself as its gradient (twice differentiable,
    as R1's double backward through the discriminator needs)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return BoxFilter3x3.apply(g)


def box_filter_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool with zero padding, divisor always 9."""
    return BoxFilter3x3.apply(x)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool, no padding."""
    return F.avg_pool2d(x, 2, stride=2)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2, gain: float = 1.0) -> torch.Tensor:
    """LeakyReLU with optional scalar gain."""
    y = F.leaky_relu(x, negative_slope)
    if gain != 1.0:
        y = y * gain
    return y
