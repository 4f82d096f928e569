"""Spatial filtering primitives (NCHW), PyTorch port of ``lcgan_tpu.ops.filters``.

  * box_filter_3x3 == ``avg_pool2d(k=3, s=1, p=1)`` with count_include_pad=True
    (custom_layers.py:136-138) — zero padding, divisor always 9
  * nearest_upsample_2x == ``F.interpolate(scale_factor=2, mode='nearest')``
    (custom_layers.py:146)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def box_filter_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool with zero padding, divisor always 9."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2, gain: float = 1.0) -> torch.Tensor:
    """LeakyReLU with optional scalar gain."""
    y = F.leaky_relu(x, negative_slope)
    if gain != 1.0:
        y = y * gain
    return y
