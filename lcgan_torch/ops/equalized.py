"""Equalized learning-rate layers (StyleGAN convention), PyTorch port of
``lcgan_tpu.ops.equalized``.

  * runtime weight scale ``c = lr_mul / sqrt(fan_in)`` with params initialized
    ``randn / lr_mul`` (custom_layers.py:7-14)
  * bias param initialized to a constant and multiplied by ``lr_mul`` in the
    forward pass (custom_layers.py:17-25, :28-44)

Layouts are PyTorch's: linear weights (out, in), conv weights OIHW. The
weight bridge (``lcgan_torch.convert``) transposes the Flax (in, out) and
HWIO leaves.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lcgan_torch.utils.remat import saved_conv


def equalized_scale(fan_in: int, lr_mul: float = 1.0) -> float:
    """He-style runtime scale: 1/sqrt(fan_in) * lr_mul (custom_layers.py:10)."""
    return lr_mul / math.sqrt(fan_in)


def equalized_param(shape, lr_mul: float, generator: Optional[torch.Generator]) -> nn.Parameter:
    """``randn / lr_mul``, drawn from ``generator``."""
    return nn.Parameter(torch.randn(shape, generator=generator) / lr_mul)


class EqualizedLinear(nn.Module):
    """Linear layer with equalized LR (custom_layers.py:17-25)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        bias_init: float = 0.0,
        lr_mul: float = 1.0,
        use_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.lr_mul = lr_mul
        self.dtype = dtype
        self.scale = equalized_scale(in_features, lr_mul)
        self.weight = equalized_param((features, in_features), lr_mul, generator)
        self.bias = nn.Parameter(torch.full((features,), float(bias_init))) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), (self.weight * self.scale).to(self.dtype))
        if self.bias is not None:
            y = y + self.bias * self.lr_mul
        return y.to(self.dtype)


class EqualizedConv2d(nn.Module):
    """Same-padding conv with equalized LR (custom_layers.py:28-44).

    ``stride=2`` is the discriminator blocks' ``conv1`` (k=3, padding 1).
    The JAX package's packed k=3 route is the same conv reordered for the
    TPU's matrix unit (used only at 1024² with Co <= 32); the port has no
    counterpart.

    ``remat_save`` marks the conv's output for a remat block's save policy
    (``lcgan_torch.utils.remat``): set on the discriminator blocks' ``conv0``
    and ``conv1``, the JAX package's "d_conv_out"
    (lcgan_tpu/models/discriminator.py:57-71). The JAX package names the
    output after the bias; the port keeps the
    conv's own output and recomputes the bias add, an elementwise op, so
    the recompute runs no convolution and keeps as many bytes.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int,
        stride: int = 1,
        no_bias: bool = False,
        lr_mul: float = 1.0,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        remat_save: bool = False,
    ):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.remat_save = remat_save
        self.lr_mul = lr_mul
        self.dtype = dtype
        self.scale = equalized_scale(in_features * k * k, lr_mul)
        self.weight = equalized_param((features, in_features, k, k), lr_mul, generator)
        self.bias = None if no_bias else nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        y = saved_conv(self.remat_save, F.conv2d, x.to(self.dtype), (self.weight * self.scale).to(self.dtype),
                       stride=self.stride, padding=k // 2)
        if self.bias is not None:
            y = y + (self.bias * self.lr_mul)[None, :, None, None]
        return y.to(self.dtype)
