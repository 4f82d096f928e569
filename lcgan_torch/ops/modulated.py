"""Modulated (StyleGAN2 mod/demod) convolution, PyTorch port of
``lcgan_tpu.ops.modulated``.

The algebraic form of the JAX package is kept: scale the input by the
styles, run ONE shared-weight conv, then demodulate,

    y[b,o] = conv(x[b] * s[b,:], W)[o] * d[b,o] + bias[o]
    d[b,o] = rsqrt( sum_i s[b,i]^2 * ||W[o,i]||^2 + eps )

which equals the reference's per-sample grouped conv (custom_layers.py:47-86).

``up=2`` is ``conv_transpose2d(stride=2, padding=(k-1)//2, output_padding=1)``
(custom_layers.py:74-80). Its weight is stored in the conv-transpose layout
(I, O, kh, kw) and is NOT flipped: the JAX package flips only because it
writes the transpose as an lhs-dilated direct conv.

``remat_save`` marks the RAW conv output, before the demod scale and the
bias, as the JAX package's ``checkpoint_name(..., "g_conv_out")`` does
(lcgan_tpu/ops/modulated.py:101-106,155): kept under a remat block's save
policy (``lcgan_torch.utils.remat``), a plain call otherwise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lcgan_torch.ops.equalized import EqualizedLinear, equalized_param, equalized_scale
from lcgan_torch.utils.remat import saved_conv


def modulated_conv2d(
    x: torch.Tensor,  # (B, I, H, W)
    styles: torch.Tensor,  # (B, I)
    weight: torch.Tensor,  # (O, I, k, k), or (I, O, k, k) for up=2; scaled, fp32
    bias: torch.Tensor,  # (O,), already lr_mul-scaled, fp32
    *,
    up: int = 1,
    eps: float = 1e-8,
    dtype: torch.dtype = torch.float32,
    remat_save: bool = False,
) -> torch.Tensor:
    """Functional mod/demod conv. See the module docstring for the form."""
    k = weight.shape[-1]
    pad = (k - 1) // 2

    # demod coefficient in fp32: d[b,o] = rsqrt(sum_i s^2[b,i] * wsq[i,o] + eps)
    wsq = weight.square().sum(dim=(2, 3))  # (O, I), or (I, O) for up=2
    if up == 1:
        wsq = wsq.t()
    sigma = styles.float().square() @ wsq
    demod = torch.rsqrt(sigma + eps)  # (B, O)

    xs = x.to(dtype) * styles.to(dtype)[:, :, None, None]
    w = weight.to(dtype)
    if up == 1:
        y = saved_conv(remat_save, F.conv2d, xs, w, padding=pad)
    elif up == 2:
        y = saved_conv(remat_save, F.conv_transpose2d, xs, w, stride=2, padding=pad, output_padding=1)
    else:
        raise ValueError(f"up must be 1 or 2, got {up}")
    # epilogue in the compute dtype
    y = y * demod.to(y.dtype)[:, :, None, None] + bias.to(y.dtype)[None, :, None, None]
    return y.to(dtype)


class ModulatedConv2d(nn.Module):
    """StyleGAN2 mod/demod conv module (custom_layers.py:47-86)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int,
        up: int = 1,
        eps: float = 1e-8,
        lr_mul: float = 1.0,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        remat_save: bool = False,
    ):
        super().__init__()
        k = kernel_size
        self.up, self.eps, self.lr_mul, self.dtype = up, eps, lr_mul, dtype
        self.remat_save = remat_save
        self.scale = equalized_scale(in_features * k * k, lr_mul)
        shape = (in_features, features, k, k) if up == 2 else (features, in_features, k, k)
        self.weight = equalized_param(shape, lr_mul, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        return modulated_conv2d(
            x,
            s,
            (self.weight * self.scale).float(),
            (self.bias * self.lr_mul).float(),
            up=self.up,
            eps=self.eps,
            dtype=self.dtype,
            remat_save=self.remat_save,
        )


class SynthesisLayer(nn.Module):
    """Style affine + modulated conv + optional fixed-noise add
    (custom_layers.py:89-111).

    ``use_noise`` (off everywhere in the reference, cnn.py:83,87) adds a
    fixed (resolution × resolution) noise image scaled by a learned scalar
    and a 0.01 gain. The image is a buffer, like the w-avg buffers.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        latent_dim: int,
        kernel_size: int = 3,
        up: int = 1,
        use_noise: bool = False,
        resolution: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        remat_save: bool = False,
    ):
        super().__init__()
        # style = EqualizedLinear(latent -> in_features, bias init 1.0)
        self.linear = EqualizedLinear(latent_dim, in_features, bias_init=1.0, generator=generator)
        self.modulated_conv = ModulatedConv2d(
            in_features, features, kernel_size, up=up, dtype=dtype, generator=generator, remat_save=remat_save
        )
        self.use_noise = use_noise
        if use_noise:
            if resolution is None:
                raise ValueError("use_noise needs the layer's output resolution")
            self.noise_strength = nn.Parameter(torch.zeros(()))
            self.register_buffer(
                "noise_const", torch.randn((resolution, resolution), generator=generator)
            )

    def forward(self, x: torch.Tensor, latent: torch.Tensor) -> torch.Tensor:
        y = self.modulated_conv(x, self.linear(latent))
        if self.use_noise:
            noise = self.noise_const * self.noise_strength * 0.01  # custom_layers.py:99
            y = y + noise.to(y.dtype)[None, None]
        return y
