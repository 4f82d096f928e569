"""Mapping network (custom_layers.py:259-287) and projection heads
(custom_layers.py:290-306), PyTorch port of ``lcgan_tpu.ops.mapping``.

A learned linear factor L = orthogonalize(tanh(basis)) @ diag(|d| + eps)
applied to the noise, followed by an MLP of equalized linears with NO
activations. The QR runs in fp32 and is sign-fixed so that diag(R) >= 0,
and the MLP stays fp32 whatever the synthesis compute dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lcgan_torch.ops.equalized import EqualizedLinear


def orthogonalize(matrix: torch.Tensor) -> torch.Tensor:
    """Q of the reduced QR, sign-fixed so diag(R) >= 0 (custom_layers.py:274-276)."""
    q, r = torch.linalg.qr(matrix.float())
    sign = torch.sign(torch.diagonal(r))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return q * sign[None, :]


class MappingNetwork(nn.Module):
    """Linear factor + activation-free equalized MLP (custom_layers.py:259-287)."""

    def __init__(
        self,
        channels_list: Sequence[int],
        lr_mul: float = 0.01,
        eps: float = 1e-6,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        m = channels_list[0]
        self.eps = eps
        self.num_layers = len(channels_list) - 1
        self.diagonal_params = nn.Parameter(torch.randn((m,), generator=generator))
        self.basis_params = nn.Parameter(torch.randn((m, m), generator=generator))
        for idx in range(self.num_layers):
            self.add_module(
                f"mlp_{idx}",
                EqualizedLinear(
                    channels_list[idx], channels_list[idx + 1], lr_mul=lr_mul, generator=generator
                ),
            )

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        d = self.diagonal_params.float().abs() + self.eps
        l_factor = orthogonalize(torch.tanh(self.basis_params)) * d[None, :]  # == B @ diag(d)
        x = z.float() @ l_factor.t()  # x = L z, batched as rows
        for idx in range(self.num_layers):
            x = getattr(self, f"mlp_{idx}")(x)
        return x


class ProjectionHead(nn.Module):
    """Equalized-linear MLP with LeakyReLU(0.2) between hidden layers only
    (custom_layers.py:290-306)."""

    def __init__(
        self,
        channels_list: Sequence[int],
        lr_mul: float = 0.01,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_layers = len(channels_list) - 1
        for idx in range(self.num_layers):
            self.add_module(
                f"mlp_{idx}",
                EqualizedLinear(
                    channels_list[idx], channels_list[idx + 1], lr_mul=lr_mul, dtype=dtype, generator=generator
                ),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for idx in range(self.num_layers):
            x = getattr(self, f"mlp_{idx}")(x)
            if idx < self.num_layers - 1:
                x = F.leaky_relu(x, 0.2)
        return x
