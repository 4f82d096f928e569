"""Minibatch standard-deviation layer (custom_layers.py:237-256), PyTorch
port of ``lcgan_tpu.ops.mbstd``.

The grouping is the reference's: a row-major reshape of the batch into
(G, N//G), so group member g of slot m is sample g·(N//G) + m, and the
statistic is tiled back over the G members. Computed in fp32, returned in
x's dtype.
"""

from __future__ import annotations

import torch


def minibatch_stddev(x: torch.Tensor, group_size: int = 8, num_channels: int = 1) -> torch.Tensor:
    """Append the per-group feature stddev as extra channel(s). x: (N, C, H, W)."""
    n, c, h, w = x.shape
    g = min(group_size, n)
    f = num_channels
    y = x.float().reshape(g, n // g, f, c // f, h, w)
    y = y - y.mean(dim=0, keepdim=True)
    y = (y.square().mean(dim=0) + 1e-8).sqrt()  # (N//G, F, C//F, H, W)
    y = y.mean(dim=(2, 3, 4))  # (N//G, F)
    y = y.repeat(g, 1).reshape(n, f, 1, 1).expand(n, f, h, w).to(x.dtype)
    return torch.cat([x, y], dim=1)
