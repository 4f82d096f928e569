"""Minibatch standard-deviation layer (custom_layers.py:237-256), PyTorch
port of ``lcgan_tpu.ops.mbstd``.

The grouping is the reference's: a row-major reshape of the batch into
(G, N//G), so group member g of slot m is sample g·(N//G) + m, and the
statistic is tiled back over the G members. Computed in fp32, returned in
x's dtype.

``num_views > 1``: the batch is that many view-batches stacked along it
(the view-batched train step, ``train.steps``), and each view gets the
statistic a call on it alone would give; the grouping reshape is strided, so
treating the stack as one batch would mix views. The views are one more
leading axis of the same reshape, not a loop.
"""

from __future__ import annotations

import torch


def minibatch_stddev(x: torch.Tensor, group_size: int = 8, num_channels: int = 1, num_views: int = 1) -> torch.Tensor:
    """Append the per-group feature stddev as extra channel(s). x: (N, C, H, W)."""
    n, c, h, w = x.shape
    if n % num_views:
        raise ValueError(f"a batch of {n} does not split into {num_views} views")
    v = num_views
    nv = n // v
    g = min(group_size, nv)
    f = num_channels
    y = x.float().reshape(v, g, nv // g, f, c // f, h, w)
    y = y - y.mean(dim=1, keepdim=True)
    y = (y.square().mean(dim=1) + 1e-8).sqrt()  # (V, N//G, F, C//F, H, W)
    y = y.mean(dim=(3, 4, 5))  # (V, N//G, F)
    y = y.repeat(1, g, 1).reshape(n, f, 1, 1).expand(n, f, h, w).to(x.dtype)
    return torch.cat([x, y], dim=1)
