"""Generator EMA (ema.py:4-32), PyTorch port of ``lcgan_tpu.train.ema``.

``p_ema = p + d·(p_ema − p)`` over parameters AND buffers (the w-avg
stats), updated in place. ``d`` is 0 before ``g_ema_start`` (a plain copy,
ema.py:19-23), else the fp32 decay.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def ema_update(model: nn.Module, ema: nn.Module, step: int, decay: float, start_iter: int) -> None:
    d = 0.0 if step < start_iter else float(np.float32(decay))
    for src, dst in ((list(model.parameters()), list(ema.parameters())),
                     (list(model.buffers()), list(ema.buffers()))):
        if not src:
            continue
        new = torch._foreach_sub(dst, src)
        torch._foreach_mul_(new, d)
        torch._foreach_add_(new, src)
        torch._foreach_copy_(dst, new)
