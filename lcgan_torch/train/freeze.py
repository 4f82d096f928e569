"""freezeD parameter masking (worker.py:127-135, gate loader.py:52-53),
PyTorch port of ``lcgan_tpu.train.freeze``.

After ``freezeD_start`` iterations the first ``freezeD_layer + 2`` children
of the reference's ``shared_model`` stop training. The ``+2`` covers the
fromRGB 1×1 conv and its parameterless LeakyReLU, so the frozen set is

    from_rgb  +  block_0 .. block_{freezeD_layer-1}

The D step gives frozen leaves zero gradients (their Adam second moment
still decays, as in the JAX package) and does not apply their updates.
"""

from __future__ import annotations

from typing import List

from torch import nn


def freeze_mask(module: nn.Module, freezeD_layer: int) -> List[bool]:
    """One bool per ``module.named_parameters()`` entry, True == frozen."""
    frozen = {"from_rgb"} | {f"block_{i}" for i in range(freezeD_layer)}
    return [name.split(".", 1)[0] in frozen for name, _ in module.named_parameters()]
