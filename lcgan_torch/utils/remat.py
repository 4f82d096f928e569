"""Per-block activation checkpointing (rematerialization) with named saves,
the port's counterpart of the JAX package's ``nn.remat`` under
``jax.checkpoint_policies.save_only_these_names`` (lcgan_tpu/models/generator.py:270-293,
lcgan_tpu/models/discriminator.py:140-154).

``checkpoint_block(fn, *args, save_convs=...)`` runs ``fn`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward keeps
only the block's inputs, and each backward that reaches the block runs its
forward again to rebuild what the gradients need. With ``save_convs`` set,
the outputs of the convolutions called through ``saved_conv(True, ...)`` are
kept as well, and the recompute returns them instead of running those
convolutions again: every other value is recomputed, as the JAX policy does
(each block carries one of its names, "g_conv_out" or "d_conv_out").
Under ``torch.no_grad()`` (the D step's fakes, generation, FID, videos) the
block runs as a plain call.

The mark is on one call, so it selects that call's output tensor and not an
op kind: the blocks' unmarked skip 1×1 convolutions are the same aten op and
are recomputed. The kept outputs live as long as the block's autograd graph and
serve every recompute of it: R1's double backward recomputes the
discriminator's blocks twice (once for the gradient it differentiates and
once for the loss's own backward) and keeps the policy in both. (PyTorch's
selective checkpointing hands each kept output to one recompute only, and
raises on a second.)

The replay works below autograd, as a dispatch mode around the one
convolution: autograd records the convolution's node on the kept output, so
a recomputed graph is differentiable again as the first one was.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from lcgan_torch.utils import trace

_CONVOLUTION = torch.ops.aten.convolution.default
_active = threading.local()  # .saves: the _Saves of the region running or recomputing on this thread


class _Saves:
    """The kept convolution outputs of one checkpointed call, in call order."""

    def __init__(self):
        self.outputs: List[torch.Tensor] = []
        self.replaying = False
        self.next = 0


class _Region:
    """The context of one checkpointed call's forward (``replaying`` False)
    or of each of its recomputes (True). Re-enterable: every recompute
    starts again at the first kept output."""

    def __init__(self, saves: _Saves, replaying: bool):
        self.saves, self.replaying = saves, replaying

    def __enter__(self):
        self.outer = getattr(_active, "saves", None)
        self.saves.replaying, self.saves.next = self.replaying, 0
        _active.saves = self.saves

    def __exit__(self, *exc):
        _active.saves = self.outer


class _Recompute:
    """The ``remat.recompute`` span around each recompute of a checkpointed
    call, joined with the call's own recompute context (``inner``).
    Re-enterable: R1's double backward recomputes a block twice."""

    def __init__(self, inner=None):
        self.inner = inner if inner is not None else contextlib.nullcontext()
        self.open: List = []

    def __enter__(self):
        self.open.append(trace.span("remat.recompute"))
        self.open[-1].__enter__()
        self.inner.__enter__()

    def __exit__(self, *exc):
        self.inner.__exit__(*exc)
        self.open.pop().__exit__(*exc)


class _Replay(TorchDispatchMode):
    """Answers the one convolution it wraps with the kept output."""

    def __init__(self, output: torch.Tensor):
        super().__init__()
        self.output = output

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _CONVOLUTION:
            return self.output.detach()  # a fresh tensor object: each recompute's node owns its own
        return func(*args, **(kwargs or {}))


def saved_conv(save: bool, conv: Callable[..., torch.Tensor], *args, **kwargs) -> torch.Tensor:
    """``conv(*args, **kwargs)``, one convolution (``F.conv2d``,
    ``F.conv_transpose2d``), with its output, where ``save`` is set, kept by
    an enclosing ``checkpoint_block(..., save_convs=True)`` and replayed in
    its recomputes. Anywhere else a plain call."""
    saves: Optional[_Saves] = getattr(_active, "saves", None)
    if not save or saves is None:
        return conv(*args, **kwargs)
    if not saves.replaying:
        out = conv(*args, **kwargs)
        saves.outputs.append(out.detach())
        return out
    kept = saves.outputs[saves.next]
    saves.next += 1
    with _Replay(kept):
        return conv(*args, **kwargs)


def checkpoint_block(fn: Callable[..., torch.Tensor], *args, save_convs: bool = False) -> torch.Tensor:
    """``fn(*args)`` rematerialized in the backward, keeping the outputs of
    its ``saved_conv`` calls where ``save_convs`` is set (see the module
    docstring). The blocks draw no random
    numbers, so no RNG state is stashed for the recompute."""
    if not torch.is_grad_enabled():
        return fn(*args)
    if not save_convs:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(), _Recompute()))
    saves = _Saves()
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (_Region(saves, False), _Recompute(_Region(saves, True))))
