"""Loss library (loss.py:9-34, worker.py:151-210), PyTorch port of
``lcgan_tpu.losses``.

Both adversarial and contrastive terms use the softplus forms. R1 is a
double backward: ``torch.autograd.grad(create_graph=True)`` of the summed
logits with respect to the image, and the same logits feed the adversarial
term (worker.py:152-160). The reference's ``+ images[:,0,0,0].mean()*0``
DDP unused-parameter hack (loss.py:23) is not needed and is dropped.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def contrastive_loss(anchor: torch.Tensor, p_sample: torch.Tensor, n_sample: torch.Tensor, tau: float) -> torch.Tensor:
    """Pairwise InfoNCE (loss.py:9-15):
    -log(e^{p/tau} / (e^{p/tau} + e^{n/tau})) == softplus((n - p)/tau)."""
    anchor = anchor.float()
    p = (anchor * p_sample.float()).sum(dim=-1)
    n = (anchor * n_sample.float()).sum(dim=-1)
    return F.softplus((n - p) / tau).mean()


def bce_logits(logit: torch.Tensor, target: float) -> torch.Tensor:
    """binary_cross_entropy_with_logits against a constant 0/1 label."""
    logit = logit.float()
    if target == 1.0:
        return F.softplus(-logit).mean()
    if target == 0.0:
        return F.softplus(logit).mean()
    return (F.softplus(logit) - target * logit).mean()


def r1_penalty_with_logits(
    logit_fn: Callable[[torch.Tensor], torch.Tensor], images: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward: (logits, r1) with r1 = ½·E_b ||∂(Σ logits)/∂image_b||².

    The gradient is taken with ``create_graph=True``, so r1 can be
    differentiated again with respect to the discriminator's parameters
    (and the image, if it already requires grad).
    """
    if not images.requires_grad:
        images = images.detach().requires_grad_(True)
    logits = logit_fn(images)
    (grads,) = torch.autograd.grad(logits.float().sum(), images, create_graph=True)
    grads = grads.float()
    r1 = 0.5 * grads.square().reshape(images.shape[0], -1).sum(dim=1).mean()
    return logits, r1


def sparsity_loss(diagonal_params1: torch.Tensor, diagonal_params2: torch.Tensor) -> torch.Tensor:
    """L1 norm of both mapping nets' diagonal params (worker.py:207-209)."""
    return torch.cat([diagonal_params1.reshape(-1).float(), diagonal_params2.reshape(-1).float()]).abs().sum()
