"""The plain reference of one LC-GAN training iteration: the G step, the
EMA, then the D step on the updated generator's fakes (loader.py:45-54,
worker.py:137-214), with Adam at beta1 0 and the losses of ``loss.py``.

The variant follows the iteration's index in the schedule: even indices
train with the contrastive and sparsity terms, odd ones without, and every
8th from 1 adds R1 to the D step. The six noise draws of an iteration
(z_g1, z_g2, z_r1, z_r2, z_d1, z_d2) are taken in that order from a
``torch.Generator`` on the run's device, seeded from the run's seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.model import (BUFFERS, FP32, Params, Precision, Sizes, WarpLog, discriminator, generator,
                                       mapping, update_averages)


@dataclasses.dataclass(frozen=True)
class Recipe:
    """The loss weights and optimizer settings of a configuration."""

    g_lr: float = 0.002
    d_lr: float = 0.002
    beta2: float = 0.99
    adam_eps: float = 1e-8
    tau: float = 0.05
    l_aux: float = 0.5
    l_r1: float = 10.0
    l_s: float = 1e-7
    g_ema_decay: float = 0.9999
    g_ema_start: int = 0

    @classmethod
    def of(cls, flags: dict) -> "Recipe":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in flags.items() if k in names})


def variant(index: int) -> str:
    return "even" if index % 2 == 0 else "odd_r1" if index % 8 == 1 else "odd"


def bce(logit: torch.Tensor, target: float) -> torch.Tensor:
    return F.softplus(-logit if target == 1.0 else logit).mean()


def contrastive(anchor: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor, tau: float) -> torch.Tensor:
    p = (anchor * pos).sum(dim=-1)
    n = (anchor * neg).sum(dim=-1)
    return F.softplus((n - p) / tau).mean()


@dataclasses.dataclass
class State:
    """Generator (with its w averages), discriminator, EMA, Adam's second
    moments and step count."""

    g: Params
    d: Params
    ema: Params
    g_v: Params
    d_v: Params
    step: int = 0

    @classmethod
    def start(cls, g: Params, d: Params) -> "State":
        g = {k: v.detach().clone().requires_grad_(k not in BUFFERS) for k, v in g.items()}
        d = {k: v.detach().clone().requires_grad_(True) for k, v in d.items()}
        ema = {k: v.detach().clone() for k, v in g.items()}
        zeros = lambda p: {k: torch.zeros_like(v) for k, v in p.items() if k not in BUFFERS}  # noqa: E731
        return cls(g=g, d=d, ema=ema, g_v=zeros(g), d_v=zeros(d))


def _adam(params: Params, v: Params, grads: Dict[str, torch.Tensor], lr: float, r: Recipe, count: int) -> None:
    correction = float(np.float32(1.0) - np.float32(r.beta2) ** np.float32(count))
    with torch.no_grad():
        for k, g in grads.items():
            v[k].mul_(r.beta2).add_(g * g * (1.0 - r.beta2))
            params[k].add_(-lr * g / ((v[k] / correction).sqrt() + r.adam_eps))


def _grads(loss: torch.Tensor, params: Params, names: List[str]) -> Dict[str, torch.Tensor]:
    got = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, got)}


def _accumulate(total: Dict[str, torch.Tensor], loss: torch.Tensor, params: Params, names: List[str]) -> None:
    for k, g in _grads(loss, params, names).items():
        total[k] = g if k not in total else total[k] + g


def iteration(st: State, s: Sizes, r: Recipe, batch: Dict[str, torch.Tensor], noise, index: int, *,
              prec: Precision = FP32, warps: Optional[WarpLog] = None, fault: str = "",
              blocks: int = 1) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One iteration on ``st`` (updated in place). Returns (g_loss, d_loss,
    G's gradients, D's gradients), the losses as detached scalars.

    ``blocks`` > 1 works the batch out in that many blocks of rows, block m
    holding rows m, m + blocks, m + 2·blocks, …: with ``blocks`` = batch /
    8 each block is one whole group of the minibatch stddev, and every other
    term is a mean over rows, so each block's losses, weighted by its share
    of the rows, add up to the batch's and their gradients to its gradients.
    The w averages are updated from the whole batch's codes. ``fault``
    plants one: ``half_batch``, each loss the mean over the first half of
    the rows of each block; ``odd_d_skipped``, the odd variant's D step
    leaves D and its Adam state as they were."""
    if fault not in ("", "half_batch", "odd_d_skipped"):
        raise ValueError(f"no fault {fault!r}")
    kind = variant(index)
    z_g1, z_g2, z_r1, z_r2, z_d1, z_d2 = noise
    n = z_g1.shape[0]
    parts = [slice(m, None, blocks) for m in range(blocks)]
    cut = (lambda t: t[: t.shape[0] // 2]) if fault == "half_batch" else (lambda t: t)  # noqa: E731
    whole = blocks == 1

    def share(rows: slice) -> float:
        return len(range(n)[rows]) / n

    def g_net(a, b, rows):
        return generator(st.g, s, a[rows], b[rows], prec=prec, warps=warps, update_avg=whole)

    def averages(a, b):  # the w averages from the whole batch, as one call on it would move them
        if not whole:
            with torch.no_grad():
                update_averages(st.g, mapping(st.g, "geometry_mapping", a, prec),
                                mapping(st.g, "appearance_mapping", b, prec))

    def d_net(img, emb=False):
        return discriminator(st.d, s, img, emb, prec=prec)

    def aux(gf, gp, gn, af, ap, an):
        return (contrastive(cut(gf), cut(gp), cut(gn), r.tau) + contrastive(cut(af), cut(ap), cut(an), r.tau)) * r.l_aux

    # G step
    g_names = [k for k in st.g if k not in BUFFERS]
    g_grads: Dict[str, torch.Tensor] = {}
    g_loss = torch.zeros((), device=z_g1.device)
    if kind == "even":
        for a, b in ((z_g1, z_g2), (z_r1, z_g2), (z_g1, z_r2)):
            averages(a, b)
        sp = torch.cat([st.g["geometry_mapping.diagonal_params"], st.g["appearance_mapping.diagonal_params"]]).abs().sum()
        _accumulate(g_grads, sp * r.l_s, st.g, g_names)
        g_loss = g_loss + (sp * r.l_s).detach()
        for rows in parts:
            anchor, res_geo, res_app = g_net(z_g1, z_g2, rows), g_net(z_r1, z_g2, rows), g_net(z_g1, z_r2, rows)
            logit, gf, af = d_net(anchor, True)
            _, gp, an = d_net(res_geo, True)
            _, gn, ap = d_net(res_app, True)
            loss = (bce(cut(logit), 1.0) + aux(gf, gp, gn, af, ap, an)) * share(rows)
            _accumulate(g_grads, loss, st.g, g_names)
            g_loss = g_loss + loss.detach()
    else:
        averages(z_g1, z_g2)
        for rows in parts:
            loss = bce(cut(d_net(g_net(z_g1, z_g2, rows))[0]), 1.0) * share(rows)
            _accumulate(g_grads, loss, st.g, g_names)
            g_loss = g_loss + loss.detach()
    _adam(st.g, st.g_v, g_grads, r.g_lr, r, st.step + 1)

    # EMA of parameters and w averages
    decay = 0.0 if st.step < r.g_ema_start else float(np.float32(r.g_ema_decay))
    with torch.no_grad():
        for k, v in st.g.items():
            st.ema[k].copy_(v + decay * (st.ema[k] - v))

    # D step
    averages(z_d1, z_d2)
    with torch.no_grad():
        fakes = [g_net(z_d1, z_d2, rows) for rows in parts]
    d_names = list(st.d)
    d_grads: Dict[str, torch.Tensor] = {}
    d_loss = torch.zeros((), device=z_g1.device)
    for rows, fake in zip(parts, fakes):
        image = batch["image"][rows]
        fake_loss = bce(cut(d_net(fake)[0]), 0.0)
        if kind == "even":
            real, gf, af = d_net(image, True)
            _, gp, an = d_net(batch["geometry_change"][rows], True)
            _, gn, ap = d_net(batch["appearance_change"][rows], True)
            loss = bce(cut(real), 1.0) + fake_loss + aux(gf, gp, gn, af, ap, an)
        elif kind == "odd_r1":
            img = image.detach().requires_grad_(True)
            real = d_net(img)[0]
            (grad,) = torch.autograd.grad(real.sum(), img, create_graph=True)
            r1 = 0.5 * cut(grad).square().reshape(cut(grad).shape[0], -1).sum(dim=1).mean()
            loss = bce(cut(real), 1.0) + fake_loss + r1 * r.l_r1
        else:
            loss = bce(cut(d_net(image)[0]), 1.0) + fake_loss
        loss = loss * share(rows)
        _accumulate(d_grads, loss, st.d, d_names)
        d_loss = d_loss + loss.detach()
    if not (fault == "odd_d_skipped" and kind == "odd"):
        _adam(st.d, st.d_v, d_grads, r.d_lr, r, st.step + 1)
    st.step += 1
    return g_loss, d_loss, g_grads, d_grads


def noise_draws(sizes: Sizes, batch: int, seed: int, count: int, device) -> list:
    """The six draws of each of the first ``count`` iterations."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = (sizes.geo_noise_dim, sizes.app_noise_dim) * 3
    return [tuple(torch.randn((batch, d), generator=gen, device=device) for d in dims) for _ in range(count)]
