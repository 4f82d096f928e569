"""Train state: models, optimizer states, step and noise stream, PyTorch
port of ``lcgan_tpu.train.state``.

The JAX package keeps everything in one immutable pytree; here the state is
a container of modules and tensors that the train iteration updates in
place (parameters, buffers, Adam moments), which keeps one copy of each.
``TrainState.state_dict`` / ``load_state_dict`` carry all of it, the noise
generator's state included, through a checkpoint (``utils.checkpoint``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from lcgan_torch.config import Config
from lcgan_torch.models.discriminator import Discriminator, build_discriminator
from lcgan_torch.models.generator import Generator, build_generator


class AdamNoMu:
    """Adam with beta1 == 0, ``_adam_no_mu`` (lcgan_tpu/train/state.py:70-93)
    ported as written: the first moment IS the gradient, so only ``v`` and
    ``count`` are kept, and the update is ``-lr·g / (sqrt(v / (1 − b2^t)) + eps)``.

    Unlike ``torch.optim.Adam``, every leaf steps every time: a frozen leaf
    gets a zero gradient, its ``v`` decays, and its update is not applied
    (``steps.py:277-281``).
    """

    def __init__(self, module: nn.Module, lr: float, b2: float, eps: float):
        self.lr, self.b2, self.eps = lr, b2, eps
        self.v = {name: torch.zeros_like(p) for name, p in module.named_parameters()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             frozen: Optional[Sequence[bool]] = None) -> None:
        """Update ``params`` (in ``named_parameters`` order) in place."""
        self.count += 1
        v = list(self.v.values())
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - self.b2)
        correction = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
        denom = torch._foreach_div(v, correction)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_mul(grads, -self.lr)
        torch._foreach_div_(updates, denom)
        live = [i for i in range(len(params)) if not (frozen and frozen[i])]
        torch._foreach_add_([params[i] for i in live], [updates[i] for i in live])

    def state_dict(self) -> dict:
        return {"v": {k: t.detach().to("cpu", copy=True) for k, t in self.v.items()}, "count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        if sd["v"].keys() != self.v.keys():
            raise KeyError(f"Adam v leaves differ: {sorted(sd['v'].keys() ^ self.v.keys())}")
        with torch.no_grad():
            for k, t in sd["v"].items():
                self.v[k].copy_(t)
        self.count = int(sd["count"])


class Adam:
    """Adam with a first moment, for ``beta1 != 0``: optax's ``adam``
    (``scale_by_adam`` + ``scale_by_learning_rate``, as lcgan_tpu/train/state.py:99-103
    builds it) in its order of operations: ``mu ← b1·mu + (1−b1)·g``,
    ``v ← b2·v + (1−b2)·g²``, both bias-corrected by ``1 − b^count``, and the
    update ``−lr · mû / (sqrt(v̂) + eps)``.

    Frozen leaves as in ``AdamNoMu``: a zero gradient, both moments decay,
    no update. The state carries ``mu``, ``v`` and ``count``.
    """

    def __init__(self, module: nn.Module, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = {name: torch.zeros_like(p) for name, p in module.named_parameters()}
        self.v = {name: torch.zeros_like(p) for name, p in module.named_parameters()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             frozen: Optional[Sequence[bool]] = None) -> None:
        """Update ``params`` (in ``named_parameters`` order) in place."""
        self.count += 1
        mu, v = list(self.mu.values()), list(self.v.values())
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        torch._foreach_mul_(v, self.b2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - self.b2))
        c1, c2 = (float(np.float32(1.0) - np.float32(b) ** np.float32(self.count)) for b in (self.b1, self.b2))
        denom = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, c1)
        torch._foreach_div_(updates, denom)
        torch._foreach_mul_(updates, -self.lr)
        live = [i for i in range(len(params)) if not (frozen and frozen[i])]
        torch._foreach_add_([params[i] for i in live], [updates[i] for i in live])

    def state_dict(self) -> dict:
        return {name: {k: t.detach().to("cpu", copy=True) for k, t in getattr(self, name).items()}
                for name in ("mu", "v")} | {"count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        for name in ("mu", "v"):
            mine = getattr(self, name)
            if sd[name].keys() != mine.keys():
                raise KeyError(f"Adam {name} leaves differ: {sorted(sd[name].keys() ^ mine.keys())}")
            with torch.no_grad():
                for k, t in sd[name].items():
                    mine[k].copy_(t)
        self.count = int(sd["count"])


Optimizer = Union[AdamNoMu, Adam]


def _module_state(module: nn.Module) -> dict:
    """Parameters and buffers, copied to the CPU."""
    return {k: v.detach().to("cpu", copy=True) for k, v in module.state_dict().items()}


@dataclasses.dataclass
class TrainState:
    step: int
    generator: Generator  # g_params and the g_stats buffers
    discriminator: Discriminator
    ema: Generator  # ema_params and ema_stats
    g_opt: Optimizer
    d_opt: Optimizer
    rng: torch.Generator  # the iterations' noise, on the run's device

    def state_dict(self) -> dict:
        """Everything a bit-exact resume needs, as CPU tensors and ints."""
        return {
            "step": self.step,
            "generator": _module_state(self.generator),
            "discriminator": _module_state(self.discriminator),
            "ema": _module_state(self.ema),
            "g_opt": self.g_opt.state_dict(),
            "d_opt": self.d_opt.state_dict(),
            "rng": self.rng.get_state(),
        }

    def load_state_dict(self, sd: dict) -> None:
        """Restore ``state_dict()``'s output in place (values copied into the
        existing tensors, which keep their device and memory format)."""
        self.generator.load_state_dict(sd["generator"])
        self.discriminator.load_state_dict(sd["discriminator"])
        self.ema.load_state_dict(sd["ema"])
        self.g_opt.load_state_dict(sd["g_opt"])
        self.d_opt.load_state_dict(sd["d_opt"])
        self.rng.set_state(sd["rng"])
        self.step = int(sd["step"])


def build_models(cfg: Config, generator: Optional[torch.Generator] = None) -> Tuple[Generator, Discriminator]:
    """G and D on the CPU, drawn from ``generator`` in that order."""
    return build_generator(cfg, generator), build_discriminator(cfg, generator)


def make_optimizers(cfg: Config, g: nn.Module, d: nn.Module) -> Tuple[Optimizer, Optimizer]:
    # Adam (beta1=0.0, beta2=0.99, eps=1e-8), worker.py:98-110; optax.adam otherwise
    if cfg.beta1 == 0.0:
        return AdamNoMu(g, cfg.g_lr, cfg.beta2, cfg.adam_eps), AdamNoMu(d, cfg.d_lr, cfg.beta2, cfg.adam_eps)
    return (Adam(g, cfg.g_lr, cfg.beta1, cfg.beta2, cfg.adam_eps),
            Adam(d, cfg.d_lr, cfg.beta1, cfg.beta2, cfg.adam_eps))


def create_train_state(cfg: Config, device: torch.device, seed: Optional[int] = None) -> TrainState:
    """Seeded models on ``device`` (channels_last); EMA starts as an exact
    copy (ema.py:12-17); the noise stream is seeded from the same seed."""
    seed = cfg.seed if seed is None else seed
    g, d = build_models(cfg, torch.Generator().manual_seed(seed))
    g = g.to(device, memory_format=torch.channels_last).train()
    d = d.to(device, memory_format=torch.channels_last).train()
    ema = copy.deepcopy(g).eval()
    g_opt, d_opt = make_optimizers(cfg, g, d)
    rng = torch.Generator(device=device).manual_seed(seed)
    return TrainState(step=0, generator=g, discriminator=d, ema=ema, g_opt=g_opt, d_opt=d_opt, rng=rng)
