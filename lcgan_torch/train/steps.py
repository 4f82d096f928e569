"""One training iteration (worker.py:137-214 + loader.py:44-54), PyTorch
port of ``lcgan_tpu.train.steps``.

One iteration = G update → EMA → D update, the reference's order
(loader.py:45-54: G first, EMA, then D on the *updated* G's fakes). The
schedule picks one of three variants by ``epoch`` (worker.py:151,159,187;
loader.py:52-53): even (adversarial + contrastive + sparsity), odd, odd +
R1 every 8th, each with a frozen-D twin after ``freezeD_start``.

The state is updated in place (see ``train.state``). Noise: the six draws
of an iteration (z_g1, z_g2, z_r1, z_r2, z_d1, z_d2) come from the state's
``torch.Generator`` in ``train_iteration``; ``_iteration`` takes them as
arguments, so a caller can inject any noise (the tests feed JAX's draws).

On the card every warp of G runs the CUDA kernels: the forward in all four
G passes of an even iteration, and the two gradient kernels in the G step's
backward. The D step's fake is generated under ``no_grad``.

Data parallelism (``lcgan_torch.parallel``, one process per GPU): each rank
runs the iteration on its shard of the global batch; G's gradients with
``g_loss``, then D's live gradients with ``d_loss``, are averaged over the
ranks by one ``mean_all_reduce`` each before Adam, as the JAX step
``pmean``s them (lcgan_tpu/train/steps.py:184-186, 274-276), and the
generator averages its w-avg batch means. Every rank keeps the same state.
Rank r's noise is rows r·b..(r+1)·b of a draw of the global batch from the
shared stream, so the ranks draw distinct noise, the stream stays one state
on every rank, and at world size 1 the draws are the one-process ones.

Not ported yet: ``view_batched_steps`` (raises).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import torch

from lcgan_torch import parallel
from lcgan_torch.config import Config, resolve_device
from lcgan_torch.losses import bce_logits, contrastive_loss, r1_penalty_with_logits, sparsity_loss
from lcgan_torch.train.ema import ema_update
from lcgan_torch.train.freeze import freeze_mask
from lcgan_torch.train.state import TrainState, create_train_state

Noise = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _grads(loss: torch.Tensor, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d params, zeros for a leaf the loss does not reach. Only
    these leaves get gradients: nothing accumulates in ``.grad``."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


class Trainer:
    """Runs the schedule's iterations on the run's device."""

    def __init__(self, cfg: Config):
        if cfg.view_batched_steps:
            raise NotImplementedError("view_batched_steps is not ported yet; run with it off")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)

    def init_state(self) -> TrainState:
        return create_train_state(self.cfg, self.device)

    def draw_noise(self, state: TrainState, batch_size: int) -> Noise:
        """The iteration's six draws from the state's noise stream, for a
        local batch of ``batch_size``: this rank's rows of each draw of the
        global batch (the whole draw at world size 1)."""
        cfg = self.cfg
        dims = (cfg.geo_noise_dim, cfg.app_noise_dim) * 3
        rank, world = parallel.rank(), parallel.world_size()
        rows = slice(rank * batch_size, (rank + 1) * batch_size)
        return tuple(torch.randn((world * batch_size, d), generator=state.rng, device=self.device)[rows]
                     for d in dims)

    # ------------------------------------------------------------------
    def _iteration(
        self, state: TrainState, batch: Dict[str, torch.Tensor], noise: Noise, *,
        even: bool, with_r1: bool, frozen: bool,
    ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
        """One iteration on ``state`` (updated in place). ``batch`` holds
        ``image``, ``geometry_change``, ``appearance_change``, (B, C, H, W)
        in [-1, 1]. Returns (state, g_loss, d_loss)."""
        cfg = self.cfg
        g_net, d_net = state.generator, state.discriminator
        g_net.train()
        d_net.train()
        z_g1, z_g2, z_r1, z_r2, z_d1, z_d2 = noise

        # ---------------- G step (worker.py:179-214) ----------------
        anchor = g_net(z_g1, z_g2)
        if even:
            res_geo = g_net(z_r1, z_g2)
            res_app = g_net(z_g1, z_r2)
            logit, geo_feat, app_feat = d_net(anchor, True)
            _, geo_pos, app_neg = d_net(res_geo, True)
            _, geo_neg, app_pos = d_net(res_app, True)
            adv = bce_logits(logit, 1.0)
            aux = (
                contrastive_loss(geo_feat, geo_pos, geo_neg, cfg.tau)
                + contrastive_loss(app_feat, app_pos, app_neg, cfg.tau)
            ) * cfg.l_aux
            sp = sparsity_loss(
                g_net.geometry_mapping.diagonal_params, g_net.appearance_mapping.diagonal_params
            ) * cfg.l_s
            g_loss = adv + aux + sp
        else:
            g_loss = bce_logits(d_net(anchor, False)[0], 1.0)
        g_params = list(g_net.parameters())
        # grads of G's leaves only: the loss ran D with grads, D gets none
        g_grads = _grads(g_loss, g_params)
        g_loss = g_loss.detach()
        parallel.mean_all_reduce(g_grads + [g_loss])  # pmean (steps.py:184-186)
        state.g_opt.step(g_params, g_grads)

        # ---------------- EMA (loader.py:48), before the D step's G forward ----------------
        ema_update(g_net, state.ema, state.step, cfg.g_ema_decay, cfg.g_ema_start)

        # ---------------- D step (worker.py:137-177) ----------------
        with torch.no_grad():  # training mode: the w averages update again
            fake = g_net(z_d1, z_d2)
        image = batch["image"]
        fake_loss = bce_logits(d_net(fake, False)[0], 0.0)
        if even:
            real_logit, geo_feat, app_feat = d_net(image, True)
            _, geo_pos, app_neg = d_net(batch["geometry_change"], True)
            _, geo_neg, app_pos = d_net(batch["appearance_change"], True)
            adv = bce_logits(real_logit, 1.0) + fake_loss
            aux = (
                contrastive_loss(geo_feat, geo_pos, geo_neg, cfg.tau)
                + contrastive_loss(app_feat, app_pos, app_neg, cfg.tau)
            ) * cfg.l_aux
            d_loss = adv + aux
        elif with_r1:
            real_logit, r1 = r1_penalty_with_logits(lambda img: d_net(img, False)[0], image)
            d_loss = bce_logits(real_logit, 1.0) + fake_loss + r1 * cfg.l_r1
        else:
            d_loss = bce_logits(d_net(image, False)[0], 1.0) + fake_loss

        d_params = list(d_net.parameters())
        mask = freeze_mask(d_net, cfg.freezeD_layer) if frozen else [False] * len(d_params)
        live = [p for p, f in zip(d_params, mask) if not f]
        live_grads = _grads(d_loss, live)
        d_loss = d_loss.detach()
        parallel.mean_all_reduce(live_grads + [d_loss])  # pmean (steps.py:274-276)
        live_grads = iter(live_grads)
        # frozen leaves: zero gradients (v decays) and no update
        d_grads = [torch.zeros_like(p) if f else next(live_grads) for p, f in zip(d_params, mask)]
        state.d_opt.step(d_params, d_grads, mask)

        state.step += 1
        return state, g_loss, d_loss

    # ------------------------------------------------------------------
    def step_variant(self, epoch: int):
        """The iteration for this epoch's slot of the schedule
        (worker.py:151,159,187; loader.py:52-53)."""
        return functools.partial(
            self._iteration,
            even=epoch % 2 == 0,
            with_r1=epoch % 8 == 1,
            frozen=epoch >= self.cfg.freezeD_start,
        )

    def train_iteration(self, state: TrainState, batch: Dict[str, torch.Tensor], epoch: int):
        """Draw the iteration's noise and run this epoch's variant.
        Returns (state, g_loss, d_loss)."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        noise = self.draw_noise(state, batch["image"].shape[0])
        return self.step_variant(epoch)(state, batch, noise)
