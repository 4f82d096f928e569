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

``view_batched_steps`` stacks the even iteration's views as the JAX step
does (lcgan_tpu/train/steps.py:124-153, 217-252): the G step's three views
(anchor, geometry-resampled, appearance-resampled) go through G once at 3B
and D once at 3B, the D step's four images (fake, real, geometry and
appearance changes) through D once at 4B, and the odd step without R1 sends
fake and real through D once at 2B (R1 keeps its real pass under its own
gradient). mbstd takes per-view statistics and G replays the per-view
w-avg lerps, so both forms compute the same values from the same six noise
draws; on the card the batched form launches each warp kernel once a block
where the unbatched one launches it once a view.
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
from lcgan_torch.utils import trace

Noise = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _grads(loss: torch.Tensor, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d params, zeros for a leaf the loss does not reach. Only
    these leaves get gradients: nothing accumulates in ``.grad``."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


class Trainer:
    """Runs the schedule's iterations on the run's device."""

    def __init__(self, cfg: Config):
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
        with trace.span("g_step.forward"):
            g_loss = self._g_loss(g_net, d_net, z_g1, z_g2, z_r1, z_r2, even)
        g_params = list(g_net.parameters())
        with trace.span("g_step.backward"):  # grads of G's leaves only: the loss ran D with grads, D gets none
            g_grads = _grads(g_loss, g_params)
            g_loss = g_loss.detach()  # the graph goes with the loss: freeing it is the backward's host time
        with trace.span("g_step.all_reduce"):
            parallel.mean_all_reduce(g_grads + [g_loss])  # pmean (steps.py:184-186)
        with trace.span("g_step.adam"):
            state.g_opt.step(g_params, g_grads)

        # ---------------- EMA (loader.py:48), before the D step's G forward ----------------
        with trace.span("ema"):
            ema_update(g_net, state.ema, state.step, cfg.g_ema_decay, cfg.g_ema_start)

        # ---------------- D step (worker.py:137-177) ----------------
        with trace.span("d_step.fake"), torch.no_grad():  # training mode: the w averages update again
            fake = g_net(z_d1, z_d2)
        with trace.span("d_step.forward"):
            d_loss = self._d_loss(d_net, fake, batch, even, with_r1)
        d_params = list(d_net.parameters())
        mask = freeze_mask(d_net, cfg.freezeD_layer) if frozen else [False] * len(d_params)
        live = [p for p, f in zip(d_params, mask) if not f]
        with trace.span("d_step.backward"):
            live_grads = _grads(d_loss, live)
            d_loss = d_loss.detach()
        with trace.span("d_step.all_reduce"):
            parallel.mean_all_reduce(live_grads + [d_loss])  # pmean (steps.py:274-276)
        with trace.span("d_step.adam"):
            live_grads = iter(live_grads)
            # frozen leaves: zero gradients (v decays) and no update
            d_grads = [torch.zeros_like(p) if f else next(live_grads) for p, f in zip(d_params, mask)]
            state.d_opt.step(d_params, d_grads, mask)

        state.step += 1
        return state, g_loss, d_loss

    def _g_loss(self, g_net, d_net, z_g1, z_g2, z_r1, z_r2, even: bool) -> torch.Tensor:
        """The G step's loss: G's and D's forwards and the losses."""
        cfg = self.cfg
        if not even:
            return bce_logits(d_net(g_net(z_g1, z_g2), False)[0], 1.0)
        b = z_g1.shape[0]
        if cfg.view_batched_steps:  # the three views through G and D once each, at 3B
            views = g_net(torch.cat([z_g1, z_r1, z_g1]), torch.cat([z_g2, z_g2, z_r2]), num_views=3)
            logits, geo_e, app_e = d_net(views, True, num_views=3)
            logit = logits[:b]
            # anchor → (feat, feat), res_geo → (geo_pos, app_neg),
            # res_app → (geo_neg, app_pos): the unbatched triple's layout
            geo_feat, geo_pos, geo_neg = geo_e.split(b)
            app_feat, app_neg, app_pos = app_e.split(b)
        else:
            anchor = g_net(z_g1, z_g2)
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
        return adv + aux + sp

    def _d_loss(self, d_net, fake: torch.Tensor, batch: Dict[str, torch.Tensor], even: bool,
                with_r1: bool) -> torch.Tensor:
        """The D step's loss on the fakes and the batch: D's forwards (R1's
        gradient among them) and the losses."""
        cfg = self.cfg
        batched = cfg.view_batched_steps
        b = fake.shape[0]
        image = batch["image"]
        if even and batched:  # fake, real and the two changes through D once, at 4B
            stacked = torch.cat([fake, image, batch["geometry_change"], batch["appearance_change"]])
            logits, geo_e, app_e = d_net(stacked, True, num_views=4)
            # the fake rows' embeddings are computed and unused
            _, geo_feat, geo_pos, geo_neg = geo_e.split(b)
            _, app_feat, app_neg, app_pos = app_e.split(b)
            adv = bce_logits(logits[b:2 * b], 1.0) + bce_logits(logits[:b], 0.0)
            aux = (
                contrastive_loss(geo_feat, geo_pos, geo_neg, cfg.tau)
                + contrastive_loss(app_feat, app_pos, app_neg, cfg.tau)
            ) * cfg.l_aux
            return adv + aux
        if batched and not with_r1:  # fake and real through D once, at 2B
            logits = d_net(torch.cat([fake, image]), False, num_views=2)[0]
            return bce_logits(logits[:b], 0.0) + bce_logits(logits[b:], 1.0)
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
            return adv + aux
        if with_r1:
            real_logit, r1 = r1_penalty_with_logits(lambda img: d_net(img, False)[0], image)
            return bce_logits(real_logit, 1.0) + fake_loss + r1 * cfg.l_r1
        return bce_logits(d_net(image, False)[0], 1.0) + fake_loss

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
        with trace.span("noise"):
            noise = self.draw_noise(state, batch["image"].shape[0])
        return self.step_variant(epoch)(state, batch, noise)
