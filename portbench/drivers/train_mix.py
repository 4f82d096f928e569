"""Driver of a training mix: the port's train phase as ``train/loop.train``
runs it, timed in whole periods of the schedule.

Set-up makes the seeded JPEGs, builds the port's ``Trainer`` and state,
loads the benchmark's weights into it (generator, EMA and discriminator),
starts the port's own input pipeline (``make_train_pipeline``) and runs the
warm-up periods under ``deterministic_algorithms()``. The first iterations
of the warm-up are the ones the comparison reads: their losses, every
leaf's gradient at each of them (from Adam's second moments), every leaf's
change in each of them and after them all, and the views the pipeline fed
them. The window
then runs whole periods through ``Trainer.train_iteration`` until its
seconds have passed.

The traffic file gives ``period`` (iterations of the schedule's mix),
``warmup_periods``, ``trace_periods``, ``compared_steps``, ``images`` and
``jpeg_quality`` (the dataset made from the seed), ``flags`` (the batch
and the switches of the run) and, where the float32 reference does not fit
the card at the whole batch, ``reference_blocks``.
"""

from __future__ import annotations

import math
import os
import sys
import time
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from portbench import compare, profile, traffic, work
from portbench.reference import model, train, views


def _sums(nets) -> Dict[str, float]:
    """{"<net>.<leaf>": the sum of the leaf's elements} in float64, read in one transfer."""
    keys = [f"{net}.{k}" for net, leaves in nets for k in leaves]
    sums = torch.stack([v.double().sum() for _, leaves in nets for v in leaves.values()]).tolist()
    return dict(zip(keys, sums))


def _snapshot(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    with torch.no_grad():
        return {k: v.detach().clone() for k, v in params.items()}


def _step_change(before: Dict[str, torch.Tensor], now: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm of its change since ``before``, read in one transfer."""
    with torch.no_grad():
        norms = torch.stack([(now[k].detach() - v).double().norm() for k, v in before.items()]).tolist()
    return dict(zip(before, norms))


class Work:
    def __init__(self, r):
        self.r = r
        t = r.traffic
        self.period, self.steps = t["period"], t["compared_steps"]
        if self.steps > self.period * t["warmup_periods"]:
            raise ValueError("the compared steps have to lie in the warm-up")
        self.sizes = model.Sizes.of(r.flags)
        self.recipe = train.Recipe.of(r.flags)
        self.batch = r.flags["batch_size"]
        self.blocks = t.get("reference_blocks", 1)  # the reference's blocks of rows (train.iteration)

    def _weights(self):
        return model.make_weights([model.generator_spec(self.sizes), model.discriminator_spec(self.sizes)],
                                  self.r.seed, self.r.device)

    # ------------------------------------------------------------------
    def setup(self) -> None:
        r, t = self.r, self.r.traffic
        from lcgan_torch.config import Config
        from lcgan_torch.train.loop import deterministic_algorithms, make_train_pipeline
        from lcgan_torch.train.steps import Trainer

        r.part("imports")
        data = os.path.join(r.tmp, "data")
        self.files = traffic.jpeg_folder(data, r.seed, t["images"], self.sizes.img_resolution, t["jpeg_quality"])
        r.part("jpegs")
        cfg = Config(**r.flags, dataset_path=data, model_name=os.path.join(r.tmp, "run"), seed=r.seed,
                     device=r.device.type)
        self._deterministic = deterministic_algorithms()
        self._deterministic.__enter__()
        self.trainer = Trainer(cfg)
        self.state = self.trainer.init_state()
        wg, wd = self._weights()
        self.state.generator.load_state_dict(wg)
        self.state.ema.load_state_dict(wg)
        self.state.discriminator.load_state_dict(wd)
        del wg, wd
        r.sync()
        r.part("state and weights")
        self.data = make_train_pipeline(cfg, self.trainer.device)
        self.native = self.data.it.it.use_native  # which of the pipeline's two paths runs here
        r.part("pipeline")
        self.views: List[Dict[str, np.ndarray]] = []
        losses, moments, step_changes = [], [], []
        self.epoch = 0
        for _ in range(self.period * t["warmup_periods"]):
            batch = next(self.data)
            if self.epoch < self.steps:
                self.views.append({k: v.cpu().numpy() for k, v in batch.items()})
            before = _snapshot(self._params()) if 0 < self.epoch < self.steps else None
            self.state, g_loss, d_loss = self.trainer.train_iteration(self.state, batch, self.epoch)
            if before is not None:
                step_changes.append(_step_change(before, self._params()))
            del before
            if self.epoch < self.steps:
                losses.append((g_loss.item(), d_loss.item()))
                moments.append(self._moment_sums())
            if self.epoch == self.steps - 1:
                grads = compare.grads_from_moments(moments, self.state.g_opt.b2)
                self.program = compare.TrainReadings(losses, grads, self._changes(), step_changes)
            self.epoch += 1
        r.sync()
        r.part("warm-up")

    def _params(self) -> Dict[str, torch.Tensor]:
        st = self.state
        return {**{f"g.{k}": v for k, v in st.generator.state_dict().items()},
                **{f"d.{k}": v for k, v in st.discriminator.state_dict().items()}}

    def _moment_sums(self) -> Dict[str, float]:
        """Each leaf's sum of Adam's second moment, the gradients' record
        (``compare.grads_from_moments``)."""
        st = self.state
        return _sums([("g", st.g_opt.v), ("d", st.d_opt.v)])

    def _changes(self) -> Dict[str, float]:
        wg, wd = self._weights()
        st = self.state
        with torch.no_grad():
            out = {f"g.{k}": float((v - wg[k]).double().norm()) for k, v in st.generator.state_dict().items()}
            out.update({f"d.{k}": float((v - wd[k]).double().norm()) for k, v in st.discriminator.state_dict().items()})
            ema = st.ema.state_dict()
            out.update({f"ema.{k}": float((ema[k] - wg[k]).double().norm()) for k in model.BUFFERS})
        return out

    # ------------------------------------------------------------------
    def traced(self) -> dict:
        """``trace_periods`` periods as the traced stretch, each iteration's
        wait for data and step call in host spans of their own."""
        units: Counter = Counter()

        def body(span):
            for _ in range(self.period * self.r.traffic["trace_periods"]):
                with span("data_wait"):
                    batch = next(self.data)
                kind = train.variant(self.epoch)
                with span("step." + kind):
                    self.state, _, _ = self.trainer.train_iteration(self.state, batch, self.epoch)
                units[kind] += 1
                self.epoch += 1

        return {"trace": profile.traced(self.r.device, body), "units": dict(units)}

    def window(self, seconds: float, spans: Dict[str, list]) -> dict:
        r = self.r
        units: Counter = Counter()
        r.sync()
        t0 = time.perf_counter()
        while True:
            for _ in range(self.period):
                a = time.perf_counter()
                batch = next(self.data)
                b = time.perf_counter()
                kind = train.variant(self.epoch)
                self.state, g_loss, d_loss = self.trainer.train_iteration(self.state, batch, self.epoch)
                spans["data_wait"].append(b - a)
                spans["step"].append(time.perf_counter() - b)
                units[kind] += 1
                self.epoch += 1
            if time.perf_counter() - t0 >= seconds:
                break
        r.sync()
        elapsed = time.perf_counter() - t0
        images = sum(units.values()) * self.batch
        finite = math.isfinite(g_loss.item()) and math.isfinite(d_loss.item())
        return {"units": dict(units), "images": images, "seconds": elapsed,
                "failed": 0 if finite else images,
                "metrics": {"train_images_per_s": (images / elapsed, "images/s")}}

    def release(self) -> None:
        """Free the program's state; stop the pipeline's workers."""
        self.data.it.it.pool.shutdown(wait=True, cancel_futures=True)
        del self.state, self.trainer, self.data
        self._deterministic.__exit__(None, None, None)

    # ------------------------------------------------------------------
    def reference(self, batches: List[Dict[str, np.ndarray]], prec: model.Precision = model.FP32,
                  fault: str = "") -> compare.TrainReadings:
        """The compared steps worked out by the plain reference from the
        benchmark's weights, the given views and the seed's noise, read as
        the program's are. ``fault`` plants one in it (``train.iteration``)."""
        dev = self.r.device
        wg, wd = self._weights()
        st = train.State.start(wg, wd)
        noise = train.noise_draws(self.sizes, self.batch, self.r.seed, self.steps, dev)
        losses, moments, step_changes = [], [], []
        for i in range(self.steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batches[i].items()}
            params = lambda: {**{f"g.{k}": v for k, v in st.g.items()}, **{f"d.{k}": v for k, v in st.d.items()}}  # noqa: E731
            before = _snapshot(params()) if i > 0 else None
            g_loss, d_loss, gg, dg = train.iteration(st, self.sizes, self.recipe, batch, noise[i], i, prec=prec,
                                                     fault=fault, blocks=self.blocks)
            if before is not None:
                step_changes.append(_step_change(before, params()))
            del before
            losses.append((float(g_loss), float(d_loss)))
            moments.append(_sums([("g", st.g_v), ("d", st.d_v)]))
            del gg, dg
        grads = compare.grads_from_moments(moments, self.recipe.beta2)
        with torch.no_grad():
            changes = {f"g.{k}": float((v - wg[k]).double().norm()) for k, v in st.g.items()}
            changes.update({f"d.{k}": float((v - wd[k]).double().norm()) for k, v in st.d.items()})
            changes.update({f"ema.{k}": float((st.ema[k] - wg[k]).double().norm()) for k in model.BUFFERS})
        return compare.TrainReadings(losses, grads, changes, step_changes)

    def reference_views(self) -> List[Dict[str, np.ndarray]]:
        return views.batches(self.files, self.sizes.img_resolution, self.batch, self.r.seed, self.steps, self.native)

    def check(self) -> Dict[str, float]:
        """The views and the compared steps against the reference's. The
        reference's views and readings stay on ``ref_views`` and ``ref``."""
        with model.reference_mode():
            self.ref_views = self.reference_views()
            self.ref = self.reference(self.ref_views)
        values = {"view_gap": compare.view_gap(self.views, self.ref_views)}
        values.update(compare.train_gaps(self.program, self.ref))
        for what, rows in compare.train_worst(self.program, self.ref).items():
            print(f"portbench: widest {what}: " + "; ".join(f"{k} {gap:.4g} ({p:.4g} vs {r:.4g})" for k, gap, p, r in rows),
                  file=sys.stderr)
        print(f"portbench: losses (g, d) program {self.program.losses} reference {self.ref.losses}", file=sys.stderr)
        print("portbench: median leaf's gap at each compared step: gradient "
              + " ".join(f"{g:.4g}" for g in compare.step_grad_gaps(self.program, self.ref)) + "; change (from step 2) "
              + " ".join(f"{g:.4g}" for g in compare.step_change_gaps(self.program, self.ref)), file=sys.stderr)
        return values

    def work(self) -> Dict[str, Dict[str, int]]:
        es = work.element_bytes(self.r.flags)
        return work.train_units(self.sizes, self.recipe, self.batch, es)
