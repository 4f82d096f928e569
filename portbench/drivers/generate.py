"""Driver of generation: batches through the port's EMA generator as
``gen/artifacts.fake_image_generation`` runs them, without the JPEG
encode: codes drawn on the CPU from a ``torch.Generator`` seeded by the
run's seed, ``generator(z1, z2, w_psi=...)`` in eval mode under
``inference_mode``, then ``to_unit`` to the host.

The traffic file gives ``flags`` (the batch and ``w_psi``),
``warmup_batches``, ``trace_batches``, and the sample the comparison
reads: ``sample_batches`` batches drawn from the seed among the window's
first ``sample_range``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import compare, profile, work
from portbench.reference import model


class Work:
    def __init__(self, r):
        self.r = r
        self.sizes = model.Sizes.of(r.flags)
        self.batch = r.flags["batch_size"]
        self.w_psi = r.flags["w_psi"]
        t = r.traffic
        pick = np.random.default_rng((r.seed, 1)).choice(t["sample_range"], t["sample_batches"], replace=False)
        self.sample = {int(i) for i in pick}
        self.kept: List[tuple] = []  # (z1, z2, images) of the sampled batches

    def _weights(self) -> model.Params:
        return model.make_weights([model.generator_spec(self.sizes)], self.r.seed, self.r.device)[0]

    def setup(self) -> None:
        r = self.r
        from lcgan_torch.config import Config
        from lcgan_torch.gen.artifacts import to_unit
        from lcgan_torch.train.loop import load_ema_generator

        r.part("imports")
        cfg = Config(**r.flags, seed=r.seed, device=r.device.type)
        self.generator = load_ema_generator(cfg, r.device, {"ema": self._weights()})
        self.to_unit = to_unit
        self.rng = torch.Generator().manual_seed(r.seed)
        r.sync()
        r.part("generator and weights")
        for _ in range(r.traffic["warmup_batches"]):
            self._batch()
        r.sync()
        r.part("warm-up")

    def _codes(self):
        z1 = torch.randn((self.batch, self.sizes.geo_noise_dim), generator=self.rng)
        z2 = torch.randn((self.batch, self.sizes.app_noise_dim), generator=self.rng)
        return z1, z2

    @torch.inference_mode()
    def _batch(self):
        z1, z2 = self._codes()
        return z1, z2, self.to_unit(self.generator(z1.to(self.r.device), z2.to(self.r.device), w_psi=self.w_psi))

    def traced(self) -> dict:
        """``trace_batches`` batches as the traced stretch, the generator's
        call and ``to_unit`` in host spans of their own."""
        r = self.r

        def body(span):
            with torch.inference_mode():
                for _ in range(r.traffic["trace_batches"]):
                    with span("generate"):
                        z1, z2 = self._codes()
                        out = self.generator(z1.to(r.device), z2.to(r.device), w_psi=self.w_psi)
                    with span("to_unit"):
                        self.to_unit(out)

        return {"trace": profile.traced(r.device, body), "units": {"batch": r.traffic["trace_batches"]}}

    def window(self, seconds: float, spans: Dict[str, list]) -> dict:
        r = self.r
        n = 0
        r.sync()
        t0 = time.perf_counter()
        with torch.inference_mode():
            while True:
                a = time.perf_counter()
                z1, z2 = self._codes()
                out = self.generator(z1.to(r.device), z2.to(r.device), w_psi=self.w_psi)
                b = time.perf_counter()
                images = self.to_unit(out)
                spans["generate"].append(b - a)
                spans["to_unit"].append(time.perf_counter() - b)
                if n in self.sample:
                    self.kept.append((z1, z2, images))
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
        elapsed = time.perf_counter() - t0  # to_unit has copied each batch to the host
        failed = sum(int(not np.isfinite(imgs).all()) * self.batch for _, _, imgs in self.kept)
        return {"units": {"batch": n}, "images": n * self.batch, "seconds": elapsed,
                "failed": failed, "metrics": {"gen_images_per_s": (n * self.batch / elapsed, "images/s")}}

    def release(self) -> None:
        del self.generator

    def reference(self, prec: model.Precision = model.FP32) -> List[np.ndarray]:
        """The sampled batches worked out by the plain reference."""
        p = self._weights()
        out = []
        with torch.no_grad():
            for z1, z2, _ in self.kept:
                img = model.generator(p, self.sizes, z1.to(self.r.device), z2.to(self.r.device), w_psi=self.w_psi,
                                      training=False, prec=prec)
                out.append(((img + 1.0) * 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1).cpu().numpy())
        return out

    def check(self) -> Dict[str, float]:
        """The sampled batches against the reference's, which stay on ``ref``."""
        with model.reference_mode():
            self.ref = self.reference()
        return compare.image_gaps([imgs for _, _, imgs in self.kept], self.ref)

    def work(self) -> Dict[str, Dict[str, int]]:
        es = work.element_bytes(self.r.flags)
        return {"batch": work.generate_unit(self.sizes, self.batch, self.w_psi, es)}
