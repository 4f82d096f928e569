"""The train loop's body against the JAX package's, on the CPU in fp32:
each package's ``make_train_pipeline`` reads one seeded image folder, and
its batch goes through the train iteration, for epochs 0-3 (even, odd + R1,
even, odd) at the dryrun width.

Both start from the JAX ``create_train_state`` (carried across by
``lcgan_torch.convert.load_train_state``); JAX's six noise draws of each
iteration are replayed into the port's ``_iteration`` as
tests/test_torch_train.py replays them. The batches must be equal bit for
bit; the losses and every leaf within tests/test_torch_train.py's
tolerance.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_train import CFG, TOL, jax_noise, leaves_with_paths

from lcgan_tpu.config import Config as JaxConfig
from lcgan_tpu.train.loop import make_train_pipeline as jax_make_train_pipeline
from lcgan_tpu.train.steps import Trainer as JaxTrainer
from lcgan_torch.config import Config
from lcgan_torch.convert import flax_from_train_state, load_train_state
from lcgan_torch.train.loop import make_train_pipeline
from lcgan_torch.train.steps import Trainer

EPOCHS = [0, 1, 2, 3]
FIELDS = ("g_params", "g_stats", "d_params", "ema_params", "ema_stats", "g_opt", "d_opt")


@pytest.fixture(scope="module")
def looped(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    (root / "train" / "x").mkdir(parents=True)
    for i in range(6):
        img = Image.fromarray(rng.integers(0, 255, (36, 40, 3), dtype=np.uint8))
        img.save(root / "train" / "x" / (f"{i}.png" if i % 2 else f"{i}.jpg"))
    kw = dict(CFG, dataset_path=str(root), freezeD_start=100000, num_data_workers=2)
    jcfg = JaxConfig(**kw)
    jtrainer = JaxTrainer(jcfg, mesh=None)
    jstate = jtrainer.init_state()
    cfg = Config(**kw, device="cpu")
    trainer = Trainer(cfg)
    state = trainer.init_state()
    load_train_state(state, jax.device_get(jstate))
    jdata, data = jax_make_train_pipeline(jcfg), make_train_pipeline(cfg, trainer.device)

    out = {}
    for epoch in EPOCHS:
        jbatch, batch = next(jdata), next(data)
        same = all(batch[k].permute(0, 2, 3, 1).numpy().tobytes() == np.asarray(jbatch[k]).tobytes() for k in jbatch)
        # the port's loop feeds (B, 3, H, W) float32 tensors in [-1, 1] on the run's device
        same &= all(t.dtype == torch.float32 and t.shape == (4, 3, 32, 32) and t.device.type == "cpu"
                    and -1.0 <= float(t.min()) and float(t.max()) <= 1.0 for t in batch.values())
        noise = jax_noise(jstate, jcfg, cfg.batch_size)
        jstate, jg, jd = jtrainer.train_iteration(jstate, {k: jnp.asarray(v) for k, v in jbatch.items()}, epoch)
        state, tg, td = trainer.step_variant(epoch)(state, batch, noise)
        ref = jax.device_get(jstate)
        ref = {f: getattr(ref, f) for f in ("step",) + FIELDS}
        out[epoch] = (same, (float(jg), float(jd), ref), (tg.item(), td.item(), copy.deepcopy(flax_from_train_state(state))))
    return out


@pytest.mark.parametrize("epoch", EPOCHS)
def test_loop_body_matches_jax(looped, epoch):
    same, (jg, jd, ref), (tg, td, got) = looped[epoch]
    assert same, "the two pipelines' batches differ, or the port's are not NCHW float32 in [-1, 1]"
    assert np.isfinite(tg) and np.isfinite(td)
    np.testing.assert_allclose(tg, jg, **TOL)
    np.testing.assert_allclose(td, jd, **TOL)
    assert int(got["step"]) == int(ref["step"]) == epoch + 1
    for field in FIELDS:
        want, have = leaves_with_paths(ref[field]), leaves_with_paths(got[field])
        assert want.keys() == have.keys(), field
        for path, value in want.items():
            np.testing.assert_allclose(have[path], value, **TOL, err_msg=f"epoch {epoch}: {field}{path}")

