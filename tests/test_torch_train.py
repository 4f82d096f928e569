"""One training iteration of the port against lcgan_tpu's Trainer, on the
CPU in fp32, chained over the schedule's variants as __graft_entry__.py:97-129
chains them: epoch 0 (even), 1 (odd + R1), 3 (odd), then 5 (odd, frozen D:
freezeD_start 4, freezeD_layer 1).

Both start from the JAX ``create_train_state`` (carried across by
``lcgan_torch.convert.load_train_state``) and see the same batch. The six
noise draws of each iteration are JAX's, replayed from ``state.rng`` as
steps.py:107-113, 156-157, 197-198 draw them, and injected into the port's
``_iteration``. The JAX side's warp is banded (``warp_impl`` "auto" on the
CPU); the port's is the plain version with its hand-written backward.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcgan_tpu.config import Config as JaxConfig
from lcgan_tpu.models import Discriminator as JaxDiscriminator
from lcgan_tpu.train.ema import ema_update as j_ema_update
from lcgan_tpu.train.freeze import freeze_mask as j_freeze_mask
from lcgan_tpu.train.state import _adam_no_mu
from lcgan_tpu.train.steps import Trainer as JaxTrainer
from lcgan_torch.config import Config
from lcgan_torch.convert import (
    discriminator_from_flax,
    flax_from_generator,
    flax_from_train_state,
    load_train_state,
)
from lcgan_torch.models.discriminator import Discriminator
from lcgan_torch.models.generator import Generator
from lcgan_torch.train.ema import ema_update
from lcgan_torch.train.freeze import freeze_mask
from lcgan_torch.train.state import AdamNoMu
from lcgan_torch.train.steps import Trainer

# the dryrun config (__graft_entry__.py:64-82): adam_eps 1e-3 keeps updates
# proportional to gradients, so fp32 noise on ~0 gradients stays small
CFG = dict(model_name="/tmp/lcgan_torch_train_test", img_resolution=32, batch_size=4, geo_noise_dim=8,
           app_noise_dim=8, geo_latent_dim=8, app_latent_dim=16, geo_projection_dim=8, app_projection_dim=8,
           base_nf=8, max_nf=16, mbstd_group_size=2, compute_dtype="float32", adam_eps=1e-3,
           freezeD_start=4, freezeD_layer=1)
EPOCHS = [0, 1, 3, 5]
# losses and leaves after up to four chained fp32 iterations, each summing
# convs, the warp and its gradient in other orders than XLA does
TOL = dict(atol=2e-5, rtol=1e-4)


def jax_noise(state, cfg, b):
    """The six draws of Trainer._iteration, replayed from state.rng."""
    _, rng_use = jax.random.split(state.rng)
    k = jax.random.split(rng_use, 6)
    dims = [cfg.geo_noise_dim, cfg.app_noise_dim] * 3
    return tuple(torch.from_numpy(np.array(jax.random.normal(k[i], (b, d)))) for i, d in enumerate(dims))


def leaves_with_paths(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def chained():
    """Per epoch: (JAX g_loss, d_loss, state as numpy trees), the port's the same."""
    jcfg = JaxConfig(**CFG)
    jtrainer = JaxTrainer(jcfg, mesh=None)
    jstate = jtrainer.init_state()
    trainer = Trainer(Config(**CFG, device="cpu"))
    state = trainer.init_state()
    load_train_state(state, jax.device_get(jstate))

    rng = np.random.default_rng(0)
    batch_np = {k: rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
                for k in ("image", "geometry_change", "appearance_change")}
    batch_j = {k: jnp.asarray(v) for k, v in batch_np.items()}
    batch_t = {k: torch.from_numpy(v).permute(0, 3, 1, 2).contiguous() for k, v in batch_np.items()}

    out = {}
    for epoch in EPOCHS:
        noise = jax_noise(jstate, jcfg, 4)
        jstate, jg, jd = jtrainer.train_iteration(jstate, batch_j, epoch)
        state, tg, td = trainer.step_variant(epoch)(state, batch_t, noise)
        ref = jax.device_get(jstate)
        ref = {f: getattr(ref, f) for f in ("step", "g_params", "g_stats", "d_params", "ema_params",
                                            "ema_stats", "g_opt", "d_opt")}
        out[epoch] = ((float(jg), float(jd), ref), (tg.item(), td.item(), copy.deepcopy(flax_from_train_state(state))))
    return out


@pytest.mark.parametrize("epoch", EPOCHS)
def test_chained_iteration_matches_jax(chained, epoch):
    (jg, jd, ref), (tg, td, got) = chained[epoch]
    assert np.isfinite(tg) and np.isfinite(td)
    np.testing.assert_allclose(tg, jg, **TOL)
    np.testing.assert_allclose(td, jd, **TOL)
    assert int(got["step"]) == int(ref["step"]) == EPOCHS.index(epoch) + 1
    for field in ("g_params", "g_stats", "d_params", "ema_params", "ema_stats", "g_opt", "d_opt"):
        want, have = leaves_with_paths(ref[field]), leaves_with_paths(got[field])
        assert want.keys() == have.keys(), field
        for path, value in want.items():
            np.testing.assert_allclose(have[path], value, **TOL, err_msg=f"epoch {epoch}: {field}{path}")


def test_frozen_iteration_keeps_frozen_leaves(chained):
    """Epoch 5 runs frozen: from_rgb and block_0 keep epoch 3's values. An
    odd D step reads no embeddings, so the projection heads keep theirs too;
    every other leaf moves."""
    before, after = chained[3][1][2]["d_params"], chained[5][1][2]["d_params"]
    still = ("from_rgb", "block_0", "projection_header1", "projection_header2")
    for top in before:
        for a, b in zip(jax.tree.leaves(before[top]), jax.tree.leaves(after[top])):
            assert np.array_equal(a, b) == (top in still), top


def test_adam_no_mu_matches_jax_with_frozen_leaves():
    """Five steps; leaf "b" frozen from step 3 on (zero grads, masked update)."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    jtx = _adam_no_mu(0.002, 0.99, 1e-8)
    jp, js = jax.tree.map(jnp.asarray, params), jtx.init(params)

    module = torch.nn.Module()
    module.a = torch.nn.Parameter(torch.from_numpy(params["a"].copy()))
    module.b = torch.nn.Parameter(torch.from_numpy(params["b"].copy()))
    opt = AdamNoMu(module, 0.002, 0.99, 1e-8)
    for step in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        frozen = step >= 2
        if frozen:
            g["b"] = np.zeros_like(g["b"])
        u, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        if frozen:
            u = {**u, "b": u["b"] * 0}
        jp = jax.tree.map(lambda p, d: p + d, jp, u)
        opt.step([module.a, module.b], [torch.from_numpy(g["a"]), torch.from_numpy(g["b"])], [False, frozen])
        for k in params:
            np.testing.assert_allclose(getattr(module, k).detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(opt.v[k].numpy(), np.asarray(js["v"][k]), rtol=1e-6, atol=1e-12)
        assert opt.count == int(js["count"])


@pytest.mark.parametrize("step,start", [(10, 0), (3, 5)])
def test_ema_matches_jax(step, start):
    kw = dict(img_resolution=16, geo_noise_dim=4, app_noise_dim=4, geo_latent_dim=4, app_latent_dim=8,
              base_nf=4, max_nf=8)
    g = Generator(**kw, generator=torch.Generator().manual_seed(0))
    e = Generator(**kw, generator=torch.Generator().manual_seed(1))
    g.avg_latent1.fill_(0.5)
    gp, gs = flax_from_generator(g.state_dict())
    ep, es = flax_from_generator(e.state_dict())
    ref_p, ref_s = j_ema_update(gp, gs, ep, es, jnp.asarray(step), 0.9, start)
    ema_update(g, e, step, 0.9, start)
    got_p, got_s = flax_from_generator(e.state_dict())
    for a, b in zip(jax.tree.leaves((ref_p, ref_s)), jax.tree.leaves((got_p, got_s))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("layer", [0, 1, 3])
def test_freeze_mask_matches_jax(layer):
    d_kw = dict(img_resolution=32, geo_projection_dim=8, app_projection_dim=8, base_nf=8, max_nf=16,
                mbstd_group_size=2)
    jd = JaxDiscriminator(**d_kw)
    params = jax.device_get(jd.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), True)["params"])
    d = Discriminator(**d_kw)
    d.load_state_dict(discriminator_from_flax(params))
    want = {jax.tree_util.keystr(p).replace("']['", ".").strip("[']"): m
            for p, m in jax.tree_util.tree_flatten_with_path(j_freeze_mask(params, layer))[0]}
    got = dict(zip((n for n, _ in d.named_parameters()), freeze_mask(d, layer)))
    assert got == want


def test_step_variant_schedule():
    trainer = Trainer(Config(**CFG, device="cpu"))
    flags = {e: trainer.step_variant(e).keywords for e in (0, 1, 2, 3, 4, 9, 17)}
    assert flags[0] == dict(even=True, with_r1=False, frozen=False)
    assert flags[1] == dict(even=False, with_r1=True, frozen=False)
    assert flags[3] == dict(even=False, with_r1=False, frozen=False)
    assert flags[4]["frozen"] and flags[9] == dict(even=False, with_r1=True, frozen=True)
    assert flags[17]["with_r1"] and not flags[2]["with_r1"]


def test_train_iteration_draws_seeded_noise():
    """The same seed gives the same iteration; the losses are finite."""
    results = []
    for _ in range(2):
        trainer = Trainer(Config(**CFG, device="cpu", seed=3))
        state = trainer.init_state()
        batch = {k: torch.rand((4, 3, 32, 32), generator=torch.Generator().manual_seed(i)) * 2 - 1
                 for i, k in enumerate(("image", "geometry_change", "appearance_change"))}
        state, g_loss, d_loss = trainer.train_iteration(state, batch, 0)
        assert state.step == 1 and np.isfinite(g_loss.item()) and np.isfinite(d_loss.item())
        results.append((g_loss.item(), d_loss.item(), state.generator.avg_latent1.clone()))
    assert results[0][:2] == results[1][:2] and torch.equal(results[0][2], results[1][2])


def test_trainer_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Config(**CFG))  # device defaults to "cuda"
