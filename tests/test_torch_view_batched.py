"""The port's view-batched train step, its Adam with a first moment and the
packed discriminator conv against lcgan_tpu, on the CPU in fp32.

* mbstd, D and G with ``num_views`` against the JAX modules: per-view
  minibatch statistics and the per-view replay of the w-avg lerps;
* chained iterations at the dryrun config with ``view_batched_steps`` and
  ``beta1 = 0.5`` (optax's Adam) over epochs 0, 1, 3 and 5 (frozen), in the
  way of tests/test_torch_train.py: JAX's state carried across, JAX's noise
  injected, at its ``TOL``;
* the port batched against the port unbatched, one iteration from one state,
  at the JAX package's own tolerances (tests/test_train.py:332-361);
* ``Adam`` against ``optax.adam`` with a leaf frozen from step 3, and the
  optax-state bridge both ways;
* the port's 3×3 stride-1 ``EqualizedConv2d`` against the JAX one where the
  latter takes its packed route (Co <= 32 on maps of 512² and up,
  lcgan_tpu/ops/equalized.py:175-184).
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_discriminator import both_discriminators, images, nchw, nhwc
from test_torch_generator import DRYRUN as G_DRYRUN
from test_torch_generator import torch_and_flax
from test_torch_train import CFG, EPOCHS, TOL, jax_noise, leaves_with_paths

from lcgan_torch.config import Config
from lcgan_torch.convert import flax_from_optimizer, flax_from_train_state, load_optimizer, load_train_state
from lcgan_torch.ops import mbstd as t_mbstd
from lcgan_torch.ops.equalized import EqualizedConv2d
from lcgan_torch.train.state import Adam, AdamNoMu
from lcgan_torch.train.steps import Trainer
from lcgan_tpu.config import Config as JaxConfig
from lcgan_tpu.models import Generator as JaxGenerator
from lcgan_tpu.ops import equalized as j_eq
from lcgan_tpu.ops import mbstd as j_mbstd
from lcgan_tpu.train.steps import Trainer as JaxTrainer

FIELDS = ("g_params", "g_stats", "d_params", "ema_params", "ema_stats", "g_opt", "d_opt")
BATCHED = dict(CFG, view_batched_steps=True, beta1=0.5)


# ---------------------------------------------------------------------------
# the modules


@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("views", [2, 3, 4])
def test_mbstd_views_match_jax(views, group):
    """Each view's statistic as a call on it alone computes it."""
    x = np.random.default_rng(views).standard_normal((4 * views, 3, 5, 6)).astype(np.float32)
    ref = j_mbstd.minibatch_stddev(jnp.asarray(x), group_size=group, num_views=views)
    out = t_mbstd.minibatch_stddev(nchw(x), group_size=group, num_views=views)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-6, rtol=1e-6)
    alone = torch.cat([t_mbstd.minibatch_stddev(v, group_size=group) for v in nchw(x).split(4)])
    np.testing.assert_allclose(out.numpy(), alone.numpy(), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="views"):
        t_mbstd.minibatch_stddev(nchw(x)[1:], group_size=group, num_views=views)


@pytest.mark.parametrize("views", [2, 3, 4])
def test_discriminator_views_match_jax(views):
    jd, params, td = both_discriminators()
    img = images(n=4 * views, seed=views)
    ref = jd.apply({"params": params}, jnp.asarray(img), True, views)
    with torch.no_grad():
        out = td(nchw(img), True, num_views=views)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_generator_w_avg_replay_matches_jax():
    """Three views in one call: the images, and the w averages after one
    lerp per view in stacking order, as JAX's Generator(num_views=3) and as
    three separate calls of the port leave them."""
    model, params, stats = torch_and_flax(G_DRYRUN)
    rng = np.random.default_rng(3)
    z1 = rng.standard_normal((6, G_DRYRUN["geo_noise_dim"])).astype(np.float32)
    z2 = rng.standard_normal((6, G_DRYRUN["app_noise_dim"])).astype(np.float32)
    ref, mut = JaxGenerator(**G_DRYRUN, warp_impl="banded").apply(
        {"params": params, "stats": stats}, jnp.asarray(z1), jnp.asarray(z2), -1.0, num_views=3, mutable=["stats"])
    separate = copy.deepcopy(model)
    with torch.no_grad():
        out = model(torch.from_numpy(z1), torch.from_numpy(z2), num_views=3)
        for a, b in zip(torch.from_numpy(z1).split(2), torch.from_numpy(z2).split(2)):
            separate(a, b)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-5, rtol=1e-5)
    for name in ("avg_latent1", "avg_latent2"):
        np.testing.assert_allclose(getattr(model, name).numpy(), np.asarray(mut["stats"][name]), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(getattr(model, name).numpy(), getattr(separate, name).numpy(),
                                   atol=1e-7, rtol=1e-6)
        assert not np.array_equal(getattr(model, name).numpy(), stats[name])


@pytest.mark.parametrize("co", [16, 32])
def test_conv3x3_matches_the_packed_jax_route(co):
    """D's block-0 conv0 at the 1024² recipe (32 → 32 channels) and a
    16-channel one, on a 512² map: the JAX layer takes its packed route
    there, a band-Toeplitz matmul that sums the 3·3·C taps (and zeros) in
    another order than a conv. Forward and both gradients within 1e-5 of
    each one's scale (fp32 sums of 288 products, and of 512² for dW)."""
    assert j_eq.PACKED_K3 and co <= j_eq.PACKED_K3_MAX_CO and 512 >= j_eq.PACKED_K3_MIN_RES
    assert j_eq._pack_p(co, 512) >= 2  # the route's own condition (equalized.py:175-181)
    rng = np.random.default_rng(co)
    x = rng.standard_normal((1, 512, 512, co)).astype(np.float32)
    g = rng.standard_normal((1, 512, 512, co)).astype(np.float32)
    layer = j_eq.EqualizedConv2d(features=co, kernel_size=3)
    params = jax.tree.map(np.asarray, layer.init(jax.random.PRNGKey(co), jnp.zeros((1, 8, 8, co)))["params"])
    params["bias"] = rng.standard_normal(co).astype(np.float32)
    ref, vjp = jax.vjp(lambda p, xx: layer.apply({"params": p}, xx), params, jnp.asarray(x))
    ref_dp, ref_dx = vjp(jnp.asarray(g))

    conv = EqualizedConv2d(co, co, 3)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(params["weight"].transpose(3, 2, 0, 1).copy()))
        conv.bias.copy_(torch.from_numpy(params["bias"]))
    xt = nchw(x).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    out = conv(xt)
    out.backward(nchw(g))
    pairs = [(nhwc(out), ref), (nhwc(xt.grad), ref_dx),
             (conv.weight.grad.permute(2, 3, 1, 0).numpy(), ref_dp["weight"]), (conv.bias.grad.numpy(), ref_dp["bias"])]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


# ---------------------------------------------------------------------------
# chained iterations against the JAX package


@pytest.fixture(scope="module")
def chained():
    """Per epoch: (JAX g_loss, d_loss, state as numpy trees), the port's the same."""
    jcfg = JaxConfig(**BATCHED)
    jtrainer = JaxTrainer(jcfg, mesh=None)
    jstate = jtrainer.init_state()
    trainer = Trainer(Config(**BATCHED, device="cpu"))
    state = trainer.init_state()
    assert isinstance(state.g_opt, Adam) and isinstance(state.d_opt, Adam)
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
        ref = {f: getattr(ref, f) for f in ("step",) + FIELDS}
        out[epoch] = ((float(jg), float(jd), ref), (tg.item(), td.item(), copy.deepcopy(flax_from_train_state(state))))
    return out


@pytest.mark.parametrize("epoch", EPOCHS)
def test_chained_batched_iteration_matches_jax(chained, epoch):
    (jg, jd, ref), (tg, td, got) = chained[epoch]
    assert np.isfinite(tg) and np.isfinite(td)
    np.testing.assert_allclose(tg, jg, **TOL)
    np.testing.assert_allclose(td, jd, **TOL)
    assert int(got["step"]) == int(ref["step"]) == EPOCHS.index(epoch) + 1
    for field in FIELDS:
        want, have = leaves_with_paths(ref[field]), leaves_with_paths(got[field])
        assert want.keys() == have.keys(), field
        for path, value in want.items():
            np.testing.assert_allclose(have[path], value, **TOL, err_msg=f"epoch {epoch}: {field}{path}")


def test_optax_state_bridge_round_trip(chained):
    """The JAX state after epoch 5 into a fresh port state and back: every
    leaf of optax's (ScaleByAdamState(count, mu, nu), EmptyState()) bit for bit."""
    ref = chained[5][0][2]
    state = Trainer(Config(**BATCHED, device="cpu")).init_state()
    load_train_state(state, SimpleNamespace(**ref))
    back = flax_from_train_state(state)
    assert int(state.g_opt.count) == int(ref["g_opt"][0].count) == 4
    for field in FIELDS:
        want, have = leaves_with_paths(ref[field]), leaves_with_paths(back[field])
        assert want.keys() == have.keys(), field
        assert all(np.array_equal(have[p], v) and have[p].dtype == v.dtype for p, v in want.items()), field


# ---------------------------------------------------------------------------
# the port batched against the port unbatched


@pytest.mark.parametrize("epoch", [0, 1, 3])
def test_port_batched_matches_unbatched(epoch):
    """One iteration from the same state, batch and noise, with and without
    view batching, at tests/test_train.py:332-361's tolerances."""
    rng = np.random.default_rng(epoch)
    batch = {k: torch.from_numpy(rng.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32))
             for k in ("image", "geometry_change", "appearance_change")}
    noise = tuple(torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)) for _ in range(6))
    runs = []
    for flag in (False, True):
        trainer = Trainer(Config(**CFG, device="cpu", view_batched_steps=flag))
        state, g_loss, d_loss = trainer.step_variant(epoch)(trainer.init_state(), batch, noise)
        runs.append((g_loss.item(), d_loss.item(), state))
    (g0, d0, s0), (g1, d1, s1) = runs
    np.testing.assert_allclose(g1, g0, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(d1, d0, rtol=2e-5, atol=1e-6)
    for net in ("generator", "discriminator"):
        want = dict(getattr(s0, net).named_parameters())
        for name, p in getattr(s1, net).named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=f"{net}.{name}")
    for name in ("avg_latent1", "avg_latent2"):
        np.testing.assert_allclose(getattr(s1.generator, name).numpy(), getattr(s0.generator, name).numpy(),
                                   rtol=2e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Adam with a first moment


def adam_module(params):
    module = torch.nn.Module()
    for k, v in params.items():
        setattr(module, k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    return module


def test_adam_matches_optax_with_a_frozen_leaf():
    """Five steps of beta1 = 0.5; leaf "b" frozen from step 3 on (zero
    gradients, masked update): parameters, mu, nu and count."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    jtx = optax.adam(0.002, b1=0.5, b2=0.99, eps=1e-8)
    jp, js = jax.tree.map(jnp.asarray, params), jtx.init(params)
    module = adam_module(params)
    opt = Adam(module, 0.002, 0.5, 0.99, 1e-8)
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
            np.testing.assert_allclose(opt.mu[k].numpy(), np.asarray(js[0].mu[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(opt.v[k].numpy(), np.asarray(js[0].nu[k]), rtol=1e-6, atol=1e-12)
        assert opt.count == int(js[0].count) == step + 1


def test_adam_state_bridge_both_ways():
    """optax's update on the state the port hands over gives the port's own
    next step, and optax's state after it loads back into the port."""
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((3, 2)).astype(np.float32)}
    module = adam_module(params)
    opt = Adam(module, 0.002, 0.5, 0.99, 1e-8)
    for _ in range(2):
        opt.step([module.w], [torch.from_numpy(rng.standard_normal((3, 2)).astype(np.float32))])
    handed = flax_from_optimizer(opt)
    g = rng.standard_normal((3, 2)).astype(np.float32)
    w = module.w.detach().numpy().copy()
    u, js = optax.adam(0.002, b1=0.5, b2=0.99, eps=1e-8).update({"w": jnp.asarray(g)}, handed, {"w": w})
    opt.step([module.w], [torch.from_numpy(g)])
    np.testing.assert_allclose(module.w.detach().numpy(), w + np.asarray(u["w"]), rtol=1e-6, atol=1e-7)
    back = Adam(adam_module(params), 0.002, 0.5, 0.99, 1e-8)
    load_optimizer(back, jax.device_get(js))
    assert back.count == opt.count == 3
    np.testing.assert_allclose(back.mu["w"].numpy(), opt.mu["w"].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(back.v["w"].numpy(), opt.v["w"].numpy(), rtol=1e-6, atol=1e-12)
    # beta1 == 0 keeps the mu-free optimizer and its layout
    state = Trainer(Config(**CFG, device="cpu")).init_state()
    assert isinstance(state.g_opt, AdamNoMu) and set(state.g_opt.state_dict()) == {"v", "count"}
    assert set(flax_from_optimizer(state.g_opt)) == {"v", "count"}
    assert set(Adam(module, 0.002, 0.5, 0.99, 1e-8).state_dict()) == {"mu", "v", "count"}
