"""The port's Discriminator, its ops, its weight bridge and the losses
against lcgan_tpu, on the CPU in fp32.

Weights are made by the JAX package's init and carried to the port by
``lcgan_torch.convert``; images come from numpy (NHWC for JAX, NCHW for the
port). The config is the dryrun's (__graft_entry__.py:64-82).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcgan_tpu import losses as j_losses
from lcgan_tpu.models import Discriminator as JaxDiscriminator
from lcgan_tpu.ops import equalized as j_eq
from lcgan_tpu.ops import filters as j_filters
from lcgan_tpu.ops import mapping as j_mapping
from lcgan_tpu.ops import mbstd as j_mbstd
from lcgan_torch import losses as t_losses
from lcgan_torch.convert import discriminator_from_flax, flax_from_discriminator
from lcgan_torch.models.discriminator import Discriminator
from lcgan_torch.ops import equalized as t_eq
from lcgan_torch.ops import filters as t_filters
from lcgan_torch.ops import mapping as t_mapping
from lcgan_torch.ops import mbstd as t_mbstd

DRYRUN = dict(img_resolution=32, geo_projection_dim=8, app_projection_dim=8, base_nf=8, max_nf=16,
              mbstd_group_size=2)
# fp32 on both sides; the convs, means and heads sum in other orders
TOL = dict(atol=1e-5, rtol=1e-5)


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def images(n=4, res=32, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, res, res, 3)).astype(np.float32)


def both_discriminators(seed=0):
    """JAX D with its init params, and the port's D carrying the same weights."""
    jd = JaxDiscriminator(**DRYRUN)
    params = jd.init(jax.random.PRNGKey(seed), jnp.zeros((2, 32, 32, 3)), True)["params"]
    params = jax.tree.map(np.asarray, params)
    td = Discriminator(**DRYRUN)
    td.load_state_dict(discriminator_from_flax(params))  # strict: every leaf maps
    return jd, params, td.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("emb", [False, True])
def test_discriminator_matches_jax(emb):
    jd, params, td = both_discriminators()
    img = images()
    ref = jd.apply({"params": params}, jnp.asarray(img), emb)
    with torch.no_grad():
        out = td(nchw(img), emb)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), **TOL)
    for got, want in zip(out[1:], ref[1:]):
        if emb:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        else:
            assert got is None and want is None


def test_discriminator_bridge_round_trip_is_bit_exact():
    jd = JaxDiscriminator(**DRYRUN)
    shapes = jax.eval_shape(lambda k: jd.init(k, jnp.zeros((2, 32, 32, 3)), True), jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), dict(shapes["params"]))
    td = Discriminator(**DRYRUN)
    td.load_state_dict(discriminator_from_flax(params))
    back = flax_from_discriminator(td.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,group", [(4, 2), (8, 8), (6, 3), (2, 8)])
def test_minibatch_stddev_matches_jax(n, group):
    x = np.random.default_rng(2).standard_normal((n, 4, 4, 16)).astype(np.float32)
    ref = j_mbstd.minibatch_stddev(jnp.asarray(x), group_size=group)
    out = t_mbstd.minibatch_stddev(nchw(x), group_size=group)
    assert out.shape == (n, 17, 4, 4)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), **TOL)


def test_avg_pool_2x2_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 8, 12, 5)).astype(np.float32)
    ref = j_filters.avg_pool_2x2(jnp.asarray(x))
    np.testing.assert_allclose(nhwc(t_filters.avg_pool_2x2(nchw(x))), np.asarray(ref), **TOL)


def test_stride2_conv_matches_jax():
    """The D blocks' conv1 (k=3, stride 2, pad 1, bias); stride 1 is in test_torch_ops.py."""
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 6)).astype(np.float32)
    jconv = j_eq.EqualizedConv2d(features=5, kernel_size=3, stride=2)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {**params, "bias": jnp.linspace(-1.0, 1.0, 5)}  # nonzero, so that its lr_mul scaling shows
    ref = jconv.apply({"params": params}, jnp.asarray(x))
    tconv = t_eq.EqualizedConv2d(6, 5, 3, stride=2)
    tconv.load_state_dict(discriminator_from_flax(params))
    with torch.no_grad():
        out = tconv(nchw(x))
    assert out.shape == (2, 5, 4, 4)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize("channels", [[16, 1], [64, 16, 8, 4]])
def test_projection_head_matches_jax(channels):
    x = np.random.default_rng(5).standard_normal((3, channels[0])).astype(np.float32)
    jhead = j_mapping.ProjectionHead(channels)
    params = jhead.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = jax.tree.map(np.asarray, params)
    ref = jhead.apply({"params": params}, jnp.asarray(x))
    thead = t_mapping.ProjectionHead(channels)
    thead.load_state_dict(discriminator_from_flax(params))
    with torch.no_grad():
        np.testing.assert_allclose(thead(torch.from_numpy(x)).numpy(), np.asarray(ref), **TOL)


def test_contrastive_bce_sparsity_match_jax():
    rng = np.random.default_rng(6)
    a, p, n = (rng.standard_normal((4, 8)).astype(np.float32) for _ in range(3))
    logit = (rng.standard_normal((4, 1)) * 5).astype(np.float32)
    d1, d2 = rng.standard_normal(8).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (t_losses.contrastive_loss(t(a), t(p), t(n), 0.05), j_losses.contrastive_loss(a, p, n, 0.05)),
        (t_losses.bce_logits(t(logit), 1.0), j_losses.bce_logits(logit, 1.0)),
        (t_losses.bce_logits(t(logit), 0.0), j_losses.bce_logits(logit, 0.0)),
        (t_losses.bce_logits(t(logit), 0.3), j_losses.bce_logits(logit, 0.3)),
        (t_losses.sparsity_loss(t(d1), t(d2)), j_losses.sparsity_loss(d1, d2)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)


def test_r1_value_and_image_gradients_match_jax():
    """R1 through the discriminator: its value, the logits it returns, the
    image gradient it squares, and d(r1)/d(image) (the double backward)."""
    jd, params, td = both_discriminators()
    img = images(seed=7)

    def j_logits(x):
        return jd.apply({"params": params}, x, False)[0]

    ref_logits, ref_r1 = j_losses.r1_penalty_with_logits(j_logits, jnp.asarray(img))
    ref_gimg = jax.grad(lambda x: jnp.sum(j_logits(x)))(jnp.asarray(img))
    ref_dr1 = jax.grad(lambda x: j_losses.r1_penalty_with_logits(j_logits, x)[1])(jnp.asarray(img))

    x = nchw(img).requires_grad_(True)
    logits, r1 = t_losses.r1_penalty_with_logits(lambda i: td(i, False)[0], x)
    (gimg,) = torch.autograd.grad(td(x, False)[0].sum(), x)
    (dr1,) = torch.autograd.grad(t_losses.r1_penalty_with_logits(lambda i: td(i, False)[0], x)[1], x)

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), **TOL)
    np.testing.assert_allclose(r1.item(), float(ref_r1), rtol=1e-5)
    np.testing.assert_allclose(nhwc(gimg), np.asarray(ref_gimg), **TOL)
    # a second derivative through every layer, at init ~1e-8: its terms
    # cancel, so fp32 sums in other orders agree to ~1e-4 of its scale
    scale = float(np.abs(np.asarray(ref_dr1)).max())
    np.testing.assert_allclose(nhwc(dr1), np.asarray(ref_dr1), atol=1e-4 * scale, rtol=1e-4)
