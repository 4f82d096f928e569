"""The port's Generator and weight bridge against lcgan_tpu's Generator.

Weights are made once, by the port's seeded init, and carried to Flax by
``lcgan_torch.convert``; z comes from numpy. The JAX side runs in fp32 with
``warp_impl="banded"``; the torch side on the CPU, where the warp is the
plain version. 128² (base_nf 4, max_nf 16) covers maps on which the TPU
would run the Pallas forward kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcgan_tpu.models import Generator as JaxGenerator
from lcgan_torch.convert import flax_from_generator, generator_from_flax
from lcgan_torch.models.generator import Generator

# the dryrun config of __graft_entry__.py:64-82
DRYRUN = dict(img_resolution=32, geo_noise_dim=8, app_noise_dim=8, geo_latent_dim=8,
              app_latent_dim=16, base_nf=8, max_nf=16)
AT_128 = dict(DRYRUN, img_resolution=128, base_nf=4, max_nf=16)


def flax_shapes(cfg: dict, use_noise: bool = False):
    """The Flax (params, stats) tree's leaf shapes, without running init."""
    g = JaxGenerator(**cfg, use_noise=use_noise)
    z = jnp.zeros((2, cfg["geo_noise_dim"]))
    return jax.eval_shape(lambda k: g.init(k, z, z, -1.0), jax.random.PRNGKey(0))


def torch_and_flax(cfg: dict, seed: int = 0, warp_impl: str = "auto"):
    """A seeded port Generator (with nonzero w-avg stats) and the same weights as Flax trees."""
    model = Generator(**cfg, warp_impl=warp_impl, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for buf in (model.avg_latent1, model.avg_latent2):
        buf.copy_(torch.from_numpy(rng.standard_normal(buf.shape).astype(np.float32)))
    params, stats = flax_from_generator(model.state_dict())
    return model.to(memory_format=torch.channels_last), params, stats


@pytest.mark.parametrize("use_noise", [False, True])
def test_bridge_round_trip_is_bit_exact(use_noise):
    shapes = flax_shapes(DRYRUN, use_noise)
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    params, stats = dict(tree["params"]), dict(tree["stats"])

    model = Generator(**DRYRUN, use_noise=use_noise)
    model.load_state_dict(generator_from_flax(params, stats))  # strict: every leaf maps
    params2, stats2 = flax_from_generator(model.state_dict())

    for ref, got in ((params, params2), (stats, stats2)):
        assert jax.tree.structure(ref) == jax.tree.structure(got)
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_bridge_matches_flax_tree_structure():
    """The port's own init carries over to exactly the Flax tree of shapes."""
    _, params, stats = torch_and_flax(DRYRUN)
    shapes = flax_shapes(DRYRUN)
    got = jax.tree.map(lambda a: a.shape, {"params": params, "stats": stats})
    ref = jax.tree.map(lambda s: s.shape, {"params": dict(shapes["params"]), "stats": dict(shapes["stats"])})
    assert got == ref


@pytest.mark.parametrize(
    "cfg,w_psi,warp_impl",
    [(DRYRUN, 1.0, "auto"), (DRYRUN, 0.7, "auto"), (DRYRUN, -1.0, "auto"), (AT_128, 0.7, "auto"),
     (DRYRUN, 0.7, "none")],
    ids=["32-psi1", "32-psi0.7", "32-psi-1", "128-psi0.7", "32-psi0.7-none"],
)
def test_generator_matches_jax(cfg, w_psi, warp_impl):
    """"none" (the diagnostic ablation) skips the warp on both sides."""
    model, params, stats = torch_and_flax(cfg, warp_impl=warp_impl)
    rng = np.random.default_rng(2)
    z1 = rng.standard_normal((2, cfg["geo_noise_dim"])).astype(np.float32)
    z2 = rng.standard_normal((2, cfg["app_noise_dim"])).astype(np.float32)

    jax_impl = "none" if warp_impl == "none" else "banded"
    ref, mut = JaxGenerator(**cfg, warp_impl=jax_impl).apply(
        {"params": params, "stats": stats}, jnp.asarray(z1), jnp.asarray(z2), w_psi, mutable=["stats"]
    )
    with torch.no_grad():
        out = model(torch.from_numpy(z1), torch.from_numpy(z2), w_psi=w_psi)
    assert out.shape == (2, 3, cfg["img_resolution"], cfg["img_resolution"])
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)

    # w_psi <= 0 updates the w averages; w_psi > 0 leaves them alone
    for name in ("avg_latent1", "avg_latent2"):
        np.testing.assert_allclose(
            getattr(model, name).numpy(), np.asarray(mut["stats"][name]), atol=1e-6, rtol=1e-6
        )
        assert np.array_equal(getattr(model, name).numpy(), stats[name]) == (w_psi > 0)


def test_eval_mode_keeps_stats():
    """Generation runs the EMA generator in eval mode: w_psi <= 0 leaves the w averages."""
    model, _, stats = torch_and_flax(DRYRUN)
    z = torch.randn((2, 8), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.eval()(z, z, w_psi=-1.0)
    for name in ("avg_latent1", "avg_latent2"):
        assert np.array_equal(getattr(model, name).numpy(), stats[name])


def test_bf16_forward_is_finite_and_near_fp32():
    model, _, _ = torch_and_flax(DRYRUN)
    model16 = Generator(**DRYRUN, dtype=torch.bfloat16)
    model16.load_state_dict(model.state_dict())
    model16 = model16.to(memory_format=torch.channels_last)
    z = torch.randn((2, 8), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        ref = model(z, z, w_psi=0.7)
        out = model16(z, z, w_psi=0.7)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    # bf16 keeps 8 bits: after three blocks of convs the images agree to a few percent of their range
    assert (out.float() - ref).abs().max() <= 0.05 * ref.abs().max()


@pytest.mark.parametrize("warp_impl", ["none", "auto"])
def test_generator_gradients_match_jax(warp_impl):
    """G's gradients of a sum of the output, as the train step takes them
    (``train.steps._grads``: zeros for a leaf the loss does not reach),
    against ``jax.grad`` of the same sum. Under "none" the flow layers feed
    nothing, so both sides give them zeros."""
    from lcgan_torch.train.steps import _grads

    model, params, stats = torch_and_flax(DRYRUN, warp_impl=warp_impl)
    rng = np.random.default_rng(5)
    z1 = rng.standard_normal((2, DRYRUN["geo_noise_dim"])).astype(np.float32)
    z2 = rng.standard_normal((2, DRYRUN["app_noise_dim"])).astype(np.float32)
    jax_gen = JaxGenerator(**DRYRUN, warp_impl="none" if warp_impl == "none" else "banded")

    def total(p):
        out, _ = jax_gen.apply({"params": p, "stats": stats}, jnp.asarray(z1), jnp.asarray(z2), -1.0,
                               mutable=["stats"])
        return out.sum()

    ref = jax.grad(total)(params)
    names = [n for n, _ in model.named_parameters()]
    leaves = [p for _, p in model.named_parameters()]
    out = model.train()(torch.from_numpy(z1), torch.from_numpy(z2), w_psi=-1.0)
    got, _ = flax_from_generator(dict(zip(names, _grads(out.sum(), leaves))))

    ref_flat = dict(jax.tree_util.tree_leaves_with_path(ref))
    got_flat = dict(jax.tree_util.tree_leaves_with_path(got))
    assert ref_flat.keys() == got_flat.keys()
    flow_leaves = 0
    for path, want in ref_flat.items():
        want, have = np.asarray(want), np.asarray(got_flat[path])
        # fp32 sums over the whole image in other orders: 1e-5 of the leaf's scale
        np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(want).max())),
                                   err_msg=jax.tree_util.keystr(path))
        if "flow_layer" in jax.tree_util.keystr(path):
            flow_leaves += 1
            assert (not want.any() and not have.any()) == (warp_impl == "none")
    assert flow_leaves == 2 * model.num_blocks * 2  # modulated_conv and linear, weight and bias, per block
