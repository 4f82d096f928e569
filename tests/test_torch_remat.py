"""The port's remat switches (``lcgan_torch.utils.remat``; ``remat_blocks``,
``remat_save_g_convs``, ``remat_save_d_convs``, ``remat_save_max_res``) on
the CPU at the dryrun widths (__graft_entry__.py:64-82, fp32).

Three policies, each with remat on: "plain" (no saves: every block keeps
only its inputs), "saves" (the JAX defaults: G's and D's conv outputs kept
in every block) and "mixed" (saves with ``remat_save_max_res`` 16, below
the 32² top map: some blocks keep their convs and the others take the plain
remat, the path tests/test_models.py:143-190 holds in the JAX package).

  * G and D under each policy against the JAX modules built with the same
    remat settings, from the same weights (``lcgan_torch.convert``):
    outputs, parameter and input gradients.
  * One Trainer iteration of each variant with remat on against remat off:
    losses, gradients and every leaf of the state bitwise equal.
  * Which convolutions run again in the backward, counted by module.
  * ``state_dict`` keys, resume across the switch, the CLI's flags.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lcgan_tpu.models import Discriminator as JaxDiscriminator
from lcgan_tpu.models import Generator as JaxGenerator
from lcgan_torch.cli import parse_config
from lcgan_torch.config import Config
from lcgan_torch.convert import discriminator_from_flax, flax_from_discriminator, flax_from_generator
from lcgan_torch.models.discriminator import Discriminator
from lcgan_torch.models.generator import Generator
from lcgan_torch.ops.equalized import EqualizedConv2d
from lcgan_torch.ops.modulated import ModulatedConv2d
from lcgan_torch.train.state import build_models
from lcgan_torch.train.steps import Trainer
from lcgan_torch.utils import remat
from lcgan_torch.utils.checkpoint import load_state, save_state

G_CFG = dict(img_resolution=32, geo_noise_dim=8, app_noise_dim=8, geo_latent_dim=8, app_latent_dim=16,
             base_nf=8, max_nf=16)
D_CFG = dict(img_resolution=32, geo_projection_dim=8, app_projection_dim=8, base_nf=8, max_nf=16,
             mbstd_group_size=2)
# (conv saves, remat_save_max_res) of each policy
POLICIES = {"plain": (False, 1024), "saves": (True, 1024), "mixed": (True, 16)}
TRAIN_CFG = dict(model_name="/tmp/lcgan_torch_remat_test", img_resolution=32, batch_size=4, geo_noise_dim=8,
                 app_noise_dim=8, geo_latent_dim=8, app_latent_dim=16, geo_projection_dim=8, app_projection_dim=8,
                 base_nf=8, max_nf=16, mbstd_group_size=2, compute_dtype="float32", adam_eps=1e-3,
                 freezeD_start=4, freezeD_layer=1, device="cpu")


def g_remat(policy):
    save, max_res = POLICIES[policy]
    return dict(remat=True, remat_save_g_convs=save, remat_save_max_res=max_res)


def d_remat(policy):
    save, max_res = POLICIES[policy]
    return dict(remat=True, remat_save_d_convs=save, remat_save_max_res=max_res)


def cfg_remat(policy):
    save, max_res = POLICIES[policy]
    return dict(remat_blocks=True, remat_save_g_convs=save, remat_save_d_convs=save, remat_save_max_res=max_res)


def flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_close(have, want, what):
    # fp32 sums over whole images in other orders: 1e-5 of the value's scale
    np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(want).max())), err_msg=what)


# ---------------------------------------------------------------------------
# (1) each policy against the JAX modules under the same policy


@pytest.mark.parametrize("policy", POLICIES)
def test_generator_matches_jax_under_remat(policy):
    model = Generator(**G_CFG, **g_remat(policy), generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last).train()
    params, stats = flax_from_generator(model.state_dict())
    rng = np.random.default_rng(1)
    z1, z2 = (rng.standard_normal((2, 8)).astype(np.float32) for _ in range(2))
    cot = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)  # NHWC cotangent of the image
    jax_gen = JaxGenerator(**G_CFG, **g_remat(policy), warp_impl="banded")

    def total(p, a, b):
        out, _ = jax_gen.apply({"params": p, "stats": stats}, a, b, -1.0, mutable=["stats"])
        return jnp.sum(out * cot), out

    (_, ref_out), ref_grads = jax.jit(jax.value_and_grad(total, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(z1), jnp.asarray(z2))

    t1, t2 = (torch.from_numpy(z).requires_grad_(True) for z in (z1, z2))
    out = model(t1, t2, w_psi=-1.0)
    names = [n for n, _ in model.named_parameters()]
    leaves = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum(), leaves + [t1, t2])
    assert_close(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref_out), "image")
    got, _ = flax_from_generator(dict(zip(names, grads[:-2])))
    want = flat(ref_grads[0])
    assert flat(got).keys() == want.keys()
    for path, have in flat(got).items():
        assert_close(have, want[path], f"{policy}: G grad {path}")
    for i, (have, w) in enumerate(zip(grads[-2:], ref_grads[1:])):
        assert_close(have.numpy(), np.asarray(w), f"{policy}: grad of z{i + 1}")


@pytest.mark.parametrize("policy", POLICIES)
def test_discriminator_matches_jax_under_remat(policy):
    jd = JaxDiscriminator(**D_CFG, **d_remat(policy))
    params = jd.init(jax.random.PRNGKey(1), jnp.zeros((2, 32, 32, 3)), True)["params"]
    params = jax.tree.map(np.asarray, params)
    td = Discriminator(**D_CFG, **d_remat(policy))
    td.load_state_dict(discriminator_from_flax(params))
    td = td.to(memory_format=torch.channels_last)
    img = np.random.default_rng(2).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)

    def loss(p, x):
        logit, ge, ae = jd.apply({"params": p}, x, True, 1)
        return jnp.mean(jnp.square(logit)) + jnp.mean(ge * ae)

    ref_loss, (ref_dp, ref_dx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(params, jnp.asarray(img))
    x = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    logit, ge, ae = td(x, True)
    t_loss = logit.square().mean() + (ge * ae).mean()
    names = [n for n, _ in td.named_parameters()]
    grads = torch.autograd.grad(t_loss, [p for _, p in td.named_parameters()] + [x])
    assert_close(t_loss.item(), float(ref_loss), "loss")
    assert_close(grads[-1].permute(0, 2, 3, 1).numpy(), np.asarray(ref_dx), f"{policy}: image grad")
    got, want = flat(flax_from_discriminator(dict(zip(names, grads[:-1])))), flat(ref_dp)
    assert got.keys() == want.keys()
    for path, have in got.items():
        assert_close(have, want[path], f"{policy}: D grad {path}")


# ---------------------------------------------------------------------------
# (2) remat on against remat off, bitwise, one iteration of each variant

# variant: (epoch, Config changes)
VARIANTS = {
    "even": (0, {}),
    "odd_r1": (1, {}),
    "odd": (3, {}),
    "odd_frozen": (5, {}),
    "even_view_batched": (0, dict(view_batched_steps=True)),
    "even_small_route": (0, dict(warp_pallas_min_res=8)),
}


def one_iteration(cfg: Config, start: dict, epoch: int):
    """(g_loss, d_loss, gradients Adam received, every state leaf) after one
    iteration from ``start`` on a seeded batch and noise."""
    trainer = Trainer(cfg)
    state = trainer.init_state()
    state.load_state_dict(start)
    grads = {}
    for key, opt in (("G", state.g_opt), ("D", state.d_opt)):
        def record(params, g, frozen=None, key=key, step=opt.step):
            grads[key] = [t.detach().clone() for t in g]
            step(params, g, frozen)
        opt.step = record
    g = torch.Generator().manual_seed(epoch + 10)
    batch = {k: torch.rand((4, 3, 32, 32), generator=g) * 2 - 1
             for k in ("image", "geometry_change", "appearance_change")}
    noise = tuple(torch.randn((4, 8), generator=g) for _ in range(6))
    state, g_loss, d_loss = trainer.step_variant(epoch)(state, batch, noise)
    return g_loss, d_loss, grads, state.state_dict()


@pytest.fixture(scope="module")
def start_state():
    """A state two iterations in, so Adam's v and the w averages are not at their init."""
    trainer = Trainer(Config(**TRAIN_CFG))
    state = trainer.init_state()
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.rand((4, 3, 32, 32), generator=g) * 2 - 1
             for k in ("image", "geometry_change", "appearance_change")}
    for epoch in (0, 1):
        state, _, _ = trainer.train_iteration(state, batch, epoch)
    return state.state_dict()


@pytest.fixture(scope="module")
def remat_off(start_state):
    cache = {}

    def get(variant):
        if variant not in cache:
            epoch, changes = VARIANTS[variant]
            cache[variant] = one_iteration(Config(**TRAIN_CFG, **changes), start_state, epoch)
        return cache[variant]
    return get


def tensors_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tensors_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(tensors_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_trainer_iteration_bitwise_under_remat(start_state, remat_off, variant, policy):
    epoch, changes = VARIANTS[variant]
    ref = remat_off(variant)
    got = one_iteration(Config(**TRAIN_CFG, **changes, **cfg_remat(policy)), start_state, epoch)
    assert torch.isfinite(got[0]) and torch.isfinite(got[1])
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (got[:2], ref[:2])
    for net in ("G", "D"):
        assert tensors_equal(got[2][net], ref[2][net]), f"{net} gradients differ"
    for key in ref[3]:
        assert tensors_equal(got[3][key], ref[3][key]), f"state {key} differs"


# ---------------------------------------------------------------------------
# (3) which convolutions run again in the backward


class ConvCounter(TorchDispatchMode):
    """Counts aten.convolution calls by the conv module running them (set
    by forward hooks): during a backward these are the recompute's."""

    def __init__(self, current):
        super().__init__()
        self.current, self.counts = current, Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.counts[self.current[0]] += 1
        return func(*args, **(kwargs or {}))


def conv_modules(prefix, net):
    return {f"{prefix}.{n}": m for n, m in net.named_modules() if isinstance(m, (ModulatedConv2d, EqualizedConv2d))}


@pytest.mark.parametrize("policy", ["off", *POLICIES])
def test_backward_recomputes_the_convs_the_policy_drops(policy):
    g_kw, d_kw = ({}, {}) if policy == "off" else (g_remat(policy), d_remat(policy))
    g = Generator(**G_CFG, **g_kw, generator=torch.Generator().manual_seed(0)).to(memory_format=torch.channels_last)
    d = Discriminator(**D_CFG, **d_kw, generator=torch.Generator().manual_seed(1)).to(memory_format=torch.channels_last)
    current = [None]
    modules = {**conv_modules("G", g), **conv_modules("D", d)}
    for name, m in modules.items():
        m.register_forward_pre_hook(lambda mod, args, name=name: current.__setitem__(0, name))
        m.register_forward_hook(lambda mod, args, out: current.__setitem__(0, None))
    z = torch.randn((2, 8), generator=torch.Generator().manual_seed(2))
    logit, ge, ae = d(g(z, z), True)
    with ConvCounter(current) as counter:
        torch.autograd.grad(logit.sum() + (ge * ae).sum(), list(g.parameters()) + list(d.parameters()))

    expect = Counter()
    if policy != "off":
        save, max_res = POLICIES[policy]
        for i in range(3):
            expect[f"G.block_{i}.skip_layer"] = 1  # unnamed: recomputed under every policy
            if not (save and 8 * 2**i <= max_res):  # the JAX rule: the block's output map
                for layer in ("flow_layer", "modulated_conv0", "modulated_conv1"):
                    expect[f"G.block_{i}.{layer}.modulated_conv"] = 1
            expect[f"D.block_{i}.skip_layer"] = 1
            if not (save and 32 // 2**i <= max_res):  # the block's input map
                expect[f"D.block_{i}.conv0"] = expect[f"D.block_{i}.conv1"] = 1
        expect["G.rgb_layer.modulated_conv0.modulated_conv"] = 1  # ToRGB: plain remat, never a policy
        expect["G.rgb_layer.modulated_conv1.modulated_conv"] = 1
    assert counter.counts == expect
    assert set(expect) <= set(modules)


def test_no_grad_calls_the_blocks_directly(monkeypatch):
    """Generation, FID, videos and the D step's fakes run under no_grad:
    no checkpoint is made there."""
    def refuse(*args, **kwargs):
        raise AssertionError("checkpoint called under no_grad")

    monkeypatch.setattr(remat, "checkpoint", refuse)
    g = Generator(**G_CFG, **g_remat("saves"), generator=torch.Generator().manual_seed(0))
    ref = Generator(**G_CFG, generator=torch.Generator().manual_seed(0))
    z = torch.randn((2, 8), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(g(z, z, w_psi=0.7), ref(z, z, w_psi=0.7))


# ---------------------------------------------------------------------------
# (4) the state across the switch, (5) the flags


def test_state_dict_keys_do_not_depend_on_remat():
    off = Trainer(Config(**TRAIN_CFG)).init_state().state_dict()
    on = Trainer(Config(**TRAIN_CFG, **cfg_remat("saves"))).init_state().state_dict()
    for key in ("generator", "discriminator", "ema"):
        assert list(off[key]) == list(on[key]), key
    assert tensors_equal(off, on)  # the same seed builds the same weights either way


def test_checkpoint_without_remat_resumes_with_it(tmp_path):
    """Epochs 0-1 with remat off, saved; epochs 2-3 from the file with remat
    on (the JAX saves) and, as the reference, with it off: the same state,
    bitwise."""
    g = torch.Generator().manual_seed(5)
    batch = {k: torch.rand((4, 3, 32, 32), generator=g) * 2 - 1
             for k in ("image", "geometry_change", "appearance_change")}
    trainer = Trainer(Config(**TRAIN_CFG))
    state = trainer.init_state()
    for epoch in (0, 1):
        state, _, _ = trainer.train_iteration(state, batch, epoch)
    path = str(tmp_path / "state.pt")
    save_state(path, state)
    finals = []
    for changes in ({}, cfg_remat("saves")):
        trainer = Trainer(Config(**TRAIN_CFG, **changes))
        state = trainer.init_state()
        load_state(path, state)
        losses = []
        for epoch in (2, 3):
            state, g_loss, d_loss = trainer.train_iteration(state, batch, epoch)
            losses += [g_loss, d_loss]
        finals.append((losses, state.state_dict()))
    assert tensors_equal(finals[0], finals[1])


@pytest.mark.parametrize("argv,want", [
    ([], dict(remat_blocks=False, remat_save_g_convs=True, remat_save_d_convs=True, remat_save_max_res=1024)),
    (["--remat_blocks"], dict(remat_blocks=True, remat_save_g_convs=True, remat_save_d_convs=True,
                              remat_save_max_res=1024)),
    (["--remat_blocks", "--no-remat_save_g_convs", "--remat_save_max_res", "16"],
     dict(remat_blocks=True, remat_save_g_convs=False, remat_save_d_convs=True, remat_save_max_res=16)),
    (["--remat_blocks", "--no-remat_save_d_convs"],
     dict(remat_blocks=True, remat_save_g_convs=True, remat_save_d_convs=False, remat_save_max_res=1024)),
], ids=["default", "remat", "no-g-saves-16", "no-d-saves"])
def test_cli_flags_reach_the_models(argv, want):
    cfg = parse_config(["--model_name", "/tmp/lcgan_torch_remat_cli", "--img_resolution", "32", "--base_nf", "8",
                        "--max_nf", "16", "--device", "cpu", *argv])
    assert {k: getattr(cfg, k) for k in want} == want
    g, d = build_models(cfg)
    assert g.remat == d.remat == want["remat_blocks"]
    max_res = want["remat_save_max_res"]
    # G: block i writes an 8·2^i map; D: block i reads a 32/2^i one
    assert g.block_saves == [want["remat_save_g_convs"] and 8 * 2**i <= max_res for i in range(3)]
    assert d.block_saves == [want["remat_save_d_convs"] and 32 // 2**i <= max_res for i in range(3)]


def test_saved_conv_outside_a_block_is_a_plain_call():
    """A marked conv with no checkpoint around it, or an unmarked one (a
    skip conv) inside a block that keeps its convs, keeps nothing."""
    x, w = torch.randn((1, 2, 5, 5)), torch.randn((3, 2, 3, 3))
    ref = torch.nn.functional.conv2d(x, w, padding=1)
    assert torch.equal(remat.saved_conv(True, torch.nn.functional.conv2d, x, w, padding=1), ref)
    saves = remat._Saves()
    with remat._Region(saves, False):
        out = remat.saved_conv(False, torch.nn.functional.conv2d, x, w, padding=1)
    assert torch.equal(out, ref) and saves.outputs == []
