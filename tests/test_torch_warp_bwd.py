"""The port's plain warp backward (``grid_sample_bicubic_plain_backward``)
against four oracles, on the CPU:

  1. ``jax.vjp`` of ``lcgan_tpu.ops.grid_sample.grid_sample_bicubic_banded``;
  2. the Pallas backward kernels themselves, in interpret mode, at W >= 128
     so that ``_vjp_bwd`` does not take the small-map kernels: K2
     (``_dgrid_kernel``) with K3 (``_dx_gather_kernel``) at C >= 128, and
     with K4 (``_dx_scatter_kernel`` and ``_overlap_add``) at C < 128;
  3. ``torch.autograd`` through ``grid_sample_bicubic_plain``;
  4. ``torch.autograd`` through ``F.grid_sample(mode='bicubic',
     padding_mode='zeros', align_corners=False)``.

Plus the autograd Function's wiring on the CPU. Flows are ``identity +
U(-1, 1) · s`` at s = 0.1 (the tanh bound) and 0.03 (the trained
magnitude). The CUDA kernels (``csrc/warp_dgrid.cu``, ``csrc/warp_dx.cu``,
``csrc/warp_dx_scatter.cu``) are held against this plain backward on the card, in
tests/test_torch_cuda.py and chip_smoke.py.

dgrid is a sum over channels of products scaled by W/2 (up to ~1e3 here),
so its tolerances are relative to its largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lcgan_tpu.ops import grid_sample as j_gs
from lcgan_tpu.ops.warp_pallas import _use_small, grid_sample_bicubic_pallas
from lcgan_torch.ops import grid_sample as t_gs
from lcgan_torch.ops import warp as t_warp

FLOWS = [0.1, 0.03]


def smooth_flow(rng, b, h, w):
    """U(-1, 1) at 1/16 of the map's size, upsampled bilinearly: neighbouring
    pixels move together, as the generator's box-filtered flows do (the card
    kernels' smooth-flow input)."""
    coarse = rng.uniform(-1, 1, (b, 2, max(1, h // 16), max(1, w // 16))).astype(np.float32)
    up = F.interpolate(torch.from_numpy(coarse), size=(h, w), mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1).numpy()


def case(shape, s, seed=0, flow="iid"):
    """NHWC features, a (B, H, W, 2) grid and an NHWC cotangent, as numpy:
    identity plus an iid U(-1, 1) flow per pixel (or a smooth one) times s."""
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if flow == "smooth":
        d = smooth_flow(rng, b, h, w)
    else:
        d = rng.uniform(-1, 1, (b, h, w, 2)).astype(np.float32)
    grid = (np.asarray(j_gs.identity_like_coordinates(b, h, w)) + d * np.float32(s)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, grid, g


def extreme_grid(kind, shape, seed=0):
    """The card checks' grids beyond any displacement bound: "pileup", every
    pixel on one spot; "thrown", two pixels thrown across the map among
    smooth near ones (s = 0.03)."""
    x, grid, g = case(shape, 0.03, seed, flow="smooth")
    if kind == "pileup":
        grid = np.full_like(grid, 0.01)
    else:
        b, h, w, _ = shape
        grid[b - 1, h // 3, min(5, w - 1)] = (0.9, -0.95)
        grid[0, h - 1, 0] = (-0.7, 0.8)
    return x, grid, g


def nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def plain_bwd(x, grid, g):
    """The port's plain backward, returned as NHWC dx and dgrid, numpy."""
    dx, dgrid = t_gs.grid_sample_bicubic_plain_backward(nchw(x), torch.from_numpy(grid), nchw(g))
    assert dx.dtype == torch.float32 and dgrid.dtype == torch.float32
    return dx.permute(0, 2, 3, 1).numpy(), dgrid.numpy()


def autograd_bwd(fn, x, grid, g):
    xt = nchw(x).clone().requires_grad_()
    gt = torch.from_numpy(grid).clone().requires_grad_()
    fn(xt, gt).backward(nchw(g))
    return xt.grad.permute(0, 2, 3, 1).numpy(), gt.grad.numpy()


def assert_grads(got, want, dx_atol, dgrid_rel):
    np.testing.assert_allclose(got[0], want[0], atol=dx_atol)
    scale = float(np.abs(want[1]).max())
    np.testing.assert_allclose(got[1], want[1], atol=dgrid_rel * scale)


@pytest.mark.parametrize("s", FLOWS)
@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 8, 32, 5)])
def test_plain_backward_matches_jax_banded_vjp(shape, s):
    x, grid, g = case(shape, s)
    m = j_gs.max_warp_displacement(max(shape[1], shape[2]), s)
    _, vjp = jax.vjp(lambda a, b: j_gs.grid_sample_bicubic_banded(a, b, m), jnp.asarray(x), jnp.asarray(grid))
    dx, dgrid = vjp(jnp.asarray(g))
    # fp32 both; the banded form sums its band as HIGHEST-precision matmuls
    assert_grads(plain_bwd(x, grid, g), (np.asarray(dx), np.asarray(dgrid)), 1e-5, 1e-5)


@pytest.mark.parametrize("s", FLOWS)
def test_plain_backward_matches_pallas_bwd_kernels(s):
    shape = (1, 8, 128, 128)
    b, h, w, c = shape
    m = j_gs.max_warp_displacement(max(h, w), s)
    assert not _use_small(h, w, c, m, 4) and c >= 128  # K2 and K3 (gather dx) themselves
    x, grid, g = case(shape, s)
    _, vjp = jax.vjp(lambda a, b: grid_sample_bicubic_pallas(a, b, m, True), jnp.asarray(x), jnp.asarray(grid))
    dx, dgrid = vjp(jnp.asarray(g))
    got = plain_bwd(x, grid, g)
    # the tolerances of tests/test_warp_pallas.py:63-64 (banded matmul sums)
    np.testing.assert_allclose(got[0], np.asarray(dx), atol=1e-3)
    np.testing.assert_allclose(got[1], np.asarray(dgrid), atol=2e-2)


@pytest.mark.parametrize("s", FLOWS)
def test_plain_backward_matches_pallas_scatter_dx(s):
    shape = (1, 16, 128, 32)
    b, h, w, c = shape
    m = j_gs.max_warp_displacement(max(h, w), s)
    assert not _use_small(h, w, c, m, 4) and c < 128  # K2 and K4 (scatter dx + overlap-add)
    x, grid, g = case(shape, s)
    _, vjp = jax.vjp(lambda a, b: grid_sample_bicubic_pallas(a, b, m, True), jnp.asarray(x), jnp.asarray(grid))
    dx, dgrid = vjp(jnp.asarray(g))
    got = plain_bwd(x, grid, g)
    # the tolerances of tests/test_warp_pallas.py:63-64 (banded matmul sums)
    np.testing.assert_allclose(got[0], np.asarray(dx), atol=1e-3)
    np.testing.assert_allclose(got[1], np.asarray(dgrid), atol=2e-2)


@pytest.mark.parametrize("s", FLOWS)
def test_plain_backward_matches_pallas_scatter_dx_smooth_flow(s):
    """The smooth flow of the card's timings and checks, within the tanh
    bound, at C < 128: K2 and K4 in interpret mode."""
    shape = (1, 16, 128, 32)
    b, h, w, c = shape
    m = j_gs.max_warp_displacement(max(h, w), s)
    assert not _use_small(h, w, c, m, 4) and c < 128
    x, grid, g = case(shape, s, flow="smooth")
    _, vjp = jax.vjp(lambda a, b: grid_sample_bicubic_pallas(a, b, m, True), jnp.asarray(x), jnp.asarray(grid))
    dx, dgrid = vjp(jnp.asarray(g))
    got = plain_bwd(x, grid, g)
    np.testing.assert_allclose(got[0], np.asarray(dx), atol=1e-3)
    np.testing.assert_allclose(got[1], np.asarray(dgrid), atol=2e-2)


@pytest.mark.parametrize("kind", ["pileup", "thrown"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 8, 32, 5)])
def test_plain_backward_matches_jax_beyond_the_bound(shape, kind):
    """Grids no tanh-sized band covers: the VJPs of the JAX gather reference
    and of the banded form with a band over the whole map."""
    x, grid, g = extreme_grid(kind, shape)
    got = plain_bwd(x, grid, g)
    m = max(shape[1], shape[2]) + 3
    for fn in (j_gs.grid_sample_bicubic, lambda a, b: j_gs.grid_sample_bicubic_banded(a, b, m)):
        _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(grid))
        dx, dgrid = vjp(jnp.asarray(g))
        # a pile-up sums every pixel's terms into 16 taps, in another order
        assert_grads(got, (np.asarray(dx), np.asarray(dgrid)), 1e-5 * max(1.0, float(np.abs(dx).max())), 1e-5)


@pytest.mark.parametrize("s", FLOWS)
@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 8, 32, 5), (2, 12, 20, 3)])
def test_plain_backward_matches_autograd_of_plain(shape, s):
    x, grid, g = case(shape, s)
    want = autograd_bwd(t_gs.grid_sample_bicubic_plain, x, grid, g)
    # the same taps and weights; autograd sums the 16 taps' terms in another order
    assert_grads(plain_bwd(x, grid, g), want, 1e-6, 1e-6)


@pytest.mark.parametrize("s", FLOWS)
@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 8, 32, 5), (1, 8, 128, 16)])
def test_plain_backward_matches_torch_grid_sample(shape, s):
    x, grid, g = case(shape, s)

    def ref(a, b):
        return F.grid_sample(a, b, mode="bicubic", padding_mode="zeros", align_corners=False)

    # aten evaluates the weights per tap from |t|; ours from t = f - floor(f)
    assert_grads(plain_bwd(x, grid, g), autograd_bwd(ref, x, grid, g), 1e-5, 1e-5)


@pytest.mark.parametrize("s", FLOWS)
def test_autograd_function_on_cpu_matches_plain(s):
    """The Function's CPU path: plain forward, plain backward, no kernel launch."""
    x, grid, g = case((2, 16, 16, 8), s)
    kernels = (t_warp.warp_fwd, t_warp.warp_dgrid, t_warp.warp_dx, t_warp.warp_dx_scatter)
    before = [k.launches for k in kernels]
    got = autograd_bwd(t_warp.grid_sample_bicubic, x, grid, g)
    assert [k.launches for k in kernels] == before
    want = plain_bwd(x, grid, g)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert_grads(got, autograd_bwd(t_gs.grid_sample_bicubic_plain, x, grid, g), 1e-6, 1e-6)


def test_autograd_function_needs_input_grad():
    """Only the inputs that need a gradient get one; bf16 features give bf16 dx."""
    x, grid, g = case((1, 8, 8, 4), 0.1)
    xt = nchw(x).to(torch.bfloat16).requires_grad_()
    out = t_warp.grid_sample_bicubic(xt, torch.from_numpy(grid))
    assert out.dtype == torch.bfloat16
    out.float().backward(nchw(g))
    assert xt.grad.dtype == torch.bfloat16 and torch.isfinite(xt.grad.float()).all()
    gt = torch.from_numpy(grid).requires_grad_()
    t_warp.grid_sample_bicubic(nchw(x), gt).backward(nchw(g))
    assert gt.grad.dtype == torch.float32 and torch.isfinite(gt.grad).all()


def test_plain_backward_far_grid_is_zero():
    x, grid, g = case((1, 8, 8, 4), 0.0)
    far = np.full_like(grid, 1e30)  # every tap off the image
    dx, dgrid = plain_bwd(x, far, g)
    assert not dx.any() and not dgrid.any()


def test_kernel_wrappers_refuse_cpu_tensors():
    x, grid, g = case((1, 8, 8, 4), 0.1)
    xt = nchw(x).contiguous(memory_format=torch.channels_last)
    gt = nchw(g).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="CUDA"):
        t_warp.warp_dgrid(xt, torch.from_numpy(grid), gt)
    with pytest.raises(ValueError, match="CUDA"):
        t_warp.warp_dx(torch.from_numpy(grid), gt)
    with pytest.raises(ValueError, match="CUDA"):
        t_warp.warp_dx_scatter(torch.from_numpy(grid), gt)
