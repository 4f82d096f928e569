"""The port's plain bicubic warp against three oracles, on the CPU:

  * ``lcgan_tpu.ops.grid_sample.grid_sample_bicubic``, the JAX 16-tap gather;
  * the Pallas forward kernel K1 (``_fwd_kernel``) in interpret mode, at
    W >= 128 so that ``_fwd_call`` does not route to the small-map kernel;
  * torch ``F.grid_sample(mode='bicubic', padding_mode='zeros',
    align_corners=False)``, the reference model's own op.

Flows are ``identity + U(-1, 1) · s`` at s = 0.1 (the tanh bound) and 0.03
(the trained magnitude), the two regimes of tools/warp_check.py. The CUDA
kernel itself is held against the plain version in tests/test_torch_cuda.py
and in chip_smoke.py, on the card.
"""

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
    """NHWC features and a (B, H, W, 2) grid, as numpy: identity plus an iid
    U(-1, 1) flow per pixel (or a smooth one) times s."""
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if flow == "smooth":
        d = smooth_flow(rng, b, h, w)
    else:
        d = rng.uniform(-1, 1, (b, h, w, 2)).astype(np.float32)
    grid = np.asarray(j_gs.identity_like_coordinates(b, h, w)) + d * np.float32(s)
    return x, grid.astype(np.float32)


def extreme_grid(kind, shape, seed=0):
    """The card checks' grids beyond any displacement bound: "pileup", every
    pixel on one spot; "thrown", two pixels thrown across the map among
    smooth near ones (s = 0.03)."""
    x, grid = case(shape, 0.03, seed, flow="smooth")
    if kind == "pileup":
        grid = np.full_like(grid, 0.01)
    else:
        b, h, w, _ = shape
        grid[b - 1, h // 3, min(5, w - 1)] = (0.9, -0.95)
        grid[0, h - 1, 0] = (-0.7, 0.8)
    return x, grid


def plain(x_nhwc: np.ndarray, grid: np.ndarray, dtype=torch.float32) -> np.ndarray:
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).to(dtype)
    out = t_gs.grid_sample_bicubic_plain(x, torch.from_numpy(grid))
    assert out.dtype == dtype
    return out.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("s", FLOWS)
@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 8, 32, 5), (2, 12, 20, 3)])
def test_plain_matches_jax_gather(shape, s):
    x, grid = case(shape, s)
    ref = j_gs.grid_sample_bicubic(jnp.asarray(x), jnp.asarray(grid))
    np.testing.assert_allclose(plain(x, grid), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s", FLOWS)
@pytest.mark.parametrize("shape", [(1, 16, 256, 8), (1, 8, 128, 16)])
def test_plain_matches_pallas_fwd_kernel(shape, s):
    b, h, w, c = shape
    m = j_gs.max_warp_displacement(max(h, w), s)
    assert not _use_small(h, w, c, m, 4)  # K1 itself, not the small-map kernel
    x, grid = case(shape, s)
    ref = grid_sample_bicubic_pallas(jnp.asarray(x), jnp.asarray(grid), m, True)
    # the kernel sums its band as matmuls, in another order (test_warp_pallas.py:47)
    np.testing.assert_allclose(plain(x, grid), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("s", FLOWS)
def test_plain_matches_pallas_fwd_kernel_smooth_flow(s):
    """The smooth flow of the card's timings and checks, within the tanh bound."""
    shape = (1, 8, 128, 16)
    b, h, w, c = shape
    m = j_gs.max_warp_displacement(max(h, w), s)
    assert not _use_small(h, w, c, m, 4)
    x, grid = case(shape, s, flow="smooth")
    ref = grid_sample_bicubic_pallas(jnp.asarray(x), jnp.asarray(grid), m, True)
    np.testing.assert_allclose(plain(x, grid), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("kind", ["pileup", "thrown"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 8, 32, 5)])
def test_plain_matches_jax_gather_beyond_the_bound(shape, kind):
    """Grids no band covers: the JAX gather reference is exact for any grid."""
    x, grid = extreme_grid(kind, shape)
    ref = j_gs.grid_sample_bicubic(jnp.asarray(x), jnp.asarray(grid))
    np.testing.assert_allclose(plain(x, grid), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s", FLOWS)
@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 8, 128, 16)])
def test_plain_matches_torch_grid_sample(shape, s):
    x, grid = case(shape, s)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ref = F.grid_sample(xt, torch.from_numpy(grid), mode="bicubic", padding_mode="zeros", align_corners=False)
    np.testing.assert_allclose(plain(x, grid), ref.permute(0, 2, 3, 1).numpy(), atol=1e-5, rtol=1e-5)


def test_plain_far_out_of_image_is_zero():
    x, grid = case((1, 8, 8, 4), 0.0)
    grid = grid * 0 + np.float32(1e30)  # every tap off the image
    assert np.array_equal(plain(x, grid), np.zeros_like(x))


@pytest.mark.parametrize("s", FLOWS)
def test_plain_bf16_within_rounding(s):
    """bf16 in, bf16 out, fp32 inside: one rounding of the output."""
    x, grid = case((2, 16, 16, 8), s)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()  # bf16-exact inputs
    ref = plain(x, grid)
    out = plain(x, grid, torch.bfloat16)
    np.testing.assert_allclose(out, ref, atol=0, rtol=2.0**-8)


def test_warp_dispatch_on_cpu_runs_plain_and_keeps_grad():
    x, grid = case((1, 8, 8, 4), 0.1)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    before = t_warp.warp_fwd.launches
    out = t_warp.grid_sample_bicubic(xt, torch.from_numpy(grid))
    assert t_warp.warp_fwd.launches == before  # no kernel launch on the CPU
    assert torch.equal(out, t_gs.grid_sample_bicubic_plain(xt, torch.from_numpy(grid)))
    out.sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()


def test_kernel_wrapper_refuses_cpu_tensors():
    x, grid = case((1, 8, 8, 4), 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        t_warp.warp_fwd(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(grid))


@pytest.mark.parametrize("h,w", [(8, 8), (16, 32)])
def test_identity_coordinates(h, w):
    ref = np.asarray(j_gs.identity_like_coordinates(2, h, w))
    np.testing.assert_array_equal(t_gs.identity_like_coordinates(2, h, w).numpy(), ref)


@pytest.mark.parametrize("size", [8, 128, 1024])
def test_max_warp_displacement(size):
    assert t_gs.max_warp_displacement(size, 0.1) == j_gs.max_warp_displacement(size, 0.1)
