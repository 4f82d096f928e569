"""The CUDA warp kernels on the card (forward, grid gradient, the two
feature-gradient kernels, and the three small-map kernels), against their
plain versions, the pool kernels (box filter, 2x2 pool and its gradient)
against ATen's pools, the deterministic-mode train iteration, the probes'
kernels (the gather and the static and loaded trip-count sums), the
collectives under a one-rank NCCL group, and the FID network on the card
against the CPU.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so on a GPU host without JAX it runs with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch
import torch.nn.functional as F

from lcgan_torch.models.generator import Generator
from lcgan_torch.ops import filters, warp
from lcgan_torch.ops.grid_sample import (
    grid_sample_bicubic_plain,
    grid_sample_bicubic_plain_backward,
    identity_like_coordinates,
)
from lcgan_torch.tools import dyn_trip_probe, gather_probe

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def case(b, c, h, w, s, dtype, dev, hg=None, wg=None, seed=0):
    hg, wg = hg or h, wg or w
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=g).to(dev, dtype).contiguous(memory_format=torch.channels_last)
    flow = torch.rand((b, hg, wg, 2), generator=g) * 2 - 1
    grid = (identity_like_coordinates(b, hg, wg) + flow * s).to(dev).contiguous()
    return x, grid


def smooth_case(b, c, h, w, s, dtype, dev, seed=0):
    """A grid whose neighbours move together: U(-1, 1) at 1/16 of the map's
    size, upsampled bilinearly, times s (chip_smoke's smooth flow)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=g).to(dev, dtype).contiguous(memory_format=torch.channels_last)
    coarse = torch.rand((b, 2, max(1, h // 16), max(1, w // 16)), generator=g) * 2 - 1
    flow = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    grid = (identity_like_coordinates(b, h, w) + flow * s).to(dev).contiguous()
    return x, grid


def assert_fwd_matches_plain(out, ref):
    if out.dtype == torch.float32:
        assert (out - ref).abs().max().item() <= 1e-5
    else:  # both round one fp32 sum to bf16: at most one ulp of the output scale apart
        ulp = 2.0 ** (torch.floor(torch.log2(ref.float().abs().max())).item() - 7)
        assert (out.float() - ref.float()).abs().max().item() <= ulp


# (b, c, h, w) of warp_fwd's row tiles: several tiles of a row with a ragged
# last one (C64 bf16: 32 pixels a tile), one pixel a tile (C256 fp32: 4),
# the scalar path, and tiles as wide as the row
FWD_EDGE_SHAPES = [(2, 64, 72, 88), (1, 256, 40, 48), (2, 5, 40, 40), (2, 512, 16, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FWD_EDGE_SHAPES)
def test_fwd_smooth_flow_and_thrown_pixel(shape, dtype, dev):
    """A smooth flow (neighbours move together, as the generator's do), then
    two pixels thrown across the map among near ones: exact, and bitwise
    repeatable."""
    b, c, h, w = shape
    x, grid = smooth_case(*shape, 0.03, dtype, dev)
    assert_fwd_matches_plain(warp.warp_fwd(x, grid), grid_sample_bicubic_plain(x, grid))
    grid[b - 1, h // 3, 5] = torch.tensor([0.9, -0.95], device=dev)
    grid[0, h - 1, 0] = torch.tensor([-0.7, 0.8], device=dev)
    out = warp.warp_fwd(x, grid)
    assert_fwd_matches_plain(out, grid_sample_bicubic_plain(x, grid))
    assert torch.equal(out, warp.warp_fwd(x, grid))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 128, 128), (2, 512, 32, 32)])
def test_fwd_far_flow_and_the_corner(shape, dtype, dev):
    """An iid flow far beyond the bound (taps of neighbouring pixels far
    apart), and every pixel on one spot by the map's corner (taps across the
    map's edge, zeros outside): exact, and bitwise repeatable."""
    x, grid = case(*shape, 0.6, dtype, dev)
    out = warp.warp_fwd(x, grid)
    assert_fwd_matches_plain(out, grid_sample_bicubic_plain(x, grid))
    assert torch.equal(out, warp.warp_fwd(x, grid))
    corner = torch.full_like(grid, -0.99)
    assert_fwd_matches_plain(warp.warp_fwd(x, corner), grid_sample_bicubic_plain(x, corner))


# (b, c, h, w): vector loads (C a multiple of 4/8) and the scalar path (C = 5, 3)
SHAPES = [(2, 8, 16, 16), (2, 512, 8, 8), (1, 16, 24, 40), (2, 5, 12, 20), (1, 3, 9, 7)]


@pytest.mark.parametrize("s", [0.1, 0.03])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_fp32(shape, s, dev):
    x, grid = case(*shape, s, torch.float32, dev)
    before = warp.warp_fwd.launches
    out = warp.warp_fwd(x, grid)
    torch.cuda.synchronize()
    assert warp.warp_fwd.launches == before + 1
    assert out.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(out, grid_sample_bicubic_plain(x, grid), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_bf16(shape, dev):
    x, grid = case(*shape, 0.1, torch.bfloat16, dev)
    out = warp.warp_fwd(x, grid).float()
    ref = grid_sample_bicubic_plain(x, grid).float()
    # both round one fp32 sum to bf16: at most one ulp of the output scale apart
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().max())).item() - 7)
    assert (out - ref).abs().max().item() <= ulp


def test_kernel_other_output_size_and_far_grid(dev):
    x, grid = case(1, 8, 16, 16, 0.1, torch.float32, dev, hg=5, wg=11)
    torch.testing.assert_close(warp.warp_fwd(x, grid), grid_sample_bicubic_plain(x, grid), atol=1e-5, rtol=0)
    far = torch.full_like(grid, 1e30)
    assert torch.count_nonzero(warp.warp_fwd(x, far)) == 0


def test_wrapper_refuses(dev):
    x, grid = case(1, 8, 8, 8, 0.1, torch.float32, dev)
    with pytest.raises(ValueError, match="channels_last"):
        warp.warp_fwd(x.contiguous(), grid)
    with pytest.raises(TypeError):
        warp.warp_fwd(x, grid.double())
    with pytest.raises(ValueError, match="cotangent"):
        warp.warp_dgrid(x, grid, x[:, :4].contiguous(memory_format=torch.channels_last))
    with pytest.raises(ValueError, match="map size"):
        warp.warp_dx(grid[:, :4].contiguous(), x)


def cotangent(x, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(x.shape, generator=g).to(x.device, x.dtype).contiguous(memory_format=torch.channels_last)


def fp32_tol(ref: torch.Tensor) -> float:
    """1e-5, scaled by the gradient's magnitude where it exceeds 1: the
    kernels sum up to C·16 products in another order than the plain version."""
    return 1e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("s", [0.1, 0.03])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_kernels_match_plain_fp32(shape, s, dev):
    x, grid = case(*shape, s, torch.float32, dev)
    g = cotangent(x)
    before = (warp.warp_dgrid.launches, warp.warp_dx.launches)
    dgrid = warp.warp_dgrid(x, grid, g)
    dx = warp.warp_dx(grid, g)
    torch.cuda.synchronize()
    assert (warp.warp_dgrid.launches, warp.warp_dx.launches) == (before[0] + 1, before[1] + 1)
    assert dx.is_contiguous(memory_format=torch.channels_last) and dx.dtype == torch.float32
    ref_dx, ref_dgrid = grid_sample_bicubic_plain_backward(x, grid, g)
    assert (dx - ref_dx).abs().max().item() <= fp32_tol(ref_dx)
    assert (dgrid - ref_dgrid).abs().max().item() <= fp32_tol(ref_dgrid)


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_kernels_match_plain_bf16(shape, dev):
    x, grid = case(*shape, 0.1, torch.bfloat16, dev)
    g = cotangent(x)
    dx = warp.warp_dx(grid, g)
    dgrid = warp.warp_dgrid(x, grid, g)
    ref_dx, ref_dgrid = grid_sample_bicubic_plain_backward(x, grid, g)
    assert dx.dtype == torch.bfloat16 and dgrid.dtype == torch.float32
    # dx: both round one fp32 sum to bf16, at most one ulp of the output scale apart
    ulp = 2.0 ** (torch.floor(torch.log2(ref_dx.float().abs().max())).item() - 7)
    assert (dx.float() - ref_dx.float()).abs().max().item() <= ulp
    # dgrid stays fp32 from bf16-exact inputs
    assert (dgrid - ref_dgrid).abs().max().item() <= fp32_tol(ref_dgrid)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_are_deterministic(dtype, dev):
    x, grid = case(2, 128, 32, 32, 0.1, dtype, dev)
    g = cotangent(x)
    assert torch.equal(warp.warp_dgrid(x, grid, g), warp.warp_dgrid(x, grid, g))
    assert torch.equal(warp.warp_dx(grid, g), warp.warp_dx(grid, g))


def test_backward_far_grid_is_zero(dev):
    x, grid = case(1, 8, 16, 16, 0.1, torch.float32, dev)
    far = torch.full_like(grid, 1e30)
    g = cotangent(x)
    assert torch.count_nonzero(warp.warp_dgrid(x, far, g)) == 0
    assert torch.count_nonzero(warp.warp_dx(far, g)) == 0


# (b, c, h, w) at the edges of the backward kernels' tiles (warp_dgrid 8 x 8
# output pixels, warp_dx 16 x 8 input pixels): maps that are no multiple of
# the tile, the scalar path (C = 5), C = 64 (the 512² recipe's top block; warp_dx
# called directly) and C = 256; and at the edge of warp_dx's two candidate
# modes (every pixel of the image up to 1024 pixels, else the row pass's
# windows): 32², 32 x 33, and 5 rows wider than a warp
TILE_EDGE_SHAPES = [(2, 128, 12, 12), (1, 128, 40, 40), (2, 5, 12, 12), (1, 5, 40, 40), (2, 64, 40, 40),
                    (1, 256, 24, 40), (3, 128, 32, 32), (1, 128, 32, 33), (2, 256, 5, 70)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [0.1, 0.03, 0.6])
@pytest.mark.parametrize("shape", TILE_EDGE_SHAPES)
def test_backward_kernels_at_tile_edges(shape, s, dtype, dev):
    x, grid = case(*shape, s, dtype, dev)
    g = cotangent(x)
    dgrid = warp.warp_dgrid(x, grid, g)
    dx = warp.warp_dx(grid, g)
    ref_dx, ref_dgrid = grid_sample_bicubic_plain_backward(x, grid, g)
    assert dgrid.dtype == torch.float32 and (dgrid - ref_dgrid).abs().max().item() <= fp32_tol(ref_dgrid)
    assert_dx_matches_plain(dx, ref_dx)
    assert torch.equal(dgrid, warp.warp_dgrid(x, grid, g)) and torch.equal(dx, warp.warp_dx(grid, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(64, 48), (16, 24)])
def test_backward_kernels_one_far_pixel(h, w, dtype, dev):
    """One pixel displaced across the map while the rest stay near: it
    widens only the windows its own row reaches (the row pass at 64 x 48;
    at 16 x 24 every pixel is a candidate), and stays exact."""
    x, grid = case(2, 128, h, w, 0.03, dtype, dev)
    grid[1, h // 3, 7] = torch.tensor([0.9, -0.95], device=dev)
    grid[0, h - 1, 0] = torch.tensor([-0.7, 0.8], device=dev)
    g = cotangent(x)
    ref_dx, ref_dgrid = grid_sample_bicubic_plain_backward(x, grid, g)
    dx = warp.warp_dx(grid, g)
    assert_dx_matches_plain(dx, ref_dx)
    assert (warp.warp_dgrid(x, grid, g) - ref_dgrid).abs().max().item() <= fp32_tol(ref_dgrid)
    assert torch.equal(dx, warp.warp_dx(grid, g))


@pytest.mark.parametrize("c,h", [(128, 32), (256, 40), (128, 16)])
def test_dx_gathered_grid(c, h, dev):
    """Every output pixel samples one spot: the tiles there hold more hits
    than one buffer, and the kernel walks its candidates buffer by buffer."""
    x, grid = case(2, c, h, h, 0.0, torch.float32, dev)
    grid = torch.full_like(grid, 0.01)
    g = cotangent(x)
    dx = warp.warp_dx(grid, g)
    assert_dx_matches_plain(dx, grid_sample_bicubic_plain_backward(x, grid, g)[0])
    assert torch.equal(dx, warp.warp_dx(grid, g))


def test_generator_none_launches_no_warp(dev):
    """warp_impl="none" (the diagnostic ablation) skips the warp: its forward
    and backward on the card launch no warp kernel, and agree with the CPU."""
    kw = dict(img_resolution=32, geo_noise_dim=8, app_noise_dim=8, geo_latent_dim=8, app_latent_dim=16, base_nf=8,
              max_nf=16, warp_impl="none")
    cpu = Generator(**kw, generator=torch.Generator().manual_seed(0)).to(memory_format=torch.channels_last)
    card = Generator(**kw)
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev, memory_format=torch.channels_last)
    z = torch.randn((2, 8), generator=torch.Generator().manual_seed(1))
    names = ("warp_fwd", "warp_dgrid", "warp_dx", "warp_dx_scatter", "warp_fwd_small", "warp_dgrid_small",
             "warp_dx_small")
    before = {n: getattr(warp, n).launches for n in names}
    out = card(z.to(dev), z.to(dev), w_psi=0.7)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert {n: getattr(warp, n).launches - before[n] for n in names} == dict.fromkeys(names, 0)
    torch.testing.assert_close(out.detach().cpu(), cpu(z, z, w_psi=0.7).detach(), atol=1e-4, rtol=1e-4)
    assert card.block_0.flow_layer.modulated_conv.weight.grad is None  # the flow feeds nothing


@pytest.mark.parametrize("s", [0.1, 0.03])
def test_autograd_function_on_card_matches_cpu(s, dev):
    """A CUDA input that requires grad runs the kernels both ways, and the
    grads agree with the Function's CPU path."""
    x, grid = case(2, 16, 12, 20, s, torch.float32, dev)
    g = cotangent(x)
    grads = []
    kernels = (warp.warp_fwd, warp.warp_dgrid, warp.warp_dx_scatter)  # C = 16: the narrow-map dx
    for device in (dev, torch.device("cpu")):
        xd = x.detach().to(device).requires_grad_()
        gd = grid.detach().to(device).requires_grad_()
        launches = tuple(k.launches for k in kernels) + (warp.warp_dx.launches,)
        warp.grid_sample_bicubic(xd, gd).backward(g.to(device).contiguous())  # not channels_last
        ran = tuple(k.launches for k in kernels) + (warp.warp_dx.launches,)
        assert ran == tuple(n + (device.type == "cuda") for n in launches[:3]) + launches[3:]
        grads.append((xd.grad.cpu(), gd.grad.cpu()))
    (dx, dgrid), (ref_dx, ref_dgrid) = grads
    assert (dx - ref_dx).abs().max().item() <= fp32_tol(ref_dx)
    assert (dgrid - ref_dgrid).abs().max().item() <= fp32_tol(ref_dgrid)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_box_filter_gradient_on_card_matches_cpu(dtype, dev):
    """The box filter's gradient on the card (the filter's kernel run on the
    cotangent) against the CPU's. PyTorch's own CUDA avg_pool2d backward on
    channels_last features once gave wrong gradients here; no pool of the
    port reaches it now."""
    from lcgan_torch.ops.filters import box_filter_3x3

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 16, 12, 10), generator=g).to(dtype).contiguous(memory_format=torch.channels_last)
    cot = torch.randn((2, 16, 12, 10), generator=g).to(dtype)
    grads = []
    for device in (dev, torch.device("cpu")):
        xd = x.to(device).requires_grad_()
        (dx,) = torch.autograd.grad(box_filter_3x3(xd), xd, cot.to(device))
        grads.append(dx.float().cpu())
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -6  # bf16: one rounding of values below 4
    torch.testing.assert_close(grads[0], grads[1], atol=tol, rtol=0)


POOL_CHANNELS = [2, 3, 8, 64, 130]  # the flow, odd, one vector, the main path's, 260 / 520 bytes a pixel
POOL_MAPS = [(1, 1), (2, 3), (7, 5), (64, 64), (256, 256)]


def pool_input(b, c, h, w, dtype, channels_last, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=g, device=dev).to(dtype)
    return x.contiguous(memory_format=torch.channels_last if channels_last else torch.contiguous_format)


def bits(t):
    """The tensor's bit patterns (tells -0 from +0)."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("hw", POOL_MAPS)
@pytest.mark.parametrize("c", POOL_CHANNELS)
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_kernels_match_aten(dtype, channels_last, c, hw, b, dev):
    """The box filter and the 2x2 pool bitwise equal to ATen's forward on
    the card (both sum in ATen's order), the 2x2 gradient to ATen's backward
    and to the plain version, each output in ATen's memory format; on a map
    with no 2x2 window the pool raises, as ATen's does."""
    h, w = hw
    x = pool_input(b, c, h, w, dtype, channels_last, dev)
    out, ref = filters.box_filter(x), F.avg_pool2d(x, 3, stride=1, padding=1)
    assert torch.equal(bits(out), bits(ref)) and out.stride() == ref.stride()
    if min(h, w) < 2:
        with pytest.raises(ValueError):
            filters.pool2x2(x)
        return
    out, ref = filters.pool2x2(x), F.avg_pool2d(x, 2, stride=2)
    assert torch.equal(bits(out), bits(ref)) and out.stride() == ref.stride()
    g = torch.randn(ref.shape, generator=torch.Generator(device=dev).manual_seed(1), device=dev).to(dtype)
    g = g.contiguous(memory_format=torch.channels_last if channels_last else torch.contiguous_format)
    out = filters.pool2x2_grad(g, h, w, filters._format(x.shape, x.stride()))
    ref = torch.ops.aten.avg_pool2d_backward(g, x, [2, 2], [2, 2], [0, 0], False, True, None)
    assert torch.equal(bits(out), bits(ref)) and out.stride() == ref.stride()
    assert torch.equal(out, filters.pool2x2_grad_plain(g, h, w))


# (b, c, h, w, channels_last) of the determinism and count checks: the three paths
POOL_PATH_SHAPES = [(8, 64, 256, 256, True), (8, 2, 256, 256, True), (2, 64, 64, 64, False)]


@pytest.mark.parametrize("shape", POOL_PATH_SHAPES)
def test_pool_kernels_are_deterministic_and_counted(shape, dev):
    """Two calls give the same bits; each call moves its kernel's launch
    count by one, and the tracing counters count every launch and the
    vector path's."""
    from lcgan_torch.utils import trace

    b, c, h, w, channels_last = shape
    x = pool_input(b, c, h, w, torch.bfloat16, channels_last, dev)
    g = pool_input(b, c, h // 2, w // 2, torch.bfloat16, channels_last, dev, seed=1)
    calls = dict(box_filter=lambda: filters.box_filter(x), pool2x2=lambda: filters.pool2x2(x),
                 pool2x2_grad=lambda: filters.pool2x2_grad(g, h, w))
    trace.take()
    trace.enable()
    for name, call in calls.items():
        before = getattr(filters, name).launches
        first, second = call(), call()
        assert getattr(filters, name).launches == before + 2
        assert torch.equal(bits(first), bits(second))
    trace.disable()
    _, counters = trace.take()
    vector = channels_last and c * 2 % 16 == 0
    assert counters.get("pool.launches") == 6 and counters.get("pool.vector_launches", 0) == (6 if vector else 0)


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_double_gradients_on_card_match_cpu(dtype, channels_last, dev):
    """Both pools' first and second derivatives on the card (their backward
    Functions differentiated again, as R1 does through D) against the
    CPU's, ATen's pools there."""
    from lcgan_torch.ops.filters import avg_pool_2x2, box_filter_3x3

    gen = torch.Generator().manual_seed(0)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = torch.randn((2, 64, 16, 12), generator=gen).to(dtype).contiguous(memory_format=fmt)
    c3 = torch.randn((2, 64, 16, 12), generator=gen).to(dtype)
    c2 = torch.randn((2, 64, 8, 6), generator=gen).to(dtype)
    results = []
    for device in (dev, torch.device("cpu")):
        xd = x.to(device).requires_grad_()
        cots = [c3.to(device).requires_grad_(), c2.to(device).requires_grad_()]
        loss = (box_filter_3x3(xd) * cots[0]).sum() + (avg_pool_2x2(xd) * cots[1]).sum()
        (dx,) = torch.autograd.grad(loss, xd, create_graph=True)
        dd = torch.autograd.grad((dx.float() ** 2).sum(), cots)
        results.append([t.float().cpu() for t in (dx, *dd)])
    for card, cpu in zip(*results):
        scale = cpu.abs().max().item()
        tol = 1e-6 * scale if dtype == torch.float32 else 2.0 ** -7 * scale  # bf16: a rounding or two
        torch.testing.assert_close(card, cpu, atol=tol, rtol=0)


def test_pools_under_checkpoint_block(dev):
    """Under the remat switch's checkpoint (non-reentrant, recomputing the
    block in the backward) the gradients equal the plain run's bitwise, and
    the recompute launches the forward kernels again."""
    from lcgan_torch.ops.filters import avg_pool_2x2, box_filter_3x3
    from lcgan_torch.utils.remat import checkpoint_block

    def block(t):  # sin saves its input, so the recompute runs both pools again
        y = torch.tanh(t)
        return torch.sin(box_filter_3x3(y)) + F.interpolate(torch.sin(avg_pool_2x2(y)), scale_factor=2.0)

    x = pool_input(4, 64, 32, 32, torch.bfloat16, True, dev)
    cot = pool_input(4, 64, 32, 32, torch.bfloat16, True, dev, seed=1)
    grads, launches = [], []
    for remat in (False, True):
        xd = x.clone().requires_grad_()
        before = filters.box_filter.launches, filters.pool2x2.launches, filters.pool2x2_grad.launches
        out = checkpoint_block(block, xd) if remat else block(xd)
        (dx,) = torch.autograd.grad(out, xd, cot)
        grads.append(dx)
        after = filters.box_filter.launches, filters.pool2x2.launches, filters.pool2x2_grad.launches
        launches.append(tuple(a - b for a, b in zip(after, before)))
    assert torch.equal(bits(grads[0]), bits(grads[1]))
    assert launches == [(2, 1, 1), (3, 2, 1)]


def test_no_pool_reaches_aten_on_card(dev, monkeypatch):
    """The generator's and the discriminator's forward, backward and R1's
    double backward on the card with ATen's avg_pool2d unavailable: every
    pool goes through the kernels."""
    from lcgan_torch.models.discriminator import Discriminator

    def refuse(*args, **kwargs):
        raise AssertionError("F.avg_pool2d called on the card")

    d = Discriminator(img_resolution=32, base_nf=8, max_nf=16, mbstd_group_size=2,
                      generator=torch.Generator().manual_seed(0))
    d = d.to(dev, memory_format=torch.channels_last)
    g = Generator(img_resolution=32, geo_noise_dim=8, app_noise_dim=8, geo_latent_dim=8, app_latent_dim=16,
                  base_nf=8, max_nf=16, generator=torch.Generator().manual_seed(1))
    g = g.to(dev, memory_format=torch.channels_last)
    z = torch.randn((4, 8), generator=torch.Generator().manual_seed(2)).to(dev)
    monkeypatch.setattr(F, "avg_pool2d", refuse)
    before = filters.box_filter.launches, filters.pool2x2.launches, filters.pool2x2_grad.launches
    fake = g(z, z)
    real = fake.detach().requires_grad_()
    (r1,) = torch.autograd.grad(d(real)[0].sum(), real, create_graph=True)
    (d(fake)[0].sum() + r1.square().sum()).backward()
    after = filters.box_filter.launches, filters.pool2x2.launches, filters.pool2x2_grad.launches
    assert all(a > b for a, b in zip(after, before))


def test_generator_on_card_matches_cpu(dev):
    kw = dict(img_resolution=32, geo_noise_dim=8, app_noise_dim=8, geo_latent_dim=8,
              app_latent_dim=16, base_nf=8, max_nf=16)
    cpu = Generator(**kw, generator=torch.Generator().manual_seed(0)).to(memory_format=torch.channels_last)
    card = Generator(**kw)
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev, memory_format=torch.channels_last)
    z = torch.randn((2, 8), generator=torch.Generator().manual_seed(1))
    before = warp.warp_fwd.launches
    with torch.no_grad():
        ref = cpu(z, z, w_psi=0.7)
        out = card(z.to(dev), z.to(dev), w_psi=0.7)
    assert warp.warp_fwd.launches == before + card.num_blocks
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-4)


# (b, c, h, w) of the narrow-map dx kernel: C < 128 with vector loads, and the scalar path
SCATTER_SHAPES = [(2, 64, 64, 64), (1, 32, 128, 96), (2, 16, 24, 40), (2, 5, 12, 20)]
# the tanh bound, the trained magnitude, and a flow far beyond the bound
SCATTER_FLOWS = [0.1, 0.03, 0.6]


def assert_dx_matches_plain(dx, ref_dx):
    if dx.dtype == torch.float32:
        assert (dx - ref_dx).abs().max().item() <= fp32_tol(ref_dx)
    else:  # both round one fp32 sum to bf16: at most one ulp of the output scale apart
        ulp = 2.0 ** (torch.floor(torch.log2(ref_dx.float().abs().max())).item() - 7)
        assert (dx.float() - ref_dx.float()).abs().max().item() <= ulp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", SCATTER_FLOWS)
@pytest.mark.parametrize("shape", SCATTER_SHAPES)
def test_dx_scatter_matches_plain(shape, s, dtype, dev):
    x, grid = case(*shape, s, dtype, dev)
    g = cotangent(x)
    before = warp.warp_dx_scatter.launches
    dx = warp.warp_dx_scatter(grid, g)
    torch.cuda.synchronize()
    assert warp.warp_dx_scatter.launches == before + 1
    assert dx.is_contiguous(memory_format=torch.channels_last) and dx.dtype == dtype
    assert_dx_matches_plain(dx, grid_sample_bicubic_plain_backward(x, grid, g)[0])


def test_dx_scatter_gathered_grid(dev):
    """Every output pixel samples one spot: one bucket holds the whole map
    (the heap-sorted path)."""
    x, grid = case(2, 16, 32, 32, 0.0, torch.float32, dev)
    grid = torch.full_like(grid, 0.01)
    g = cotangent(x)
    dx = warp.warp_dx_scatter(grid, g)
    assert_dx_matches_plain(dx, grid_sample_bicubic_plain_backward(x, grid, g)[0])
    assert torch.equal(dx, warp.warp_dx_scatter(grid, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dx_scatter_is_deterministic(dtype, dev):
    x, grid = case(2, 64, 64, 64, 0.1, dtype, dev)
    g = cotangent(x)
    assert torch.equal(warp.warp_dx_scatter(grid, g), warp.warp_dx_scatter(grid, g))


def test_dx_scatter_far_grid_is_zero_and_refuses(dev):
    x, grid = case(1, 8, 16, 16, 0.1, torch.float32, dev)
    g = cotangent(x)
    assert torch.count_nonzero(warp.warp_dx_scatter(torch.full_like(grid, 1e30), g)) == 0
    with pytest.raises(ValueError, match="map size"):
        warp.warp_dx_scatter(grid[:, :4].contiguous(), g)
    with pytest.raises(ValueError, match="channels_last"):
        warp.warp_dx_scatter(grid, g.contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SCATTER_SHAPES)
def test_dx_scatter_smooth_flow_and_thrown_pixel(shape, dtype, dev):
    """A smooth flow, then two pixels thrown across the map among near ones:
    exact, and bitwise repeatable."""
    b, c, h, w = shape
    x, grid = smooth_case(*shape, 0.1, dtype, dev)
    g = cotangent(x)
    assert_dx_matches_plain(warp.warp_dx_scatter(grid, g), grid_sample_bicubic_plain_backward(x, grid, g)[0])
    grid[b - 1, h // 3, 5] = torch.tensor([0.9, -0.95], device=dev)
    grid[0, h - 1, 0] = torch.tensor([-0.7, 0.8], device=dev)
    dx = warp.warp_dx_scatter(grid, g)
    assert_dx_matches_plain(dx, grid_sample_bicubic_plain_backward(x, grid, g)[0])
    assert torch.equal(dx, warp.warp_dx_scatter(grid, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 32])
def test_dx_scatter_hit_buffer_rounds(c, dtype, dev):
    """Every output pixel on one spot: the tile there holds 4096 hits per
    image, many times the gather's hit buffer, and walks them one buffer at
    a time; half the map on a second spot in another tile."""
    x, grid = case(2, c, 64, 64, 0.0, dtype, dev)
    grid = torch.full_like(grid, 0.01)
    grid[:, 32:] = torch.tensor([-0.5, 0.7], device=dev)
    g = cotangent(x)
    dx = warp.warp_dx_scatter(grid, g)
    assert_dx_matches_plain(dx, grid_sample_bicubic_plain_backward(x, grid, g)[0])
    assert torch.equal(dx, warp.warp_dx_scatter(grid, g))


@pytest.mark.parametrize("c,kernel", [(64, "warp_dx_scatter"), (32, "warp_dx_scatter"), (128, "warp_dx")])
def test_autograd_function_sends_dx_by_channels(c, kernel, dev):
    """C < 128 runs the narrow-map dx kernel, C >= 128 the other, as the
    JAX package's _vjp_bwd splits them; both agree with the CPU path."""
    x, grid = case(1, c, 16, 24, 0.1, torch.float32, dev)
    g = cotangent(x)
    names = ("warp_fwd", "warp_dgrid", "warp_dx", "warp_dx_scatter")
    before = {n: getattr(warp, n).launches for n in names}
    xd = x.detach().requires_grad_()
    warp.grid_sample_bicubic(xd, grid.detach().requires_grad_()).backward(g)
    ran = {n: getattr(warp, n).launches - before[n] for n in names}
    assert ran == {"warp_fwd": 1, "warp_dgrid": 1, "warp_dx": int(kernel == "warp_dx"),
                   "warp_dx_scatter": int(kernel == "warp_dx_scatter")}
    assert_dx_matches_plain(xd.grad, grid_sample_bicubic_plain_backward(x, grid, g)[0])


@pytest.mark.parametrize("epoch", [0, 1])
def test_train_iteration_in_deterministic_mode(epoch, dev):
    """The train phase runs under torch.use_deterministic_algorithms(True):
    no op of an even or an odd + R1 iteration may refuse it, and two runs
    from one state give the same bits."""
    from lcgan_torch.config import Config
    from lcgan_torch.train.loop import deterministic_algorithms
    from lcgan_torch.train.steps import Trainer

    cfg = Config(model_name="unused", img_resolution=32, batch_size=4, geo_noise_dim=8, app_noise_dim=8,
                 geo_latent_dim=8, app_latent_dim=16, geo_projection_dim=8, app_projection_dim=8, base_nf=8,
                 max_nf=64, mbstd_group_size=2, device="cuda")
    g = torch.Generator().manual_seed(0)
    batch = {k: (torch.rand((4, 3, 32, 32), generator=g) * 2 - 1).to(dev)
             for k in ("image", "geometry_change", "appearance_change")}
    results = []
    with deterministic_algorithms():
        for _ in range(2):
            trainer = Trainer(cfg)
            state, g_loss, d_loss = trainer.train_iteration(trainer.init_state(), batch, epoch)
            results.append((g_loss, d_loss, state.generator.state_dict(), state.discriminator.state_dict()))
    (g0, d0, gen0, dis0), (g1, d1, gen1, dis1) = results
    assert torch.isfinite(g0) and torch.isfinite(d0)
    assert torch.equal(g0, g1) and torch.equal(d0, d1)
    assert all(torch.equal(v, gen1[k]) for k, v in gen0.items()) and all(torch.equal(v, dis1[k]) for k, v in dis0.items())


# (b, c, h, w) of the small-map kernels: tiny, the 8² and 64² blocks of the
# 256² recipe, and the scalar path (C = 5, 3; a 9x7 map)
SMALL_SHAPES = [(2, 16, 8, 8), (8, 512, 8, 8), (8, 512, 64, 64), (2, 5, 12, 12), (1, 3, 9, 7)]
SMALL_KERNELS = ("warp_fwd_small", "warp_dgrid_small", "warp_dx_small")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", SCATTER_FLOWS)
@pytest.mark.parametrize("shape", SMALL_SHAPES)
def test_small_kernels_match_plain(shape, s, dtype, dev):
    x, grid = case(*shape, s, dtype, dev)
    g = cotangent(x)
    before = {n: getattr(warp, n).launches for n in SMALL_KERNELS}
    out = warp.warp_fwd_small(x, grid)
    dgrid = warp.warp_dgrid_small(x, grid, g)
    dx = warp.warp_dx_small(grid, g)
    torch.cuda.synchronize()
    assert {n: getattr(warp, n).launches - before[n] for n in SMALL_KERNELS} == dict.fromkeys(SMALL_KERNELS, 1)
    for t in (out, dx):
        assert t.is_contiguous(memory_format=torch.channels_last) and t.dtype == dtype
    ref = grid_sample_bicubic_plain(x, grid)
    ref_dx, ref_dgrid = grid_sample_bicubic_plain_backward(x, grid, g)
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() <= 1e-5
    else:
        assert_dx_matches_plain(out, ref)  # one bf16 ulp of the output scale
    assert dgrid.dtype == torch.float32 and (dgrid - ref_dgrid).abs().max().item() <= fp32_tol(ref_dgrid)
    assert_dx_matches_plain(dx, ref_dx)


def test_small_fwd_other_output_size_and_far_grid(dev):
    x, grid = case(1, 8, 16, 16, 0.1, torch.float32, dev, hg=5, wg=11)
    torch.testing.assert_close(warp.warp_fwd_small(x, grid), grid_sample_bicubic_plain(x, grid), atol=1e-5, rtol=0)
    far = torch.full_like(grid, 1e30)
    g = cotangent(warp.warp_fwd_small(x, far))
    assert torch.count_nonzero(warp.warp_fwd_small(x, far)) == 0
    assert torch.count_nonzero(warp.warp_dgrid_small(x, far, g)) == 0


def test_dx_small_gathered_grid(dev):
    """Every output pixel samples one spot: one bucket holds the whole map
    (the heap-sorted path)."""
    for c, h in ((16, 32), (512, 64)):
        x, grid = case(2, c, h, h, 0.0, torch.float32, dev)
        grid = torch.full_like(grid, 0.01)
        g = cotangent(x)
        dx = warp.warp_dx_small(grid, g)
        assert_dx_matches_plain(dx, grid_sample_bicubic_plain_backward(x, grid, g)[0])
        assert torch.equal(dx, warp.warp_dx_small(grid, g))
        assert torch.count_nonzero(warp.warp_dx_small(torch.full_like(grid, 1e30), g)) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [8, 16, 32, 64])
def test_small_backward_kernels_are_deterministic(h, dtype, dev):
    x, grid = case(8, 512, h, h, 0.1, dtype, dev)
    g = cotangent(x)
    assert torch.equal(warp.warp_dgrid_small(x, grid, g), warp.warp_dgrid_small(x, grid, g))
    assert torch.equal(warp.warp_dx_small(grid, g), warp.warp_dx_small(grid, g))


# (b, c, h, w) of warp_fwd_small's and warp_dgrid_small's own cases: the
# four small maps of a 256² batch (8 x 8 tiles at 64², smaller tiles below),
# and the scalar path (C = 5) on a 40² map of several tiles
SMALL_TILE_SHAPES = [(8, 512, 8, 8), (8, 512, 16, 16), (8, 512, 32, 32), (8, 512, 64, 64), (2, 5, 40, 40)]


def assert_fwd_dgrid_small_match_plain(x, grid, g):
    """warp_fwd_small against the plain forward (1e-5 in fp32, one bf16 ulp
    of the output scale in bf16), warp_dgrid_small against the plain
    backward's grid gradient (fp32_tol), and both bitwise repeatable."""
    out, dgrid = warp.warp_fwd_small(x, grid), warp.warp_dgrid_small(x, grid, g)
    assert_fwd_matches_plain(out, grid_sample_bicubic_plain(x, grid))
    ref_dgrid = grid_sample_bicubic_plain_backward(x, grid, g)[1]
    assert dgrid.dtype == torch.float32 and (dgrid - ref_dgrid).abs().max().item() <= fp32_tol(ref_dgrid)
    assert torch.equal(out, warp.warp_fwd_small(x, grid)) and torch.equal(dgrid, warp.warp_dgrid_small(x, grid, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SMALL_TILE_SHAPES)
def test_fwd_dgrid_small_flows_and_thrown_pixel(shape, dtype, dev):
    """warp_fwd_small and warp_dgrid_small against the plain versions on the
    iid flow (s = 0.1 and far beyond the bound, 0.6), the smooth flow
    (neighbours move together), and with one pixel thrown across the map (a
    tile's taps far outside its window, read from device memory)."""
    b, c, h, w = shape
    for x, grid in (case(*shape, 0.1, dtype, dev), case(*shape, 0.6, dtype, dev),
                    smooth_case(*shape, 0.1, dtype, dev)):
        assert_fwd_dgrid_small_match_plain(x, grid, cotangent(x))
    grid[0, h - 1, 0] = torch.tensor([0.9, -0.95], device=dev)
    grid[-1, h // 3, w // 2] = torch.tensor([-0.7, 0.8], device=dev)
    assert_fwd_dgrid_small_match_plain(x, grid, cotangent(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SMALL_TILE_SHAPES)
def test_fwd_dgrid_small_taps_off_the_image(shape, dtype, dev):
    """Every tap of every pixel off the image (a grid beyond each edge, and
    far away): zeros from both kernels; the first image's pixels by its
    corner with some taps on it, the second image's half off it: against the
    plain versions."""
    b, c, h, w = shape
    x, grid = case(*shape, 0.0, dtype, dev)
    g = cotangent(x)
    for off in (-1.5, 1.5, 1e30):
        far = torch.full_like(grid, off)
        assert torch.count_nonzero(warp.warp_fwd_small(x, far)) == 0
        assert torch.count_nonzero(warp.warp_dgrid_small(x, far, g)) == 0
    grid[0] = torch.tensor([-0.97, -0.99], device=dev)
    grid[-1, : h // 2] = torch.tensor([1.2, 0.3], device=dev)
    assert_fwd_dgrid_small_match_plain(x, grid, g)


@pytest.mark.parametrize("h", [8, 16, 32, 64])
def test_dgrid_small_launches_per_call(h, dev):
    """One device kernel per warp_dgrid_small call, by the profiler (no
    timing): the channel sum stays inside each block, so there is no partial
    sum and no second launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, grid = case(8, 512, h, h, 0.1, torch.bfloat16, dev)
    g = cotangent(x)
    warp.warp_dgrid_small(x, grid, g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warp.warp_dgrid_small(x, grid, g)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
             for _ in range(e.count)]
    assert len(names) == 1 and "warp_dgrid_small_kernel" in names[0], names


# (b, c, h, w) of warp_dx_small's own cases: the four small maps of a 256²
# batch (one launch at 8² and 16², index and gather above), and the scalar
# path (C = 5) on a 40² map of several tiles
DX_SMALL_SHAPES = [(8, 512, 8, 8), (8, 512, 16, 16), (8, 512, 32, 32), (8, 512, 64, 64), (2, 5, 40, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DX_SMALL_SHAPES)
def test_dx_small_flows_and_thrown_pixel(shape, dtype, dev):
    """warp_dx_small against the plain backward on the iid flow (s = 0.1 and
    far beyond the bound, 0.6), the smooth flow (neighbours move together),
    and with one pixel thrown across the map; bitwise repeatable."""
    b, c, h, w = shape
    for x, grid in (case(*shape, 0.1, dtype, dev), case(*shape, 0.6, dtype, dev),
                    smooth_case(*shape, 0.1, dtype, dev)):
        g = cotangent(x)
        assert_dx_matches_plain(warp.warp_dx_small(grid, g), grid_sample_bicubic_plain_backward(x, grid, g)[0])
    grid[0, h - 1, 0] = torch.tensor([0.9, -0.95], device=dev)
    grid[-1, h // 3, w // 2] = torch.tensor([-0.7, 0.8], device=dev)
    dx = warp.warp_dx_small(grid, g)
    assert_dx_matches_plain(dx, grid_sample_bicubic_plain_backward(x, grid, g)[0])
    assert torch.equal(dx, warp.warp_dx_small(grid, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [16, 64])
def test_dx_small_hit_buffer_rounds(h, dtype, dev):
    """Every output pixel of the first image on one spot by the map's corner,
    of the second half on one spot and half on another: one bucket holds
    hundreds of pixels (heap-sorted), which at 64² the tiles there walk one
    hit buffer at a time (at 16² a block holds the whole map); a grid whose
    pixels all sample outside the map gives zeros."""
    x, grid = case(2, 512, h, h, 0.0, dtype, dev)
    grid[0] = torch.tensor([-0.97, -0.99], device=dev)
    grid[1, : h // 2] = torch.tensor([0.95, 0.9], device=dev)
    grid[1, h // 2:] = torch.tensor([-0.2, 0.3], device=dev)
    g = cotangent(x)
    dx = warp.warp_dx_small(grid, g)
    assert_dx_matches_plain(dx, grid_sample_bicubic_plain_backward(x, grid, g)[0])
    assert torch.equal(dx, warp.warp_dx_small(grid, g))
    assert torch.count_nonzero(warp.warp_dx_small(torch.full_like(grid, -1.5), g)) == 0


@pytest.mark.parametrize("h,kernels", [(8, 1), (16, 1), (32, 2), (64, 2)])
def test_dx_small_launches_per_call(h, kernels, dev):
    """The device kernels of one warp_dx_small call, by the profiler (no
    timing): one at 8² and 16², where each block indexes its image itself,
    and the index kernel before the gather above."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, grid = case(8, 512, h, h, 0.1, torch.bfloat16, dev)
    g = cotangent(x)
    warp.warp_dx_small(grid, g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warp.warp_dx_small(grid, g)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
             for _ in range(e.count)]
    assert len(names) == kernels and all("warp_dx" in n for n in names), names


def test_small_kernels_refuse(dev):
    x, grid = case(1, 8, 72, 72, 0.1, torch.float32, dev)
    g = cotangent(x)
    for call in (lambda: warp.warp_fwd_small(x, grid), lambda: warp.warp_dgrid_small(x, grid, g),
                 lambda: warp.warp_dx_small(grid, g)):
        with pytest.raises(ValueError, match="at most 64"):
            call()
    x, grid = case(1, 8, 16, 16, 0.1, torch.float32, dev)
    g = cotangent(x)
    with pytest.raises(ValueError, match="CUDA"):
        warp.warp_fwd_small(x.cpu(), grid.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        warp.warp_dx_small(grid.cpu(), g.cpu())
    with pytest.raises(ValueError, match="channels_last"):
        warp.warp_dgrid_small(x, grid, g.contiguous())
    with pytest.raises(ValueError, match="map size"):
        warp.warp_dx_small(grid[:, :4].contiguous(), g)


@pytest.mark.parametrize("s", [0.1, 0.6])
def test_autograd_function_small_route_on_card_matches_cpu(s, dev):
    """small=True runs the small-map kernels both ways on the card and no
    other kernel; the grads agree with the Function's CPU path."""
    x, grid = case(2, 64, 32, 32, s, torch.float32, dev)
    g = cotangent(x)
    names = ("warp_fwd", "warp_dgrid", "warp_dx", "warp_dx_scatter") + SMALL_KERNELS
    grads = []
    for device in (dev, torch.device("cpu")):
        xd = x.detach().to(device).requires_grad_()
        gd = grid.detach().to(device).requires_grad_()
        before = {n: getattr(warp, n).launches for n in names}
        out = warp.grid_sample_bicubic(xd, gd, True)
        out.backward(g.to(device).contiguous())  # not channels_last
        ran = {n: getattr(warp, n).launches - before[n] for n in names}
        on_card = int(device.type == "cuda")
        assert ran == {n: on_card * (n in SMALL_KERNELS) for n in names}
        grads.append((out.detach().cpu(), xd.grad.cpu(), gd.grad.cpu()))
    (out, dx, dgrid), (ref, ref_dx, ref_dgrid) = grads
    assert (out - ref).abs().max().item() <= 1e-5
    assert (dx - ref_dx).abs().max().item() <= fp32_tol(ref_dx)
    assert (dgrid - ref_dgrid).abs().max().item() <= fp32_tol(ref_dgrid)


def test_generator_256_small_route_launches(dev):
    """warp_pallas_min_res=8 at the 256² widths: the four 8²-64² blocks
    (C = 512) launch the small-map forward, the 128² and 256² blocks the
    general one."""
    card = Generator(img_resolution=256, base_nf=128, max_nf=512, warp_pallas_min_res=8, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0)).to(dev, memory_format=torch.channels_last).eval()
    z = torch.randn((2, 64), generator=torch.Generator().manual_seed(1)).to(dev)
    before = (warp.warp_fwd_small.launches, warp.warp_fwd.launches)
    with torch.no_grad():
        out = card(z, z, w_psi=0.7)
    torch.cuda.synchronize()
    assert (warp.warp_fwd_small.launches - before[0], warp.warp_fwd.launches - before[1]) == (4, 2)
    assert out.shape == (2, 3, 256, 256) and torch.isfinite(out.float()).all()


# ----------------------------------------------------------------------------
# the probes' kernels (lcgan_torch.tools): csrc/gather_probe.cu and
# csrc/dyn_trip_probe.cu
# ----------------------------------------------------------------------------


def gather_indices(kind, r, shape):
    if kind == "random":
        return torch.randint(0, r, shape, generator=torch.Generator().manual_seed(1))
    return torch.full(shape, 0 if kind == "zeros" else r - 1)


@pytest.mark.parametrize("kind", ["random", "zeros", "last"])
@pytest.mark.parametrize("r,c,m", [(256, 128, 256), (40, 64, 33), (384, 32, 1)])
def test_gather_probe_matches_plain(r, c, m, kind, dev):
    x = torch.randn((r, c), generator=torch.Generator().manual_seed(0)).to(dev)
    idx = gather_indices(kind, r, (m, c)).to(dev, torch.int32)
    before = gather_probe.gather_probe.launches
    out = gather_probe.gather_probe(x, idx)
    torch.cuda.synchronize()
    assert gather_probe.gather_probe.launches == before + 1
    assert torch.equal(out, gather_probe.take_along_rows_plain(x, idx))  # a gather: exact


def test_gather_probe_refuses(dev):
    x = torch.zeros((256, 128), device=dev)
    idx = torch.zeros((256, 128), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        gather_probe.gather_probe(x, idx.long())
    with pytest.raises(ValueError, match="multiple of 32"):
        gather_probe.gather_probe(x[:, :40].contiguous(), idx[:, :40].contiguous())
    with pytest.raises(ValueError, match="1-384 rows"):
        gather_probe.gather_probe(torch.zeros((385, 128), device=dev), idx)
    with pytest.raises(ValueError, match="contiguous"):
        gather_probe.gather_probe(x.t().contiguous().t(), idx)


def packs_on(dev, packs=16):
    g = torch.Generator().manual_seed(0)
    return torch.randn((packs, 256, 256), generator=g).to(dev), torch.randn((256, 256), generator=g).to(dev)


@pytest.mark.parametrize("n", [16, 8, 1, 0])
def test_dyn_trip_matches_fp64_and_static_bitwise(n, dev):
    x, w = packs_on(dev)
    before = (dyn_trip_probe.dyn_trip_static.launches, dyn_trip_probe.dyn_trip_dyn.launches)
    dyn = dyn_trip_probe.dyn_trip_dyn(torch.tensor([n], dtype=torch.int32, device=dev), x, w)
    ref = (x[:n].double() @ w.double()).sum(0)
    # fp32 fused multiply-adds over n·256 products against fp64: 1e-5 of the output's scale
    assert (dyn.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    plain = dyn_trip_probe.packed_sum_plain(x, w, n)
    assert (plain.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    if n in dyn_trip_probe.STATIC_COUNTS:
        assert torch.equal(dyn_trip_probe.dyn_trip_static(x, w, n), dyn)  # one body
    torch.cuda.synchronize()
    after = (dyn_trip_probe.dyn_trip_static.launches, dyn_trip_probe.dyn_trip_dyn.launches)
    assert after == (before[0] + (n in dyn_trip_probe.STATIC_COUNTS), before[1] + 1)


@pytest.mark.parametrize("n", dyn_trip_probe.STATIC_COUNTS)
def test_dyn_trip_every_static_count(n, dev):
    """Both arms at every static count on 64 packs: the loaded count gives the
    static one's bits, and both are within 1e-5 of the output's scale of an
    fp64 sum; n = 0, loaded, gives zeros."""
    x, w = packs_on(dev, packs=64)
    static = dyn_trip_probe.dyn_trip_static(x, w, n)
    dyn = dyn_trip_probe.dyn_trip_dyn(torch.tensor([n], dtype=torch.int32, device=dev), x, w)
    assert torch.equal(dyn, static)
    ref = (x[:n].double() @ w.double()).sum(0)
    for out in (static, dyn):
        assert (out.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert torch.count_nonzero(dyn_trip_probe.dyn_trip_dyn(torch.tensor([0], dtype=torch.int32, device=dev), x, w)) == 0


def test_dyn_trip_clamps_and_refuses(dev):
    x, w = packs_on(dev, packs=4)
    full = dyn_trip_probe.dyn_trip_static(x, w, 4)
    assert torch.equal(dyn_trip_probe.dyn_trip_dyn(torch.tensor([99], dtype=torch.int32, device=dev), x, w), full)
    assert torch.count_nonzero(dyn_trip_probe.dyn_trip_dyn(torch.tensor([-3], dtype=torch.int32, device=dev), x, w)) == 0
    with pytest.raises(ValueError, match="built for counts"):
        dyn_trip_probe.dyn_trip_static(x, w, 3)
    with pytest.raises(ValueError, match="built for counts"):
        dyn_trip_probe.dyn_trip_static(x, w, 8)  # more than x's packs
    with pytest.raises(ValueError, match="int32"):
        dyn_trip_probe.dyn_trip_dyn(torch.tensor([4], device=dev), x, w)
    with pytest.raises(ValueError, match="contiguous"):
        dyn_trip_probe.dyn_trip_static(x[:, :, :128], w, 4)


# ---------------------------------------------------------------------------
# data parallelism and FID on the card


def test_mean_all_reduce_under_a_one_rank_nccl_group(dev, monkeypatch):
    """torchrun's environment at world size 1: NCCL, cuda:LOCAL_RANK, the
    values back bit for bit, rows gathered, the group gone on exit."""
    import socket

    import numpy as np

    from lcgan_torch import parallel
    from lcgan_torch.config import resolve_device

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    with parallel.process_group("auto", "cuda"):
        assert parallel.initialized() and torch.distributed.get_backend() == "nccl"
        g = torch.Generator().manual_seed(0)
        tensors = [torch.randn(5, generator=g).to(dev), torch.randn(2, 3, 4, 4, generator=g).to(dev).contiguous(
            memory_format=torch.channels_last)]
        before = [t.clone() for t in tensors]
        parallel.mean_all_reduce(tensors)
        assert all(torch.equal(a, b) for a, b in zip(tensors, before))
        rows = np.arange(6.0).reshape(2, 3)
        np.testing.assert_array_equal(parallel.all_gather_rows(rows), rows)
        parallel.barrier()
    assert not parallel.initialized()


def test_inception_on_card_matches_cpu_with_tf32_off(dev, tmp_path, monkeypatch):
    """The FID network's features on the card against the CPU on 2 images
    (fp32 through ~100 convs in other orders: within 1e-4 of the features'
    largest value; TF32 would be ~1e-3 off). fid_evaluate turns TF32 off
    around the network and restores the flags after it."""
    import numpy as np
    from PIL import Image

    from lcgan_torch.config import Config
    from lcgan_torch.eval import fid
    from lcgan_torch.eval.inception import InceptionV3FID
    from lcgan_torch.models.generator import build_generator

    net = InceptionV3FID(generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand((2, 3, 256, 256), generator=torch.Generator().manual_seed(1)) * 2 - 1
    with torch.no_grad():
        ref = net(x)
        with fid.fp32_convs():
            got = net.to(dev)(x.to(dev)).cpu()
    assert got.shape == (2, 2048) and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()

    d = tmp_path / "data" / "train" / "x"
    d.mkdir(parents=True)
    for i in range(2):
        Image.fromarray(np.random.default_rng(i).integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(d / f"{i}.png")
    cfg = Config(model_name=str(tmp_path / "run"), dataset_path=str(tmp_path / "data"), img_resolution=32,
                 batch_size=2, geo_noise_dim=8, app_noise_dim=8, geo_latent_dim=8, app_latent_dim=16, base_nf=8,
                 max_nf=16, compute_dtype="float32", num_data_workers=1)
    seen = []
    load = fid.load_inception

    def recording(cfg, device):
        model = load(cfg, device)
        model.register_forward_pre_hook(
            lambda m, a: seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
        return model

    monkeypatch.setattr(fid, "load_inception", recording)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        value = fid.fid_evaluate(cfg, build_generator(cfg).to(dev).eval(), dev)
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    assert np.isfinite(value) and seen and all(flags == (False, False) for flags in seen)


# (b, c, h, w) of the view-batched 256² G step's warps (three views of 8):
# a 16² block and the two maps of 128² and up
THREE_VIEW_SHAPES = [(24, 512, 16, 16), (24, 256, 128, 128), (24, 128, 256, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", THREE_VIEW_SHAPES)
def test_kernels_at_three_views_match_plain(shape, dtype, dev):
    """warp_fwd, warp_dgrid and warp_dx at B = 24 against their plain versions."""
    x, grid = case(*shape, 0.1, dtype, dev)
    g = cotangent(x)
    out, dgrid, dx = warp.warp_fwd(x, grid), warp.warp_dgrid(x, grid, g), warp.warp_dx(grid, g)
    ref_dx, ref_dgrid = grid_sample_bicubic_plain_backward(x, grid, g)
    assert_fwd_matches_plain(out, grid_sample_bicubic_plain(x, grid))
    assert (dgrid - ref_dgrid).abs().max().item() <= fp32_tol(ref_dgrid)
    if dtype == torch.float32:
        assert (dx - ref_dx).abs().max().item() <= fp32_tol(ref_dx)
    else:
        ulp = 2.0 ** (torch.floor(torch.log2(ref_dx.float().abs().max())).item() - 7)
        assert (dx.float() - ref_dx.float()).abs().max().item() <= ulp


@pytest.mark.parametrize("view_batched_steps,beta1", [(True, 0.0), (False, 0.5)], ids=["view_batched", "beta1_0.5"])
def test_iteration_on_card_matches_cpu(view_batched_steps, beta1, dev):
    """Epochs 0, 1, 3 and 5 (frozen from 4) chained at the dryrun width in
    fp32, the same weights, batch and noise on the card and on the CPU:
    view-batched, and with Adam's first moment. Losses within 1e-4, every
    leaf (Adam's moments included) within 1e-3 of its scale: cuDNN and the
    kernels sum in other orders than the CPU."""
    import numpy as np

    from lcgan_torch.config import Config
    from lcgan_torch.train.steps import Trainer

    kw = dict(model_name="unused", img_resolution=32, batch_size=4, geo_noise_dim=8, app_noise_dim=8,
              geo_latent_dim=8, app_latent_dim=16, geo_projection_dim=8, app_projection_dim=8, base_nf=8, max_nf=16,
              mbstd_group_size=2, compute_dtype="float32", adam_eps=1e-3, freezeD_start=4, freezeD_layer=1,
              view_batched_steps=view_batched_steps, beta1=beta1)
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(Config(**kw, device=device))
        state = trainer.init_state()
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32)).to(device)
                 for k in ("image", "geometry_change", "appearance_change")}
        losses = []
        for epoch in (0, 1, 3, 5):
            noise = tuple(torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)).to(device) for _ in range(6))
            state, g_loss, d_loss = trainer.step_variant(epoch)(state, batch, noise)
            losses.append((g_loss.item(), d_loss.item()))
        leaves = {f"{name}.{k}": v.cpu() for name, m in (("G", state.generator), ("D", state.discriminator),
                                                         ("EMA", state.ema)) for k, v in m.state_dict().items()}
        for name in ("g_opt", "d_opt"):
            for moment, tree in getattr(state, name).state_dict().items():
                if moment != "count":
                    leaves.update({f"{name}.{moment}.{k}": v for k, v in tree.items()})
        runs[device] = (losses, leaves)
    (card_losses, card), (cpu_losses, cpu) = runs["cuda"], runs["cpu"]
    assert card.keys() == cpu.keys() and any(".mu." in k for k in cpu) == (beta1 != 0)
    for a, b in zip(card_losses, cpu_losses):
        assert all(abs(x - y) <= 1e-4 * max(1.0, abs(y)) for x, y in zip(a, b)), (a, b)
    for k, v in cpu.items():
        assert (card[k] - v).abs().max().item() <= 1e-3 * max(1e-3, v.abs().max().item()), k


def test_phase_spans_on_card(dev):
    """The program's tracing on the card: an even iteration under remat,
    traced and not, from one state in deterministic mode, bitwise equal;
    every span of the step carries its CUDA events, the step's phases in
    order on the device, and each recompute (opened on autograd's device
    thread) inside the device window of the G step's backward."""
    import threading

    from lcgan_torch.config import Config
    from lcgan_torch.train.loop import deterministic_algorithms
    from lcgan_torch.train.steps import Trainer
    from lcgan_torch.utils import trace

    kw = dict(model_name="unused", img_resolution=32, batch_size=4, geo_noise_dim=8, app_noise_dim=8,
              geo_latent_dim=8, app_latent_dim=16, geo_projection_dim=8, app_projection_dim=8, base_nf=8, max_nf=16,
              mbstd_group_size=2, compute_dtype="float32", remat_blocks=True, device="cuda")
    g = torch.Generator().manual_seed(0)
    batch = {k: (torch.rand((4, 3, 32, 32), generator=g) * 2 - 1).to(dev)
             for k in ("image", "geometry_change", "appearance_change")}
    with deterministic_algorithms():
        trainer = Trainer(Config(**kw))
        state = trainer.init_state()
        start = state.state_dict()  # copies on the CPU
        runs = []
        for traced in (False, True):
            state.load_state_dict(start)
            trace.take()
            if traced:
                trace.enable()
            state, g_loss, d_loss = trainer.train_iteration(state, batch, 0)
            trace.disable()
            spans, _ = trace.take()
            torch.cuda.synchronize()
            runs.append(((g_loss.item(), d_loss.item()), state.state_dict(), spans))
    (off_losses, off_state, off_spans), (on_losses, on_state, spans) = runs
    assert not off_spans and off_losses == on_losses
    for net in ("generator", "discriminator", "ema"):
        assert all(torch.equal(off_state[net][k], v) for k, v in on_state[net].items()), net
    main = threading.get_ident()
    top = [s for s in spans if s.parent is None and s.thread == main]
    assert [s.name for s in top][:3] == ["noise", "g_step.forward", "g_step.backward"]
    assert all(s.device_start_ns is not None and s.device_start_ns <= s.device_end_ns for s in spans)
    assert all(a.device_end_ns <= b.device_start_ns for a, b in zip(top, top[1:]))
    (backward,) = [s for s in spans if s.name == "g_step.backward"]
    recompute = [s for s in spans if s.name == "remat.recompute" and
                 backward.device_start_ns <= s.device_start_ns <= backward.device_end_ns]
    assert recompute and all(s.thread != main and s.device_end_ns <= backward.device_end_ns for s in recompute)
