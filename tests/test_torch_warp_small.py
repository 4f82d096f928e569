"""The small-map warp route of the port (maps of at most 64², ``warp_impl`` /
``warp_pallas_min_res``), on the CPU:

  1. the port's route rule (``lcgan_torch.ops.warp.use_small``,
     ``small_route``) against the JAX package's (``_use_small`` and the
     generator's ``use_pallas``), per block of the port's Generator too;
  2. the port's plain forward and backward against the JAX small-map Pallas
     kernels themselves, in interpret mode: K5 (``_fwd_small_kernel``), K6
     (``_dgrid_small_kernel``) and K7 (``_dx_small_kernel``), their
     channel-group split included;
  3. the autograd Function's CPU path on the small route (the plain version,
     no launch), the Generator with ``warp_pallas_min_res=8`` against the JAX
     Generator, and the CLI's train phase carrying the knob into
     ``args.txt`` and generation.

The CUDA kernels (``csrc/warp_fwd_small.cu``, ``warp_dgrid_small.cu``,
``warp_dx_small.cu``) are held against the plain versions on the card, in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lcgan_tpu.models import Generator as JaxGenerator
from lcgan_tpu.ops import grid_sample as j_gs
from lcgan_tpu.ops.warp_pallas import _small_groups, _use_small, grid_sample_bicubic_pallas
from lcgan_torch import cli
from lcgan_torch.config import Config
from lcgan_torch.convert import flax_from_generator
from lcgan_torch.models.generator import Generator
from lcgan_torch.ops import grid_sample as t_gs
from lcgan_torch.ops import warp as t_warp
from lcgan_torch.train.loop import load_ema_generator

FLOWS = [0.1, 0.03]
KERNELS = ("warp_fwd", "warp_dgrid", "warp_dx", "warp_dx_scatter", "warp_fwd_small", "warp_dgrid_small",
           "warp_dx_small")
# the dryrun config of __graft_entry__.py:64-82, and the flagship 256² widths
DRYRUN = dict(img_resolution=32, geo_noise_dim=8, app_noise_dim=8, geo_latent_dim=8, app_latent_dim=16, base_nf=8,
              max_nf=16)
FLAGSHIP = dict(img_resolution=256, base_nf=128, max_nf=512)
ROUTES = [("auto", 8), ("auto", 128), ("pallas", 128)]


def case(shape, s, seed=0):
    """NHWC features, a (B, H, W, 2) grid and an NHWC cotangent, as numpy."""
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    flow = rng.uniform(-1, 1, (b, h, w, 2)).astype(np.float32)
    grid = (np.asarray(j_gs.identity_like_coordinates(b, h, w)) + flow * np.float32(s)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, grid, g


def nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize("s", [0.03, 0.1])
@pytest.mark.parametrize("h", [4, 8, 16, 32, 64, 128, 256])
def test_use_small_matches_jax(h, s):
    m = t_gs.max_warp_displacement(h, s)
    assert m == j_gs.max_warp_displacement(h, s)
    for c in (3, 8, 64, 256, 512):
        assert t_warp.use_small(h, h, c, m) == _use_small(h, h, c, m, 4), (h, c, m)
        if _use_small(h, h, c, m, 4):
            assert t_warp._small_groups(h, h, c, m) == _small_groups(h, h, c, m)


def jax_route(cfg: dict, warp_impl: str, min_res: int, max_flow_scale: float = 0.1):
    """The JAX generator's per-block choice (models/generator.py:115-120 with
    the backend a TPU, then warp_pallas._fwd_call/_vjp_bwd's _use_small)."""
    n = int(np.log2(cfg["img_resolution"])) - 2
    routes = []
    for i in range(n):
        h, c = 8 * 2**i, min(cfg["base_nf"] * 2 ** (n - i - 1), cfg["max_nf"])
        use_pallas = warp_impl == "pallas" or (warp_impl == "auto" and h >= min_res)
        routes.append(use_pallas and _use_small(h, h, c, j_gs.max_warp_displacement(h, max_flow_scale), 4))
    return routes


@pytest.mark.parametrize("warp_impl,min_res", ROUTES)
@pytest.mark.parametrize("cfg", [DRYRUN, FLAGSHIP], ids=["dryrun", "flagship256"])
def test_generator_route_matches_jax(cfg, warp_impl, min_res):
    model = Generator(**cfg, warp_impl=warp_impl, warp_pallas_min_res=min_res)
    got = [getattr(model, f"block_{i}").small_warp for i in range(model.num_blocks)]
    assert got == jax_route(cfg, warp_impl, min_res)
    if cfg is FLAGSHIP:  # the 8²-64² blocks (C = 512) go small under (auto, 8); 128² and 256² never
        assert got == ([True] * 4 + [False] * 2 if (warp_impl, min_res) != ("auto", 128) else [False] * 6)


def test_banded_and_none_keep_the_general_route(monkeypatch):
    """"banded" keeps the general route. "none" takes no route at all: the
    blocks skip the warp, as the JAX blocks do, so the warp is never called."""
    from lcgan_torch.models import generator as t_generator

    model = Generator(**DRYRUN, warp_impl="banded", warp_pallas_min_res=8)
    assert not any(getattr(model, f"block_{i}").small_warp for i in range(model.num_blocks))

    calls = []
    monkeypatch.setattr(t_generator, "grid_sample_bicubic", lambda *a: calls.append(a) or a[0])
    z = torch.zeros((2, DRYRUN["geo_noise_dim"]))
    with torch.no_grad():
        Generator(**DRYRUN, warp_impl="banded")(z, z, w_psi=0.7)
        assert len(calls) == model.num_blocks
        out = Generator(**DRYRUN, warp_impl="none", warp_pallas_min_res=8)(z, z, w_psi=0.7)
    assert len(calls) == model.num_blocks and torch.isfinite(out).all()


# (b, h, w, c) where _use_small holds: one group, and (1, 32, 32, 512) in two
SMALL_SHAPES = [(2, 16, 16, 8), (1, 32, 32, 16), (1, 32, 32, 512)]


def assert_small_route(shape, m):
    b, h, w, c = shape
    assert _use_small(h, w, c, m, 4) and t_warp.use_small(h, w, c, m)  # K5-K7 themselves
    assert _small_groups(h, w, c, m) == (2 if c == 512 else 1)


@pytest.mark.parametrize("s", FLOWS)
@pytest.mark.parametrize("shape", SMALL_SHAPES)
def test_plain_matches_pallas_small_fwd_kernel(shape, s):
    b, h, w, c = shape
    m = j_gs.max_warp_displacement(h, s)
    assert_small_route(shape, m)
    x, grid, _ = case(shape, s)
    ref = grid_sample_bicubic_pallas(jnp.asarray(x), jnp.asarray(grid), m, True)
    got = t_gs.grid_sample_bicubic_plain(nchw(x), torch.from_numpy(grid)).permute(0, 2, 3, 1).numpy()
    # the kernel sums its band as matmuls, in another order (test_warp_pallas.py:47)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("s", FLOWS)
@pytest.mark.parametrize("shape", SMALL_SHAPES)
def test_plain_backward_matches_pallas_small_bwd_kernels(shape, s):
    b, h, w, c = shape
    m = j_gs.max_warp_displacement(h, s)
    assert_small_route(shape, m)
    x, grid, g = case(shape, s)
    _, vjp = jax.vjp(lambda a, q: grid_sample_bicubic_pallas(a, q, m, True), jnp.asarray(x), jnp.asarray(grid))
    dx, dgrid = vjp(jnp.asarray(g))
    got_dx, got_dgrid = t_gs.grid_sample_bicubic_plain_backward(nchw(x), torch.from_numpy(grid), nchw(g))
    # the tolerances of tests/test_warp_pallas.py:63-64 (banded matmul sums)
    np.testing.assert_allclose(got_dx.permute(0, 2, 3, 1).numpy(), np.asarray(dx), atol=1e-3)
    np.testing.assert_allclose(got_dgrid.numpy(), np.asarray(dgrid), atol=2e-2)


@pytest.mark.parametrize("s", FLOWS)
def test_autograd_function_small_route_on_cpu_is_plain(s):
    """On CPU tensors the small route runs the plain versions, bit for bit
    the general route's, and launches nothing."""
    x, grid, g = case((2, 16, 16, 8), s)
    before = [getattr(t_warp, k).launches for k in KERNELS]
    grads = []
    for small in (True, False):
        xt = nchw(x).clone().requires_grad_()
        gt = torch.from_numpy(grid).clone().requires_grad_()
        out = t_warp.grid_sample_bicubic(xt, gt, small)
        out.backward(nchw(g))
        grads.append((out.detach(), xt.grad, gt.grad))
    assert [getattr(t_warp, k).launches for k in KERNELS] == before
    want_dx, want_dgrid = t_gs.grid_sample_bicubic_plain_backward(nchw(x), torch.from_numpy(grid), nchw(g))
    assert torch.equal(grads[0][0], t_gs.grid_sample_bicubic_plain(nchw(x), torch.from_numpy(grid)))
    assert torch.equal(grads[0][1], want_dx) and torch.equal(grads[0][2], want_dgrid)
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_small_kernel_wrappers_refuse_cpu_tensors():
    x, grid, g = case((1, 8, 8, 4), 0.1)
    xt = nchw(x).contiguous(memory_format=torch.channels_last)
    gt = nchw(g).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="CUDA"):
        t_warp.warp_fwd_small(xt, torch.from_numpy(grid))
    with pytest.raises(ValueError, match="CUDA"):
        t_warp.warp_dgrid_small(xt, torch.from_numpy(grid), gt)
    with pytest.raises(ValueError, match="CUDA"):
        t_warp.warp_dx_small(torch.from_numpy(grid), gt)


CSRC = Path(t_warp.__file__).resolve().parent / "csrc"
# (b, c, h, w, hg, wg, vec) of warp_fwd_small's and warp_dgrid_small's
# launches: the four small maps of a 256² batch (C = 512) on the vector path,
# odd C and odd maps on the scalar path, and grids of another size than the
# map (fewer and more output pixels)
SMALL_TILE_LAUNCHES = ([(8, 512, h, h, h, h, 1) for h in (8, 16, 32, 64)]
                       + [(2, 5, 12, 12, 12, 12, 0), (1, 3, 9, 7, 9, 7, 0), (2, 16, 16, 16, 5, 11, 1),
                          (2, 24, 8, 8, 20, 20, 1)])


def test_small_tile_geometry_matches_the_kernel_sources():
    """The host's copies of the tile kernels' constants (csrc/warp_small.cuh),
    and the kernels' decoding of the block index through tile_block."""
    small = (CSRC / "warp_small.cuh").read_text()
    threads = int(re.search(r"constexpr int kTileThreads = (\d+);", small)[1])
    assert re.search(r"constexpr int kMaxTilePx = (\d+);", small)[1] == str(t_warp._SMALL_TILE_PX)
    assert "constexpr int kTileWarps = kTileThreads / 32;" in small and threads // 32 == t_warp._SMALL_TILE_WARPS
    assert "const int chunk = bid % nchunks;" in small and "const int tile = bid % ntiles;" in small
    assert "tile_block(Hg, Wg, th, tw, tiles_x, ntiles, cv, nchunks, C / VEC)" in (CSRC / "warp_fwd_small.cu").read_text()
    assert "tile_block(Hg, Wg, th, tw, tiles_x, ntiles, nvec, 1, nvec)" in (CSRC / "warp_dgrid_small.cu").read_text()


@pytest.mark.parametrize("grad", [False, True], ids=["fwd", "dgrid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w,hg,wg,vec", SMALL_TILE_LAUNCHES)
def test_small_tile_geometry_covers_each_pixel_and_channel_once(b, c, h, w, hg, wg, vec, dtype, grad):
    """warp_fwd_small's and warp_dgrid_small's tiles and chunks, decoded from
    the block index as the kernels decode it (tile_block in
    csrc/warp_small.cuh), cover every (image, output pixel, channel vector)
    exactly once; a tile has at most 64 pixels; the grid gradient's blocks
    take all of a pixel's channels (its channel sum stays in the block); the
    forward's chunks are 512-1024 bytes of a pixel where C allows."""
    es = torch.empty(0, dtype=dtype).element_size()
    step = 16 // es if vec else 1  # channels of a vector
    nvec = c // step
    geo = t_warp._small_tile_geometry(b, c, h, w, hg, wg, es, vec, grad)
    assert 1 <= geo.th * geo.tw <= t_warp._SMALL_TILE_PX and geo.th <= hg and geo.tw <= wg
    if grad:
        assert geo.cv == nvec
    else:  # 1024 bytes of a pixel, halved down to 512 to fill the card, or all of a narrower pixel
        assert min(nvec * step * es, t_warp._SMALL_FWD_MIN_CHUNK) <= geo.cv * step * es <= t_warp._SMALL_FWD_CHUNK
    nchunks = -(-nvec // geo.cv)
    tiles_x = -(-wg // geo.tw)
    ntiles = tiles_x * -(-hg // geo.th)
    blocks = b * ntiles * nchunks
    seen = np.zeros((b, hg, wg, nvec), np.uint8)
    for bid in range(blocks):
        chunk, rest = bid % nchunks, bid // nchunks
        tile, image = rest % ntiles, rest // ntiles
        ty = tile // tiles_x
        r0, q0 = ty * geo.th, (tile - ty * tiles_x) * geo.tw
        th, tw = min(geo.th, hg - r0), min(geo.tw, wg - q0)
        v0 = chunk * geo.cv
        cw = min(geo.cv, nvec - v0)
        assert th >= 1 and tw >= 1 and cw >= 1
        seen[image, r0:r0 + th, q0:q0 + tw, v0:v0 + cw] += 1
    assert (seen == 1).all()


# (b, c, h, w, vec) of warp_dx_small's launches: the four small maps of a 256²
# batch (C = 512) on the vector path, and odd C on the scalar path
DX_SMALL_LAUNCHES = ([(8, 512, h, h, 1) for h in (8, 16, 32, 64)]
                     + [(2, 5, 40, 40, 0), (1, 3, 9, 7, 0), (2, 16, 8, 8, 0), (2, 24, 4, 64, 1)])


def test_dx_small_geometry_matches_the_kernel_sources():
    """The host's copies of the gather's constants and of the index's size."""
    gather = (CSRC / "warp_dx_gather.cuh").read_text()
    small = (CSRC / "warp_dx_small.cu").read_text()
    assert re.search(r"constexpr int kGatherThreads = (\d+);", gather)[1] == str(t_warp._GATHER_THREADS)
    assert re.search(r"constexpr int kMaxTile = (\d+);", gather)[1] == str(t_warp._GATHER_MAX_TILE)
    assert "return 2 * H * W + 2 * (H + 3) * (W + 3) + 1;" in small
    assert "nbuf * (9 * sizeof(float) + cv * VEC * sizeof(T))" in small
    assert "map_g_bytes(H * W, cg, sizeof(T)) + (size_t)H * W * 8 * sizeof(float) + index_bytes;" in small


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w,vec", DX_SMALL_LAUNCHES)
def test_dx_small_geometry_covers_each_pixel_and_channel_once(b, c, h, w, vec, dtype):
    """warp_dx_small's tiles and chunks, decoded from the block index as the
    kernels decode it, cover every (image, pixel, channel vector) exactly
    once, and a block's shared memory stays under a small-map block's limit:
    at most 256 pixels, one block per image and channel group (the group's
    map of g, 8 weights a pixel and the index); above, tiles of at most
    16 x 16 and a buffer of whole groups of 4 hits."""
    es = torch.empty(0, dtype=dtype).element_size()
    step = 16 // es if vec else 1  # channels of a vector
    geo = t_warp._dx_small_geometry(b, c, h, w, es, vec)
    assert c % step == 0 and geo.local == (h * w <= t_warp._DX_SMALL_LOCAL)
    if geo.local:
        assert (geo.th, geo.tw, geo.scratch_ints) == (h, w, 0)
        assert geo.cv * step == t_warp._channel_group(b, c, h, w, es, vec, t_warp._SMS)
        index = 4 * t_warp._dx_small_index_ints(h, w)
        assert geo.smem == t_warp._round_up(h * w * geo.cv * step * es, 16) + 32 * h * w + index
    else:
        assert 1 <= geo.th <= t_warp._GATHER_MAX_TILE and 1 <= geo.tw <= t_warp._GATHER_MAX_TILE
        assert geo.nbuf >= 4 and geo.nbuf % 4 == 0 and geo.nbuf <= t_warp._round_up(h * w, 4)
        assert geo.smem == geo.nbuf * (geo.cv * step * es + 36)
        assert geo.scratch_ints == b * ((h + 3) * (w + 3) + 1 + h * w)
    assert geo.smem <= t_warp._SMALL_SMEM
    nvec = c // step
    nchunks = -(-nvec // geo.cv)
    tiles_x = -(-w // geo.tw)
    ntiles = tiles_x * -(-h // geo.th)
    seen = np.zeros((b, h, w, nvec), np.uint8)
    for bid in range(b * ntiles * nchunks):
        chunk, rest = bid % nchunks, bid // nchunks
        tile, image = rest % ntiles, rest // ntiles
        u0, v0 = tile // tiles_x * geo.th, tile % tiles_x * geo.tw
        cw = min(geo.cv, nvec - chunk * geo.cv)
        seen[image, u0:u0 + geo.th, v0:v0 + geo.tw, chunk * geo.cv:chunk * geo.cv + cw] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("w_psi", [0.7, -1.0])
def test_generator_small_route_matches_jax(w_psi):
    """The port's Generator with warp_pallas_min_res=8 (every block on the
    small route) on the CPU against the JAX Generator, in the pattern of
    tests/test_torch_generator.py."""
    model = Generator(**DRYRUN, warp_pallas_min_res=8, generator=torch.Generator().manual_seed(0))
    assert all(getattr(model, f"block_{i}").small_warp for i in range(model.num_blocks))
    rng = np.random.default_rng(0)
    for buf in (model.avg_latent1, model.avg_latent2):
        buf.copy_(torch.from_numpy(rng.standard_normal(buf.shape).astype(np.float32)))
    params, stats = flax_from_generator(model.state_dict())
    model = model.to(memory_format=torch.channels_last)
    z1 = rng.standard_normal((2, 8)).astype(np.float32)
    z2 = rng.standard_normal((2, 8)).astype(np.float32)
    ref, _ = JaxGenerator(**DRYRUN, warp_impl="banded").apply(
        {"params": params, "stats": stats}, jnp.asarray(z1), jnp.asarray(z2), w_psi, mutable=["stats"]
    )
    with torch.no_grad():
        out = model(torch.from_numpy(z1), torch.from_numpy(z2), w_psi=w_psi)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


TINY = ["--img_resolution", "16", "--batch_size", "4", "--geo_noise_dim", "4", "--app_noise_dim", "4",
        "--geo_latent_dim", "4", "--app_latent_dim", "8", "--geo_projection_dim", "4", "--app_projection_dim", "4",
        "--base_nf", "4", "--max_nf", "8", "--mbstd_group_size", "2", "--compute_dtype", "float32",
        "--num_data_workers", "2", "--device", "cpu"]


def test_cli_train_phase_keeps_the_route_for_generation(tmp_path):
    """``--warp_pallas_min_res 8`` goes into args.txt; fake_image_generation
    reloads it, so its generator takes the route the run trained with."""
    d = tmp_path / "data" / "train" / "x"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (20, 24, 3), dtype=np.uint8)).save(d / f"{i}.png")
    run = str(tmp_path / "run")
    cli.main(["--phase", "train", "--dataset_path", str(tmp_path / "data"), "--model_name", run, *TINY,
              "--warp_pallas_min_res", "8", "--epoch", "1", "--save_interval", "1"])
    assert Config.load(os.path.join(run, "args.txt")).warp_pallas_min_res == 8

    argv = ["--phase", "fake_image_generation", "--model_name", run, "--num_fakes", "1"]
    cfg = cli.parse_config(argv)
    assert (cfg.warp_pallas_min_res, cfg.warp_impl) == (8, "auto")
    gen = load_ema_generator(cfg, torch.device("cpu"))
    assert [getattr(gen, f"block_{i}").small_warp for i in range(gen.num_blocks)] == [True, True]
    cli.main(argv)
    assert np.asarray(Image.open(os.path.join(run, "fakes", "0000_images.jpg"))).shape == (64, 16, 3)
    # a typed flag still wins over args.txt
    assert cli.parse_config(argv + ["--warp_pallas_min_res", "128"]).warp_pallas_min_res == 128
