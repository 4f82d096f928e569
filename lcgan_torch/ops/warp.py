"""The synthesis-block warp: bicubic ``grid_sample`` with zeros padding, and
its gradient.

``grid_sample_bicubic(x, grid, small)`` takes the contract of
``F.grid_sample``: x (B, C, H, W), grid (B, Hg, Wg, 2) in (x, y) order,
mode='bicubic', padding_mode='zeros', align_corners=False. It is the
autograd Function ``BicubicWarp`` (the port of the JAX package's
``custom_vjp`` ``_grid_sample_bicubic_pallas_vjp``):

  * on CPU tensors its forward and backward are the plain versions
    (``ops.grid_sample``), whatever the route;
  * on CUDA tensors the general route launches ``csrc/warp_fwd.cu`` forward
    and ``csrc/warp_dgrid.cu`` (the grid's gradient) and, for the
    features', ``csrc/warp_dx.cu`` at C >= 128 or ``csrc/warp_dx_scatter.cu``
    at C < 128 (the split of the JAX package's ``_vjp_bwd``); the small-map
    route (``small=True``, maps of at most 64²) launches
    ``csrc/warp_fwd_small.cu`` and ``csrc/warp_dgrid_small.cu``, which take
    tiles of output pixels, each pixel's weights once and a warp per pixel,
    and ``csrc/warp_dx_small.cu``
    (the gather of ``warp_dx_scatter.cu`` over an index built once per
    image; on maps of at most 256 pixels a block per image and channel
    group). Or it raises: nothing falls back to the plain versions.

Every kernel is exact for any grid, as the forward is, and the dx kernels
need Hg = H and Wg = W, the generator's only use.

``small_route`` is the JAX generator's choice of route, copied
(``use_small`` is the rule of ``lcgan_tpu.ops.warp_pallas._use_small``),
so that a run takes the same route in both packages.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch.autograd.function import once_differentiable

from lcgan_torch.ops import _build
from lcgan_torch.ops.grid_sample import (
    grid_sample_bicubic_plain,
    grid_sample_bicubic_plain_backward,
    max_warp_displacement,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


# each kernel's C entry point and its arguments (csrc/<name>.cu)
_SIGNATURES = {
    "warp_fwd": ("lcgan_warp_fwd", [_PTR] * 3 + [_INT] * 8 + [_PTR]),
    "warp_dgrid": ("lcgan_warp_dgrid", [_PTR] * 4 + [_INT] * 8 + [_PTR]),
    "warp_dx": ("lcgan_warp_dx", [_PTR] * 4 + [_INT] * 6 + [_PTR]),
    "warp_dx_scatter": ("lcgan_warp_dx_scatter", [_PTR] * 3 + [ctypes.c_longlong, _PTR] + [_INT] * 6 + [_PTR]),
    "warp_fwd_small": ("lcgan_warp_fwd_small", [_PTR] * 3 + [_INT] * 11 + [_PTR]),
    "warp_dgrid_small": ("lcgan_warp_dgrid_small", [_PTR] * 4 + [_INT] * 10 + [_PTR]),
    "warp_dx_small": ("lcgan_warp_dx_small", [_PTR] * 4 + [_INT] * 11 + [_PTR]),
}
_DX_SPLIT_C = 128  # dx kernel by channel count, as _vjp_bwd splits it (lcgan_tpu/ops/warp_pallas.py)
_SCAN_TILE = 1024  # counts scanned per block: kScanTile in csrc/warp_dx_scatter.cu
_SMALL_MAX = 64  # the small-map kernels take maps of at most 64²
_SMALL_SMEM = 229_376  # shared memory a small-map block may take: kMaxSmem in csrc/warp_small.cuh
_SMS = 132  # streaming multiprocessors of an H100 SXM
_SMALL_MIN_BLOCKS = 2 * _SMS  # about two blocks per SM
# warp_fwd_small's and warp_dgrid_small's tiles (csrc/warp_small.cuh): output pixels of a tile at most,
# a warp per pixel
_SMALL_TILE_PX = 64  # kMaxTilePx
_SMALL_TILE_WARPS = 8  # kTileWarps
_SMALL_TILE_SIDE = 8  # rows and columns of a tile before it is halved to fill the card
_SMALL_FWD_CHUNK = 1024  # channel bytes of a pixel a forward block takes: two 16-byte vectors per lane of a warp,
_SMALL_FWD_MIN_CHUNK = 512  # halved to one per lane where the grid is short of blocks
# warp_dx_small's gather (csrc/warp_dx_gather.cuh, csrc/warp_dx_small.cu): threads and tile sides of a block
_GATHER_THREADS = 256  # kGatherThreads
_GATHER_MAX_TILE = 16  # kMaxTile
_DX_SMALL_CHUNK = 512  # channel bytes of a pixel a gather block takes: one per lane of a warp
_DX_SMALL_ITEMS = 1024  # (pixel, vector) items of a block at most
_DX_SMALL_BUFFER = 52 * 1024  # the hit buffer: four blocks an SM
_DX_SMALL_LOCAL = 256  # maps of at most this many pixels: one launch, a block per image and channel group


# ----------------------------------------------------------------------------
# the route: the JAX generator's rule (lcgan_tpu/models/generator.py and
# lcgan_tpu/ops/warp_pallas._small_geom/_small_groups/_use_small), copied.
# The TPU's VMEM budget decides only which maps take the small route, so
# that both packages route a run alike; the CUDA kernels pick their own
# launches (_small_tile_geometry, _dx_small_geometry).
# ----------------------------------------------------------------------------

_UNROLL = 2  # packs per band-loop body (warp_pallas._unroll)


def _npack(c: int) -> int:
    """Band rows packed per matmul (warp_pallas._npack, without its
    environment override)."""
    raw = max(1, min(8, 256 // max(c, 1)))
    return 1 << (raw.bit_length() - 1)


def _round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _small_geom(h: int, w: int, c: int, m: int):
    """(rows per lane tile, padded width, padded height) of the JAX
    package's packed small-map layout."""
    nr = min(max(128 // w, 1), h)
    npack = _npack(c)
    s_dma = _round_up(w + 2 * m, 128)
    pb = _round_up((nr + 2 * m + 2 * npack - 2) // npack, _UNROLL)
    hp = ((h - nr) // npack + pb) * npack
    return nr, s_dma, hp


def _small_groups(h: int, w: int, c: int, m: int):
    """The JAX package's channel-group count for its small-map kernels, or
    None if no split fits its 6 MB budget."""
    groups = 1
    while True:
        cg = c // groups
        _, s_dma, hp = _small_geom(h, w, cg, m)
        if hp * max(cg, 8) * s_dma * 4 <= 6 * 1024 * 1024:
            return groups
        if cg % 2 or groups * 2 > c:
            return None
        groups *= 2


def use_small(h: int, w: int, c: int, m: int) -> bool:
    """Whether the JAX package's Pallas entry sends an (h, w, c) map with
    displacement bound m to its small-map kernels."""
    nr = _small_geom(h, w, c, m)[0]
    if w > 64 or 128 % w or h % nr:
        return False
    return _small_groups(h, w, c, m) is not None


def small_route(warp_impl: str, warp_pallas_min_res: int, h: int, w: int, c: int, max_flow_scale: float) -> bool:
    """The synthesis block's route: small exactly where the JAX generator
    would call its Pallas entry (``warp_impl`` "pallas", or "auto" at maps of
    ``warp_pallas_min_res`` and up, where the card stands in for the TPU) and
    that entry would take its small-map kernels. "banded" keeps the general
    route; under "none", the JAX package's diagnostic ablation, the synthesis
    block does not warp at all, so the route is never used."""
    pallas = warp_impl == "pallas" or (warp_impl == "auto" and h >= warp_pallas_min_res)
    return pallas and use_small(h, w, c, max_warp_displacement(h, max_flow_scale))


def _fn(name: str) -> ctypes._CFuncPtr:
    """The kernel's C entry point, built, loaded and typed at first use."""
    return _build.entry(name, *_SIGNATURES[name])


def _check_features(name: str, t: torch.Tensor, what: str) -> None:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 {what}, got {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} needs 4-D channels_last {what}, got {tuple(t.shape)} {t.stride()}")


def _check_grid(name: str, grid: torch.Tensor, ref: torch.Tensor) -> None:
    if ref.device.type != "cuda" or grid.device != ref.device:
        raise ValueError(f"{name} needs its tensors on one CUDA device, got {ref.device}, {grid.device}")
    if grid.dtype != torch.float32:
        raise TypeError(f"{name} takes a float32 grid, got {grid.dtype}")
    if grid.dim() != 4 or grid.shape[0] != ref.shape[0] or grid.shape[3] != 2 or not grid.is_contiguous():
        raise ValueError(f"{name} needs a contiguous (B, Hg, Wg, 2) grid, got {tuple(grid.shape)}")


def _vec(*tensors: torch.Tensor) -> int:
    """1 if every tensor's channel runs can be read as 16-byte vectors."""
    t0 = tensors[0]
    return int(t0.shape[1] % (16 // t0.element_size()) == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def warp_fwd(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA forward-warp kernel. Counts its launches in
    ``warp_fwd.launches``.

    x: (B, C, H, W) fp32 or bf16 in channels_last memory; grid: (B, Hg, Wg, 2)
    fp32, contiguous, on the same device. Returns (B, C, Hg, Wg) channels_last
    in x's dtype.
    """
    _check_grid("warp_fwd", grid, x)
    _check_features("warp_fwd", x, "features")
    b, c, h, w = x.shape
    hg, wg = grid.shape[1], grid.shape[2]
    out = torch.empty((b, c, hg, wg), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    fn = _fn("warp_fwd")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), grid.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], _vec(x),
                b, c, h, w, hg, wg, _stream(x))
    _build.raise_on(rc, "warp_fwd")
    warp_fwd.launches += 1
    return out


def warp_dgrid(x: torch.Tensor, grid: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA grid-gradient kernel. Counts its launches in
    ``warp_dgrid.launches``.

    x: (B, C, H, W) and the cotangent g: (B, C, Hg, Wg), both channels_last in
    one dtype (fp32 or bf16); grid: (B, Hg, Wg, 2) fp32, contiguous. Returns
    dgrid (B, Hg, Wg, 2) fp32.
    """
    _check_grid("warp_dgrid", grid, x)
    _check_features("warp_dgrid", x, "features")
    _check_features("warp_dgrid", g, "cotangent")
    b, c, h, w = x.shape
    hg, wg = grid.shape[1], grid.shape[2]
    if g.dtype != x.dtype or g.device != x.device or tuple(g.shape) != (b, c, hg, wg):
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} does not match x {tuple(x.shape)} {x.dtype} "
                         f"and grid {tuple(grid.shape)}")
    dgrid = torch.empty((b, hg, wg, 2), dtype=torch.float32, device=x.device)
    if g.numel() == 0:
        return dgrid.zero_()
    fn = _fn("warp_dgrid")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), grid.data_ptr(), g.data_ptr(), dgrid.data_ptr(), _DTYPES[x.dtype], _vec(x, g),
                b, c, h, w, hg, wg, _stream(x))
    _build.raise_on(rc, "warp_dgrid")
    warp_dgrid.launches += 1
    return dgrid


def _check_dx_args(name: str, grid: torch.Tensor, g: torch.Tensor) -> None:
    _check_grid(name, grid, g)
    _check_features(name, g, "cotangent")
    if tuple(grid.shape[1:3]) != tuple(g.shape[2:]):
        raise ValueError(f"{name} needs the features' map size on the grid: grid {tuple(grid.shape)}, g {tuple(g.shape)}")


def warp_dx(grid: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA feature-gradient kernels (the per-row window pass, on
    maps of more than 1024 pixels, and the tiled gather). Counts its
    launches in ``warp_dx.launches``.

    grid: (B, H, W, 2) fp32, contiguous; g: the cotangent (B, C, H, W),
    channels_last, fp32 or bf16, on the grid's map size. Returns dx
    (B, C, H, W) channels_last in g's dtype: the features had the grid's
    map size (the generator's only use; other sizes raise).
    """
    _check_dx_args("warp_dx", grid, g)
    b, c, h, w = g.shape
    dx = torch.empty_like(g, memory_format=torch.channels_last)
    if g.numel() == 0:
        return dx
    fn = _fn("warp_dx")
    rows = torch.empty((b * h, 4), dtype=torch.int32, device=g.device)  # each output row's window
    with torch.cuda.device(g.device):
        rc = fn(grid.data_ptr(), g.data_ptr(), rows.data_ptr(), dx.data_ptr(), _DTYPES[g.dtype], _vec(g, dx),
                b, c, h, w, _stream(g))
    _build.raise_on(rc, "warp_dx")
    warp_dx.launches += 1
    return dx


def _dx_scatter_scratch_ints(b: int, h: int, w: int) -> int:
    """int32 workspace of ``warp_dx_scatter``: each pixel's bucket and the
    sorted list (B·H·W each), the counts and the offsets (one per bucket and
    one more), and one total per scanned tile."""
    ncount = b * (h + 3) * (w + 3) + 1
    return 2 * b * h * w + 2 * ncount + -(-ncount // _SCAN_TILE)


def warp_dx_scatter(grid: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA feature-gradient kernels for narrow maps (the bucket
    sort of the output pixels by their taps, and the gather). Counts its
    launches in ``warp_dx_scatter.launches``.

    The arguments and the result are ``warp_dx``'s: grid (B, H, W, 2) fp32,
    contiguous; g (B, C, H, W) channels_last, fp32 or bf16; returns dx in
    g's dtype. Any C works; the backward sends C < 128 here.
    """
    _check_dx_args("warp_dx_scatter", grid, g)
    b, c, h, w = g.shape
    dx = torch.empty_like(g, memory_format=torch.channels_last)
    if g.numel() == 0:
        return dx
    fn = _fn("warp_dx_scatter")
    n_ints = _dx_scatter_scratch_ints(b, h, w)
    scratch = torch.empty(n_ints, dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        rc = fn(grid.data_ptr(), g.data_ptr(), scratch.data_ptr(), n_ints, dx.data_ptr(), _DTYPES[g.dtype],
                _vec(g, dx), b, c, h, w, _stream(g))
    _build.raise_on(rc, "warp_dx_scatter")
    warp_dx_scatter.launches += 1
    return dx


def _check_small_map(name: str, t: torch.Tensor) -> None:
    if t.shape[2] > _SMALL_MAX or t.shape[3] > _SMALL_MAX:
        raise ValueError(f"{name} takes maps of at most {_SMALL_MAX}², got {tuple(t.shape[2:])}")


@dataclasses.dataclass(frozen=True)
class SmallTileGeometry:
    """The launch of ``warp_fwd_small`` or ``warp_dgrid_small``: one block per
    image, tile of ``th`` x ``tw`` output pixels and chunk of ``cv`` channel
    vectors (of 16 bytes, or single channels on the scalar path; all of them
    for the grid gradient, whose channel sum stays in the block)."""

    th: int
    tw: int
    cv: int


def _small_tile_geometry(b: int, c: int, h: int, w: int, hg: int, wg: int, es: int, vec: int,
                         grad: bool) -> SmallTileGeometry:
    """The launch of the small-map forward (``grad`` False) or grid-gradient
    kernel for a (b, c, h, w) map of ``es``-byte elements (16-byte vectors if
    ``vec``) and an (hg, wg) grid: tiles of 8 x 8 output pixels, halved while
    the grid has fewer blocks than the card has SMs (two fit an SM) and a
    tile has more pixels than a block has warps; the gradient's blocks take
    all of a pixel's channels, the forward's _SMALL_FWD_CHUNK bytes of them,
    halved down to _SMALL_FWD_MIN_CHUNK while the grid is still short of
    blocks."""
    step = 16 // es if vec else 1
    vbytes = step * es  # bytes of a vector
    nvec = c // step
    cv = nvec if grad else min(nvec, max(1, _SMALL_FWD_CHUNK // vbytes))

    def blocks():
        return b * -(-hg // th) * -(-wg // tw) * -(-nvec // cv)

    th, tw = min(hg, _SMALL_TILE_SIDE), min(wg, _SMALL_TILE_SIDE)
    while blocks() < _SMS and th * tw > _SMALL_TILE_WARPS:
        if th >= tw:
            th = (th + 1) // 2
        else:
            tw = (tw + 1) // 2
    while not grad and blocks() < _SMS and cv * vbytes > _SMALL_FWD_MIN_CHUNK:
        cv = max(1, cv // 2)
    return SmallTileGeometry(th=th, tw=tw, cv=cv)


def _channel_group(b: int, c: int, h: int, w: int, es: int, vec: int, min_blocks: int = _SMALL_MIN_BLOCKS) -> int:
    """Channels per block of ``warp_dx_small``'s whole-map blocks (one per
    batch element and channel group) for ``es``-byte elements: C, halved
    while the group's h·w map overflows a block's shared memory or the grid
    has fewer than ``min_blocks`` blocks; a multiple of the 16-byte vector's
    channels on the vector path."""
    step = 16 // es if vec else 1
    cg = c
    while cg > step and (h * w * cg * es > _SMALL_SMEM or b * -(-c // cg) < min_blocks):
        cg = max(step, cg // 2 // step * step)
    return cg


@dataclasses.dataclass(frozen=True)
class DxSmallGeometry:
    """The launch of ``warp_dx_small``: blocks of ``th`` x ``tw`` input
    pixels (the whole map if ``local``) and ``cv`` channel vectors (of 16
    bytes, or single channels on the scalar path), with ``smem`` bytes of
    dynamic shared memory; ``local``: one launch, each block indexes its
    image itself, else one block per image first (``scratch_ints`` int32)
    and a gather with a buffer of ``nbuf`` hits."""

    th: int
    tw: int
    cv: int
    nbuf: int
    local: bool
    smem: int
    scratch_ints: int


def _dx_small_index_ints(h: int, w: int) -> int:
    """Shared-memory int32 of one image's bucket index (csrc/warp_dx_small.cu
    ``index_ints``): each pixel's bucket and the list, the bucket starts and
    their end, the counts."""
    return 2 * h * w + 2 * (h + 3) * (w + 3) + 1


def _dx_small_geometry(b: int, c: int, h: int, w: int, es: int, vec: int) -> DxSmallGeometry:
    """``warp_dx_small``'s launch for a (b, c, h, w) map of ``es``-byte
    elements (16-byte vectors if ``vec``).

    Maps of at most _DX_SMALL_LOCAL pixels: one block per image and channel
    group, holding the group's whole map of g, each pixel's 8 weights and the
    image's index; the groups as wide as about one block per SM allows, so
    that as few blocks as that build each image's index.

    Larger maps: chunks of _DX_SMALL_CHUNK bytes of a pixel's channels; tiles
    of at most 16 x 16 and _DX_SMALL_ITEMS (pixel, vector) items, halved
    while the grid is short of about two blocks per SM and a block keeps a
    round of items; a hit buffer of as many hits as _DX_SMALL_BUFFER holds (a
    hit: 8 weights, its pixel and its chunk of g) and no more than the map
    has."""
    step = 16 // es if vec else 1
    nvec = c // step
    if h * w <= _DX_SMALL_LOCAL:
        cv = _channel_group(b, c, h, w, es, vec, _SMS) // step
        smem = _round_up(h * w * cv * step * es, 16) + 8 * 4 * h * w + 4 * _dx_small_index_ints(h, w)
        return DxSmallGeometry(th=h, tw=w, cv=cv, nbuf=0, local=True, smem=smem, scratch_ints=0)
    cv = min(nvec, max(1, _DX_SMALL_CHUNK // (step * es)))
    nchunks = -(-nvec // cv)
    th, tw = min(h, _GATHER_MAX_TILE), min(w, _GATHER_MAX_TILE)

    def blocks():
        return b * -(-h // th) * -(-w // tw) * nchunks

    def halve(th, tw):
        return ((th + 1) // 2, tw) if th >= tw else (th, (tw + 1) // 2)

    while th * tw * cv > _DX_SMALL_ITEMS:
        th, tw = halve(th, tw)
    while blocks() < _SMALL_MIN_BLOCKS and th * tw * cv > _GATHER_THREADS and th * tw > 1:
        th, tw = halve(th, tw)
    per_hit = cv * step * es + 9 * 4
    nbuf = _round_up(max(1, min(_DX_SMALL_BUFFER // per_hit, h * w)), 4)
    return DxSmallGeometry(th=th, tw=tw, cv=cv, nbuf=nbuf, local=False, smem=nbuf * per_hit,
                           scratch_ints=b * ((h + 3) * (w + 3) + 1 + h * w))


def warp_fwd_small(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA small-map forward-warp kernel. Counts its launches in
    ``warp_fwd_small.launches``.

    The arguments and the result are ``warp_fwd``'s, with x's map at most
    64² (the grid's any size).
    """
    _check_grid("warp_fwd_small", grid, x)
    _check_features("warp_fwd_small", x, "features")
    _check_small_map("warp_fwd_small", x)
    b, c, h, w = x.shape
    hg, wg = grid.shape[1], grid.shape[2]
    out = torch.empty((b, c, hg, wg), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    fn = _fn("warp_fwd_small")
    vec = _vec(x, out)
    geo = _small_tile_geometry(b, c, h, w, hg, wg, x.element_size(), vec, grad=False)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), grid.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], vec, b, c, h, w, hg, wg, geo.th,
                geo.tw, geo.cv, _stream(x))
    _build.raise_on(rc, "warp_fwd_small")
    warp_fwd_small.launches += 1
    return out


def warp_dgrid_small(x: torch.Tensor, grid: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA small-map grid-gradient kernel (one launch; each
    block sums over all channels of its pixels). Counts its launches in
    ``warp_dgrid_small.launches``.

    The arguments and the result are ``warp_dgrid``'s, with x's map at most
    64².
    """
    _check_grid("warp_dgrid_small", grid, x)
    _check_features("warp_dgrid_small", x, "features")
    _check_features("warp_dgrid_small", g, "cotangent")
    _check_small_map("warp_dgrid_small", x)
    b, c, h, w = x.shape
    hg, wg = grid.shape[1], grid.shape[2]
    if g.dtype != x.dtype or g.device != x.device or tuple(g.shape) != (b, c, hg, wg):
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} does not match x {tuple(x.shape)} {x.dtype} "
                         f"and grid {tuple(grid.shape)}")
    dgrid = torch.empty((b, hg, wg, 2), dtype=torch.float32, device=x.device)
    if g.numel() == 0:
        return dgrid.zero_()
    fn = _fn("warp_dgrid_small")
    vec = _vec(x, g)
    geo = _small_tile_geometry(b, c, h, w, hg, wg, x.element_size(), vec, grad=True)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), grid.data_ptr(), g.data_ptr(), dgrid.data_ptr(), _DTYPES[x.dtype], vec, b, c, h, w,
                hg, wg, geo.th, geo.tw, _stream(x))
    _build.raise_on(rc, "warp_dgrid_small")
    warp_dgrid_small.launches += 1
    return dgrid


def warp_dx_small(grid: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA small-map feature-gradient kernels (the bucket index of
    the output pixels, once per image, and the tiled gather; on maps of at
    most 256 pixels one launch, a block per image and channel group). Counts
    its launches in ``warp_dx_small.launches``.

    The arguments and the result are ``warp_dx``'s, with the map at most
    64².
    """
    _check_dx_args("warp_dx_small", grid, g)
    _check_small_map("warp_dx_small", g)
    b, c, h, w = g.shape
    dx = torch.empty_like(g, memory_format=torch.channels_last)
    if g.numel() == 0:
        return dx
    fn = _fn("warp_dx_small")
    vec = _vec(g, dx)
    geo = _dx_small_geometry(b, c, h, w, g.element_size(), vec)
    scratch = torch.empty(geo.scratch_ints, dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        rc = fn(grid.data_ptr(), g.data_ptr(), scratch.data_ptr(), dx.data_ptr(), _DTYPES[g.dtype], vec, b, c, h, w,
                geo.th, geo.tw, geo.cv, geo.nbuf, int(geo.local), _stream(g))
    _build.raise_on(rc, "warp_dx_small")
    warp_dx_small.launches += 1
    return dx


warp_fwd.launches = 0
warp_dgrid.launches = 0
warp_dx.launches = 0
warp_dx_scatter.launches = 0
warp_fwd_small.launches = 0
warp_dgrid_small.launches = 0
warp_dx_small.launches = 0


class BicubicWarp(torch.autograd.Function):
    """Bicubic warp with its hand-written gradient. Saves only (x, grid), as
    the JAX package's ``_vjp_fwd`` does; ``small`` picks the route on the
    card."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, grid: torch.Tensor, small: bool) -> torch.Tensor:
        ctx.save_for_backward(x, grid)
        ctx.small = small
        if x.device.type == "cpu" and grid.device.type == "cpu":
            return grid_sample_bicubic_plain(x, grid)
        return (warp_fwd_small if small else warp_fwd)(x, grid)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        x, grid = ctx.saved_tensors
        need_x, need_grid = ctx.needs_input_grad[:2]
        if x.device.type == "cpu" and grid.device.type == "cpu":
            dx, dgrid = grid_sample_bicubic_plain_backward(x, grid, g)
            return (dx if need_x else None), (dgrid.to(grid.dtype) if need_grid else None), None
        g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
        if ctx.small:
            dx_kernel, dgrid_kernel = warp_dx_small, warp_dgrid_small
        else:
            dx_kernel = warp_dx if g.shape[1] >= _DX_SPLIT_C else warp_dx_scatter
            dgrid_kernel = warp_dgrid
        dx = dx_kernel(grid, g) if need_x else None
        dgrid = dgrid_kernel(x, grid, g) if need_grid else None
        return dx, dgrid, None


def grid_sample_bicubic(x: torch.Tensor, grid: torch.Tensor, small: bool = False) -> torch.Tensor:
    """Bicubic warp: plain PyTorch on the CPU, the CUDA kernels on the card
    (the small-map route if ``small``)."""
    return BicubicWarp.apply(x, grid, small)
