"""The synthesis-block warp: bicubic ``grid_sample`` with zeros padding, and
its gradient.

``grid_sample_bicubic(x, grid)`` takes the contract of ``F.grid_sample``:
x (B, C, H, W), grid (B, Hg, Wg, 2) in (x, y) order, mode='bicubic',
padding_mode='zeros', align_corners=False. It is the autograd Function
``BicubicWarp`` (the port of the JAX package's ``custom_vjp``
``_grid_sample_bicubic_pallas_vjp``):

  * on CPU tensors its forward and backward are the plain versions
    (``ops.grid_sample``);
  * on CUDA tensors the forward launches ``csrc/warp_fwd.cu`` and the
    backward ``csrc/warp_dgrid.cu`` (the grid's gradient) and, for the
    features', ``csrc/warp_dx.cu`` at C >= 128 or ``csrc/warp_dx_scatter.cu``
    at C < 128 (the split of the JAX package's ``_vjp_bwd``), or raises.
    Nothing falls back to the plain versions.

Both dx kernels are exact for any grid, as the forward is (``warp_dx``
measures its window from the grid on the device; ``warp_dx_scatter`` sorts
the output pixels by their taps), and both need Hg = H and Wg = W, the
generator's only use.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from lcgan_torch.ops import _build
from lcgan_torch.ops.grid_sample import grid_sample_bicubic_plain, grid_sample_bicubic_plain_backward

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


# each kernel's C entry point and its arguments (csrc/<name>.cu)
_SIGNATURES = {
    "warp_fwd": ("lcgan_warp_fwd", [_PTR] * 3 + [_INT] * 8 + [_PTR]),
    "warp_dgrid": ("lcgan_warp_dgrid", [_PTR] * 4 + [_INT] * 8 + [_PTR]),
    "warp_dx": ("lcgan_warp_dx", [_PTR] * 4 + [_INT] * 6 + [_PTR]),
    "warp_dx_scatter": ("lcgan_warp_dx_scatter", [_PTR] * 3 + [ctypes.c_longlong, _PTR] + [_INT] * 6 + [_PTR]),
}
_DX_SCRATCH = 128  # fp32 partial maxima of warp_dx's window pass: kDispBlocks in csrc/warp_dx.cu
_DX_SPLIT_C = 128  # dx kernel by channel count, as _vjp_bwd splits it (lcgan_tpu/ops/warp_pallas.py)
_SCAN_TILE = 1024  # counts scanned per block: kScanTile in csrc/warp_dx_scatter.cu
_fns: dict = {}


def _fn(name: str) -> ctypes._CFuncPtr:
    """The kernel's C entry point, built, loaded and typed at first use."""
    fn = _fns.get(name)
    if fn is None:
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(_build.load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


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


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


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
    _raise_on(rc, "warp_fwd")
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
    _raise_on(rc, "warp_dgrid")
    warp_dgrid.launches += 1
    return dgrid


def _check_dx_args(name: str, grid: torch.Tensor, g: torch.Tensor) -> None:
    _check_grid(name, grid, g)
    _check_features(name, g, "cotangent")
    if tuple(grid.shape[1:3]) != tuple(g.shape[2:]):
        raise ValueError(f"{name} needs the features' map size on the grid: grid {tuple(grid.shape)}, g {tuple(g.shape)}")


def warp_dx(grid: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA feature-gradient kernels (the window pass and the
    gather). Counts its launches in ``warp_dx.launches``.

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
    partial = torch.empty(_DX_SCRATCH, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        rc = fn(grid.data_ptr(), g.data_ptr(), partial.data_ptr(), dx.data_ptr(), _DTYPES[g.dtype], _vec(g, dx),
                b, c, h, w, _stream(g))
    _raise_on(rc, "warp_dx")
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
    _raise_on(rc, "warp_dx_scatter")
    warp_dx_scatter.launches += 1
    return dx


warp_fwd.launches = 0
warp_dgrid.launches = 0
warp_dx.launches = 0
warp_dx_scatter.launches = 0


class BicubicWarp(torch.autograd.Function):
    """Bicubic warp with its hand-written gradient. Saves only (x, grid), as
    the JAX package's ``_vjp_fwd`` does."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, grid)
        if x.device.type == "cpu" and grid.device.type == "cpu":
            return grid_sample_bicubic_plain(x, grid)
        return warp_fwd(x, grid)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        x, grid = ctx.saved_tensors
        need_x, need_grid = ctx.needs_input_grad[:2]
        if x.device.type == "cpu" and grid.device.type == "cpu":
            dx, dgrid = grid_sample_bicubic_plain_backward(x, grid, g)
            return (dx if need_x else None), (dgrid.to(grid.dtype) if need_grid else None)
        g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
        dx = None
        if need_x:
            dx = (warp_dx if g.shape[1] >= _DX_SPLIT_C else warp_dx_scatter)(grid, g)
        dgrid = warp_dgrid(x, grid, g) if need_grid else None
        return dx, dgrid


def grid_sample_bicubic(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bicubic warp: plain PyTorch on the CPU, the CUDA kernels on the card."""
    return BicubicWarp.apply(x, grid)
