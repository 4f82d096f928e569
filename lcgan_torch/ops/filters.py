"""Spatial filtering primitives (NCHW), PyTorch port of ``lcgan_tpu.ops.filters``.

  * box_filter_3x3 == ``avg_pool2d(k=3, s=1, p=1)`` with count_include_pad=True
    (custom_layers.py:136-138): zero padding, divisor always 9. The filter
    is its own adjoint, so its gradient is the same filter applied to the
    cotangent (``BoxFilter3x3``, twice differentiable, as R1's double
    backward through the discriminator needs).
  * avg_pool_2x2 == ``avg_pool2d(k=2, s=2, p=0)`` (custom_layers.py:202)
  * nearest_upsample_2x == ``F.interpolate(scale_factor=2, mode='nearest')``
    (custom_layers.py:146)

On CPU tensors both pools are the plain versions (``F.avg_pool2d``, as
``box_filter_plain`` and ``pool2x2_plain`` name them). On CUDA tensors they
launch the hand-written kernels of ``csrc/pool2d.cu`` (``box_filter``,
``pool2x2`` and ``pool2x2_grad``), forward and backward, or raise: nothing
falls back to ATen's pool. The kernel's path follows the tensor
(``pool_path``): 16-byte channel vectors on channels_last maps whose channel
run is a multiple of 16 bytes, one element a thread on other channels_last
maps and on NCHW-contiguous ones. The output has the memory format ATen's
pool would give it (``channels_last_like``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from lcgan_torch.ops import _build
from lcgan_torch.utils import trace

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
_PATHS = {"vector": 0, "narrow": 1, "strided": 2}  # enum Path in csrc/pool2d.cu
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# each kernel's C entry point and its arguments (csrc/pool2d.cu)
_SIGNATURES = {
    "box_filter": ("lcgan_box_filter", [_PTR, _PTR] + [_INT] * 7 + [_PTR]),
    "pool2x2": ("lcgan_pool2x2", [_PTR, _PTR] + [_INT] * 6 + [_PTR]),
    "pool2x2_grad": ("lcgan_pool2x2_grad", [_PTR, _PTR] + [_INT] * 6 + [_PTR]),
}
_VECTOR_BYTES = 16
_STRIP = 8  # output rows a box-filter thread slides over at most: kStrip in csrc/pool2d.cu
_CARD_THREADS = 132 * 2048  # threads an H100 SXM holds at once: 132 SMs of 2048
_INT_MAX = 2**31 - 1


def channels_last_like(shape: Sequence[int], strides: Sequence[int]) -> bool:
    """ATen's choice of memory format for a 4-D tensor
    (``Tensor.suggest_memory_format``, the rule its pools apply to their
    output): channels_last where the strides run C, W, H, N from the
    innermost, ties broken toward NCHW."""
    if strides[1] == 0:
        return False
    least = 0
    for d in (1, 3, 2, 0):
        if shape[d] == 0 or strides[d] < least:
            return False
        if d == 0 and least == strides[1]:
            return False
        least = strides[d] * shape[d]
    return True


def _format(shape: Sequence[int], strides: Sequence[int]) -> torch.memory_format:
    return torch.channels_last if channels_last_like(shape, strides) else torch.contiguous_format


def pool_path(dtype: torch.dtype, shape: Sequence[int], strides: Sequence[int], addrs: Sequence[int]) -> str:
    """The kernels' path, from the output's shape and strides (dense in the
    memory format the wrapper chose, the input dense in the same one) and
    the addresses of both: "vector" (16-byte channel vectors) on a
    channels_last map whose channel run is a multiple of 16 bytes, with
    every address 16-byte aligned; "narrow" (one element a thread) on any
    other channels_last map; "strided" (one element a thread, neighbouring
    columns) on an NCHW one. Raises on what the kernels do not take."""
    if dtype not in _DTYPES:
        raise TypeError(f"the pool kernels take float32 or bfloat16, got {dtype}")
    if len(shape) != 4:
        raise ValueError(f"the pool kernels take 4-D (N, C, H, W) tensors, got shape {tuple(shape)}")
    if not channels_last_like(shape, strides):
        return "strided"
    if shape[1] * _ITEMSIZE[dtype] % _VECTOR_BYTES == 0 and all(a % _VECTOR_BYTES == 0 for a in addrs):
        return "vector"
    return "narrow"


def box_rows(n: int, c: int, h: int, w: int, vec: int) -> int:
    """Output rows a box-filter thread slides over, for ``vec`` channels a
    thread: ``_STRIP``, halved while the grid would hold fewer threads than
    the card does at once."""
    per_row = n * w * (c // vec)  # threads of one row of strips
    rows = _STRIP
    while rows > 1 and per_row * -(-h // rows) < _CARD_THREADS:
        rows //= 2
    return rows


class _Plan(NamedTuple):
    fmt: torch.memory_format
    out_shape: Tuple[int, ...]
    out_strides: Tuple[int, ...]
    path: str  # pool_path's, for 16-byte aligned pointers
    sizes: Tuple[int, ...]  # the C entry's sizes: N, C, H, W (the pool's input's map), and the box filter's rows
    narrow_sizes: Tuple[int, ...]  # the same where the pointers take the narrow path instead


@functools.lru_cache(maxsize=None)
def _plan(name: str, shape: torch.Size, strides: Tuple[int, ...], dtype: torch.dtype,
          out_hw: Tuple[int, int], fmt: Optional[torch.memory_format]) -> _Plan:
    """What a wrapper decides from its input's geometry alone, once per
    geometry: the memory format (``fmt``, or ATen's for the input), the
    output's shape and dense strides, the path and the launch's sizes.
    Raises on what the kernels do not take."""
    if dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {dtype}")
    if len(shape) != 4:
        raise ValueError(f"{name} takes a 4-D (N, C, H, W) tensor, got shape {tuple(shape)}")
    fmt = fmt or _format(shape, strides)
    n, c = shape[:2]
    out_shape = (n, c, *out_hw)
    out_strides = torch.empty(out_shape, device="meta", memory_format=fmt).stride()
    path = pool_path(dtype, out_shape, out_strides, (0, 0))
    h, w = out_hw if name == "pool2x2_grad" else shape[2:]  # the map the kernel's sizes name: the pool's input's
    if n * c * h * w > _INT_MAX:
        raise ValueError(f"{name}: {n * c * h * w} elements, more than the kernel's int index holds")
    sizes = (n, c, h, w)
    narrow = sizes
    if name == "box_filter":
        vec = _VECTOR_BYTES // _ITEMSIZE[dtype] if path == "vector" else 1
        sizes, narrow = sizes + (box_rows(n, c, h, w, vec),), sizes + (box_rows(n, c, h, w, 1),)
    return _Plan(fmt, out_shape, out_strides, path, sizes, narrow)


def _run(name: str, t: torch.Tensor, out_hw: Tuple[int, int], fmt: Optional[torch.memory_format] = None):
    """Launch kernel ``name`` of csrc/pool2d.cu on ``t`` on torch's current
    stream and return its output; count the launch."""
    plan = _plan(name, t.shape, t.stride(), t.dtype, out_hw, fmt)
    if t.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got one on {t.device}")
    t = t.contiguous(memory_format=plan.fmt)  # a copy only where t is not dense in it, as ATen's pool makes
    out = torch.empty_strided(plan.out_shape, plan.out_strides, dtype=t.dtype, device=t.device)
    if out.numel() == 0:
        return out
    src, dst = t.data_ptr(), out.data_ptr()
    path, sizes = plan.path, plan.sizes
    if path == "vector" and (src | dst) % _VECTOR_BYTES:
        path, sizes = "narrow", plan.narrow_sizes
    device = t.device.index
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = _build.entry("pool2d", *_SIGNATURES[name])
    if device == torch.cuda.current_device():
        rc = fn(src, dst, _DTYPES[t.dtype], _PATHS[path], *sizes, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(src, dst, _DTYPES[t.dtype], _PATHS[path], *sizes, stream)
    _build.raise_on(rc, name)
    trace.count("pool.launches")
    if path == "vector":
        trace.count("pool.vector_launches")
    return out


def box_filter(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA box-filter kernel (3x3, stride 1, zero padding, divisor
    9). Counts its launches in ``box_filter.launches``. x: (N, C, H, W) fp32
    or bf16 on a CUDA device; returns the filtered map in x's dtype and
    ATen's memory format for x."""
    out = _run("box_filter", x, tuple(x.shape[2:]))
    box_filter.launches += out.numel() > 0
    return out


def pool2x2(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA 2x2 average-pool kernel (stride 2, an odd map's last
    row and column dropped). Counts its launches in ``pool2x2.launches``.
    x: (N, C, H, W) fp32 or bf16 on a CUDA device, H and W at least 2;
    returns (N, C, H // 2, W // 2) in x's dtype and ATen's memory format for
    x."""
    if x.dim() == 4 and min(x.shape[2:]) < 2:  # as ATen's pool refuses it
        raise ValueError(f"pool2x2: a {x.shape[2]}x{x.shape[3]} map has no 2x2 window")
    out = _run("pool2x2", x, (x.shape[2] // 2, x.shape[3] // 2) if x.dim() == 4 else (0, 0))
    pool2x2.launches += out.numel() > 0
    return out


def pool2x2_grad(g: torch.Tensor, h: int, w: int, fmt: Optional[torch.memory_format] = None) -> torch.Tensor:
    """Launch the CUDA kernel of the 2x2 pool's gradient: each g value,
    quartered, at the four inputs of its window, zero on an odd map's last
    row or column. Counts its launches in ``pool2x2_grad.launches``.
    g: (N, C, h // 2, w // 2) fp32 or bf16 on a CUDA device; returns (N, C,
    h, w) in g's dtype and in memory format ``fmt`` (the pool's input's, as
    ATen's backward gives it; by default ATen's format for g)."""
    if g.dim() == 4 and tuple(g.shape[2:]) != (h // 2, w // 2):
        raise ValueError(f"pool2x2_grad: g {tuple(g.shape)} is not the 2x2 pool of a {h}x{w} map")
    out = _run("pool2x2_grad", g, (h, w), fmt)
    pool2x2_grad.launches += out.numel() > 0
    return out


box_filter.launches = 0
pool2x2.launches = 0
pool2x2_grad.launches = 0


def box_filter_plain(x: torch.Tensor) -> torch.Tensor:
    """The box filter in plain PyTorch: ATen's 3x3 average pool."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def pool2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """The 2x2 pool in plain PyTorch: ATen's 2x2 average pool."""
    return F.avg_pool2d(x, 2, stride=2)


def pool2x2_grad_plain(g: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The 2x2 pool's gradient in plain PyTorch: g / 4 spread over each
    window, zero-padded to (h, w)."""
    y = (g * 0.25).repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return F.pad(y, (0, w - y.shape[3], 0, h - y.shape[2]))


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


class BoxFilter3x3(torch.autograd.Function):
    """The 3x3 box filter with itself as its gradient; no tensor saved."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return box_filter(x) if _on_card(x) else box_filter_plain(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return BoxFilter3x3.apply(g)


class AvgPool2x2(torch.autograd.Function):
    """The 2x2 pool; its gradient is ``Pool2x2Grad``, whose gradient is this
    pool again, so both are twice differentiable. Saves the map's size and
    memory format only."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.size, ctx.fmt = tuple(x.shape[2:]), _format(x.shape, x.stride())
        return pool2x2(x) if _on_card(x) else pool2x2_plain(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return Pool2x2Grad.apply(g, *ctx.size, ctx.fmt)


class Pool2x2Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g: torch.Tensor, h: int, w: int, fmt: torch.memory_format) -> torch.Tensor:
        if _on_card(g):
            return pool2x2_grad(g, h, w, fmt)
        return pool2x2_grad_plain(g, h, w).contiguous(memory_format=fmt)

    @staticmethod
    def backward(ctx, gg: torch.Tensor):
        return AvgPool2x2.apply(gg), None, None, None


def box_filter_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool with zero padding, divisor always 9."""
    return BoxFilter3x3.apply(x)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool, no padding: the kernels on the card, ATen's
    pool (and its autograd) elsewhere."""
    return AvgPool2x2.apply(x) if _on_card(x) else pool2x2_plain(x)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2, gain: float = 1.0) -> torch.Tensor:
    """LeakyReLU with optional scalar gain."""
    y = F.leaky_relu(x, negative_slope)
    if gain != 1.0:
        y = y * gain
    return y
