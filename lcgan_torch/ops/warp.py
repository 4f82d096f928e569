"""The synthesis-block warp: bicubic ``grid_sample`` with zeros padding.

``grid_sample_bicubic(x, grid)`` takes the contract of ``F.grid_sample``:
x (B, C, H, W), grid (B, Hg, Wg, 2) in (x, y) order, mode='bicubic',
padding_mode='zeros', align_corners=False. A CPU tensor goes to the plain
version (``ops.grid_sample.grid_sample_bicubic_plain``); a CUDA tensor
launches the hand-written kernel ``csrc/warp_fwd.cu`` or raises.

Forward only: the backward kernels come with the training slice of the
port, so on CUDA an input that requires grad raises.
"""

from __future__ import annotations

import ctypes

import torch

from lcgan_torch.ops import _build
from lcgan_torch.ops.grid_sample import grid_sample_bicubic_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("warp_fwd")
    fn = lib.lcgan_warp_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def warp_fwd(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA forward-warp kernel. Counts its launches in
    ``warp_fwd.launches``.

    x: (B, C, H, W) fp32 or bf16 in channels_last memory; grid: (B, Hg, Wg, 2)
    fp32, contiguous, on the same device. Returns (B, C, Hg, Wg) channels_last
    in x's dtype.
    """
    if x.device.type != "cuda" or grid.device != x.device:
        raise ValueError(f"warp_fwd needs x and grid on one CUDA device, got {x.device}, {grid.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"warp_fwd takes float32 or bfloat16 features, got {x.dtype}")
    if grid.dtype != torch.float32:
        raise TypeError(f"warp_fwd takes a float32 grid, got {grid.dtype}")
    if x.dim() != 4 or grid.dim() != 4 or grid.shape[0] != x.shape[0] or grid.shape[3] != 2:
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, grid {tuple(grid.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("warp_fwd needs channels_last features")
    if not grid.is_contiguous():
        raise ValueError("warp_fwd needs a contiguous grid")
    b, c, h, w = x.shape
    hg, wg = grid.shape[1], grid.shape[2]
    out = torch.empty((b, c, hg, wg), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    vec_elems = 16 // x.element_size()
    vec = int(c % vec_elems == 0 and x.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _lib().lcgan_warp_fwd(
            x.data_ptr(), grid.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], vec,
            b, c, h, w, hg, wg, stream,
        )
    if rc != 0:
        raise RuntimeError(f"warp_fwd kernel launch failed: cudaError {rc}")
    warp_fwd.launches += 1
    return out


warp_fwd.launches = 0


def grid_sample_bicubic(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bicubic warp: plain PyTorch on the CPU, the CUDA kernel on the card."""
    if x.device.type == "cpu" and grid.device.type == "cpu":
        return grid_sample_bicubic_plain(x, grid)
    if x.requires_grad or grid.requires_grad:
        raise NotImplementedError(
            "the CUDA warp is forward-only; its backward kernels land with the training slice"
        )
    return warp_fwd(x, grid)
