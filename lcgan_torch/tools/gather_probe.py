"""Gather probe on the card: the port of ``tools/gather_probe.py``, which
asked what a gather out of on-chip memory costs, beside the bicubic warp's
other ways to gather its taps.

    python -m lcgan_torch.tools.gather_probe [--device cpu] [--batch 16 --size 256 --channels 128]

Prints one row per way, with its device ms per call (CUDA events) and its
host-clock ms per call:

  A  ``out[i, j] = x[idx[i, j], j]`` on a (256, 128) fp32 tile, indices
     drawn in [0, 256): the CUDA kernel ``csrc/gather_probe.cu``, which
     gathers out of shared memory (the JAX probe's Pallas ``pk``);
  B  the two-stage axis gathers of the warp's 16 taps (4 rows, then 4
     columns of each) in torch ops, at (batch, size, size, channels) bf16
     NHWC;
  C  the port's warp (``ops.warp.BicubicWarp``) forward, and the gradient of
     ``sum(out²)`` with respect to the features and the grid, at the same
     shape (the JAX probe's ``grid_sample_bicubic_patch``).

With ``--device cpu`` A runs the plain version and B and C the port's CPU
path, with no device time. Without a GPU and without ``--device cpu`` it
raises.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from lcgan_torch.config import resolve_device
from lcgan_torch.ops import _build
from lcgan_torch.ops.grid_sample import identity_like_coordinates
from lcgan_torch.ops.warp import grid_sample_bicubic
from lcgan_torch.tools import describe, time_ms

TILE = (256, 128)  # the JAX probe's (rows, columns)
_STRIP = 32  # columns per block: kStrip in csrc/gather_probe.cu
_MAX_ROWS = 384  # rows of x a block's shared memory takes: kMaxRows
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def take_along_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = x[idx[i, j], j]`` in torch ops."""
    return torch.take_along_dim(x, idx.long(), 0)


def gather_probe(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA gather kernel. Counts its launches in
    ``gather_probe.launches``.

    x: (R, C) fp32 with R at most 384 and C a multiple of 32, 16-byte
    aligned; idx: (M, C) int32 with every index in [0, R) (not checked: the
    contract); both contiguous on one CUDA device. Returns (M, C) fp32.
    """
    if x.device.type != "cuda" or idx.device != x.device:
        raise ValueError(f"gather_probe needs its tensors on one CUDA device, got {x.device}, {idx.device}")
    if x.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"gather_probe takes float32 x and int32 indices, got {x.dtype}, {idx.dtype}")
    if (x.dim() != 2 or idx.dim() != 2 or idx.shape[1] != x.shape[1] or not (x.is_contiguous() and idx.is_contiguous())
            or x.data_ptr() % 16):
        raise ValueError(f"gather_probe needs contiguous (R, C) x, 16-byte aligned, and (M, C) indices, got "
                         f"{tuple(x.shape)}, {tuple(idx.shape)}")
    r, c = x.shape
    m = idx.shape[0]
    if not (1 <= r <= _MAX_ROWS and c >= _STRIP and c % _STRIP == 0 and m >= 1):
        raise ValueError(f"gather_probe takes 1-{_MAX_ROWS} rows of a multiple of {_STRIP} columns and at least "
                         f"one index row, got x {tuple(x.shape)}, idx {tuple(idx.shape)}")
    out = torch.empty((m, c), dtype=torch.float32, device=x.device)
    fn = _build.entry("gather_probe", "lcgan_gather_probe", [_PTR] * 3 + [_INT] * 3 + [_PTR])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), r, m, c, torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, "gather_probe")
    gather_probe.launches += 1
    return out


gather_probe.launches = 0


def take_along_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = x[idx[i, j], j]``: the plain version on CPU tensors, the
    kernel on CUDA ones."""
    if x.device.type == "cpu":
        return take_along_rows_plain(x, idx)
    return gather_probe(x, idx)


def two_stage(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Stage B of the JAX probe (``tools/gather_probe.py:57-74``) in torch
    ops: each output pixel's 4 tap rows gathered along H, then their 4 tap
    columns along W. x: (B, H, W, C) NHWC; grid: (B, H, W, 2). Returns the
    taps, (B, 4H, 4W, C), y-tap major, x-tap minor."""
    gb, gh, gw, _ = grid.shape
    fx = ((grid[..., 0] + 1.0) * gw - 1.0) * 0.5
    fy = ((grid[..., 1] + 1.0) * gh - 1.0) * 0.5
    iy0 = (torch.floor(fy).long() - 1).clamp(0, gh - 4)
    ix0 = (torch.floor(fx).long() - 1).clamp(0, gw - 4)
    four = torch.arange(4, device=grid.device)
    ys = (iy0[:, :, None, :] + four[None, None, :, None]).reshape(gb, gh * 4, gw)
    rows = torch.take_along_dim(x, ys[..., None], dim=1)  # (B, 4H, W, C)
    xs = ix0[:, :, None, :] + four[None, None, :, None]  # (B, H, 4, W)
    xs4 = xs[:, :, None].expand(gb, gh, 4, 4, gw).reshape(gb, gh * 4, 4 * gw)
    cols = xs4.reshape(gb, gh * 4, 4, gw).transpose(2, 3).reshape(gb, gh * 4, gw * 4)
    return torch.take_along_dim(rows, cols[..., None], dim=2)


def bench(name: str, fn, n: int, device: torch.device) -> None:
    device_ms, host_ms = time_ms(fn, n, device)
    shown = f"{device_ms:9.4f} ms device" if device_ms is not None else "device not measured"
    print(f"{name:44s} {shown}, {host_ms:9.4f} ms host", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the GPU (default; raises if none is present) or the CPU's plain versions")
    ap.add_argument("--batch", type=int, default=16, help="B and C: images")
    ap.add_argument("--size", type=int, default=256, help="B and C: map height and width")
    ap.add_argument("--channels", type=int, default=128, help="B and C: channels")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"devices: {describe(device)}")
    gen = torch.Generator(device=device).manual_seed(0)

    # --- A: the kernel, a gather along rows out of shared memory ---
    xx = torch.randn(TILE, generator=gen, device=device)
    idx = torch.randint(0, TILE[0], TILE, generator=gen, device=device, dtype=torch.int32)
    what = "gather_probe kernel" if device.type == "cuda" else "plain take_along_dim"
    bench(f"A: {what} (256,128)", lambda: take_along_rows(xx, idx), 20, device)

    # --- B: two-stage axis gathers at warp scale ---
    b, s, c = args.batch, args.size, args.channels
    x = torch.randn((b, s, s, c), generator=gen, device=device).to(torch.bfloat16)
    flow = torch.rand((b, s, s, 2), generator=gen, device=device) * 0.2 - 0.1
    grid = (identity_like_coordinates(b, s, s, device) + flow).contiguous()
    bench("B: two-stage axis gathers (taps only)", lambda: two_stage(x, grid), 4, device)

    # --- C: the port's warp, forward and gradient ---
    xc = x.permute(0, 3, 1, 2)  # (B, C, H, W) in channels_last memory
    bench(f"C: warp fwd {s}²x{c}", lambda: grid_sample_bicubic(xc, grid), 4, device)

    def grad():
        xg = xc.detach().requires_grad_()
        gg = grid.detach().requires_grad_()
        grid_sample_bicubic(xg, gg).float().square().sum().backward()
        return xg.grad, gg.grad

    bench(f"C: warp grad {s}²x{c}", grad, 4, device)
    print(f"launches: gather_probe {gather_probe.launches}", flush=True)


if __name__ == "__main__":
    main()
