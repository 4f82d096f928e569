"""Arithmetic that several per-layer readers share. Each metric's own file
(``metrics/<name>.py``) says what it reads; these functions say how."""

from __future__ import annotations

from typing import Optional

# the port's warp kernels (ops/csrc/warp_*.cu): warp_fwd_kernel, warp_dgrid_kernel,
# warp_dx_rows_kernel, warp_dx_kernel, warp_dxs_*_kernel and the small-map ones
WARP_KERNELS = r"\bwarp_\w*kernel"


def span_ms(r, name: str) -> Optional[float]:
    """Mean host ms of a benchmark span in the window."""
    xs = r.spans.get(name)
    return 1e3 * sum(xs) / len(xs) if xs else None


def idle_pct(r) -> Optional[float]:
    """The share of the traced window in which no kernel ran."""
    t = r.trace
    if t is None or not t.kernels or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_pct(r, pattern: str) -> Optional[float]:
    """The least time of the warp work of the traced units (the larger of
    bytes over the card's bandwidth and FLOPs over its float32 rate) over
    the device time of the kernels matching ``pattern``."""
    t = r.trace
    if t is None or r.peaks is None or not r.traced_units:
        return None
    kernel_s = t.kernel_seconds(pattern)
    if kernel_s <= 0:
        return None
    nbytes = sum(r.work[u]["warp_bytes"] * n for u, n in r.traced_units.items())
    flops = sum(r.work[u]["warp_flops"] * n for u, n in r.traced_units.items())
    least = max(nbytes / r.peaks["bytes_per_s"], flops / r.peaks["fp32_flops"])
    return 100.0 * least / kernel_s


def mfu_pct(r) -> Optional[float]:
    """Model FLOPs of the window's units over its seconds, as a share of
    the card's dense bf16 peak."""
    if r.peaks is None or not r.units or r.window_s <= 0:
        return None
    flops = sum(r.work[u]["flops"] * n for u, n in r.units.items())
    return 100.0 * flops / r.window_s / r.peaks["bf16_flops"]
