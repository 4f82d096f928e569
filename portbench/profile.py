"""The traced stretch and its reduction to what the per-layer metrics read:
the device's kernels in the stretch, the union of their intervals (busy
time), the idle gaps between them, each labelled by the benchmark's host
span that was open at its middle, and device time by kernel name.

The profiler records the device's activity only (CUPTI), so that tracing
adds no host work to the stretch it measures: recording every operator on
the host would stretch a host-bound step and read its idle share too high.
The stretch is bounded by the host's clock, after a synchronize at each
end; the host spans are the benchmark's own, on the same clock. A marker
kernel launched on the idle device just before the stretch and just after
it maps the host's clock onto the trace's. Memory copies and sets are not
kernels and are left out of busy time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
_NOT_KERNELS = re.compile(r"^(Memcpy|Memset)")


@dataclasses.dataclass
class Trace:
    start_ns: int
    end_ns: int
    kernels: List[Tuple[str, int, int]]  # (name, start ns, duration ns), sorted by start
    spans: List[Tuple[str, int, int]]  # (label, start ns, end ns) of the benchmark's host spans
    skew_ns: int = 0  # the two markers' disagreement on the clocks' offset

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the kernels' intervals, clipped to the window."""
        out: List[List[int]] = []
        for _, s, d in self.kernels:
            s, e = max(s, self.start_ns), min(s + d, self.end_ns)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_seconds(self, pattern: Optional[str] = None) -> float:
        """Device seconds of the kernels whose names match ``pattern`` (all)."""
        rx = re.compile(pattern) if pattern else None
        return sum(d for name, _, d in self.kernels if rx is None or rx.search(name)) / 1e9

    def device_ops(self, top: int = 10) -> List[List]:
        by_name: Dict[str, int] = defaultdict(int)
        for name, _, d in self.kernels:
            by_name[name] += d
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:160], ns / 1e9] for name, ns in ranked]

    def label_at(self, t: int) -> str:
        """The innermost benchmark span open at ``t``, or "between"."""
        best = None
        for label, s, e in self.spans:
            if s <= t < e and (best is None or s >= best[1]):
                best = (label, s)
        return best[0] if best else "between"

    def idle_gaps(self, top: int = 10) -> List[List]:
        busy = self.busy_intervals()
        edges = [self.start_ns] + [x for iv in busy for x in iv] + [self.end_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.label_at((s + e) // 2), (e - s) / 1e9] for s, e in gaps[:top]]


class Spans:
    """The benchmark's host spans of a traced stretch, on the host's clock."""

    def __init__(self):
        self.rows: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, label: str) -> Iterator[None]:
        s = time.perf_counter_ns()
        try:
            yield
        finally:
            self.rows.append((label, s, time.perf_counter_ns()))


def _mark() -> int:
    """Launch the marker kernel; the host's clock at its launch."""
    h = time.perf_counter_ns()
    torch.cuda._sleep(1)
    return h


def traced(device: torch.device, body: Callable[[Spans], None]) -> Trace:
    """Run ``body(spans)`` as the traced stretch and reduce its trace. Off
    the card there is no device to trace: the stretch has no kernels."""
    spans = Spans()
    if device.type != "cuda":
        t0 = time.perf_counter_ns()
        body(spans)
        return Trace(t0, time.perf_counter_ns(), [], spans.rows)
    from torch.profiler import ProfilerActivity, profile

    _mark()  # the marker's module loaded before the stretch
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        marks = [_mark()]
        torch.cuda.synchronize(device)
        t0 = time.perf_counter_ns()
        body(spans)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter_ns()
        marks.append(_mark())
        torch.cuda.synchronize(device)
    return reduce(prof, t0, t1, spans.rows, marks)


def reduce(prof, t0: int, t1: int, spans: List[Tuple[str, int, int]], marks: List[int]) -> Trace:
    """The stretch [t0, t1] (host clock) of a finished ``torch.profiler``
    trace that begins and ends with the marker kernel launched at the host
    times ``marks``; times are moved onto the trace's clock."""
    from torch.autograd import DeviceType

    kernels = sorted(((e.name(), e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
                      and not _NOT_KERNELS.match(e.name())), key=lambda k: k[1])
    if len(kernels) < 2 or MARKER not in kernels[0][0] or MARKER not in kernels[-1][0]:
        names = [k[0][:60] for k in kernels[:1] + kernels[-1:]]
        raise RuntimeError(f"the trace does not begin and end with the marker kernel {MARKER} (it has {names})")
    offsets = [kernels[0][1] - marks[0], kernels[-1][1] - marks[1]]
    off = min(offsets)  # each marker starts a launch's latency after its host time
    return Trace(t0 + off, t1 + off, kernels[1:-1], [(label, s + off, e + off) for label, s, e in spans],
                 skew_ns=abs(offsets[1] - offsets[0]))
