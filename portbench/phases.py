"""The program's own phase spans and counters in the traced stretch, and
what the per-layer readers of the phases read from them.

While ``torch.profiler`` records, the port records its phases itself
(``lcgan_torch.utils.trace``): a span at each phase boundary of the train
step (``noise``, ``g_step.forward`` ... ``d_step.adam``), ``r1.grad``,
``remat.recompute``, ``to_unit`` and ``to_unit.copy``, and the pipeline's
counters ``data.get`` and ``data.ready``. The traced stretch is the only
time the benchmark's process runs the profiler, so what the program
recorded is the stretch's. The first reader takes it from the program; the
others read the same ``Phases``. A program without that module gives
nothing, and every reader of a phase returns None.

On the card each span on the step's threads carries two CUDA events, one
recorded as it opened and one as it closed, on the stream its kernels run
on. The stream runs its work in order, so the kernels launched inside the
span run between its two events whatever the launch queue's depth: that
interval of the device's clock is the span's device window. A phase's
device time is the busy time (``Trace.busy_intervals``) inside its
windows, less its child spans' windows. This holds for autograd's device
thread too (``remat.recompute`` opens there, inside the window of the
step's ``g_step.backward``), and for the kernels cuDNN runs on streams of
its own inside a call.

Two clocks are fitted against the trace's own:

* the host's (``perf_counter_ns``, the program's spans): the benchmark's
  offset, found as the one under which each of the step thread's
  outermost spans lies inside one of the benchmark's spans around a call
  into the program (``step.*``, ``to_unit``); and the
  markers' disagreement (``Trace.skew_ns``: the trace's kernel times can
  run fast or slow against the host's clock by a few parts in a thousand)
  spread over the stretch, one way or the other, or not at all;
* the events' (``elapsed_time`` from the first event, which keeps time
  with the host): ``c0 + a·t``, ``a`` near the host map's rate, ``c0`` no
  earlier than any closing event's host time allows (the device runs an
  event after the host records it), and the pair placing the fewest events
  inside a kernel, where none can run (the stream runs them between
  kernels). Of the three host maps, the one whose fit leaves fewest events
  inside a kernel, then the device's least lag behind the host alike early
  and late in the stretch.

The device ms by phase are read only where the fit holds (``_gate``): in
a long stretch the trace's kernel times can jump against the events' clock
by milliseconds (b32's 16-s stretch: kernels of one stream overlapping
each other, kernels starting before the host launched them), and no one
map fits. ``window_ms`` reads a span's events alone, on their own clock.

An idle gap is labelled with the benchmark's span and the program's spans
open on the host at its middle, under the fitted host map.

``Trace`` and ``readers.py`` are left as they are; this module reads them.
"""

from __future__ import annotations

import sys
import traceback
from collections import Counter, defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

FORWARD = ("g_step.forward", "d_step.fake", "d_step.forward")
BACKWARD = ("g_step.backward", "d_step.backward", "r1.grad", "remat.recompute")
BACKWARD_HOST = ("g_step.backward", "d_step.backward", "r1.grad")  # on the step's thread
OPTIMIZER = ("g_step.adam", "d_step.adam", "ema")
RECOMPUTE = ("remat.recompute",)
STEP_THREAD = ("noise",) + FORWARD + BACKWARD_HOST + OPTIMIZER + ("g_step.all_reduce", "d_step.all_reduce",
                                                                  "to_unit", "to_unit.copy")

CALLS = ("step.", "to_unit")  # the benchmark's spans around calls into the program: train_iteration, to_unit
TOL_NS = 1500  # an event counts as inside a kernel only this far from both its ends (the events' resolution)
# the grid of the event clock's fit: slopes (ppm) and steps (ns) from the least offset causality allows,
# coarse, then fine around the best
COARSE = (np.arange(-20, 21, 4), np.arange(-300_000, 300_001, 2000))
FINE = (np.arange(-30, 31, 1) / 10, np.arange(-3000, 3001, 250))  # 0.1 ppm: 1.7 us over b32's 17-s stretch
PLATEAU_NS = 300_000
# the device-ms readers read nothing unless the fit holds: spans' device windows hold this share of the busy
# time, and no more than this share of the events sits inside a kernel
MIN_ATTRIBUTED_PCT = 95.0
MAX_INSIDE_PCT = 5.0


def _intersect(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Two sorted lists of disjoint closed intervals intersected."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo <= hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def host_offset(bench: Sequence[Tuple[str, int, int]], spans: Iterable) -> Optional[Tuple[int, int, int]]:
    """(offset, its uncertainty, the intervals left) that moves the program's
    ``spans`` (host clock) inside the benchmark's spans (trace clock), each
    wholly inside one; None if no offset does."""
    bench = sorted((s, e) for _, s, e in bench)
    feasible = None
    for sp in spans:
        d = sp.end_ns - sp.start_ns
        allowed = [(bs - sp.start_ns, be - sp.end_ns) for bs, be in bench if be - bs >= d]
        feasible = allowed if feasible is None else _intersect(feasible, allowed)
        if not feasible:
            return None
    if not feasible:
        return None
    lo, hi = feasible[0]
    return (lo + hi) // 2, (hi - lo) // 2, len(feasible)


def host_maps(trace, off: int) -> List[Tuple[str, Callable[[int], float], float]]:
    """Candidate maps of the host's clock onto the trace's, each with the
    rate at which the trace's clock gains on the host's. The benchmark
    places its spans with one offset, the lesser of the two markers'; the
    trace's kernel times can run fast or slow against the host's clock
    (and the events', which keep time with it) over a stretch: the markers'
    disagreement, whose sign the trace does not keep. So: that offset
    alone, and that offset with the disagreement spread over the stretch,
    rising or falling."""
    t0, t1, k = trace.start_ns - off, trace.end_ns - off, trace.skew_ns
    span = max(t1 - t0, 1)
    return [("constant", lambda h: h + off, 0.0),
            ("rising", lambda h: h + off + k * (h - t0) / span, k / span),
            ("falling", lambda h: h + off + k * (t1 - h) / span, -k / span)]


def fit_event_clock(kernels: Sequence[Tuple[str, int, int]], events: Sequence[int],
                    closing: Sequence[Tuple[int, int]], maps) -> Tuple[float, float, int, int, int]:
    """(c0, a, events inside a kernel, the host map's index, kernels left
    out) of the map t -> t + c0 + a·t of the events' clock onto the
    trace's. ``events`` are every event's device time, ``closing`` the
    closing events' (device time, host time of the record): the device ran
    each after that, which bounds c0 below under each of the host ``maps``
    (map, rate), and ``a`` is sought around each map's rate.
    Only kernels that overlap no other kernel are held against the events:
    a kernel on another stream (cuDNN's own, the input pipeline's) may run
    across one."""
    t = np.array(events, dtype=np.float64)
    tc = np.array([d for d, _ in closing], dtype=np.float64)
    starts = np.array([s for _, s, _ in kernels], dtype=np.float64)
    ends = starts + np.array([d for _, _, d in kernels], dtype=np.float64)
    reach = np.maximum.accumulate(ends)
    solo = np.ones(len(starts), dtype=bool)
    solo[1:] &= starts[1:] >= reach[:-1]
    solo[:-1] &= ends[:-1] <= starts[1:]
    starts, ends = starts[solo], ends[solo]

    def inside(x: np.ndarray) -> int:
        k = np.searchsorted(starts, x - TOL_NS, side="right") - 1
        return int(np.count_nonzero((k >= 0) & (ends[np.maximum(k, 0)] > x + TOL_NS)))

    def search(bound, slopes, steps, best, m, rate):
        for ppm in slopes:
            a = rate + ppm * 1e-6
            c_min = float(np.max(bound - a * tc))
            for step in steps:
                key = (inside(t + c_min + step + a * t), abs(step), abs(ppm))
                if best is None or key < best[0]:
                    best = (key, ppm, step, c_min + step, a, m)
        return best

    best = None
    half = tc <= np.median(tc)
    for m, (fn, rate) in enumerate(maps):
        bound = np.array([fn(h) for _, h in closing], dtype=np.float64) - tc  # c(t) >= bound
        mine = search(bound, *COARSE, None, m, rate)
        mine = search(bound, mine[1] + FINE[0], mine[2] + FINE[1], mine, m, rate)
        # the device's least lag behind the host, early and late in the stretch: equal under the right map
        lag = mine[3] + mine[4] * tc - bound
        key = (mine[0][0], abs(float(lag[half].min() - lag[~half].min())) if (~half).any() else 0.0)
        if best is None or key < best[0]:
            best = (key, mine)
    (n, _, _), _, _, c0, a, m = best[1]
    # the middle of the run of offsets around c0 that place as few events inside a kernel
    steps = np.arange(1, PLATEAU_NS // 250 + 1) * 250.0
    run = []
    for sign in (-1, 1):
        edge = 0.0
        for d in sign * steps:
            if inside(t + c0 + d + a * t) > n:
                break
            edge = d
        run.append(edge)
    return c0 + sum(run) / 2, a, n, m, int(len(solo) - solo.sum())


class Phases:
    """The program's spans of one traced stretch on the trace's clock, and
    the device's busy time cut by the innermost span's device window."""

    def __init__(self, trace, spans: Sequence, counters: Dict[str, int], iterations: int):
        self.trace, self.spans, self.counters = trace, list(spans), dict(counters)
        self.iterations = iterations
        self.kids: Dict[int, int] = defaultdict(int)  # ns of each span's children
        for sp in self.spans:
            if sp.parent is not None:
                self.kids[sp.parent] += sp.end_ns - sp.start_ns
        names = Counter(s.thread for s in self.spans if s.name in STEP_THREAD)
        self.thread = names.most_common(1)[0][0] if names else None
        tops = [s for s in self.spans if s.thread == self.thread and s.parent is None]
        calls = [b for b in trace.spans if b[0].startswith(CALLS)]  # the calls the step thread's spans ran in
        fit = host_offset(calls, tops) if tops and calls else None
        self.off, self.off_slack, self.off_intervals = fit if fit else (None, None, 0)
        maps = host_maps(trace, self.off) if self.off is not None else []
        self.host_map, self.host = maps[0][:2] if maps else (None, None)
        self.windows: List[Tuple[int, int, object]] = []  # (start, end, span) on the trace's clock
        self.busy: Dict[str, int] = {}  # busy ns by innermost span name
        self.fit = None
        timed = [s for s in self.spans if s.device_start_ns is not None]
        if timed and trace.kernels and maps:
            c0, a, n, m, apart = fit_event_clock(
                trace.kernels, [t for s in timed for t in (s.device_start_ns, s.device_end_ns)],
                [(s.device_end_ns, s.end_ns) for s in timed], [(fn, rate) for _, fn, rate in maps])
            self.fit = (c0, a, n, 2 * len(timed), apart)
            self.host_map, self.host = maps[m][:2]
            place = lambda t: int(round(t + c0 + a * t))  # noqa: E731
            self.windows = sorted(((place(s.device_start_ns), place(s.device_end_ns), s) for s in timed),
                                  key=lambda w: (w[0], -w[1]))
            self.busy = self._cut()
        self.withheld = self._gate()

    def _gate(self) -> Optional[str]:
        """Why the device ms by phase are not to be trusted, or None."""
        if self.fit is None:
            return "no event clock fit"
        inside, events = self.fit[2], self.fit[3]
        if 100.0 * inside > MAX_INSIDE_PCT * events:
            return f"{inside} of {events} events inside a kernel, over {MAX_INSIDE_PCT}%"
        pct = self.attributed_pct()
        if pct is None or pct < MIN_ATTRIBUTED_PCT:
            return f"busy time inside a program span's device window {pct}%, under {MIN_ATTRIBUTED_PCT}%"
        return None

    def _cut(self) -> Dict[str, int]:
        """Busy ns of the stretch by the innermost window holding it."""
        busy = self.trace.busy_intervals()
        bs = np.array([s for s, _ in busy], dtype=np.int64)
        be = np.array([e for _, e in busy], dtype=np.int64)
        before = np.concatenate([[0], np.cumsum(be - bs)])

        def upto(x: int) -> int:  # busy ns before x
            k = int(np.searchsorted(bs, x, side="right")) - 1
            return 0 if k < 0 else int(before[k] + min(x, be[k]) - bs[k])

        edges = sorted({x for w in self.windows for x in w[:2]})
        out: Dict[str, int] = defaultdict(int)
        active, i, w = [], 0, self.windows
        for lo, hi in zip(edges, edges[1:]):
            while i < len(w) and w[i][0] <= lo:
                active.append(w[i])
                i += 1
            active = [x for x in active if x[1] > lo]
            if active:
                out[max(active, key=lambda x: (x[0], -x[1]))[2].name] += upto(hi) - upto(lo)
        return dict(out)

    # ------------------------------------------------------------------
    def device_ms(self, names: Sequence[str]) -> Optional[float]:
        """Device ms an iteration busy inside the device windows of the
        spans ``names``, less their child spans' windows; None where the
        fit fails its gate (``_gate``)."""
        if not self.windows or not self.iterations or self.withheld:
            return None
        if not any(s.name in names for s in self.spans):
            return None
        return sum(self.busy.get(n, 0) for n in names) / 1e6 / self.iterations

    def window_ms(self, names: Sequence[str]) -> Optional[float]:
        """Device ms an iteration between the opening and the closing CUDA
        event of the spans ``names``, on the events' own clock: no map onto
        the trace's is needed, so no gate; idle time inside counts."""
        hits = [s for s in self.spans if s.name in names and s.device_start_ns is not None]
        if not hits or not self.iterations:
            return None
        return sum(s.device_end_ns - s.device_start_ns for s in hits) / 1e6 / self.iterations

    def self_ns(self, span) -> int:
        """A span's duration less its children's on its thread."""
        return span.end_ns - span.start_ns - self.kids.get(span.id, 0)

    def host_ms(self, names: Sequence[str], self_time: bool = False) -> Optional[float]:
        """Host ms an iteration in the step thread's spans of ``names``
        (their self time with ``self_time``)."""
        hits = [s for s in self.spans if s.name in names and s.thread == self.thread]
        if not hits or not self.iterations:
            return None
        ns = sum(self.self_ns(s) if self_time else s.end_ns - s.start_ns for s in hits)
        return ns / 1e6 / self.iterations

    def ratio_pct(self, part: str, whole: str) -> Optional[float]:
        if not self.counters.get(whole):
            return None
        return 100.0 * self.counters.get(part, 0) / self.counters[whole]

    # ------------------------------------------------------------------
    def path_at(self, t: int) -> str:
        """The benchmark's span open at ``t`` (trace clock), then the
        program's spans open then on the step's thread, outermost first,
        then those open on autograd's thread (remat's recompute), all
        placed by the fitted host map."""
        if self.host is None:
            return self.trace.label_at(t)
        bench = [(label, s) for label, s, e in self.trace.spans
                 if self.host(s - self.off) <= t < self.host(e - self.off)]
        names = [max(bench, key=lambda b: b[1])[0] if bench else "between"]
        open_ = [s for s in self.spans if self.host(s.start_ns) <= t < self.host(s.end_ns)
                 and (s.thread == self.thread or s.name in RECOMPUTE)]
        names += [s.name for s in sorted(open_, key=lambda s: (s.thread != self.thread, s.start_ns))]
        return "/".join(names)

    def idle_gaps(self, top: int = 10) -> List[List]:
        t = self.trace
        busy = t.busy_intervals()  # as Trace.idle_gaps finds them
        edges = [t.start_ns] + [x for iv in busy for x in iv] + [t.end_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.path_at((s + e) // 2), (e - s) / 1e9] for s, e in gaps[:top]]

    def attributed_pct(self) -> Optional[float]:
        """The share of the stretch's busy time inside some span's device window."""
        total = self.trace.busy_s * 1e9
        if not self.windows or not total:
            return None
        return 100.0 * sum(self.busy.values()) / total

    def by_phase(self) -> Dict[str, List[float]]:
        """{span name: [device ms, host self ms]} an iteration."""
        names = sorted({s.name for s in self.spans})
        return {n: [round(self.device_ms([n]) or 0.0, 3), round(self.host_ms([n], self_time=True) or 0.0, 3)]
                for n in names}

    def report(self) -> None:
        """What the stretch's phases say, on standard error (not metrics)."""
        lines = [f"portbench: program spans {len(self.spans)}, counters {self.counters}"]
        if self.off is not None:
            lines.append(f"portbench: host clock onto the trace's: the benchmark's offset within "
                         f"+-{self.off_slack / 1e3:.1f} us ({self.off_intervals} feasible interval(s)), the markers' "
                         f"skew {self.trace.skew_ns / 1e3:.1f} us spread {self.host_map}")
        if self.fit is not None:
            c0, a, n, m, apart = self.fit
            lines.append(f"portbench: event clock fit: slope {a * 1e6:+.1f} ppm, {n} of {m} events inside a kernel "
                         f"({apart} kernels overlapping another left out); busy time inside a program span's "
                         f"device window {self.attributed_pct():.2f}%")
            lines.append(f"portbench: idle gaps by phase {self.idle_gaps()}")
        if self.withheld:
            lines.append(f"portbench: device ms by phase withheld: {self.withheld}")
        lines.append(f"portbench: phases, [device ms, host self ms] an iteration {self.by_phase()}")
        print("\n".join(lines), file=sys.stderr, flush=True)


def _take():
    """The program's recorded spans and counters, or None where the program
    has no tracing module."""
    try:
        from lcgan_torch.utils import trace
    except ImportError:
        return None
    return trace.take()


_cache: Dict[int, Optional[Phases]] = {}


def of(r) -> Optional[Phases]:
    """The ``Phases`` of the readings' traced stretch (taken once)."""
    if r.trace is None:
        return None
    key = id(r.trace)
    if key not in _cache:
        _cache.clear()
        _cache[key] = None
        try:
            taken = _take()
            if taken is not None and (taken[0] or taken[1]):
                _cache[key] = Phases(r.trace, taken[0], taken[1], sum(r.traced_units.values()))
                _cache[key].report()
        except Exception:  # a reader reports nothing rather than fail the run
            traceback.print_exc(file=sys.stderr)
    return _cache[key]

