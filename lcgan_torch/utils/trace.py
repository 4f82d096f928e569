"""Phase spans and counters of the port: the one tracing system the program has.

``span(name)`` marks a phase of the work (``with span("g_step.backward"):``)
and ``count(name, n)`` adds to a counter. Both record only while tracing is
on: after ``enable()`` until ``disable()``. For now they also record while
``torch.profiler`` records in this process, so that the benchmark's traced
stretch, which opens a profiler and no more, sees the phases; that second
trigger goes once the benchmark calls ``enable()`` and ``take()`` itself.
What a profiler session leaves untaken is bounded by ``MAX_SPANS`` and
dropped by the next ``enable()``. Off, ``span`` returns one shared no-op
context after two flag reads: nothing is allocated and no clock is read.

On, a finished span is kept in memory as a ``Span``: its name, its start and
end on ``time.perf_counter_ns()``, its thread, and its parent, the innermost
span open on the same thread when it opened (each thread keeps its own
stack: autograd runs a CUDA backward on its own device thread, the input
pipeline on worker threads). Once CUDA is initialised, a span opened with
``device=True`` also records a CUDA event on its thread's current stream as
it opens and as it closes, so ``take()`` can place it on the device's
timeline as well: a stream runs its work in order, so the kernels launched
inside the span run between the two events. ``enable(annotate=True)`` opens
a ``torch.profiler.record_function`` range of the same name around each
span, which puts the phases into the profiler's own trace.

``take()`` returns the finished spans, in the order they opened, and the
counters, and clears both. Nothing is written out: the caller decides.
Tracing does not touch the arithmetic: it reads clocks and records events.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _torch_profiler

MAX_SPANS = 10_000  # kept, with their events, until take(); past it a span is counted under "trace.dropped"

_on = False
_annotate = False
_lock = threading.Lock()
_spans: list = []  # finished spans, as _Open.__exit__ appends them
_counters: Dict[str, int] = {}
_local = threading.local()  # .stack: the ids of the spans open on this thread
_ids = itertools.count()
_ref: Optional[torch.cuda.Event] = None  # the first event since take(): device times count from it


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    thread: int  # threading.get_ident() of the thread it ran on
    parent: Optional[int]  # id of the innermost span open on that thread, or None
    device_start_ns: Optional[int] = None  # its events on the device's clock, from the first event since take()
    device_end_ns: Optional[int] = None


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()


def recording() -> bool:
    """Whether spans and counters are recorded now. (torch has no public
    check for a running profiler; its flag below is the one torch's own
    fast paths read.)"""
    return _on or _torch_profiler._is_profiler_enabled


def span(name: str, device: bool = True):
    """A context that records the phase ``name`` while tracing is on (and,
    with ``device``, places it on the device's timeline); else ``NOOP``."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return NOOP
    return _Open(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enable(annotate: bool = False) -> None:
    """Record from now on, from nothing: what an earlier session left
    untaken is dropped. With ``annotate``, each span is also a
    ``torch.profiler.record_function`` range of its name."""
    global _on, _annotate
    take()
    _on, _annotate = True, annotate


def disable() -> None:
    """Stop recording (what was recorded stays until ``take()``). Spans
    still record while ``torch.profiler`` does."""
    global _on, _annotate
    _on, _annotate = False, False


def _event() -> Optional[torch.cuda.Event]:
    global _ref
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    if _ref is None:
        _ref = ev
    return ev


class _Open:
    __slots__ = ("name", "device", "id", "parent", "range", "ev", "start")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.range = torch.profiler.record_function(self.name) if _annotate else None
        if self.range is not None:
            self.range.__enter__()
        self.ev = _event() if self.device else None
        self.start = time.perf_counter_ns()  # the host's times leave out the events' records
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        ev = _event() if self.ev is not None else None
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        row = (self.id, self.name, self.start, end, threading.get_ident(), self.parent, self.ev, ev)
        with _lock:
            if len(_spans) < MAX_SPANS:
                _spans.append(row)
            else:
                _counters["trace.dropped"] = _counters.get("trace.dropped", 0) + 1
        return False


def _device_ns(ref: torch.cuda.Event, ev: Optional[torch.cuda.Event]) -> Optional[int]:
    if ev is None:
        return None
    ev.synchronize()
    return round(ref.elapsed_time(ev) * 1e6)


def take() -> Tuple[List[Span], Dict[str, int]]:
    """The finished spans (in the order they opened) and the counters
    recorded since the last ``take()``; both are cleared. Spans with events
    wait for them and carry their device times."""
    global _ref
    with _lock:
        rows, counters = sorted(_spans, key=lambda r: r[0]), dict(_counters)
        _spans.clear()
        _counters.clear()
        ref, _ref = _ref, None
    out = []
    for i, name, s, e, thread, parent, ev0, ev1 in rows:
        ds = de = None
        if ref is not None and ev0 is not None and ev1 is not None:
            ds, de = _device_ns(ref, ev0), _device_ns(ref, ev1)
        out.append(Span(i, name, s, e, thread, parent, ds, de))
    return out, counters
