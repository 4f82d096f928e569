"""The readers of the program's phases (``portbench/phases.py``) on a
synthetic traced stretch: a stream simulated from a script of phases, each
launching kernels, with the host ahead of the device (the launch queue
deep, as at batch 32) or behind it (the device waiting, as at 256²). The
clocks are put back, each kernel goes to the span it was launched in
(remat's recompute from a second thread too), self times, the pipeline's
ratio, and the readers that were there read what they read before."""

from __future__ import annotations

from collections import defaultdict

import pytest

from portbench import harness, phases, readers
from portbench.profile import Trace

OFF = 7_000_000_000  # the trace's clock less the host's
C0, SLOPE = 123_456_789, 20e-6  # the events' clock onto the trace's: t + C0 + SLOPE·t
LAT = 4_000  # from a launch on the host to the earliest start on the device
MAIN, AUTOGRAD = 1, 2


class Span(tuple):
    """``lcgan_torch.utils.trace.Span``'s fields, without the port."""

    _fields = ("id", "name", "start_ns", "end_ns", "thread", "parent", "device_start_ns", "device_end_ns")

    def __new__(cls, *values):
        return tuple.__new__(cls, values)

    def __getattr__(self, name):
        return self[self._fields.index(name)]


# (phase, kernels: (count, device ns each)); "remat.recompute" runs on the second thread
ITERATION = [
    ("noise", [(6, 3_000)]),
    ("g_step.forward", [(40, 60_000)]),
    ("g_step.backward", [(30, 50_000), ("remat.recompute", [(10, 40_000)]), (30, 50_000)]),
    ("g_step.all_reduce", []),
    ("g_step.adam", [(8, 20_000)]),
    ("ema", [(4, 20_000)]),
    ("d_step.fake", [(20, 50_000)]),
    ("d_step.forward", [(20, 50_000), ("r1.grad", [(15, 50_000)]), (5, 10_000)]),
    ("d_step.backward", [(40, 50_000)]),
    ("d_step.all_reduce", []),
    ("d_step.adam", [(8, 20_000)]),
]


def simulate(launch_ns: int, python_ns: int, drift: float = 0.0, iterations: int = 2):
    """(Trace, program spans, {phase: device ns launched in it}, host self ns
    by phase, {span id: its events on the trace's clock}) of ``iterations``
    even iterations, each after a data wait. ``drift``: the trace's kernel
    times run that much fast against the host's clock and the events' (the
    markers disagree)."""
    host = 1_000_000_000
    dev_free = host + OFF
    kernels, bench, spans, truth, selfs, windows = [], [], [], defaultdict(int), defaultdict(int), {}
    ids = iter(range(10**6))
    ev_base = None

    def event(h):
        nonlocal dev_free, ev_base
        t = max(dev_free, h + OFF + LAT)
        dev_free = t
        e = (t - C0) / (1 + SLOPE)
        if ev_base is None:
            ev_base = e
        return t, e

    def run(name, body, thread, parent, owner):
        nonlocal host, dev_free
        sid = next(ids)
        host += python_ns
        ts, ds = event(host)
        start = host
        for part in body:
            if isinstance(part[0], str):  # a child phase
                child, kids = part
                took = run(child, kids, AUTOGRAD if child == "remat.recompute" else thread, None
                           if child == "remat.recompute" else sid, child)
                if child != "remat.recompute":
                    selfs[name] -= took
                continue
            n, dur = part
            for _ in range(n):
                host += launch_ns
                s = max(dev_free + 1_000, host + OFF + LAT)
                kernels.append((f"k_{owner}", s, dur))
                truth[owner] += dur
                dev_free = s + dur
        host += python_ns
        end = host
        te, de = event(host)
        windows[sid] = (ts, te)
        selfs[name] += end - start
        spans.append([sid, name, start, end, thread, parent, ds, de])
        return end - start

    for _ in range(iterations):
        b0 = host
        host += 200_000
        bench.append(("data_wait", b0 + OFF, host + OFF))
        s0 = host
        host += 3_000
        for name, body in ITERATION:
            run(name, body, MAIN, None, name)
        host += 3_000
        bench.append(("step.even", s0 + OFF, host + OFF))
    t0, t1 = 1_000_000_000, max(host, dev_free - OFF) + 1_000_000
    seen = lambda x: round(x + drift * (x - t0 - OFF))  # noqa: E731  (the trace's clock)
    o0, o1 = OFF, seen(t1 + OFF) - t1  # each marker's offset: the trace's clock less the host's
    off = min(o0, o1)  # the benchmark's
    out = sorted((Span(i, n, s, e, th, p, None if ds is None else round(ds - ev_base),
                       None if de is None else round(de - ev_base)) for i, n, s, e, th, p, ds, de in spans),
                 key=lambda s: s.id)
    bench = [(label, s - OFF + off, e - OFF + off) for label, s, e in bench]
    kernels = sorted((name, seen(s), seen(s + d) - seen(s)) for name, s, d in kernels)
    truth = {k: v * (1 + drift) for k, v in truth.items()}
    windows = {k: (seen(a), seen(b)) for k, (a, b) in windows.items()}
    trace = Trace(t0 + off, t1 + off, sorted(kernels, key=lambda k: k[1]), bench, skew_ns=abs(o1 - o0))
    return trace, out, truth, selfs, windows


CASES = {"device_bound": (5_000, 20_000), "host_bound": (80_000, 300_000),
         "host_bound_drift": (80_000, 300_000, -3e-2), "device_bound_drift": (5_000, 20_000, 3e-3)}


@pytest.fixture(params=list(CASES))
def stretch(request):
    trace, spans, truth, selfs, windows = simulate(*CASES[request.param])
    p = phases.Phases(trace, spans, {"data.get": 8, "data.ready": 6}, iterations=2)
    return p, trace, spans, truth, selfs, windows, request.param


def test_host_clock_put_back(stretch):
    p, trace = stretch[0], stretch[1]
    drift = CASES[stretch[-1]][2:]
    if drift:  # the trace's clock fast: the later marker's offset is the greater, and the map rises
        assert p.host_map == ("rising" if drift[0] > 0 else "falling")
    assert p.off_intervals == 1
    windows = stretch[5]  # where each span's events ran, on the trace's clock
    for sp in p.spans:  # the device ran each event after the host recorded it
        if sp.id in windows:
            assert p.host(sp.start_ns) <= windows[sp.id][0] + p.off_slack
    first = min(windows)  # recorded on an idle device: it ran a launch's latency later
    assert abs(p.host(p.spans[first].start_ns) + LAT - windows[first][0]) <= p.off_slack


def test_event_clock_put_back_and_no_event_inside_a_kernel(stretch):
    p, windows = stretch[0], stretch[5]
    _, _, inside, n, _ = p.fit
    assert inside == 0 and n == 2 * len(windows) == 2 * len(p.windows)
    edges = sorted(x for _, s, d in p.trace.kernels for x in (s, s + d))
    for start, end, span in p.windows:  # each event put between the same two kernels as it ran
        for placed, ran in zip((start, end), windows[span.id]):
            lo, hi = sorted((placed, ran))
            assert not [x for x in edges if lo + phases.TOL_NS < x < hi - phases.TOL_NS], (span, placed - ran)


def test_each_kernel_goes_to_the_span_it_was_launched_in(stretch):
    p, trace, _, truth, _, _, _ = stretch
    for k in set(p.busy) | set(truth):  # the events sit within a gap of where they ran: slivers at most
        assert p.busy.get(k, 0) == pytest.approx(truth.get(k, 0), abs=20_000), k
    assert p.device_ms(phases.FORWARD) == pytest.approx(sum(truth[n] for n in phases.FORWARD) / 1e6 / 2, rel=1e-3)
    assert p.device_ms(phases.BACKWARD) == pytest.approx(sum(truth[n] for n in phases.BACKWARD) / 1e6 / 2, rel=1e-3)
    assert p.device_ms(phases.OPTIMIZER) == pytest.approx(sum(truth[n] for n in phases.OPTIMIZER) / 1e6 / 2, rel=1e-3)
    assert truth["remat.recompute"] > 0
    assert p.device_ms(phases.RECOMPUTE) == pytest.approx(truth["remat.recompute"] / 1e6 / 2, rel=1e-3)
    assert p.attributed_pct() == pytest.approx(100.0, rel=1e-3)


def test_recompute_from_the_second_thread_lies_in_the_backwards_window(stretch):
    p = stretch[0]
    rec = [w for w in p.windows if w[2].name == "remat.recompute"]
    back = [w for w in p.windows if w[2].name == "g_step.backward"]
    assert len(rec) == len(back) == 2
    assert all(b[0] <= r[0] and r[1] <= b[1] for r, b in zip(rec, back))


def test_self_times_and_the_pipelines_ratio(stretch):
    p, trace, spans, _, selfs, _, _ = stretch
    want = sum(selfs[n] for n in phases.FORWARD) / 1e6 / 2
    assert p.host_ms(phases.FORWARD, self_time=True) == pytest.approx(want)
    back = [s for s in spans if s.name in phases.BACKWARD_HOST]
    assert p.host_ms(phases.BACKWARD_HOST) == pytest.approx(sum(s.end_ns - s.start_ns for s in back) / 1e6 / 2)
    assert all(p.self_ns(s) >= 0 for s in spans)
    assert p.ratio_pct("data.ready", "data.get") == 75.0
    assert p.ratio_pct("data.ready", "nothing") is None


def test_idle_gaps_named_by_phase(stretch):
    p = stretch[0]
    gaps = p.idle_gaps()
    assert gaps and all(label.split("/")[0] in ("data_wait", "step.even", "between") for label, _ in gaps)
    assert sum(d for _, d in gaps) <= p.trace.window_s


def readings(trace, units=None):
    return harness.Readings(units={"even": 2}, window_s=1.0, spans={"data_wait": [0.003], "step": [0.4]},
                            work={"even": {"flops": 10**12, "warp_bytes": 10**9, "warp_flops": 10**10}},
                            trace=trace, traced_units=units or {"even": 2},
                            peaks={"bytes_per_s": 3.35e12, "fp32_flops": 67e12, "bf16_flops": 989e12})


def read_all(r):
    out = {}
    for path in sorted((harness.HERE / "metrics").glob("*.py")):
        out[path.stem] = harness.load_module(path, "m_" + path.stem.replace(".", "_")).read(r)
    return out


def test_readers_on_the_synthetic_stretch(stretch, monkeypatch):
    """The new readers read the phases; the readers that were there read the
    trace as they did (``readers.py`` on the same numbers); a program
    without the tracing module gives no phase metric, and no error."""
    _, trace, spans, truth, _, _, _ = stretch
    monkeypatch.setattr(phases, "_take", lambda: (spans, {"data.get": 8, "data.ready": 6}))
    got = read_all(readings(trace))
    assert got["fwd_device_ms.train"] == pytest.approx(sum(truth[n] for n in phases.FORWARD) / 2e6, rel=1e-3)
    recompute = [s for s in spans if s.name == "remat.recompute"]
    assert got["recompute_device_ms.train"] == sum(s.device_end_ns - s.device_start_ns for s in recompute) / 2e6
    assert got["recompute_device_ms.train"] >= truth["remat.recompute"] / 2e6 > 0
    assert got["data_ready_pct.train"] == 75.0
    assert got["d2h_wait_ms.gen"] is None  # no to_unit.copy span
    assert got["device_idle_pct.train"] == readers.idle_pct(readings(trace))
    assert got["warp_roofline_pct.train"] is None  # no warp kernel in the synthetic stretch
    assert got["data_wait_ms.train"] == pytest.approx(3.0) and got["step_host_ms.train"] == pytest.approx(400.0)
    busy = sum(e - s for s, e in trace.busy_intervals())
    assert got["device_idle_pct.gen"] == pytest.approx(100.0 * (1 - busy / (trace.end_ns - trace.start_ns)))
    monkeypatch.setattr(phases, "_take", lambda: None)
    again = read_all(readings(Trace(trace.start_ns, trace.end_ns, trace.kernels, trace.spans)))
    new = {"fwd_device_ms.train", "bwd_device_ms.train", "opt_device_ms.train", "fwd_host_ms.train",
           "bwd_host_ms.train", "opt_host_ms.train", "recompute_device_ms.train", "data_ready_pct.train",
           "d2h_wait_ms.gen"}
    assert all(again[m] is None for m in new)
    assert {k: v for k, v in again.items() if k not in new} == {k: v for k, v in got.items() if k not in new}


def test_device_ms_withheld_when_the_fit_fails():
    """Events scattered off where they ran land inside kernels: the device
    ms by phase read nothing (the host's and the windows' own lengths still
    do); spans that leave most of the busy time outside their windows
    likewise."""
    trace, spans, _, _, _ = simulate(*CASES["device_bound"])
    assert phases.Phases(trace, spans, {}, iterations=2).withheld is None
    shift = [(i * 7919) % 200_001 - 100_000 for i in range(len(spans))]
    scattered = [Span(*s[:6], s.device_start_ns + d, s.device_end_ns + d) if s.device_start_ns is not None else s
                 for s, d in zip(spans, shift)]
    p = phases.Phases(trace, scattered, {}, iterations=2)
    assert "inside a kernel" in p.withheld
    assert p.device_ms(phases.FORWARD) is None and p.device_ms(phases.RECOMPUTE) is None
    assert p.host_ms(phases.FORWARD, self_time=True) is not None
    # the windows on the events' own clock need no fit: scattered alike, each keeps its length
    assert p.window_ms(phases.RECOMPUTE) == phases.Phases(trace, spans, {}, iterations=2).window_ms(phases.RECOMPUTE)
    few = [s for s in spans if s.name not in ("g_step.forward", "g_step.backward", "remat.recompute")]
    q = phases.Phases(trace, few, {}, iterations=2)
    assert "under 95.0%" in q.withheld and q.device_ms(phases.OPTIMIZER) is None
