"""The port's phase spans and counters (``lcgan_torch.utils.trace``) on the
CPU at the dryrun widths: off they record nothing; on they leave the
arithmetic bit for bit as it was and give the span tree of an even and an
odd + R1 iteration (and remat's recomputes inside the G step's backward);
the pipeline's and the all-reduce's counters; a torch profiler opened
around the program records the phases too, and what it leaves untaken is
bounded and dropped by the next ``enable()``; and the ``--profile_dir``
Chrome trace holds them inside its ``train_iteration epoch N`` ranges."""

import itertools
import json
import os
import socket
import threading
import time

import pytest
import torch
import torch.distributed as dist
from test_torch_train_phase import TINY, data_dir  # noqa: F401 (data_dir is a fixture)

from lcgan_torch import cli, parallel
from lcgan_torch.config import Config
from lcgan_torch.data.dataset import ImageFolderDataset, Prefetcher, TrainInputPipeline
from lcgan_torch.gen.artifacts import to_unit
from lcgan_torch.train.steps import Trainer
from lcgan_torch.utils import trace

CFG = dict(model_name="/tmp/lcgan_torch_trace_test", img_resolution=32, batch_size=4, geo_noise_dim=8,
           app_noise_dim=8, geo_latent_dim=8, app_latent_dim=16, geo_projection_dim=8, app_projection_dim=8,
           base_nf=8, max_nf=16, mbstd_group_size=2, compute_dtype="float32", adam_eps=1e-3, device="cpu")
STEP = ["noise", "g_step.forward", "g_step.backward", "g_step.all_reduce", "g_step.adam", "ema", "d_step.fake",
        "d_step.forward", "d_step.backward", "d_step.all_reduce", "d_step.adam"]


@pytest.fixture(autouse=True)
def clean():
    """Tracing off and nothing recorded, before and after each test."""
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.rand((4, 3, 32, 32), generator=g) * 2 - 1
            for k in ("image", "geometry_change", "appearance_change")}


def run(epochs, traced, **changes):
    """(losses, state_dict, spans) of the epochs from a fresh seeded state."""
    trainer = Trainer(Config(**CFG, **changes))
    state = trainer.init_state()
    losses, spans = [], []
    for epoch in epochs:
        if traced:
            trace.enable()
        state, g_loss, d_loss = trainer.train_iteration(state, batch(epoch), epoch)
        trace.disable()
        spans.append(trace.take()[0])
        losses.append((g_loss, d_loss))
    return losses, state.state_dict(), spans


@pytest.fixture(scope="module")
def even_r1():
    return run([0, 1], traced=False), run([0, 1], traced=True)


def same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def check_tree(spans):
    """Each child inside its parent on the parent's thread; self times >= 0."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.end_ns >= s.start_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.thread == s.thread and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p, s)
    for s in spans:
        kids = sum(c.end_ns - c.start_ns for c in spans if c.parent == s.id)
        assert s.end_ns - s.start_ns - kids >= 0, s


def test_off_records_nothing():
    assert not trace.recording()
    assert trace.span("g_step.forward") is trace.NOOP and trace.span("x", device=False) is trace.NOOP
    with trace.span("g_step.forward"):
        trace.count("data.get")
    run([0], traced=False)
    assert trace.take() == ([], {})


def test_tracing_leaves_the_arithmetic_bitwise(even_r1):
    (off_losses, off_state, off_spans), (on_losses, on_state, _) = even_r1
    assert all(not s for s in off_spans)
    assert same(off_losses, on_losses) and same(off_state, on_state)


def test_span_tree_of_an_even_and_an_r1_iteration(even_r1):
    even, r1 = even_r1[1][2]
    for spans in (even, r1):
        check_tree(spans)
        top = [s.name for s in spans if s.parent is None]
        assert top == STEP, top
        assert all(s.device_start_ns is None for s in spans)  # no CUDA here: no events
    assert "r1.grad" not in {s.name for s in even}
    (r1_grad,) = [s for s in r1 if s.name == "r1.grad"]
    assert {s.id: s.name for s in r1}[r1_grad.parent] == "d_step.forward"


def test_remat_recompute_inside_the_g_steps_backward():
    spans = run([0], traced=True, remat_blocks=True)[2][0]
    check_tree(spans)
    (backward,) = [s for s in spans if s.name == "g_step.backward"]
    recompute = [s for s in spans if s.name == "remat.recompute"]
    assert recompute and any(backward.start_ns <= s.start_ns and s.end_ns <= backward.end_ns for s in recompute)
    for s in recompute:  # on the CPU autograd runs the backward on the calling thread
        assert s.thread == backward.thread


def test_a_profiler_around_the_program_records_its_phases():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert trace.recording() and trace.span("x") is not trace.NOOP
        run([0], traced=False)  # traced=False: no enable(); run() takes the spans
    assert not trace.recording()
    trainer = Trainer(Config(**CFG))
    state = trainer.init_state()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trainer.train_iteration(state, batch(), 0)
    trainer.train_iteration(state, batch(), 2)
    spans, _ = trace.take()
    assert [s.name for s in spans if s.parent is None] == STEP


def test_an_unrelated_profiler_session_is_drained(monkeypatch):
    """What a profiler session records and nobody takes is bounded (past
    ``MAX_SPANS`` a span is only counted) and dropped by the next
    ``enable()``, which starts from nothing."""
    monkeypatch.setattr(trace, "MAX_SPANS", 5)

    def session():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(8):
                with trace.span("x"):
                    trace.count("data.get")
        assert not trace.recording()

    session()
    spans, counters = trace.take()
    assert [s.name for s in spans] == ["x"] * 5 and counters == {"data.get": 8, "trace.dropped": 3}
    session()
    trace.enable()
    with trace.span("y"):
        pass
    trace.disable()
    spans, counters = trace.take()
    assert [s.name for s in spans] == ["y"] and counters == {}


def test_to_unit_spans():
    trace.enable()
    out = to_unit(torch.rand(2, 3, 8, 8) * 2 - 1)
    spans, _ = trace.take()
    assert out.shape == (2, 8, 8, 3)
    assert [(s.name, s.parent) for s in spans] == [("to_unit", None), ("to_unit.copy", spans[0].id)]


def test_pipeline_counts_one_get_per_batch(data_dir):  # noqa: F811
    """The counters ``data.get`` once a batch and ``data.ready`` when the
    queue held one; each batch made in a ``data.batch`` span on the
    producing thread, and no other span."""
    pipeline = TrainInputPipeline(ImageFolderDataset(data_dir, 16, is_train=True), batch_size=2, num_workers=1,
                                  use_native=False)
    trace.enable()
    feed = Prefetcher(itertools.islice(pipeline, 3), depth=2)
    deadline = time.monotonic() + 60
    while not feed.q.full() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert feed.q.full()
    batches = [next(feed) for _ in range(3)]
    feed.thread.join(timeout=60)
    assert not feed.thread.is_alive()
    trace.disable()
    spans, counters = trace.take()
    pipeline.pool.shutdown(wait=True)
    assert all(b["image"].shape == (2, 3, 16, 16) for b in batches)
    assert counters["data.get"] == 3 and 1 <= counters["data.ready"] <= 3
    assert {s.name for s in spans} == {"data.batch"}
    assert len(spans) == 3 and all(s.thread == feed.thread.ident and s.parent is None for s in spans)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_all_reduce_counters_under_a_group_only():
    tensors = [torch.ones(3), torch.ones(2, 5)]
    trace.enable()
    parallel.mean_all_reduce(tensors)
    assert trace.take()[1] == {}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
    try:
        parallel.mean_all_reduce(tensors)
        parallel.mean_all_reduce(tensors[:1])
    finally:
        dist.destroy_process_group()
    trace.disable()
    _, counters = trace.take()
    assert counters == {"all_reduce.calls": 2, "all_reduce.bytes": (13 + 3) * 4}
    assert all(torch.equal(t, torch.ones_like(t)) for t in tensors)


def test_profile_dir_trace_holds_the_phases(data_dir, tmp_path):  # noqa: F811
    """Epochs 0-13: the window 12-13, each phase a range inside its epoch's
    ``train_iteration epoch N`` range; tracing is off again after it."""
    prof = str(tmp_path / "prof")
    cli.main(["--phase", "train", "--dataset_path", data_dir, "--model_name", str(tmp_path / "run"), *TINY,
              "--epoch", "13", "--profile_dir", prof])
    with open(os.path.join(prof, "trace_epochs_12-13_rank0.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    epochs = {int(e["name"].rsplit(" ", 1)[1]): e for e in events if e["name"].startswith("train_iteration epoch ")}
    assert sorted(epochs) == [12, 13]
    for epoch, outer in epochs.items():
        inside = {e["name"] for e in events if e["tid"] == outer["tid"]
                  and outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]}
        assert set(STEP) <= inside, (epoch, inside)
    assert not trace.recording() and trace.take() == ([], {})
