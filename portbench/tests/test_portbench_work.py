"""The yardstick's arithmetic on the CPU: the meta-device FLOP count against
a count over real tensors, the warp applications the reference logs, the
warp's bytes and FLOPs, the reduction of a trace, and the readers."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import readers, work
from portbench.harness import Readings
from portbench.profile import Trace
from portbench.reference import model, train
from portbench.tests.tiny import FLAGS

SIZES = model.Sizes.of(FLAGS)
RECIPE = train.Recipe.of(FLAGS)
CPU = torch.device("cpu")


@pytest.mark.parametrize("index", [0, 1, 3])
def test_meta_count_equals_a_cpu_count(index):
    wg, wd = model.make_weights([model.generator_spec(SIZES), model.discriminator_spec(SIZES)], 1, CPU)
    st = train.State.start(wg, wd)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32))
             for k in ("image", "geometry_change", "appearance_change")}
    noise = train.noise_draws(SIZES, 4, 1, 1, CPU)[0]
    warps = []
    with FlopCounterMode(display=False) as counter:
        train.iteration(st, SIZES, RECIPE, batch, noise, index, warps=warps)
    unit = work.train_units(SIZES, RECIPE, 4, 4)[train.variant(index)]
    assert unit["flops"] == counter.get_total_flops() + work.warps_work(warps, 4)[1]
    assert unit["warp_bytes"] == work.warps_work(warps, 4)[0]


def test_warp_applications_of_each_variant():
    """Even: three differentiated G applications in the G step and one
    without gradients in the D step; odd: one and one. Each applies one warp
    a synthesis block."""
    blocks = SIZES.num_blocks
    for index, (with_grad, without) in ((0, (3, 1)), (1, (1, 1)), (3, (1, 1))):
        st = train.State.start(*[{n: torch.zeros(s, device="meta").requires_grad_(n not in model.BUFFERS)
                                  for n, s, _ in spec}
                                 for spec in (model.generator_spec(SIZES), model.discriminator_spec(SIZES))])
        warps = []
        views = {k: torch.zeros((4, 3, 32, 32), device="meta") for k in ("image", "geometry_change", "appearance_change")}
        noise = tuple(torch.zeros((4, 8), device="meta") for _ in range(6))
        train.iteration(st, SIZES, RECIPE, views, noise, index, warps=warps)
        assert sum(w[3] for w in warps) == with_grad * blocks
        assert sum(not w[3] for w in warps) == without * blocks


def test_warp_work_counts_each_input_once():
    nbytes, flops = work.warp_work("warp_fwd", 8, 64, 512, 2)
    n = 8 * 512 * 512
    assert nbytes == 2 * n * 64 * 2 + n * 8 and flops == 32 * 64 * n
    nbytes, flops = work.warp_work("warp_dgrid", 8, 64, 512, 2)
    assert nbytes == 2 * n * 64 * 2 + 2 * n * 8 and flops == 64 * 64 * n


def _trace():
    ms = 1_000_000
    kernels = [("warp_fwd_kernel<bf16>", 0 * ms, 2 * ms), ("gemm", 1 * ms, 2 * ms),
               ("avg_pool", 5 * ms, 1 * ms), ("warp_dgrid_kernel", 8 * ms, 1 * ms)]
    spans = [("data_wait", 3 * ms, 5 * ms), ("step.even", 5 * ms, 10 * ms)]
    return Trace(0, 10 * ms, kernels, spans)


def test_trace_reduction():
    t = _trace()
    assert t.busy_intervals() == [(0, 3_000_000), (5_000_000, 6_000_000), (8_000_000, 9_000_000)]
    assert t.busy_s == pytest.approx(0.005) and t.window_s == pytest.approx(0.010)
    assert t.idle_gaps() == [["data_wait", 0.002], ["step.even", 0.002], ["step.even", 0.001]]
    assert t.device_ops()[0] == ["warp_fwd_kernel<bf16>", 0.002]
    assert t.kernel_seconds(readers.WARP_KERNELS) == pytest.approx(0.003)


def test_readers():
    t = _trace()
    r = Readings(units={"even": 2}, window_s=2.0, spans={"step": [0.1, 0.3]},
                 work={"even": {"flops": 989e12, "warp_bytes": 3.35e9, "warp_flops": 0}}, trace=t,
                 traced_units={"even": 1}, peaks={"bytes_per_s": 3.35e12, "bf16_flops": 989e12, "fp32_flops": 67e12})
    assert readers.idle_pct(r) == pytest.approx(50.0)
    assert readers.span_ms(r, "step") == pytest.approx(200.0) and readers.span_ms(r, "data_wait") is None
    assert readers.roofline_pct(r, readers.WARP_KERNELS) == pytest.approx(100.0 * 1e-3 / 3e-3)
    assert readers.mfu_pct(r) == pytest.approx(100.0)
    bare = Readings(units={}, window_s=0.0, spans={}, work={})
    assert readers.idle_pct(bare) is None and readers.roofline_pct(bare, readers.WARP_KERNELS) is None
    assert readers.mfu_pct(bare) is None
