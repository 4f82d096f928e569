"""The port's probes, the counterparts of the JAX package's kernel probes
(``tools/gather_probe.py``, ``tools/dyn_trip_probe.py``): each holds its
CUDA kernel's wrapper and plain version, and a ``main`` that asks on the
card what the JAX probe asked on the TPU. Run as

    python -m lcgan_torch.tools.gather_probe
    python -m lcgan_torch.tools.dyn_trip_probe

on the GPU, or with ``--device cpu`` on the plain versions.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional, Tuple

import torch


def describe(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} (cuda, {torch.cuda.device_count()} device(s))"
    return "cpu"


def time_ms(fn: Callable[[], object], n: int, device: torch.device,
            per_hold: Optional[int] = None) -> Tuple[Optional[float], float]:
    """(device ms, host ms) per call of ``fn`` over ``n`` calls, after one
    warm call.

    Host: the clock around the ``n`` calls and a synchronize. Device (CUDA
    only, else None): CUDA events around runs of at most ``per_hold`` calls
    (all ``n`` by default), each run queued behind a sleep kernel so that
    the host has enqueued it before the device reaches it; the events then
    bracket the device's time, not the host's launches. A run must fit in
    the stream's launch queue (a few hundred launches), so a call that
    launches many kernels takes a small ``per_hold``. The device ms is the
    median over the runs: a run that the host still paced (a pause longer
    than its hold) stands out and is not averaged in.
    """
    cuda = device.type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    host_s = time.perf_counter() - t0
    if not cuda:
        return None, host_s / n * 1e3
    per_call, done = [], 0
    while done < n:
        k = min(per_hold or n, n - done)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * 1.5 * host_s * k / n))  # cycles at <= 2 GHz
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / k)
        done += k
    return statistics.median(per_call), host_s / n * 1e3
