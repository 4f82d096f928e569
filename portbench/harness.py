"""The harness: runs one cell of ``BENCHMARK.json`` once and builds its
result.

A run is: set-up by the cell's driver (imports, the kernels loaded or
built, weights made from the seed on the device, the traffic, the warm-up
with the steps the comparison reads), then with ``--trace 1`` a traced
stretch of the same traffic, then the measured window of ``seconds``, then
the program's state freed and the comparison against the plain reference.
Everything about a cell is found by name: its configuration's file, its
traffic mix's file and driver, its limits, and one reader a per-layer
metric (``metrics/<name>.py``, whose ``read(readings)`` returns a number or
None).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import shutil
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from portbench import compare, traffic
from portbench.peaks import card_peaks

HERE = Path(__file__).resolve().parent
# top-level module names that no run may hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "lcgan_tpu", "bench", "chip_smoke", "tools")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def banned_modules() -> List[str]:
    return sorted(name for name in list(sys.modules) if name.split(".", 1)[0] in BANNED)


@dataclasses.dataclass
class Cell:
    """One cell and everything its files say about it."""

    name: str
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: Dict[str, float]  # workloads/<cell>.json
    end_to_end: List[dict]  # the end-to-end metrics it reports
    per_layer: List[dict]  # the per-layer metrics it reports
    root: Path  # the benchmark's folder

    @property
    def flags(self) -> dict:
        """The port's flags: the configuration's, then the mix's."""
        return {**self.config["flags"], **self.traffic.get("flags", {})}


def quantity(name: str) -> str:
    """What an end-to-end metric measures: its name up to the first dot.
    ``train_images_per_s.b32`` is ``train_images_per_s`` in the cells it
    lists, held to a bound of its own."""
    return name.split(".", 1)[0]


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell(bench: dict, name: str, root: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (a parsed BENCHMARK.json); its files
    under ``root``."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {sorted(entries)})")
    entry = entries[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(root.parent / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(root / "workloads" / f"{name}.json") as f:
        limits = json.load(f)["limits"]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, config, traffic.load(entry["traffic"], root), limits, e2e, per_layer, root)


class Run:
    """What a driver is handed: the cell, the seed, the device, a scratch
    folder under ``TMPDIR``, and a log of set-up parts on standard error."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, started: float, tmp: str):
        self.cell, self.seed, self.device, self.tmp = cell, seed, device, tmp
        self.parts: List[tuple] = []
        self._last = started

    @property
    def flags(self) -> dict:
        return self.cell.flags

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def part(self, what: str) -> None:
        now = time.perf_counter()
        self.parts.append((what, now - self._last))
        print(f"portbench: set-up {what} {now - self._last:.3f} s", file=sys.stderr, flush=True)
        self._last = now

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read."""

    units: Dict[str, int]  # units of work in the window, by kind (variants, or "batch")
    window_s: float  # the measured window, host clock
    spans: Dict[str, List[float]]  # host seconds of each benchmark span in the window
    work: Dict[str, Dict[str, int]]  # {unit kind: {"flops", "warp_bytes"}} from the reference
    trace: Optional[object] = None  # profile.Trace of the traced stretch
    traced_units: Dict[str, int] = dataclasses.field(default_factory=dict)
    peaks: Optional[dict] = None  # the card's data-sheet peaks


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def refuse_banned() -> None:
    """Exit, naming them, if modules that no run may load are loaded."""
    found = banned_modules()
    if found:
        raise SystemExit(f"portbench: modules that no run may load were loaded: {', '.join(found)}")


def _per_layer(cell: Cell, work, window: dict, spans: dict, prof: dict, kind: str) -> dict:
    """The traced run's per-layer metrics: each reader's number, where it
    found something to read."""
    readings = Readings(units=window["units"], window_s=window["seconds"], spans=dict(spans), work=work.work(),
                        trace=prof["trace"], traced_units=prof["units"], peaks=card_peaks(kind))
    out = {}
    for m in cell.per_layer:
        reader = load_module(cell.root / "metrics" / f"{m['name']}.py", "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device: torch.device,
        started: float, root: Path = HERE, plant: Optional[Callable] = None) -> dict:
    """One run of the cell; returns its result (the last line's object).
    ``plant`` is called with the driver's object after its set-up (a fault
    planted by a test)."""
    cell = load_cell(bench, workload, root)
    driver = load_module(root / "drivers" / f"{cell.traffic['driver']}.py", f"portbench_driver_{cell.traffic['driver']}")
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        r = Run(cell, seed, device, started, tmp)
        work = driver.Work(r)
        work.setup()
        setup_s = time.perf_counter() - started
        if plant is not None:
            plant(work)
        prof = work.traced() if trace else None
        spans: Dict[str, List[float]] = defaultdict(list)
        reset_peak(device)
        window = work.window(seconds, spans)
        memory_peak = peak_bytes(device)
        work.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        work.values = values = work.check()
        print(f"portbench: comparison {time.perf_counter() - t:.3f} s"
              + (f", peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB" if device.type == "cuda" else ""),
              file=sys.stderr, flush=True)
        correct, compared = compare.judge(values, cell.limits)
        for name in sorted(set(values) - set(cell.limits)):
            print(f"portbench: read, not compared: {name} {values[name]!r}", file=sys.stderr)

        dev = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               "count": 1, "memory_peak_bytes": memory_peak}
        result = {"correct": correct and window["failed"] == 0, "attempted": window["images"],
                  "failed": window["failed"]}
        if trace:
            metrics = _per_layer(cell, work, window, spans, prof, dev["kind"])
            t = prof["trace"]
            traced_units, window_units = sum(prof["units"].values()), sum(window["units"].values())
            print(f"portbench: traced stretch {t.window_s:.4f} s for {traced_units} units, "
                  f"{1e3 * t.window_s / traced_units:.2f} ms a unit; the window "
                  f"{1e3 * window['seconds'] / window_units:.2f} ms a unit; the markers' skew "
                  f"{t.skew_ns / 1e3:.1f} us", file=sys.stderr)
            dev.update(busy_s=t.busy_s, window_s=t.window_s)
            result["breakdown"] = {"device_ops": t.device_ops(), "idle_gaps": t.idle_gaps()}
        else:
            measured = {"setup_s": (setup_s, "s"), "peak_mem_gib": (memory_peak / 2**30, "GiB"), **window["metrics"]}
            missing = [m["name"] for m in cell.end_to_end if quantity(m["name"]) not in measured]
            if missing:
                raise KeyError(f"the driver reported no {', '.join(missing)}")
            metrics = {m["name"]: dict(zip(("value", "unit"), measured[quantity(m["name"])])) for m in cell.end_to_end}
        result.update(metrics=metrics, device=dev, setup_parts=dict(r.parts), compared=compared)
        refuse_banned()
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def print_result(result: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(finite_json(result), allow_nan=False), flush=True)


def finite_json(o):
    """JSON has no infinity: a number that is not finite is written as a string."""
    if isinstance(o, float) and not math.isfinite(o):
        return str(o)
    if isinstance(o, dict):
        return {k: finite_json(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [finite_json(v) for v in o]
    return o
