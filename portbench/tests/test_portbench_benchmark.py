"""BENCHMARK.json and every file it names: they parse, their names and units
use only the allowed characters, and each per-layer metric is reported
where the end-to-end metric it moves is."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank|_nf|hidden|intermediate|latent|state|projection|head|expansion|experts_per_token)")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) and not w.startswith("/") for w in BENCH["command"])


def test_names_units_and_lines():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_named_file_parses():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and "flags" in cfg
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    for w in BENCH["workloads"]:
        cell = harness.load_cell(BENCH, w["name"])
        assert (harness.HERE / "drivers" / f"{cell.traffic['driver']}.py").exists()
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
    for m in BENCH["per_layer"]:
        reader = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py", "reader")
        assert callable(reader.read)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    c = harness.load_cell(BENCH, cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert cell in cells
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_four_chip_cells_within_their_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
