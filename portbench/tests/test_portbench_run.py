"""A run end to end on the CPU at the dryrun widths, through a throwaway
benchmark in a temporary folder (so a cell, a configuration and a mix are
added by files alone), with the timed path sound and broken underneath:
``correct`` has to come out true, then false for each fault a cell can
have, and false for the control put in the program's place. Without a card
the command itself refuses to run."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import model
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 11
ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def bench(tmp_path):
    return tiny.make(tmp_path)


def _run(bench, cell, trace=False, plant=None, seconds=0.5):
    b, root = bench
    return harness.run(b, cell, SEED, seconds, trace, CPU, time.perf_counter(), root=root, plant=plant)


def test_sound_train_run_is_correct_and_reports_its_metrics(bench):
    res = _run(bench, "tiny-train")
    assert res["correct"], res["compared"]
    assert set(res["metrics"]) == {"setup_s", "peak_mem_gib", "train_images_per_s"}
    assert list(res)[-1] == "compared" and res["attempted"] > 0


def test_sound_traced_train_run(bench):
    res = _run(bench, "tiny-train", trace=True)
    assert res["correct"]
    # no card: only the host spans have something to read
    assert set(res["metrics"]) == {"data_wait_ms.train", "step_host_ms.train"}
    assert res["device"]["window_s"] > 0 and len(res["breakdown"]["idle_gaps"]) <= 10


def test_sound_generation_run_is_correct(bench):
    res = _run(bench, "tiny-gen")
    assert res["correct"], res["compared"]
    assert set(res["metrics"]) == {"setup_s", "peak_mem_gib", "gen_images_per_s"}


def test_unchanged_state_is_not_correct(bench, monkeypatch):
    import lcgan_torch.train.state as state
    import lcgan_torch.train.steps as steps

    monkeypatch.setattr(state.AdamNoMu, "step", lambda self, params, grads, frozen=None: None)
    monkeypatch.setattr(steps, "ema_update", lambda *a, **k: None)
    res = _run(bench, "tiny-train")
    assert not res["correct"] and res["compared"]["change_gap"]["value"] > 0.5


def test_half_batch_is_not_correct(bench, monkeypatch):
    import lcgan_torch.train.steps as steps

    bce = steps.bce_logits
    monkeypatch.setattr(steps, "bce_logits", lambda logit, target: bce(logit[: logit.shape[0] // 2], target))
    res = _run(bench, "tiny-train")
    assert not res["correct"] and res["compared"]["loss1_gap"]["value"] > res["compared"]["loss1_gap"]["limit"]


def test_odd_step_without_its_d_update_is_not_correct(bench, monkeypatch):
    """The odd variant (no R1) leaves D and its optimizer as they were; the
    other variants are sound."""
    import lcgan_torch.train.steps as steps

    iteration = steps.Trainer.train_iteration

    def train_iteration(self, state, batch, epoch):
        if epoch % 2 == 1 and epoch % 8 != 1:
            state.d_opt.step = lambda *a, **k: None
        try:
            return iteration(self, state, batch, epoch)
        finally:
            state.d_opt.__dict__.pop("step", None)

    monkeypatch.setattr(steps.Trainer, "train_iteration", train_iteration)
    res = _run(bench, "tiny-train")
    c = res["compared"]
    assert not res["correct"] and c["later_change_median_gap"]["value"] > c["later_change_median_gap"]["limit"], c
    assert c["loss1_gap"]["value"] <= c["loss1_gap"]["limit"]


def test_altered_view_is_not_correct(bench):
    def plant(work):
        work.views[1]["appearance_change"][0, 0, 0, 0] += 2.0 / 255.0

    res = _run(bench, "tiny-train", plant=plant)
    assert not res["correct"] and res["compared"]["view_gap"]["value"] > 0


def test_train_control_is_not_correct(bench):
    """The control: the reference computed in fp8, in the program's place."""
    def plant(work):
        with model.reference_mode():
            work.program = work.reference(work.reference_views(), prec=model.Precision.fp8())

    res = _run(bench, "tiny-train", plant=plant)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("fault", ["altered_image", "half_batch", "control"])
def test_generation_faults_are_not_correct(bench, fault):
    def plant(work):
        to_unit = work.to_unit
        if fault == "altered_image":
            work.to_unit = lambda out: np.concatenate([to_unit(out)[:1, :, ::-1], to_unit(out)[1:]])
        elif fault == "half_batch":
            work.to_unit = lambda out: to_unit(out)[: out.shape[0] // 2]
        else:
            weights = work._weights()

            def control(out):
                z1, z2 = work.last_codes
                with model.reference_mode():
                    img = model.generator(weights, work.sizes, z1, z2, w_psi=work.w_psi, training=False,
                                          prec=model.Precision.fp8())
                return to_unit(img)

            codes = work._codes
            work._codes = lambda: setattr(work, "last_codes", codes()) or work.last_codes
            work.to_unit = control

    res = _run(bench, "tiny-gen", plant=plant)
    assert not res["correct"], res["compared"]


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "gen-256", "--seed", str(SEED),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_command_fails_with_the_benchmark_alone(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's folder only: no
    port to run, no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; torch.cuda.is_available = lambda: True; torch.cuda.device_count = lambda: 1; "
            "import portbench.run as r; sys.exit(r.main(['--workload', 'gen-256', '--seed', '1', '--seconds', '1']))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "lcgan_torch" in out.stderr


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """On the card: one short run of the generation cell prints a correct result."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "gen-256", "--seed", str(SEED),
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-gen"])
def test_control_readings(bench, cell):
    """``portbench.control``'s readings at a size a test run holds: the
    control and every planted fault fail one of the cell's numbers, and
    the program's own readings pass."""
    from portbench import compare, control

    got = {}
    res = _run(bench, cell, plant=lambda w: got.setdefault("w", w))
    work = got["w"]
    assert res["correct"] and compare.judge(work.values, harness.load_cell(bench[0], cell, bench[1]).limits)[0]
    limits = harness.load_cell(bench[0], cell, bench[1]).limits
    faults = (control.gen_faults if cell == "tiny-gen" else control.train_faults)(work, True)
    assert {"control", "half_batch"} <= set(faults)
    for kind, values in faults.items():
        if kind != "bf16_reference":
            assert not compare.judge({**work.values, **values}, limits)[0], kind
