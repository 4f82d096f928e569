"""A throwaway benchmark for the CPU tests: a copy of the benchmark's
folder under a temporary root with one tiny configuration (the dryrun
widths, 32², float32), its traffic mixes and cells added as files, and a
``BENCHMARK.json`` that names them. It shows that a cell, a configuration
and a traffic mix are added by files alone."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

FLAGS = {"img_resolution": 32, "base_nf": 8, "max_nf": 16, "geo_noise_dim": 8, "app_noise_dim": 8,
         "geo_latent_dim": 8, "app_latent_dim": 16, "geo_projection_dim": 8, "app_projection_dim": 8,
         "mbstd_group_size": 2, "compute_dtype": "float32", "freezeD_layer": 1, "freezeD_start": 500000}
TRAIN_LIMITS = {"view_gap": 0.0, "loss1_gap": 1e-4, "grad_median_gap": 1e-3, "later_change_median_gap": 1e-3,
                "change_gap": 0.05}
GEN_LIMITS = {"image_max_gap": 1e-4, "image_rms_gap": 1e-5}


def make(tmp: Path, train_limits=None, gen_limits=None) -> tuple:
    """(BENCHMARK.json's object, the benchmark folder) of a tiny benchmark
    under ``tmp`` with the cells ``tiny-train`` and ``tiny-gen``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    root = tmp / "portbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "configs" / "tiny.json").write_text(json.dumps({"flags": FLAGS}))
    (root / "traffic" / "tiny-mix.json").write_text(json.dumps(
        {"driver": "train_mix", "flags": {"batch_size": 4, "num_data_workers": 2}, "period": 8,
         "warmup_periods": 1, "trace_periods": 1, "compared_steps": 4, "images": 12, "jpeg_quality": 90}))
    (root / "traffic" / "tiny-gen.json").write_text(json.dumps(
        {"driver": "generate", "flags": {"batch_size": 4, "w_psi": 1.0}, "warmup_batches": 1,
         "trace_batches": 2, "sample_batches": 2, "sample_range": 2}))
    (root / "workloads" / "tiny-train.json").write_text(json.dumps({"limits": train_limits or TRAIN_LIMITS}))
    (root / "workloads" / "tiny-gen.json").write_text(json.dumps({"limits": gen_limits or GEN_LIMITS}))
    bench = copy.deepcopy(bench)
    bench["configs"].append({"name": "tiny", "source": "the dryrun widths", "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"] += [
        {"name": "tiny-train", "config": "tiny", "traffic": "tiny-mix", "chips": 1, "why": "tests"},
        {"name": "tiny-gen", "config": "tiny", "traffic": "tiny-gen", "chips": 1, "why": "tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:  # the tiny cells report what the batch-8 cells do
        for kind, like in (("train", "train-512-mix"), ("gen", "gen-256")):
            if like in m.get("workloads", ()):
                m["workloads"].append(f"tiny-{kind}")
    return bench, root
