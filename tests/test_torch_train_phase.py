"""The port's train phase on the CPU: ``python -m lcgan_torch.cli --phase
train`` end to end at a tiny width (the file contract of the JAX package's
loop, the monitor firing, resume from epoch.txt, generation from the
checkpoint it writes), the full-state checkpoint, and bit-exact resume in a
fresh process (in the pattern of tests/test_train.py's
test_resume_is_bit_exact).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from torch_resume_worker import CFG, fake_batch

from lcgan_torch import cli
from lcgan_torch.config import Config
from lcgan_torch.train.loop import deterministic_algorithms, load_ema_generator
from lcgan_torch.train.steps import Trainer
from lcgan_torch.utils.checkpoint import (
    load_state,
    read_epoch_file,
    save_state,
    state_path,
    write_epoch_file,
)

LOG_LINE = re.compile(r"^epoch:(\d+), elapsed:\d+:\d\d:\d\d, g_loss:(-?\d+\.\d{6}), d_loss:(-?\d+\.\d{6}) $")
TINY = ["--img_resolution", "16", "--batch_size", "4", "--geo_noise_dim", "4", "--app_noise_dim", "4",
        "--geo_latent_dim", "4", "--app_latent_dim", "8", "--geo_projection_dim", "4", "--app_projection_dim", "4",
        "--base_nf", "4", "--max_nf", "8", "--mbstd_group_size", "2", "--compute_dtype", "float32",
        "--num_data_workers", "2", "--device", "cpu"]


@pytest.fixture
def data_dir(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "data" / "train" / "x"
    d.mkdir(parents=True)
    for i in range(6):
        img = Image.fromarray(rng.integers(0, 255, (20, 24, 3), dtype=np.uint8))
        img.save(d / (f"{i}.png" if i % 2 else f"{i}.jpg"))
    return str(tmp_path / "data")


def log_lines(run):
    with open(os.path.join(run, "log.txt")) as f:
        lines = f.read().splitlines(keepends=False)
    matches = [LOG_LINE.match(line) for line in lines]
    assert all(matches), lines
    return [(int(m[1]), float(m[2]), float(m[3])) for m in matches]


def test_train_phase_file_contract_monitor_and_resume(data_dir, tmp_path, capsys):
    run = str(tmp_path / "run")
    base = ["--phase", "train", "--dataset_path", data_dir, "--model_name", run, *TINY,
            "--save_interval", "3", "--print_interval", "1", "--show_interval", "2"]
    cli.main(base + ["--epoch", "4"])
    assert "restart training from" not in capsys.readouterr().out
    cfg = Config.load(os.path.join(run, "args.txt"))
    assert (cfg.phase, cfg.epoch, cfg.img_resolution, cfg.device) == ("train", 4, 16, "cpu")
    lines = log_lines(run)
    assert [e for e, _, _ in lines] == [0, 1, 2, 3, 4]
    assert all(np.isfinite(g) and np.isfinite(d) for _, g, d in lines)
    assert read_epoch_file(run) == 3  # saved at epoch 3; epoch 4 ran after it
    assert os.path.exists(os.path.join(run, "model", "state.pt"))
    videos = sorted(os.listdir(os.path.join(run, "samples")))  # the monitor at epochs 2 and 4
    assert [os.path.splitext(v)[0] for v in videos] == [
        "appearance_2_0", "appearance_4_0", "geometry_2_0", "geometry_4_0"]
    assert all(os.path.getsize(os.path.join(run, "samples", v)) > 0 for v in videos)

    # the second call resumes from epoch.txt + 1 and appends to log.txt
    cli.main(base + ["--epoch", "5", "--show_interval", "100"])
    assert "restart training from: 4" in capsys.readouterr().out
    assert [e for e, _, _ in log_lines(run)] == [0, 1, 2, 3, 4, 4, 5]
    assert read_epoch_file(run) == 3  # no save at 4 or 5

    # generation reads the EMA from the checkpoint the train phase wrote
    cli.main(["--phase", "fake_image_generation", "--model_name", run, "--num_fakes", "1", "--device", "cpu"])
    assert np.asarray(Image.open(os.path.join(run, "fakes", "0000_images.jpg"))).shape == (64, 16, 3)


def test_train_phase_raises_without_a_gpu_unless_asked(data_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = str(tmp_path / "run")
    argv = ["--phase", "train", "--dataset_path", data_dir, "--model_name", run, "--epoch", "1"]
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(argv)


def tiny_state(run, **kw):
    cfg = Config(model_name=run, **{**CFG, **kw})
    trainer = Trainer(cfg)
    return cfg, trainer, trainer.init_state()


def test_state_checkpoint_round_trip(tmp_path):
    """Every leaf, both Adam v trees and counts, step and the noise
    generator's state come back; generation reads the EMA alone."""
    cfg, trainer, state = tiny_state(str(tmp_path / "run"))
    for epoch in range(2):
        state, _, _ = trainer.train_iteration(state, fake_batch(cfg, epoch), epoch)
    path = state_path(cfg)
    save_state(path, state)
    assert path.endswith(os.path.join("model", "state.pt"))
    assert state_path(cfg, best=True).endswith("state_best.pt")
    _, _, fresh = tiny_state(cfg.model_name, seed=9)
    load_state(path, fresh)
    want, got = state.state_dict(), fresh.state_dict()
    assert got["step"] == want["step"] == 2 and got["g_opt"]["count"] == got["d_opt"]["count"] == 2
    for part in ("generator", "discriminator", "ema"):
        assert all(torch.equal(got[part][k], v) for k, v in want[part].items()), part
    for opt in ("g_opt", "d_opt"):
        assert all(torch.equal(got[opt]["v"][k], v) for k, v in want[opt]["v"].items()), opt
    assert torch.equal(got["rng"], want["rng"])
    saved = torch.load(path, map_location="cpu", weights_only=True)
    ema = saved["ema"]
    assert ema.keys() == want["ema"].keys() and all(torch.equal(ema[k], v) for k, v in want["ema"].items())
    assert all(torch.equal(saved["generator"][k], v) for k, v in want["generator"].items())

    gen = load_ema_generator(cfg, torch.device("cpu"))
    assert not gen.training and all(torch.equal(gen.state_dict()[k], v) for k, v in want["ema"].items())


def test_epoch_file(tmp_path):
    assert read_epoch_file(str(tmp_path)) is None
    write_epoch_file(str(tmp_path), 17)
    assert read_epoch_file(str(tmp_path)) == 17


def test_deterministic_algorithms_are_restored():
    before = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.benchmark)
    with deterministic_algorithms():
        assert torch.are_deterministic_algorithms_enabled() and not torch.backends.cudnn.benchmark
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"]
    assert (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.benchmark) == before


@pytest.mark.parametrize("beta1", [0.0, 0.5])
def test_resume_is_bit_exact_in_a_fresh_process(tmp_path, beta1):
    """N epochs → save → restore in a fresh process → M more must equal an
    uninterrupted N+M run bit for bit: G, D and EMA leaves and buffers, both
    Adam v trees (and mu trees, beta1 != 0) and counts, step and the noise
    generator's state. Epochs 0-7 cover the schedule period (4 even, 1 odd +
    R1, 3 odd), frozen from epoch 6."""
    n, m = 4, 4
    cfg, trainer, oracle = tiny_state(str(tmp_path / "run"), beta1=beta1)
    with deterministic_algorithms():
        for epoch in range(n + m):
            oracle, _, _ = trainer.train_iteration(oracle, fake_batch(cfg, epoch), epoch)
        state = trainer.init_state()
        for epoch in range(n):
            state, _, _ = trainer.train_iteration(state, fake_batch(cfg, epoch), epoch)
    save_state(state_path(cfg), state)

    worker = os.path.join(os.path.dirname(__file__), "torch_resume_worker.py")
    proc = subprocess.run([sys.executable, worker, cfg.model_name, str(n), str(n + m), str(beta1)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    resumed = trainer.init_state()
    load_state(os.path.join(cfg.model_name, "model_resumed", "state.pt"), resumed)

    want, got = oracle.state_dict(), resumed.state_dict()
    mismatches = [f"{part}.{k}" for part in ("generator", "discriminator", "ema")
                  for k, v in want[part].items() if not torch.equal(got[part][k], v)]
    moments = ("v", "mu") if beta1 else ("v",)
    assert set(want["g_opt"]) == {*moments, "count"}
    mismatches += [f"{opt}.{mom}.{k}" for opt in ("g_opt", "d_opt") for mom in moments
                   for k, v in want[opt][mom].items() if not torch.equal(got[opt][mom][k], v)]
    assert not mismatches, f"resume not bit-exact in: {mismatches}"
    assert got["step"] == want["step"] == n + m
    assert got["g_opt"]["count"] == want["g_opt"]["count"] and got["d_opt"]["count"] == want["d_opt"]["count"]
    assert torch.equal(got["rng"], want["rng"])


def test_args_txt_is_the_jax_packages_json(data_dir, tmp_path):
    """args.txt holds every Config field as JSON, so a run dir reloads."""
    run = str(tmp_path / "run")
    cli.main(["--phase", "train", "--dataset_path", data_dir, "--model_name", run, *TINY, "--epoch", "1"])
    with open(os.path.join(run, "args.txt")) as f:
        raw = json.load(f)
    assert raw["model_name"] == run and raw["epoch"] == 1 and raw["base_nf"] == 4
    assert [e for e, _, _ in log_lines(run)] == [0]  # print_interval 100: epoch 0 only
