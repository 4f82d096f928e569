"""The port's generation phase end to end on the CPU (from the train phase's
full-state checkpoint), its device rule, and its independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from lcgan_torch import cli
from lcgan_torch.config import Config
from lcgan_torch.train.loop import run_phase
from lcgan_torch.train.steps import Trainer
from lcgan_torch.utils.checkpoint import save_state, state_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_resolution=32, batch_size=2, geo_noise_dim=8, app_noise_dim=8, geo_latent_dim=8,
            app_latent_dim=16, base_nf=8, max_nf=16, compute_dtype="float32")


def write_run(run_dir: str, **overrides) -> Config:
    """A run directory with args.txt and a seeded full-state checkpoint."""
    cfg = Config(model_name=run_dir, **{**TINY, **overrides})
    cfg.make_run_dirs()
    cfg.dump(os.path.join(run_dir, "args.txt"))
    save_state(state_path(cfg), Trainer(Config(**{**TINY, **overrides}, device="cpu")).init_state())
    return cfg


def test_fake_image_generation_on_cpu(tmp_path):
    run = str(tmp_path / "run")
    write_run(run)
    cli.main(["--phase", "fake_image_generation", "--model_name", run, "--num_fakes", "2", "--device", "cpu"])
    for i in range(2):
        img = np.asarray(Image.open(os.path.join(run, "fakes", f"{i:04d}_images.jpg")))
        # nrow=1 (one image per row), padding=0: the local batch of 2 stacked vertically
        assert img.shape == (64, 32, 3)
    first = np.asarray(Image.open(os.path.join(run, "fakes", "0000_images.jpg")))
    second = np.asarray(Image.open(os.path.join(run, "fakes", "0001_images.jpg")))
    assert not np.array_equal(first, second)  # fresh z for every batch


def test_generation_is_seeded(tmp_path):
    paths = []
    for name in ("a", "b"):
        run = str(tmp_path / name)
        write_run(run)
        cli.main(["--phase", "fake_image_generation", "--model_name", run, "--num_fakes", "1", "--device", "cpu"])
        paths.append(os.path.join(run, "fakes", "0000_images.jpg"))
    assert np.array_equal(*(np.asarray(Image.open(p)) for p in paths))


def test_cuda_default_raises_without_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = str(tmp_path / "run")
    write_run(run)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--phase", "fake_image_generation", "--model_name", run, "--num_fakes", "1"])
    assert not os.path.exists(os.path.join(run, "fakes"))


def test_missing_checkpoint_raises(tmp_path):
    run = str(tmp_path / "run")
    with pytest.raises(FileNotFoundError):
        cli.main(["--phase", "fake_image_generation", "--model_name", run, "--device", "cpu"])


@pytest.mark.parametrize("phase", ["fid_eval", "video_generation"])
def test_other_phases_wait_for_their_slice(phase, tmp_path):
    """Both phases are ported: without a checkpoint they raise as the JAX
    package's run_phase does; only an unknown phase is refused as such."""
    with pytest.raises(FileNotFoundError, match="run the train phase first"):
        cli.main(["--phase", phase, "--model_name", str(tmp_path / "run"), "--device", "cpu"])
    cfg = Config(model_name=str(tmp_path / "run"), device="cpu")
    cfg.phase = "sample"
    with pytest.raises(ValueError, match="unknown phase"):
        run_phase(cfg)


def test_generation_reloads_args_txt_and_typed_flags_win(tmp_path):
    run = str(tmp_path / "run")
    write_run(run, w_psi=0.5)
    cfg = cli.parse_config(["--phase", "fake_image_generation", "--model_name", run, "--seed", "7"])
    assert (cfg.img_resolution, cfg.base_nf, cfg.compute_dtype) == (32, 8, "float32")
    assert (cfg.w_psi, cfg.seed, cfg.phase) == (0.5, 7, "fake_image_generation")
    assert cfg.dtype == torch.float32


def test_config_rejects_unknown_device():
    with pytest.raises(ValueError, match="device"):
        Config(model_name="x", device="tpu").validate()


def test_port_imports_no_jax():
    """Every module of lcgan_torch imports without JAX or the JAX package."""
    code = (
        "import pkgutil, importlib, sys, lcgan_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(lcgan_torch.__path__, 'lcgan_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'lcgan_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
