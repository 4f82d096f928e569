"""The port's ``video_generation`` against the JAX package's on the CPU: the
frames of ``demo_generation`` for JAX's latent and the same EMA weights, and
the phase's files (``demo/controlled_dim=<d>_<n>.mp4``, 60 frames at the
default ``num_explore`` of 30, every dimension under ``--ctrl_dim -1``)."""

import os

import cv2
import jax
import numpy as np
import pytest
import torch
from test_torch_cli import write_run
from test_torch_train import CFG

import lcgan_tpu.gen.artifacts as jart
from lcgan_torch import cli
from lcgan_torch.config import Config
from lcgan_torch.convert import generator_from_flax
from lcgan_torch.gen.artifacts import demo_frames
from lcgan_torch.models.generator import build_generator
from lcgan_tpu.config import Config as JaxConfig
from lcgan_tpu.train.steps import Trainer as JaxTrainer


def video_frames(path: str):
    """(frame count, frames/s) of an mp4."""
    cap = cv2.VideoCapture(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS)
    finally:
        cap.release()


def decoded(path: str) -> np.ndarray:
    cap = cv2.VideoCapture(path)
    frames = []
    try:
        ok, frame = cap.read()
        while ok:
            frames.append(frame)
            ok, frame = cap.read()
    finally:
        cap.release()
    return np.stack(frames)


@pytest.mark.parametrize("controlled_dim", [1, 12])
def test_demo_frames_match_jax(controlled_dim, monkeypatch):
    """JAX's demo_generation (its frames caught before the mp4 writer) and
    the port's sweep of the same latent through the same EMA weights, at
    the dryrun width in fp32, a geometry and an appearance dimension.
    Frames are uint8: at most one level apart (fp32 sums in another order
    round across a level's edge), the mean difference well under one."""
    local_b, num_explore = 4, 5
    # the JAX package divides --batch_size by its device count (8 fake CPU devices here)
    jcfg = JaxConfig(**dict(CFG, batch_size=local_b * jax.device_count(), w_psi=0.7))
    jtrainer = JaxTrainer(jcfg, mesh=None)
    jstate = jtrainer.init_state()
    caught = []
    monkeypatch.setattr(jart, "save_video", lambda frames, path, fps: caught.append((frames, path, fps)))
    jart.demo_generation(jcfg, jtrainer, jstate, controlled_dim=controlled_dim, num_video=1,
                         num_explore=num_explore)
    (want, path, fps), = caught
    assert os.path.basename(path) == f"controlled_dim={controlled_dim}_0.mp4" and fps == num_explore

    _, k = jax.random.split(jax.random.PRNGKey(jcfg.seed))  # demo_generation's first video
    latent = np.array(jax.random.normal(k, (local_b, jcfg.geo_noise_dim + jcfg.app_noise_dim)))
    cfg = Config(**dict(CFG, batch_size=local_b, w_psi=0.7, device="cpu"))
    gen = build_generator(cfg)
    gen.load_state_dict(generator_from_flax(*jax.device_get((jstate.ema_params, jstate.ema_stats))))
    got = demo_frames(cfg, gen.eval(), torch.device("cpu"), latent, controlled_dim, num_explore)

    assert len(got) == len(want) == 2 * num_explore
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == b.shape == (2 * 32, 2 * 32, 3)  # nrow = ⌊√4⌋
        diff = np.abs(a.astype(int) - b.astype(int))
        assert diff.max() <= 1 and diff.mean() < 0.05
    assert not np.array_equal(got[0], got[num_explore - 1])  # the sweep moves the images


# a 16² generator with 3 + 2 noise dims
SMALL = dict(img_resolution=16, geo_noise_dim=3, app_noise_dim=2, geo_latent_dim=4, app_latent_dim=8,
             base_nf=4, max_nf=8, batch_size=4)


def test_video_generation_every_dimension(tmp_path):
    """--ctrl_dim -1: one video per dimension, geometry then appearance;
    60 frames at 30 frames/s each."""
    run = str(tmp_path / "run")
    write_run(run, **SMALL)
    cli.main(["--phase", "video_generation", "--model_name", run, "--num_videos", "1", "--device", "cpu"])
    demo = os.path.join(run, "demo")
    assert sorted(os.listdir(demo)) == [f"controlled_dim={d}_0.mp4" for d in range(5)]
    for name in os.listdir(demo):
        assert os.path.getsize(os.path.join(demo, name)) > 0
        assert video_frames(os.path.join(demo, name)) == (60, 30.0)


def test_video_generation_one_dimension_is_seeded(tmp_path):
    """--ctrl_dim 2 --num_videos 2: two videos of a fresh latent each; the
    same seed writes the same files."""
    videos = []
    for name in ("a", "b"):
        run = str(tmp_path / name)
        write_run(run, **SMALL)
        cli.main(["--phase", "video_generation", "--model_name", run, "--ctrl_dim", "2", "--num_videos", "2",
                  "--device", "cpu"])
        demo = os.path.join(run, "demo")
        assert sorted(os.listdir(demo)) == ["controlled_dim=2_0.mp4", "controlled_dim=2_1.mp4"]
        videos.append([decoded(os.path.join(demo, f)) for f in sorted(os.listdir(demo))])
    assert all(np.array_equal(a, b) for a, b in zip(*videos))
    assert not np.array_equal(*videos[0])
