"""Fake-image generation (worker.py:427-441), control-dimension demo videos
(worker.py:447-485) and the training monitor (worker.py:255-363), PyTorch
port of ``lcgan_tpu.gen.artifacts``.

All run the EMA generator in eval mode, so its w-avg buffers stay as they
are (the JAX package discards that mutation), on rank 0 alone. Codes are
drawn on the CPU from a ``torch.Generator`` seeded by the config, so a seed
gives the same codes on every device. The local batch is the global
``--batch_size`` over the world size, as the JAX package divides it by its
mesh's device count.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from lcgan_torch import parallel
from lcgan_torch.config import Config
from lcgan_torch.utils import trace
from lcgan_torch.utils.media import make_grid, resize_frame, save_image_grid, save_video, to_uint8


def to_unit(img: torch.Tensor) -> np.ndarray:
    """[-1,1] NCHW model output -> float [0,1] NHWC numpy (worker.py:435).
    The copy to the host waits for the device: the span ``to_unit.copy``."""
    with trace.span("to_unit"):
        unit = ((img.float() + 1.0) * 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)
        with trace.span("to_unit.copy"):
            unit = unit.cpu()
        return unit.numpy()


def local_batch(cfg: Config) -> int:
    """The global batch's share of one rank (at least 1)."""
    return max(cfg.batch_size // parallel.world_size(), 1)


@torch.inference_mode()
def fake_image_generation(cfg: Config, generator: torch.nn.Module, device: torch.device):
    """num_fakes batches → <model_name>/fakes/NNNN_images.jpg (worker.py:427-441).

    ``generator`` is the EMA generator on ``device``, in eval mode (the
    w-avg buffers stay as they are); z is drawn on the CPU
    from a ``torch.Generator`` seeded by ``cfg.seed``, so a seed gives the
    same codes on every device.
    """
    rng = torch.Generator().manual_seed(cfg.seed)
    folder = cfg.run_dirs()["fakes"]
    os.makedirs(folder, exist_ok=True)
    local_b = local_batch(cfg)
    for count in range(cfg.num_fakes):
        z1 = torch.randn((local_b, cfg.geo_noise_dim), generator=rng).to(device)
        z2 = torch.randn((local_b, cfg.app_noise_dim), generator=rng).to(device)
        imgs = to_unit(generator(z1, z2, w_psi=cfg.w_psi))
        save_image_grid(imgs, os.path.join(folder, f"{count:04d}_images.jpg"), nrow=1, padding=0)


@torch.inference_mode()
def demo_frames(
    cfg: Config,
    generator: torch.nn.Module,
    device: torch.device,
    latent: np.ndarray,
    controlled_dim: int,
    num_explore: int = 30,
) -> List[np.ndarray]:
    """The frames of one demo video of ``latent`` ((local_b, geo + app
    noise dims)): its ``controlled_dim`` swept up by ``num_explore`` steps
    of 2·psi/num_explore, then down as many. The endpoint arithmetic is the
    reference's (worker.py:456-472): the code starts at −psi − interval and
    steps before each frame, so the up-pass tops out at +psi − interval and
    the down-pass ends at −psi − interval. Each frame is a grid of
    ⌊√local_b⌋ images a row, uint8."""
    latent = np.array(latent, np.float32)  # a copy: the sweep writes into it
    interval = cfg.psi * 2.0 / num_explore
    latent[:, controlled_dim] = -cfg.psi - interval
    nrow = max(int(latent.shape[0] ** 0.5), 1)
    frames = []
    for direction in (+1.0, -1.0):
        for _ in range(num_explore):
            latent[:, controlled_dim] += direction * interval
            z = torch.from_numpy(latent).to(device)
            img = to_unit(generator(z[:, : cfg.geo_noise_dim], z[:, cfg.geo_noise_dim :], w_psi=cfg.w_psi))
            frames.append(to_uint8(make_grid(img, nrow=nrow, padding=0)))
    return frames


def demo_generation(
    cfg: Config,
    generator: torch.nn.Module,
    device: torch.device,
    controlled_dim: int = 0,
    num_video: int = 1,
    num_explore: int = 30,
):
    """``num_video`` sweeps of ``controlled_dim`` → ``<model_name>/demo/
    controlled_dim=<d>_<n>.mp4`` at ``num_explore`` frames/s
    (worker.py:447-485). Each video's latent ((local_b, geo + app noise
    dims), standard normal) is drawn on the CPU from a ``torch.Generator``
    seeded by ``cfg.seed``."""
    rng = torch.Generator().manual_seed(cfg.seed)
    folder = cfg.run_dirs()["demo"]
    os.makedirs(folder, exist_ok=True)
    total_dim = cfg.geo_noise_dim + cfg.app_noise_dim
    for n in range(num_video):
        latent = torch.randn((local_batch(cfg), total_dim), generator=rng).numpy()
        frames = demo_frames(cfg, generator, device, latent, controlled_dim, num_explore)
        save_video(frames, os.path.join(folder, f"controlled_dim={controlled_dim}_{n}.mp4"), fps=num_explore)


@torch.no_grad()
def monitor_current_result(
    cfg: Config,
    generator: torch.nn.Module,
    device: torch.device,
    epoch: int = 0,
    num_explore: int = 10,
    w_psi: float = 0.7,
    nrow: int = 8,
    images_per_output: int = 32,
    num_clips: int = 5,
    disp_resolution: int = 128,
):
    """Per-dim sweep mp4s with the EMA generator (worker.py:255-363).

    For each group of ``images_per_output`` dims, render ``num_clips`` clips;
    each clip sweeps sample j's dim (group*ipo + j) from -psi to +psi and
    back, with a fresh code of the other modality per clip. Writes
    ``<samples>/{geometry,appearance}_<epoch>_<group>.mp4``.
    """
    rng = torch.Generator().manual_seed(cfg.seed + epoch)
    samples_dir = cfg.run_dirs()["samples"]
    os.makedirs(samples_dir, exist_ok=True)

    def sweep(noise_dim_swept: int, other_dim: int, swept_is_geo: bool, tag: str):
        ipo = min(images_per_output, noise_dim_swept)
        for group in range(noise_dim_swept // ipo):
            mult_frames = []
            for _ in range(num_clips):
                start = torch.randn((ipo, noise_dim_swept), generator=rng).numpy()
                end = start.copy()
                other = torch.randn((ipo, other_dim), generator=rng).to(device)
                for j in range(ipo):
                    idx = group * ipo + j
                    start[j, idx] = -cfg.psi
                    end[j, idx] = cfg.psi
                frames = []
                for seq_start, seq_end in ((start, end), (end, start)):
                    for j in range(num_explore):
                        t = j / num_explore
                        z = torch.from_numpy(seq_start + (seq_end - seq_start) * t).to(device)
                        img = generator(z, other, w_psi=w_psi) if swept_is_geo else generator(other, z, w_psi=w_psi)
                        canvas = make_grid(to_unit(img), nrow=nrow, padding=0)
                        frames.append(resize_frame(canvas, (disp_resolution * ipo // nrow, disp_resolution * nrow)))
                mult_frames.extend(frames * 2)  # worker.py:307
            save_video(mult_frames, os.path.join(samples_dir, f"{tag}_{epoch}_{group}.mp4"), fps=15)

    sweep(cfg.geo_noise_dim, cfg.app_noise_dim, True, "geometry")
    sweep(cfg.app_noise_dim, cfg.geo_noise_dim, False, "appearance")
