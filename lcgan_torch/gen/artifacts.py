"""Fake-image generation (worker.py:427-441) and the training monitor
(worker.py:255-363), PyTorch port of ``lcgan_tpu.gen.artifacts``. Demo
videos come with a later slice of the port.

Both run the EMA generator in eval mode, so its w-avg buffers stay as they
are (the JAX package discards that mutation). Codes are drawn on the CPU
from a ``torch.Generator`` seeded by the config, so a seed gives the same
codes on every device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lcgan_torch.config import Config
from lcgan_torch.utils.media import make_grid, resize_frame, save_image_grid, save_video


def to_unit(img: torch.Tensor) -> np.ndarray:
    """[-1,1] NCHW model output -> float [0,1] NHWC numpy (worker.py:435)."""
    return ((img.float() + 1.0) * 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1).cpu().numpy()


def device_count(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


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
    local_b = max(cfg.batch_size // device_count(device), 1)
    for count in range(cfg.num_fakes):
        z1 = torch.randn((local_b, cfg.geo_noise_dim), generator=rng).to(device)
        z2 = torch.randn((local_b, cfg.app_noise_dim), generator=rng).to(device)
        imgs = to_unit(generator(z1, z2, w_psi=cfg.w_psi))
        save_image_grid(imgs, os.path.join(folder, f"{count:04d}_images.jpg"), nrow=1, padding=0)


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
