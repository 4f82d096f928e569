"""Fake-image generation (worker.py:427-441), PyTorch port of the matching
phase of ``lcgan_tpu.gen.artifacts``. Demo videos and the training monitor
come with later slices of the port."""

from __future__ import annotations

import os

import numpy as np
import torch

from lcgan_torch.config import Config
from lcgan_torch.utils.media import save_image_grid


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
