"""Phase dispatch (loader.py:22-110), PyTorch port of ``lcgan_tpu.train.loop``.

This slice of the port serves ``fake_image_generation``; every other phase
raises until its slice lands.
"""

from __future__ import annotations

import os

import torch

from lcgan_torch.config import Config, resolve_device
from lcgan_torch.gen.artifacts import fake_image_generation
from lcgan_torch.models.generator import Generator, build_generator
from lcgan_torch.utils.checkpoint import checkpoint_path, load_generator_state


def load_ema_generator(cfg: Config, device: torch.device) -> Generator:
    """The checkpoint's EMA generator, on ``device`` in channels_last, in eval mode."""
    path = checkpoint_path(cfg, best=cfg.best)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path} (run the train phase first)")
    generator = build_generator(cfg)
    generator.load_state_dict(load_generator_state(path, use_ema=True))
    return generator.to(device=device, memory_format=torch.channels_last).eval()


def run_phase(cfg: Config):
    """Top-level phase dispatch (loader.py:26,84,95,101)."""
    if cfg.phase != "fake_image_generation":
        raise NotImplementedError(f"phase {cfg.phase!r} lands in a later slice of the port")
    device = resolve_device(cfg.device)
    generator = load_ema_generator(cfg, device)
    fake_image_generation(cfg, generator, device)
