"""Fresh-process half of the port's bit-exact resume test
(tests/test_torch_train_phase.py), in the pattern of tests/resume_worker.py.

Builds the trainer from the config, restores ``<run>/model/state.pt``
(saved by the parent after N epochs), trains epochs N..M-1 on the same
seeded fake batches, and saves the state to ``<run>/model_resumed/state.pt``.
The parent compares it bitwise to an uninterrupted run. Imports no JAX.

Usage: python torch_resume_worker.py <model_name> <start_epoch> <end_epoch> [beta1]
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the repo root

from lcgan_torch.config import Config  # noqa: E402
from lcgan_torch.train.loop import deterministic_algorithms  # noqa: E402
from lcgan_torch.train.steps import Trainer  # noqa: E402
from lcgan_torch.utils.checkpoint import load_state, save_state, state_path  # noqa: E402

# the dryrun width (__graft_entry__.py:64-82) in fp32, frozen from epoch 6
CFG = dict(img_resolution=32, batch_size=4, geo_noise_dim=8, app_noise_dim=8, geo_latent_dim=8, app_latent_dim=16,
           geo_projection_dim=8, app_projection_dim=8, base_nf=8, max_nf=16, mbstd_group_size=2,
           compute_dtype="float32", freezeD_start=6, freezeD_layer=1, device="cpu")


def fake_batch(cfg: Config, epoch: int) -> dict:
    g = torch.Generator().manual_seed(epoch)
    shape = (cfg.batch_size, 3, cfg.img_resolution, cfg.img_resolution)
    return {k: torch.rand(shape, generator=g) * 2 - 1 for k in ("image", "geometry_change", "appearance_change")}


def main(model_name: str, start_epoch: int, end_epoch: int, beta1: float = 0.0) -> None:
    cfg = Config(model_name=model_name, **CFG, beta1=beta1)
    with deterministic_algorithms():
        trainer = Trainer(cfg)
        state = trainer.init_state()
        load_state(state_path(cfg), state)
        for epoch in range(start_epoch, end_epoch):
            state, _, _ = trainer.train_iteration(state, fake_batch(cfg, epoch), epoch)
    save_state(os.path.join(model_name, "model_resumed", "state.pt"), state)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *map(float, sys.argv[4:5]))
