"""The port's full-state checkpoint and the run directory's resume sidecar
(worker.py:219-253, loader.py:36-42,75-80).

One ``torch.save`` file under ``<model_name>/<save_dir>/``: ``state.pt``
(``state_best.pt`` for the best-FID snapshot) holding the whole
``TrainState`` as ``TrainState.state_dict`` gives it: G, D and EMA
parameters and buffers, both Adam ``v`` trees and counts, ``step`` and the
noise generator's state. Restoring it into a freshly built state resumes
bit for bit. ``<model_name>/epoch.txt`` holds the last saved epoch.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from lcgan_torch.config import Config


def state_path(cfg: Config, best: bool = False) -> str:
    return os.path.join(cfg.run_dirs()["model"], "state_best.pt" if best else "state.pt")


def save_state(path: str, state) -> None:
    """Write ``state`` (a ``TrainState``) to ``path`` atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)


def load_state(path: str, state) -> None:
    """Restore the checkpoint at ``path`` into ``state`` (built from the
    same config), in place."""
    state.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def load_generator_state(path: str, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The state_dict of the EMA (or raw) generator stored at ``path``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["ema" if use_ema else "generator"]


def read_epoch_file(model_name: str) -> Optional[int]:
    p = os.path.join(model_name, "epoch.txt")
    if os.path.exists(p):
        with open(p) as f:
            return int(f.read().strip())
    return None


def write_epoch_file(model_name: str, epoch: int) -> None:
    with open(os.path.join(model_name, "epoch.txt"), "w") as f:
        f.write(str(epoch))
