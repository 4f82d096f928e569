"""The port's full-state checkpoint and the run directory's resume sidecar
(worker.py:219-253, loader.py:36-42,75-80).

One ``torch.save`` file under ``<model_name>/<save_dir>/``: ``state.pt``
(``state_best.pt`` for the best-FID snapshot) holding the whole
``TrainState`` as ``TrainState.state_dict`` gives it: G, D and EMA
parameters and buffers, both Adam ``v`` trees and counts, ``step`` and the
noise generator's state. Restoring it into a freshly built state resumes
bit for bit. ``<model_name>/epoch.txt`` holds the last saved epoch. Under
data parallelism every rank holds the same state (its noise stream
included: the ranks share one stream, ``train.steps``), and rank 0 alone
writes it, so the layout is the same at every world size.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from lcgan_torch.config import Config


def state_path(cfg: Config, best: bool = False) -> str:
    return os.path.join(cfg.run_dirs()["model"], "state_best.pt" if best else "state.pt")


def save_checkpoint(path: str, checkpoint: dict) -> None:
    """Write ``checkpoint`` (a ``TrainState.state_dict()``) to ``path`` atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(checkpoint, tmp)
    os.replace(tmp, path)


def save_state(path: str, state) -> None:
    """Write ``state`` (a ``TrainState``) to ``path`` atomically."""
    save_checkpoint(path, state.state_dict())


def load_state(path: str, state) -> None:
    """Restore the checkpoint at ``path`` into ``state`` (built from the
    same config), in place."""
    state.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def read_epoch_file(model_name: str) -> Optional[int]:
    p = os.path.join(model_name, "epoch.txt")
    if os.path.exists(p):
        with open(p) as f:
            return int(f.read().strip())
    return None


def write_epoch_file(model_name: str, epoch: int) -> None:
    with open(os.path.join(model_name, "epoch.txt"), "w") as f:
        f.write(str(epoch))
