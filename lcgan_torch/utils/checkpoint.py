"""The port's generator checkpoint.

One ``torch.save`` file under ``<model_name>/<save_dir>/``: ``generator.pt``
(``generator_best.pt`` for the best-FID snapshot) holding
``{g_params, g_stats, ema_params, ema_stats}``, each a state_dict-keyed dict
of CPU tensors (parameters, and buffers: the w-avg stats). The full train
state (D, Adam, RNG, step) comes with the training slice.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch
from torch import nn

from lcgan_torch.config import Config


def checkpoint_path(cfg: Config, best: bool = False) -> str:
    name = "generator_best.pt" if best else "generator.pt"
    return os.path.join(cfg.run_dirs()["model"], name)


def split_state(module: nn.Module) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params, stats) of a module as CPU tensors."""
    params = {k: v.detach().cpu() for k, v in module.named_parameters()}
    stats = {k: v.detach().cpu() for k, v in module.named_buffers()}
    return params, stats


def save_generator(path: str, generator: nn.Module, ema: nn.Module):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    g_params, g_stats = split_state(generator)
    ema_params, ema_stats = split_state(ema)
    tmp = path + ".tmp"
    torch.save(
        {"g_params": g_params, "g_stats": g_stats, "ema_params": ema_params, "ema_stats": ema_stats},
        tmp,
    )
    os.replace(tmp, path)


def load_generator_state(path: str, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The state_dict of the EMA (or raw) generator stored at ``path``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    prefix = "ema" if use_ema else "g"
    return {**ckpt[f"{prefix}_params"], **ckpt[f"{prefix}_stats"]}
