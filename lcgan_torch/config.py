"""Run configuration of the PyTorch port.

The same fields, defaults and ``args.txt`` JSON as ``lcgan_tpu.config`` (the
33 reference flags plus the JAX package's extensions), so a run directory
written by either package reloads in the other. The one new field is
``device``. ``warp_impl`` and ``warp_pallas_min_res`` pick each synthesis
block's warp route on the card as they pick the JAX package's (the
small-map kernels where its Pallas entry would take them, else the general
kernels; ``ops.warp.small_route``); on the CPU the warp is the plain
version either way. ``warp_impl`` "none" is the JAX package's diagnostic
ablation: the synthesis blocks skip the warp. ``distributed`` joins the
process group of a ``torchrun`` launch (``lcgan_torch.parallel``).
``view_batched_steps``, ``beta1`` and ``profile_dir`` act as in the JAX
package (``train.steps``, ``train.state``, ``train.loop``), and so do the
remat switches (``models.generator``, ``models.discriminator``,
``utils.remat``), with one default changed: ``remat_blocks`` is off, since
every reference recipe fits an 80 GB card at its per-GPU batch without it.
``warp_adaptive_band`` is kept only so that ``args.txt`` round-trips: it
picks the JAX Pallas warp's band windows, which do not change its output,
and the port's kernels are exact on any grid with no band.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional

import torch

from lcgan_torch.parallel import local_rank


@dataclasses.dataclass
class Config:
    # --- phase control (main.py:16-17) ---
    phase: str = "train"  # train | fid_eval | fake_image_generation | video_generation
    best: bool = False

    # --- loss weights (main.py:19-23) ---
    tau: float = 0.05
    l_adv: float = 1.0
    l_aux: float = 0.5
    l_r1: float = 10.0
    l_s: float = 1e-7

    # --- latent geometry (main.py:25-31) ---
    max_flow_scale: float = 0.1
    geo_noise_dim: int = 64
    app_noise_dim: int = 64
    geo_projection_dim: int = 256
    app_projection_dim: int = 256
    geo_latent_dim: int = 64
    app_latent_dim: int = 512

    # --- schedule (main.py:33-42) ---
    epoch: int = 100000  # per the reference, an "epoch" is one iteration
    batch_size: int = 32  # global batch, split across data-parallel devices
    g_lr: float = 0.002
    d_lr: float = 0.002
    beta1: float = 0.0
    beta2: float = 0.99
    g_ema_decay: float = 0.9999
    g_ema_start: int = 0
    freezeD_start: int = 100000
    freezeD_layer: int = 5

    # --- image / truncation (main.py:44-47) ---
    img_resolution: int = 256
    img_ch: int = 3
    psi: float = 2.0
    w_psi: float = 1.0

    # --- paths (main.py:49-52) ---
    dataset_path: str = "./"
    model_name: str = ""
    save_dir: str = "model"
    sample_dir: str = "samples"

    # --- generation (main.py:54-56) ---
    num_fakes: int = 10
    ctrl_dim: int = -1
    num_videos: int = 10

    # --- intervals (main.py:58-60) ---
    save_interval: int = 5000
    print_interval: int = 100
    show_interval: int = 1000

    # --- extensions shared with lcgan_tpu (not in the reference) ---
    compute_dtype: str = "bfloat16"  # conv compute dtype; params stay fp32
    seed: int = 0
    base_nf: Optional[int] = None  # override channel base (tests / tiny models)
    max_nf: int = 512
    mbstd_group_size: int = 8
    num_data_workers: int = 4
    inception_weights: str = ""
    adam_eps: float = 1e-8
    # off, where the JAX package defaults to on for a v5e's 16G HBM: the
    # recipes' per-GPU batches fit an H100 without it (13.93, 24.86 and
    # 25.67 GiB at 256², 512² and 1024²). Only memory and time depend on it.
    remat_blocks: bool = False
    remat_save_g_convs: bool = True
    remat_save_max_res: int = 1024
    remat_save_d_convs: bool = True
    profile_dir: str = ""
    distributed: str = "auto"
    warp_impl: str = "auto"
    warp_pallas_min_res: int = 128
    warp_adaptive_band: bool = True
    view_batched_steps: bool = False

    # --- the port's own ---
    device: str = "cuda"  # entry points raise if "cuda" and no GPU is present

    # ------------------------------------------------------------------
    @property
    def resolved_base_nf(self) -> int:
        """Channel base per resolution (cnn.py:17, cnn.py:54)."""
        if self.base_nf is not None:
            return self.base_nf
        return 32 if self.img_resolution == 1024 else 64 if self.img_resolution == 512 else 128

    @property
    def num_blocks(self) -> int:
        """log2(resolution) - 2, 4×4 base (cnn.py:13, cnn.py:52)."""
        return int(math.log2(self.img_resolution)) - 2

    @property
    def dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.compute_dtype]

    # ------------------------------------------------------------------
    def run_dirs(self) -> dict:
        """Run-directory layout matching check_args (main.py:70-95)."""
        return {
            "root": self.model_name,
            "model": os.path.join(self.model_name, self.save_dir),
            "samples": os.path.join(self.model_name, self.sample_dir),
            "fakes": os.path.join(self.model_name, "fakes"),
            "demo": os.path.join(self.model_name, "demo"),
        }

    def make_run_dirs(self):
        d = self.run_dirs()
        for key in ("root", "model", "samples"):
            os.makedirs(d[key], exist_ok=True)

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields})

    PHASES = ("train", "fid_eval", "fake_image_generation", "video_generation")

    def validate(self):
        if self.phase not in self.PHASES:
            raise ValueError(f"unknown phase {self.phase!r}; expected one of {self.PHASES}")
        if not self.model_name:
            raise ValueError("model name must be given")  # main.py:73-75
        if self.epoch < 1:
            raise ValueError("number of epochs must be >= 1")  # main.py:84-87
        if self.batch_size < 1:
            raise ValueError("batch size must be >= 1")  # main.py:90-93
        res = self.img_resolution
        if res < 8 or (res & (res - 1)) != 0:
            raise ValueError(f"img_resolution must be a power of two >= 8, got {res}")
        if self.warp_impl not in ("auto", "pallas", "banded", "none"):
            raise ValueError(
                f"warp_impl must be one of auto|pallas|banded|none, got {self.warp_impl!r}"
            )
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"compute_dtype must be bfloat16 or float32, got {self.compute_dtype!r}"
            )
        for name in ("save_interval", "print_interval", "show_interval"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1 (the train loop takes `step % {name}`)")
        if self.distributed not in ("auto", "on", "off"):
            raise ValueError(f"distributed must be auto|on|off, got {self.distributed!r}")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {self.device!r}")


def resolve_device(name: str) -> torch.device:
    """The run's device: ``cuda:LOCAL_RANK`` (the process's GPU under
    ``torchrun``; GPU 0 otherwise) or the CPU. ``cuda`` without a GPU
    raises: nothing falls back to the CPU unless the caller asked for it."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
        return torch.device("cuda", local_rank())
    return torch.device(name)
