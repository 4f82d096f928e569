"""Phase orchestration and the train loop (loader.py:22-110), PyTorch port
of ``lcgan_tpu.train.loop``.

One process on one device: the card the run was given (or the CPU when
asked). The global batch is that device's batch until data parallelism
lands. The file contract is the JAX package's: ``args.txt``, ``epoch.txt``,
``log.txt`` (the exact line of loader.py:64-66), ``samples/``, ``model/``
(here ``model/state.pt``), ``fakes/``.

This slice of the port serves ``train`` and ``fake_image_generation``;
``fid_eval`` and ``video_generation`` raise until their slice lands.
"""

from __future__ import annotations

import contextlib
import os
from datetime import datetime
from typing import Iterator, Tuple

import torch

from lcgan_torch.config import Config, resolve_device
from lcgan_torch.data.dataset import DeviceFeeder, ImageFolderDataset, Prefetcher, TrainInputPipeline
from lcgan_torch.gen.artifacts import fake_image_generation, monitor_current_result
from lcgan_torch.models.generator import Generator, build_generator
from lcgan_torch.train.state import TrainState
from lcgan_torch.train.steps import Trainer
from lcgan_torch.utils.checkpoint import (
    load_generator_state,
    load_state,
    read_epoch_file,
    save_state,
    state_path,
    write_epoch_file,
)


@contextlib.contextmanager
def deterministic_algorithms() -> Iterator[None]:
    """Deterministic kernels for the block, as a bit-exact resume needs:
    ``torch.use_deterministic_algorithms(True)``, no cuDNN autotuning, and
    the cuBLAS workspace setting that deterministic cuBLAS requires (set
    here unless the environment has it; it takes effect only if no CUDA call
    ran before). The previous settings come back on exit."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.benchmark = before[1]


def load_ema_generator(cfg: Config, device: torch.device) -> Generator:
    """The checkpoint's EMA generator, on ``device`` in channels_last, in eval mode."""
    path = state_path(cfg, best=cfg.best)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path} (run the train phase first)")
    generator = build_generator(cfg)
    generator.load_state_dict(load_generator_state(path, use_ema=True))
    return generator.to(device=device, memory_format=torch.channels_last).eval()


def load_or_init_state(cfg: Config, trainer: Trainer) -> Tuple[TrainState, int]:
    """Resume from the checkpoint if there is one (loader.py:36-42).

    The checkpoint alone decides whether weights are restored; epoch.txt only
    gates the resume epoch."""
    state = trainer.init_state()
    path = state_path(cfg, best=cfg.best)
    start_epoch = 0
    if os.path.exists(path):
        load_state(path, state)
        last_epoch = read_epoch_file(cfg.model_name)
        if last_epoch is not None:
            start_epoch = last_epoch + 1
        print(f"restart training from: {start_epoch}")
    return state, start_epoch


def make_train_pipeline(cfg: Config, device: torch.device) -> DeviceFeeder:
    """Batches of the run's image folder on ``device``: decoded and augmented
    by worker threads, two batches ahead, and copied to the card one ahead."""
    dataset = ImageFolderDataset(cfg.dataset_path, cfg.img_resolution, is_train=True, seed=cfg.seed)
    print(f"Train dataset size: {len(dataset)}")
    pipeline = TrainInputPipeline(
        dataset,
        batch_size=cfg.batch_size,
        num_workers=cfg.num_data_workers,
        seed=cfg.seed,
        pin_memory=device.type == "cuda",
    )
    return DeviceFeeder(Prefetcher(pipeline, depth=2), device)


def train(cfg: Config) -> TrainState:
    cfg.validate()
    cfg.make_run_dirs()
    cfg.dump(os.path.join(cfg.model_name, "args.txt"))  # loader.py:27-28

    with deterministic_algorithms():
        trainer = Trainer(cfg)
        state, epoch = load_or_init_state(cfg, trainer)
        data = make_train_pipeline(cfg, trainer.device)
        start_time = datetime.now()
        while epoch <= cfg.epoch:
            state, g_loss, d_loss = trainer.train_iteration(state, next(data), epoch)

            if epoch % cfg.print_interval == 0:
                g, d = g_loss.item(), d_loss.item()
                elapsed = str(datetime.now() - start_time).split(".")[0]
                mode = "w" if epoch == 0 else "a"
                with open(os.path.join(cfg.model_name, "log.txt"), mode) as f:
                    f.write(f"epoch:{epoch}, elapsed:{elapsed}, g_loss:{g:.6f}, d_loss:{d:.6f} \n")

            if epoch % cfg.show_interval == 0 and epoch > 0:
                # images_per_output=geo_noise_dim: the reference's training
                # loop overrides the worker.py:255 default of 32 with
                # args.geo_noise_dim at loader.py:72
                monitor_current_result(cfg, state.ema, trainer.device, epoch=epoch, num_explore=20,
                                       w_psi=cfg.w_psi, images_per_output=cfg.geo_noise_dim)

            if epoch % cfg.save_interval == 0 and epoch > 0:
                print("save model")
                save_state(state_path(cfg), state)
                write_epoch_file(cfg.model_name, epoch)

            epoch += 1
    return state


def run_phase(cfg: Config):
    """Top-level phase dispatch (loader.py:26,84,95,101)."""
    if cfg.phase == "train":
        return train(cfg)
    if cfg.phase != "fake_image_generation":
        raise NotImplementedError(f"phase {cfg.phase!r} lands in a later slice of the port")
    device = resolve_device(cfg.device)
    generator = load_ema_generator(cfg, device)
    fake_image_generation(cfg, generator, device)
    return None
