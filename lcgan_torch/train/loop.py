"""Phase orchestration and the train loop (loader.py:22-110), PyTorch port
of ``lcgan_tpu.train.loop``.

One process per device: the card the run was given (``cuda:LOCAL_RANK``
under ``torchrun``) or the CPU when asked. Under ``torchrun`` (or
``--distributed on``) the ranks join one process group for the phase
(``lcgan_torch.parallel``): each reads its shard of the global
``--batch_size``, the train step averages gradients across them, and rank 0
alone writes the run directory, with barriers after the monitor and the
save (lcgan_tpu/train/loop.py:125,137). The file contract is the JAX
package's: ``args.txt``, ``epoch.txt``, ``log.txt`` (the exact line of
loader.py:64-66), ``samples/``, ``model/`` (here ``model/state.pt`` and
``model/state_best.pt``), ``fakes/``, ``demo/``, ``fid.txt`` and
``best_fid.txt``.

``--profile_dir`` traces the JAX package's window (lcgan_tpu/train/loop.py:85-99),
counted from the start epoch: ``torch.profiler`` (the CPU and, on the card,
CUDA activity) from epoch start+12 to min(start+20, ``--epoch``), each
iteration under a ``train_iteration epoch N`` range, the device
synchronized before it stops. Each rank writes its Chrome trace as
``<profile_dir>/trace_epochs_<first>-<last>_rank<r>.json``. A run that ends
before the window traces nothing.
"""

from __future__ import annotations

import contextlib
import os
from datetime import datetime
from typing import Iterator, Optional, Tuple

import torch

from lcgan_torch import parallel
from lcgan_torch.config import Config, resolve_device
from lcgan_torch.data.dataset import DeviceFeeder, ImageFolderDataset, Prefetcher, TrainInputPipeline
from lcgan_torch.gen.artifacts import demo_generation, fake_image_generation, monitor_current_result
from lcgan_torch.models.generator import Generator, build_generator
from lcgan_torch.train.state import TrainState
from lcgan_torch.train.steps import Trainer
from lcgan_torch.utils.checkpoint import (
    load_state,
    read_epoch_file,
    save_checkpoint,
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


def load_ema_generator(cfg: Config, device: torch.device, checkpoint: Optional[dict] = None) -> Generator:
    """The EMA generator of ``checkpoint`` (a loaded ``state.pt``; by default
    the run's, or ``state_best.pt`` under ``--best``), on ``device`` in
    channels_last, in eval mode."""
    if checkpoint is None:
        checkpoint = read_checkpoint(cfg)
    generator = build_generator(cfg)
    generator.load_state_dict(checkpoint["ema"])
    return generator.to(device=device, memory_format=torch.channels_last).eval()


def read_checkpoint(cfg: Config) -> dict:
    """The run's full-state checkpoint as a dict of CPU tensors."""
    path = state_path(cfg, best=cfg.best)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path} (run the train phase first)")
    return torch.load(path, map_location="cpu", weights_only=True)


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
        if parallel.rank() == 0:
            print(f"restart training from: {start_epoch}")
    return state, start_epoch


def make_train_pipeline(cfg: Config, device: torch.device) -> DeviceFeeder:
    """This rank's shard of the run's image folder on ``device``: decoded and
    augmented by worker threads, two batches ahead, and copied to the card
    one ahead."""
    dataset = ImageFolderDataset(cfg.dataset_path, cfg.img_resolution, is_train=True, seed=cfg.seed)
    if parallel.rank() == 0:
        print(f"Train dataset size: {len(dataset)}")
    pipeline = TrainInputPipeline(
        dataset,
        batch_size=cfg.batch_size,
        process_index=parallel.rank(),
        process_count=parallel.world_size(),
        num_workers=cfg.num_data_workers,
        seed=cfg.seed,
        pin_memory=device.type == "cuda",
    )
    return DeviceFeeder(Prefetcher(pipeline, depth=2), device)


class EpochProfiler:
    """The ``--profile_dir`` window of a run that starts at ``start_epoch``."""

    def __init__(self, cfg: Config, start_epoch: int, device: torch.device):
        self.dir = cfg.profile_dir
        self.first = start_epoch + 12  # past the first calls (the JAX package's compiles)
        self.last = min(self.first + 8, cfg.epoch)
        self.device = device
        self.prof = None

    @contextlib.contextmanager
    def iteration(self, epoch: int) -> Iterator[None]:
        """Around the iteration of ``epoch``: starts the trace at the
        window's first epoch, stops it after its last."""
        if self.dir and epoch == self.first:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
        if self.prof is None:
            yield
            return
        with torch.profiler.record_function(f"train_iteration epoch {epoch}"):
            yield
        if epoch >= self.last:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.prof.stop()
            os.makedirs(self.dir, exist_ok=True)
            self.prof.export_chrome_trace(
                os.path.join(self.dir, f"trace_epochs_{self.first}-{self.last}_rank{parallel.rank()}.json"))
            self.prof, self.dir = None, ""


def train(cfg: Config) -> TrainState:
    cfg.validate()
    cfg.make_run_dirs()
    main = parallel.rank() == 0
    if main:
        cfg.dump(os.path.join(cfg.model_name, "args.txt"))  # loader.py:27-28

    with deterministic_algorithms():
        trainer = Trainer(cfg)
        state, epoch = load_or_init_state(cfg, trainer)
        data = make_train_pipeline(cfg, trainer.device)
        profiler = EpochProfiler(cfg, epoch, trainer.device)
        start_time = datetime.now()
        while epoch <= cfg.epoch:
            batch = next(data)
            with profiler.iteration(epoch):
                state, g_loss, d_loss = trainer.train_iteration(state, batch, epoch)

            if epoch % cfg.print_interval == 0 and main:
                g, d = g_loss.item(), d_loss.item()  # averaged over the ranks
                elapsed = str(datetime.now() - start_time).split(".")[0]
                mode = "w" if epoch == 0 else "a"
                with open(os.path.join(cfg.model_name, "log.txt"), mode) as f:
                    f.write(f"epoch:{epoch}, elapsed:{elapsed}, g_loss:{g:.6f}, d_loss:{d:.6f} \n")

            if epoch % cfg.show_interval == 0 and epoch > 0:
                if main:
                    # images_per_output=geo_noise_dim: the reference's training
                    # loop overrides the worker.py:255 default of 32 with
                    # args.geo_noise_dim at loader.py:72
                    monitor_current_result(cfg, state.ema, trainer.device, epoch=epoch, num_explore=20,
                                           w_psi=cfg.w_psi, images_per_output=cfg.geo_noise_dim)
                parallel.barrier()  # loader.py:73

            if epoch % cfg.save_interval == 0 and epoch > 0:
                if main:  # every rank holds the same state
                    print("save model")
                    save_state(state_path(cfg), state)
                    write_epoch_file(cfg.model_name, epoch)
                parallel.barrier()  # loader.py:80

            epoch += 1
    return state


def fid_eval(cfg: Config, device: torch.device, checkpoint: dict) -> float:
    """FID of ``checkpoint``'s EMA generator; a new best FID snapshots the
    evaluated state as ``state_best.pt`` (lcgan_tpu/train/loop.py:157-184)."""
    from lcgan_torch.eval.fid import fid_evaluate

    fid_value = fid_evaluate(cfg, load_ema_generator(cfg, device, checkpoint), device)
    if parallel.rank() == 0:  # every rank computed the same value from the gathered features
        # fixes the reference's os.path.join(..., 'fid.txt', 'w') bug (loader.py:91)
        with open(os.path.join(cfg.model_name, "fid.txt"), "w") as f:
            f.write(f"FID:{fid_value} \n")
        best_path = os.path.join(cfg.model_name, "best_fid.txt")
        best = float("inf")
        if os.path.exists(best_path):
            with open(best_path) as f:
                best = float(f.read().strip())
        if fid_value < best:
            print("save best model")
            save_checkpoint(state_path(cfg, best=True), checkpoint)
            with open(best_path, "w") as f:
                f.write(str(fid_value))
    parallel.barrier()
    return fid_value


def video_generation(cfg: Config, generator: Generator, device: torch.device) -> None:
    """Demo videos of one latent dimension, or of every one, geometry then
    appearance, under ``--ctrl_dim -1`` (loader.py:101-110)."""
    dims = range(cfg.geo_noise_dim + cfg.app_noise_dim) if cfg.ctrl_dim == -1 else [cfg.ctrl_dim]
    for d in dims:
        demo_generation(cfg, generator, device, controlled_dim=d, num_video=cfg.num_videos)


def run_phase(cfg: Config):
    """Top-level phase dispatch (loader.py:26,84,95,101), inside the process
    group of a ``torchrun`` launch (``--distributed``), which is destroyed
    at the end of the phase. Generation runs on rank 0 alone."""
    if cfg.phase not in Config.PHASES:
        raise ValueError(f"unknown phase: {cfg.phase}")
    device = resolve_device(cfg.device)
    with parallel.process_group(cfg.distributed, device.type):
        if cfg.phase == "train":
            return train(cfg)
        checkpoint = read_checkpoint(cfg)  # on every rank: none raises FileNotFoundError
        if cfg.phase == "fid_eval":
            return fid_eval(cfg, device, checkpoint)
        if parallel.rank() == 0:
            generator = load_ema_generator(cfg, device, checkpoint)
            if cfg.phase == "fake_image_generation":
                fake_image_generation(cfg, generator, device)
            else:
                video_generation(cfg, generator, device)
    return None
