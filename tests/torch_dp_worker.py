"""One rank of the port's data-parallel tests (tests/test_torch_parallel.py):
a gloo process group on the CPU, joined through ``lcgan_torch.parallel`` from
the environment that ``torchrun`` would set. Imports no JAX.

    python torch_dp_worker.py collectives <rank> <world> <port> <dir>
    python torch_dp_worker.py noise <rank> <world> <port> <dir>
    python torch_dp_worker.py train <rank> <world> <port> <dir> [--epochs 0,1,3,5] [--init state.pt]
        [--inputs inputs.pt] [--save-state] [--plain-first] [--tag name]

``noise`` draws two iterations' noise for the local batch from a stream
seeded by ``dir/cfg.json``'s seed and writes ``dir/noise_r<rank>.pt`` with
the draws and the stream's state after them.
``train`` builds the trainer from ``dir/cfg.json``, restores ``--init`` (a
``state.pt``) if given, and runs the epochs on this rank's rows of each
global batch: the batches and per-rank noise of ``--inputs`` where given,
else ``torch_resume_worker.fake_batch`` and the state's own noise stream.
It writes ``dir/<tag>_r<rank>.pt`` with each epoch's losses and state.
``--save-state``: rank 0 writes the final state to the run's ``state.pt``.
``--plain-first``: the same epochs first without a process group (tag
``plain``), then with one.
"""

import argparse
import json
import os
import sys
from types import SimpleNamespace

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the repo root
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_resume_worker import fake_batch  # noqa: E402

from lcgan_torch import parallel  # noqa: E402
from lcgan_torch.config import Config  # noqa: E402
from lcgan_torch.train.loop import deterministic_algorithms  # noqa: E402
from lcgan_torch.train.steps import Trainer  # noqa: E402
from lcgan_torch.utils.checkpoint import load_state, save_state, state_path  # noqa: E402


def torchrun_env(rank: int, world: int, port: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def collectives(d: str) -> None:
    r, w = parallel.rank(), parallel.world_size()
    g = torch.Generator().manual_seed(r)
    tensors = [torch.randn(3, generator=g), torch.randn(2, 3, 4, 5, generator=g).contiguous(
        memory_format=torch.channels_last), torch.randn((), generator=g)]
    before = [t.clone() for t in tensors]
    parallel.mean_all_reduce(tensors)
    try:
        parallel.mean_all_reduce([torch.zeros(2), torch.zeros(2, dtype=torch.float64)])
        mixed = "accepted"
    except TypeError as e:
        mixed = str(e)
    rows = parallel.all_gather_rows((torch.arange(6.0).reshape(2, 3) + 10 * r).double().numpy())
    parallel.barrier()
    torch.save(dict(rank=r, world=w, before=before, after=tensors,
                    channels_last=tensors[1].is_contiguous(memory_format=torch.channels_last),
                    mixed=mixed, rows=torch.from_numpy(rows)), os.path.join(d, f"collectives_r{r}.pt"))


def noise(cfg: Config, d: str) -> None:
    r, w = parallel.rank(), parallel.world_size()
    trainer = Trainer(cfg)
    state = SimpleNamespace(rng=torch.Generator().manual_seed(cfg.seed))  # all draw_noise reads
    draws = [trainer.draw_noise(state, cfg.batch_size // w) for _ in range(2)]
    torch.save(dict(world=w, draws=draws, rng=state.rng.get_state()), os.path.join(d, f"noise_r{r}.pt"))


def run_epochs(cfg: Config, args, tag: str) -> None:
    r, w = parallel.rank(), parallel.world_size()
    inputs = torch.load(args.inputs, weights_only=False) if args.inputs else None
    with deterministic_algorithms():
        trainer = Trainer(cfg)
        state = trainer.init_state()
        if args.init:
            load_state(args.init, state)
        out = []
        for epoch in args.epochs:
            batch = inputs["batches"][epoch] if inputs else fake_batch(cfg, epoch)
            local_b = cfg.batch_size // w
            batch = {k: v[r * local_b:(r + 1) * local_b] for k, v in batch.items()}
            if inputs:
                noise = inputs["noise"][epoch][r]
                state, g_loss, d_loss = trainer.step_variant(epoch)(state, batch, noise)
            else:
                state, g_loss, d_loss = trainer.train_iteration(state, batch, epoch)
            out.append((epoch, g_loss.item(), d_loss.item(), state.state_dict()))
    if args.save_state:
        if r == 0:
            save_state(state_path(cfg), state)
        parallel.barrier()
    torch.save(out, os.path.join(args.dir, f"{tag}_r{r}.pt"))


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["collectives", "noise", "train"])
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("port", type=int)
    p.add_argument("dir")
    p.add_argument("--epochs", type=lambda s: [int(e) for e in s.split(",")], default=[0, 1, 3, 5])
    p.add_argument("--init", default="")
    p.add_argument("--inputs", default="")
    p.add_argument("--save-state", action="store_true")
    p.add_argument("--plain-first", action="store_true")
    p.add_argument("--tag", default="group")
    args = p.parse_args(argv)
    torch.set_num_threads(2)
    if args.mode != "collectives":
        with open(os.path.join(args.dir, "cfg.json")) as f:
            cfg = Config(**json.load(f))
        if args.plain_first:
            run_epochs(cfg, args, "plain")
    torchrun_env(args.rank, args.world, args.port)
    with parallel.process_group("on", "cpu"):
        if not parallel.initialized():
            raise RuntimeError("the process group was not created")
        if args.mode == "collectives":
            collectives(args.dir)
        elif args.mode == "noise":
            noise(cfg, args.dir)
        else:
            run_epochs(cfg, args, args.tag)


if __name__ == "__main__":
    main()
