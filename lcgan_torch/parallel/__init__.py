"""Data parallelism of the port over ``torch.distributed``, in place of
``lcgan_tpu.parallel`` (a 1-D ``data`` mesh, ``pmean``, coordination-service
barriers).

One process per GPU, launched by ``torchrun`` (or by anything that sets its
environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``). Parameters are replicated: every rank starts from the same
seed and applies the same averaged gradients, so no broadcast is needed. The
batch is sharded by the input pipeline. G and D are not wrapped in DDP: the
train step takes gradients with ``torch.autograd.grad``, which fires no DDP
hook, so it averages them itself with one ``all_reduce`` per step
(``mean_all_reduce``), as the JAX step ``pmean``s them.

Without a process group every function here is the one-process identity:
rank 0 of 1, ``mean_all_reduce`` and ``barrier`` do nothing,
``all_gather_rows`` returns its input.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Sequence

import numpy as np
import torch
import torch.distributed as dist

from lcgan_torch.utils import trace

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """True when ``torchrun``'s environment is present."""
    return all(k in os.environ for k in _ENV)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def local_rank() -> int:
    """This process's GPU on its host: ``LOCAL_RANK`` as ``torchrun`` sets it, else 0."""
    return int(os.environ.get("LOCAL_RANK", 0))


def initialize(policy: str, device_type: str) -> bool:
    """Join the process group that ``torchrun``'s environment describes, as
    the JAX CLI's ``--distributed`` joins ``jax.distributed`` (lcgan_tpu/cli.py:196-213):
    "auto" when the environment is present, "on" always (it must be present),
    "off" never. NCCL on ``cuda``, gloo on ``cpu``. Returns whether this call
    created the group (a group that already exists is kept and not claimed)."""
    if policy not in ("auto", "on", "off"):
        raise ValueError(f"distributed must be auto|on|off, got {policy!r}")
    if policy == "off" or initialized():
        return False
    if not launched():
        if policy == "on":
            raise RuntimeError(f"--distributed on needs torchrun's environment ({', '.join(_ENV)})")
        return False
    backend = "nccl" if device_type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
    )
    return True


@contextlib.contextmanager
def process_group(policy: str, device_type: str) -> Iterator[None]:
    """``initialize`` for the block; the group it created is destroyed on exit."""
    created = initialize(policy, device_type)
    try:
        yield
    finally:
        if created:
            dist.destroy_process_group()


def _nccl() -> bool:
    return dist.get_backend() == dist.Backend.NCCL


def barrier() -> None:
    """Wait for every rank (the fences around rank-0 I/O, lcgan_tpu/train/loop.py:125,137)."""
    if not initialized():
        return
    if _nccl():
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def mean_all_reduce(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place: the list
    flattened into one buffer, one ``all_reduce(SUM)``, divided by the world
    size, copied back. The tensors share one dtype and device. At world size
    1 the values come back bit for bit. While tracing is on
    (``utils.trace``), each call under a group adds to the counters
    ``all_reduce.calls`` and ``all_reduce.bytes``."""
    if not initialized() or not tensors:
        return
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"mean_all_reduce takes one dtype, got {sorted(map(str, dtypes))}")
    buf = torch.cat([t.detach().reshape(-1) for t in tensors])
    trace.count("all_reduce.calls")
    trace.count("all_reduce.bytes", buf.numel() * buf.element_size())
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    buf.div_(dist.get_world_size())
    parts = buf.split([t.numel() for t in tensors])
    with torch.no_grad():  # one call: a copy_ a tensor costs the host ~19 µs on the card (PERF.md §6)
        torch._foreach_copy_(list(tensors), [part.view(t.shape) for t, part in zip(tensors, parts)])


def all_gather_rows(array: np.ndarray) -> np.ndarray:
    """Every rank's rows, in rank order (the shapes must agree across ranks):
    ``process_allgather`` then a reshape, as lcgan_tpu/eval/fid.py:164-168."""
    if not initialized():
        return array
    device = torch.device("cuda", torch.cuda.current_device()) if _nccl() else torch.device("cpu")
    local = torch.from_numpy(np.ascontiguousarray(array)).to(device)
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    return torch.cat(parts).cpu().numpy()
