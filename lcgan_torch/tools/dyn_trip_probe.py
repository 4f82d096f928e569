"""Trip-count probe on the card: the port of ``tools/dyn_trip_probe.py``.

A loop of packed products, ``out = sum_{i < n} x[i] @ w`` over (256, 256)
fp32 packs, once with the trip count known to the compiler (the static
kernel) and once with it read from device memory inside the kernel (the
dynamic one); both are ``csrc/dyn_trip_probe.cu``, one body. The probe asks
what the JAX probe asked of Mosaic:

  1. does the loaded bound give the static loop's result (bit for bit)?
  2. at a matched trip count, what does the loaded bound cost?
  3. does halving the loaded count halve the time?

    python -m lcgan_torch.tools.dyn_trip_probe [--packs 16] [--reps 64] [--chain 32] [--device cpu]

Each timed call is a chain of ``--chain`` kernel calls in which each
call's output becomes ``x[0]`` of the next; the values overflow along the
chain, as in the JAX probe, and are not checked. The verdict uses the
device ms per chain (CUDA events); the host-clock ms is printed beside it.
With ``--device cpu`` both run the plain version, and the verdict uses the
host clock. Without a GPU and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from lcgan_torch.config import resolve_device
from lcgan_torch.ops import _build
from lcgan_torch.tools import describe, time_ms

PACK = 256  # x[i], w and out are PACK x PACK
STATIC_COUNTS = (1, 2, 4, 8, 16, 32, 64)  # the static kernel's trip counts (csrc/dyn_trip_probe.cu)
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def packed_sum_plain(x: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """``sum_{i < n} x[i] @ w`` as a Python loop of products (fp32 on the
    card with TF32 off, as the caller sets it)."""
    if not 0 <= n <= x.shape[0]:
        raise ValueError(f"the count {n} is outside [0, {x.shape[0]}]")
    out = torch.zeros((PACK, PACK), dtype=torch.float32, device=x.device)
    for i in range(n):
        out = out + x[i] @ w
    return out


def _check(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name} needs its tensors on one CUDA device, got {x.device}, {w.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 x and w, got {x.dtype}, {w.dtype}")
    if (x.dim() != 3 or tuple(x.shape[1:]) != (PACK, PACK) or tuple(w.shape) != (PACK, PACK)
            or not (x.is_contiguous() and w.is_contiguous()) or x.data_ptr() % 16):
        raise ValueError(f"{name} needs contiguous, 16-byte aligned x (packs, {PACK}, {PACK}) and w ({PACK}, {PACK}), "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")


def dyn_trip_static(x: torch.Tensor, w: torch.Tensor, npk: int) -> torch.Tensor:
    """Launch the static-count kernel: the first ``npk`` packs of x, ``npk``
    one of ``STATIC_COUNTS``. Counts its launches in
    ``dyn_trip_static.launches``. Returns (256, 256) fp32."""
    _check("dyn_trip_static", x, w)
    if npk not in STATIC_COUNTS or npk > x.shape[0]:
        raise ValueError(f"dyn_trip_static is built for counts {STATIC_COUNTS} up to x's {x.shape[0]} packs, "
                         f"got {npk}")
    out = torch.empty((PACK, PACK), dtype=torch.float32, device=x.device)
    fn = _build.entry("dyn_trip_probe", "lcgan_dyn_trip_static", [_PTR] * 3 + [_INT, _PTR])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), npk, torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, "dyn_trip_static")
    dyn_trip_static.launches += 1
    return out


def dyn_trip_dyn(n: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the loaded-count kernel: the count is ``n[0]``, an int32 on the
    device that the kernel reads (no host sync), in [0, packs] by contract
    (the kernel clamps it there). Counts its launches in
    ``dyn_trip_dyn.launches``. Returns (256, 256) fp32."""
    _check("dyn_trip_dyn", x, w)
    if n.device != x.device or n.dtype != torch.int32 or n.numel() != 1:
        raise ValueError(f"dyn_trip_dyn takes its count as one int32 on x's device, got {tuple(n.shape)} "
                         f"{n.dtype} on {n.device}")
    out = torch.empty((PACK, PACK), dtype=torch.float32, device=x.device)
    fn = _build.entry("dyn_trip_probe", "lcgan_dyn_trip_dyn", [_PTR, _INT] + [_PTR] * 4)
    with torch.cuda.device(x.device):
        rc = fn(n.data_ptr(), x.shape[0], x.data_ptr(), w.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, "dyn_trip_dyn")
    dyn_trip_dyn.launches += 1
    return out


dyn_trip_static.launches = 0
dyn_trip_dyn.launches = 0


def packed_sum_static(x: torch.Tensor, w: torch.Tensor, npk: int) -> torch.Tensor:
    """The static-count sum: the plain version on CPU tensors, the kernel on
    CUDA ones."""
    if x.device.type == "cpu":
        return packed_sum_plain(x, w, npk)
    return dyn_trip_static(x, w, npk)


def packed_sum_dyn(n: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The loaded-count sum: the plain version on CPU tensors, the kernel on
    CUDA ones."""
    if x.device.type == "cpu":
        return packed_sum_plain(x, w, int(n.reshape(-1)[0]))
    return dyn_trip_dyn(n, x, w)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packs", type=int, default=16)
    ap.add_argument("--reps", type=int, default=64)
    ap.add_argument("--chain", type=int, default=32, help="kernel calls chained per timed call")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the GPU (default; raises if none is present) or the CPU's plain version")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    packs, k = args.packs, args.packs // 2
    if device.type == "cuda" and not (packs in STATIC_COUNTS and k in STATIC_COUNTS):
        raise ValueError(f"on the card --packs and --packs // 2 must be static counts {STATIC_COUNTS}, got {packs}")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in fp32, as precision=HIGHEST
    print(f"devices: {describe(device)}")

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((packs, PACK, PACK)).astype(np.float32)).to(device)
    w = torch.from_numpy(rng.standard_normal((PACK, PACK)).astype(np.float32)).to(device)
    n_full = torch.tensor([packs], dtype=torch.int32, device=device)
    n_half = torch.tensor([k], dtype=torch.int32, device=device)

    # correctness first: dynamic(n=packs) == static(packs); n=k matches a
    # static loop of k; bit for bit (one body)
    if not torch.equal(packed_sum_dyn(n_full, x, w), packed_sum_static(x, w, packs)):
        raise AssertionError(f"dynamic bound != static loop at n={packs}")
    if not torch.equal(packed_sum_dyn(n_half, x, w), packed_sum_static(x, w, k)):
        raise AssertionError(f"dynamic bound != static loop at n={k}")
    print("correctness: dynamic bound == static loop at n and n/2 (bitwise)")

    def chain(call):
        def fn():
            y = x.clone()
            for _ in range(args.chain):
                y[0].copy_(call(y))
            return y

        return fn

    # a chain is 2 * chain + 1 launches: one chain behind each hold of the device
    t_static = time_ms(chain(lambda y: packed_sum_static(y, w, packs)), args.reps, device, per_hold=1)
    t_dyn_full = time_ms(chain(lambda y: packed_sum_dyn(n_full, y, w)), args.reps, device, per_hold=1)
    t_dyn_half = time_ms(chain(lambda y: packed_sum_dyn(n_half, y, w)), args.reps, device, per_hold=1)
    on_device = device.type == "cuda"
    for label, which in (("device, CUDA events", 0), ("host clock", 1)):
        if which == 0 and not on_device:
            print("device ms: not measured (CPU)")
            continue
        s, f, h = t_static[which], t_dyn_full[which], t_dyn_half[which]
        print(f"packs={packs} chain={args.chain} ({label}, ms per chain): static {s:.3f} ms | "
              f"dyn(n={packs}) {f:.3f} ms ({f / s:.2f}x) | dyn(n={k}) {h:.3f} ms ({h / s:.2f}x)")
    which = 0 if on_device else 1
    s, f, h = t_static[which], t_dyn_full[which], t_dyn_half[which]
    verdict = (
        "GO: dynamic bound is ~free and scales with n"
        if f < 1.15 * s and h < 0.75 * s
        else "NO-GO: dynamic bound costs too much or does not scale"
    )
    print(verdict)
    print(f"launches: dyn_trip_static {dyn_trip_static.launches}, dyn_trip_dyn {dyn_trip_dyn.launches}", flush=True)


if __name__ == "__main__":
    main()
