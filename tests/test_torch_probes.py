"""The port's probes (``lcgan_torch.tools.gather_probe`` and
``lcgan_torch.tools.dyn_trip_probe``) on the CPU, against the JAX probes:

  1. P2: the JAX probe's own ``build(packs, dyn)`` (``tools/dyn_trip_probe.py``),
     its ``pl.pallas_call`` run in interpret mode, against the port's plain
     version, static and loaded counts, at packs 4 and n in {4, 2, 0};
  2. P1: the JAX probe's ``pk`` (``tools/gather_probe.py:39-50``, restated
     word for word: it lives inside ``main``) in interpret mode against the
     port's plain gather, exactly, for random, all-0 and all-255 indices;
  3. stage B: the JAX probe's ``two_stage`` (``:57-74``, restated) against the
     port's, exactly, at a small size;
  4. both entry points with ``--device cpu`` at small sizes, and their
     refusal to run without a GPU unless asked for the CPU.

The CUDA kernels (``csrc/gather_probe.cu``, ``csrc/dyn_trip_probe.cu``) are
held against these plain versions on the card, in tests/test_torch_cuda.py
and chip_smoke.py.
"""

import functools
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import tools.dyn_trip_probe as j_dyn
from lcgan_torch.ops.grid_sample import identity_like_coordinates
from lcgan_torch.tools import dyn_trip_probe as t_dyn
from lcgan_torch.tools import gather_probe as t_gather

ROOT = Path(__file__).resolve().parents[1]


def interpret_pl():
    """``pallas`` with ``pallas_call`` in interpret mode, for the JAX probe's
    module to call."""
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return shim


def packs_case(packs, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((packs, 256, 256)).astype(np.float32)
    w = rng.standard_normal((256, 256)).astype(np.float32)
    return x, w


def assert_sum_close(got, want):
    # fp32 sums of up to 1024 products in other orders (XLA's dot, torch's
    # matmul): relative 1e-5, and 1e-5 of the output's scale for the values
    # near 0 (both are 0 at n = 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("n", [4, 2, 0])
def test_dyn_trip_plain_matches_pallas(n, monkeypatch):
    monkeypatch.setattr(j_dyn, "pl", interpret_pl())
    x, w = packs_case(4)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    dyn = np.asarray(j_dyn.build(4, dyn=True)(jnp.array([n], jnp.int32), jnp.asarray(x), jnp.asarray(w)))
    static = np.asarray(j_dyn.build(n, dyn=False)(jnp.asarray(x), jnp.asarray(w)))
    before = (t_dyn.dyn_trip_static.launches, t_dyn.dyn_trip_dyn.launches)
    got_dyn = t_dyn.packed_sum_dyn(torch.tensor([n], dtype=torch.int32), xt, wt)
    got_static = t_dyn.packed_sum_static(xt, wt, n)
    assert (t_dyn.dyn_trip_static.launches, t_dyn.dyn_trip_dyn.launches) == before  # CPU: no kernel
    assert torch.equal(got_dyn, got_static)
    assert torch.equal(got_dyn, t_dyn.packed_sum_plain(xt, wt, n))
    assert_sum_close(got_dyn.numpy(), dyn)
    assert_sum_close(got_static.numpy(), static)


def test_dyn_trip_plain_refuses_counts_out_of_range():
    x, w = (torch.from_numpy(a) for a in packs_case(2))
    for n in (-1, 3):
        with pytest.raises(ValueError, match="outside"):
            t_dyn.packed_sum_plain(x, w, n)


def slice_indices(n, slices, pack):
    """A model of the kernels' split of the inner dimension
    (csrc/dyn_trip_probe.cu): the threads of slice ks sum the inner indices
    i·pack + j, j in [ks·pack/slices, (ks+1)·pack/slices), of every pack
    i < n, pack by pack; the slices' partial tiles are then added in slice
    order. Returns the slices' indices in that order."""
    s = pack // slices
    return [[i * pack + j for i in range(n) for j in range(ks * s, (ks + 1) * s)] for ks in range(slices)]


def test_dyn_trip_inner_split_sums_each_index_once():
    """Under the kernel's own constants, the split sums every inner index of
    n·256 exactly once, an equal share in each slice, for n = 0...64."""
    src = (ROOT / "lcgan_torch" / "ops" / "csrc" / "dyn_trip_probe.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (kN|kTN|kThreads) = (\d+);", src)}
    pack, slices = const["kN"], const["kThreads"] // (const["kTN"] // 2)
    assert pack == t_dyn.PACK and slices == 16
    assert "const int ks = threadIdx.x / kColPairs;" in src and "(ks * kSlice + j) * kN" in src
    for n in range(max(t_dyn.STATIC_COUNTS) + 1):
        parts = slice_indices(n, slices, pack)
        assert [len(part) for part in parts] == [n * pack // slices] * slices
        assert sorted(k for part in parts for k in part) == list(range(n * pack))


# --- P1: tools/gather_probe.py:39-50, word for word but for interpret=True ---
def pk(x_ref, idx_ref, o_ref):
    vals = x_ref[:]             # (256, 128)
    idx = idx_ref[:]            # (256, 128) int32
    o_ref[:] = jnp.take_along_axis(vals, idx, axis=0)


def pallas_gather(xx, idx):
    return pl.pallas_call(
        pk,
        out_shape=jax.ShapeDtypeStruct(idx.shape, xx.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(xx, idx)


@pytest.mark.parametrize("kind", ["random", "zeros", "last"])
def test_gather_plain_matches_pallas(kind):
    rng = np.random.default_rng(1)
    xx = rng.standard_normal(t_gather.TILE).astype(np.float32)
    idx = dict(random=rng.integers(0, 256, t_gather.TILE), zeros=np.zeros(t_gather.TILE),
               last=np.full(t_gather.TILE, 255))[kind].astype(np.int32)
    want = np.asarray(pallas_gather(jnp.asarray(xx), jnp.asarray(idx)))
    before = t_gather.gather_probe.launches
    got = t_gather.take_along_rows(torch.from_numpy(xx), torch.from_numpy(idx))
    assert t_gather.gather_probe.launches == before  # CPU: no kernel
    assert got.dtype == torch.float32 and tuple(got.shape) == t_gather.TILE
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t_gather.take_along_rows_plain(torch.from_numpy(xx), torch.from_numpy(idx)).numpy(),
                                  want)


def test_gather_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(t_gather.TILE)
    idx = torch.zeros(t_gather.TILE, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        t_gather.gather_probe(x, idx)
    with pytest.raises(ValueError, match="CUDA"):
        t_dyn.dyn_trip_static(torch.zeros(2, 256, 256), torch.zeros(256, 256), 2)


# --- stage B: tools/gather_probe.py:57-74, word for word ---
def two_stage(x, grid):
    gb, gh, gw, _ = grid.shape
    fx = ((grid[..., 0] + 1.0) * gw - 1.0) * 0.5
    fy = ((grid[..., 1] + 1.0) * gh - 1.0) * 0.5
    iy0 = jnp.clip(jnp.floor(fy).astype(jnp.int32) - 1, 0, gh - 4)
    ix0 = jnp.clip(jnp.floor(fx).astype(jnp.int32) - 1, 0, gw - 4)
    # stage 1: gather 4 rows per output pixel along axis=1
    ys = (iy0[:, :, None, :] + jnp.arange(4)[None, None, :, None]).reshape(gb, gh * 4, gw)
    rows = jnp.take_along_axis(x, ys[..., None], axis=1)  # (B, 4H, W, C)
    # stage 2: gather 4 cols along axis=2
    xs = (ix0[:, :, None, :] + jnp.arange(4)[None, None, :, None])  # (B,H,4,W)
    xs4 = jnp.broadcast_to(xs[:, :, None, :, :], (gb, gh, 4, 4, gw)).reshape(gb, gh * 4, 4 * gw)
    # rows is (B, 4H, W, C); gather cols per (b, 4h) row
    taps = jnp.take_along_axis(
        rows, xs4.reshape(gb, gh * 4, 4, gw).transpose(0, 1, 3, 2).reshape(gb, gh * 4, gw * 4)[..., None],
        axis=2,
    )  # (B, 4H, 4W, C) -- [y-tap major, x-tap minor]
    return taps


@pytest.mark.parametrize("s", [0.1, 0.6])
def test_two_stage_matches_jax(s):
    b, h, c = 1, 32, 8
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, h, h, c)).astype(np.float32)
    ident = identity_like_coordinates(b, h, h).numpy()
    grid = (ident + rng.uniform(-s, s, (b, h, h, 2))).astype(np.float32)
    want = np.asarray(jax.jit(two_stage)(jnp.asarray(x), jnp.asarray(grid)))
    got = t_gather.two_stage(torch.from_numpy(x), torch.from_numpy(grid))
    assert tuple(got.shape) == (b, 4 * h, 4 * h, c)
    np.testing.assert_array_equal(got.numpy(), want)


def run_module(*args):
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_dyn_trip_entry_point_on_cpu():
    proc = run_module("lcgan_torch.tools.dyn_trip_probe", "--device", "cpu", "--packs", "4", "--reps", "2",
                      "--chain", "2")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert "correctness: dynamic bound == static loop at n and n/2 (bitwise)" in lines
    assert any(line.startswith("packs=4 chain=2 (host clock") for line in lines)
    assert any(line.startswith(("GO:", "NO-GO:")) for line in lines)


def test_gather_entry_point_on_cpu():
    proc = run_module("lcgan_torch.tools.gather_probe", "--device", "cpu", "--batch", "1", "--size", "32",
                      "--channels", "8")
    assert proc.returncode == 0, proc.stderr
    rows = [line.split(":")[0] for line in proc.stdout.splitlines()]
    assert rows.count("A") == 1 and rows.count("B") == 1 and rows.count("C") == 2, proc.stdout


@pytest.mark.parametrize("module", [t_gather, t_dyn])
def test_entry_point_raises_without_gpu(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main([])
