"""Smoke run of the PyTorch/CUDA port (lcgan_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-kernels warp_fwd,warp_dgrid,warp_dx,warp_dx_scatter,warp_fwd_small,warp_dgrid_small,warp_dx_small,dyn_trip,even512 [ROOT]
        # per-shape times and output hashes of the named kernels of the lcgan_torch under
        # ROOT (warp_dx_scatter, warp_dgrid_small and warp_dx_small split by launch, each
        # small-map kernel beside its general kernel, dyn_trip's two arms beside torch.mm),
        # and the 512² mix and even-step profile (even512)
    python3 chip_smoke.py --time-backward [ROOT]  # shorthand for --time-kernels warp_dgrid,warp_dx [ROOT]
    python3 chip_smoke.py --time-pools [ROOT]  # steps 2 and 3 of the pool kernels of the lcgan_torch under ROOT
    python3 chip_smoke.py --cli-worker OUT.json -- CLI_ARGS  # step 8's rank under torchrun

1. Builds every CUDA kernel of the port from lcgan_torch/ops/csrc with nvcc
   for sm_90a, one nvcc per source, in parallel: warp_fwd, warp_dgrid,
   warp_dx, warp_dx_scatter, the small-map route's warp_fwd_small,
   warp_dgrid_small, warp_dx_small, the probes' gather_probe and
   dyn_trip_probe (two kernels: dyn_trip_static, dyn_trip_dyn), and pool2d
   (three kernels: box_filter, pool2x2, pool2x2_grad).
2. Holds each kernel against its plain PyTorch version on the card, at the
   main paths' shapes, in fp32 (max abs error <= 1e-5, scaled by the
   gradient's magnitude where it exceeds 1: the gradients sum up to C·16
   products in another order) and bf16 (at most one bf16 ulp of the output
   scale: both round the same fp32 sum once), for flows at the tanh bound
   (0.1) and at the trained magnitude (0.03); warp_dgrid, warp_dx and
   warp_dx_scatter (the dx of the narrow maps, C < 128) also at a flow far
   beyond the bound (0.6), warp_dgrid also at the 512² recipe's top block
   (512²·C64), and warp_dgrid and warp_dx with one pixel thrown across the
   map among near ones and (warp_dx) every pixel on one spot. warp_fwd
   also at the 512² and 1024² recipes' top blocks, and warp_fwd and
   warp_dx_scatter on a smooth flow (neighbours move together, as the
   generator's do), with a pixel thrown across the map, every pixel on one
   spot and on the scalar path (C = 5); warp_dx_scatter's pile-up against
   an fp64 oracle, with a limit set between the kernel's error and that of
   a kernel dropping or doubling one hit. The
   error against torch's own op (F.grid_sample,
   aten.grid_sampler_2d_backward) is printed beside it. The three small-map
   kernels are held the same way at the 8²-64² maps of the 256² recipe
   (B=8, C=512) and one tiny odd-C map (the scalar path), fp32 and bf16, at
   flows 0.1, 0.03 and 0.6, and warp_dx_small on a grid that gathers every
   pixel onto one spot. The gradient kernels, called twice on the same
   inputs, must give bitwise-equal outputs. The pool kernels must equal
   ATen's pools bitwise (avg_pool2d's forward, the 2x2 pool's backward) and
   their plain versions, with ATen's strides, twice alike, at the timed maps
   of step 3 and on odd maps, the narrow and the strided path, bf16 and
   fp32.
3. Times the four general kernels per shape with one function (the same as
   --time-kernels): warp_fwd at the six warp shapes of one 256² batch of 8
   and the narrow top blocks of the 512² and 1024² recipes (512²c64 B=8,
   1024²c32 B=4), warp_dgrid and warp_dx at the six warps and 512²c64
   (warp_dx at 1024²c32 too, the other design for warp_dx_scatter's sum),
   warp_dx_scatter at the two narrow maps; bf16 and fp32, the iid and the
   smooth flow, s = 0.1; with CUDA events, beside the bound (the larger of
   bytes over the card's memory rate and flops over its fp32 rate) and, in
   bf16, the wrapper's host time per call. At each kernel's kernels-line
   basis (warp_fwd and warp_dx_scatter bf16, the others fp32; iid flow) also
   its plain version and the one PyTorch call that computes the same
   function (F.grid_sample and aten.grid_sampler_2d_backward, the
   yardsticks, on fp32 copies since F.grid_sample takes no bf16 features
   with an fp32 grid; the port never calls them). The kernels line sums the
   six warps for warp_fwd, warp_dgrid and warp_dx, and takes the 512² train
   path's call (512²c64 B=8) for warp_dx_scatter.
   The same function times the three small-map kernels at the four small
   maps of a 256² batch (bf16 and fp32, both flows; their kernels line sums
   the four in bf16), each in turns with its general kernel at the same
   call (warp_fwd, warp_dgrid, warp_dx), and the trip-count probe's two
   kernels at n = 1, 8, 16 and 64 beside torch.mm (its kernels line:
   n = 16). Then the pool kernels in bf16 channels_last at the 512²
   recipe's top block (512²·C64, batch 8 and 32), the 256² recipe's
   (256²·C128, batch 8) and the 512² flow at batch 32 (C = 2, the box
   filter alone), in turns with ATen's pool (the yardstick, K, L, L, K),
   beside the byte bound and the plain version; each within 2x its bound
   on the three large maps (their kernels line sums them).
4. Drives the generation path: `python -m lcgan_torch.cli --phase
   fake_image_generation` on a seeded flagship 256² generator (base_nf 128,
   max_nf 512, latents 64/512, bf16, batch 8), three batches. The kernel
   launch counts are set to 0 just before and read just after; warp_fwd
   must have run 6 times per batch. The JPEGs must exist, the outputs be
   finite, and the same generator in fp32 must agree with the port's CPU
   path (the plain warp, held to the JAX package by the CPU tests).
5. Drives one training iteration of the flagship 256² recipe:
   `Trainer.train_iteration` (bf16, batch 8, seed 0, freezeD_start 2,
   freezeD_layer 5) for epochs 0-3 (even, odd + R1, even frozen, odd frozen)
   on a seeded synthetic batch. Counts set to 0 just before and read just
   after: warp_fwd 24+12+24+12 = 72, warp_dgrid and warp_dx 18+6+18+6 = 48
   each. Losses finite, the frozen D leaves untouched by epochs 2-3, every
   other leaf moved. Then times each variant alone (min of 3, a per-layer
   figure), and the reference's 8-iteration mix (4 even, 1 odd + R1, 3 odd)
   through train_iteration as MIX_WINDOWS synchronized windows, printing all
   the images over all the time (images/s). Then `--warp_impl none` (the
   diagnostic ablation) must launch no warp kernel in a forward and backward
   of the flagship generator, and four epochs at the dryrun width in fp32 on
   the card and on the port's CPU path must agree.
6. Drives the train phase, the main path of this slice: `python -m
   lcgan_torch.cli --phase train` at the reference's 512² recipe (base_nf 64,
   max_nf 512, latents 64/512, bf16, batch 8, freezeD_layer 4) on a seeded
   synthetic folder of 512² JPEGs, epochs 0-3 with print and save firing.
   Counts set to 0 just before and read just after: warp_fwd 7·12 = 84,
   warp_dgrid 7·8 = 56, warp_dx 6·8 = 48 (the C >= 128 blocks),
   warp_dx_scatter 1·8 = 8 (the 512²·C=64 block). args.txt, log.txt (the
   JAX package's line), epoch.txt and model/state.pt must exist and the
   losses be finite; a second call must resume from epoch.txt + 1, and
   fake_image_generation must read the checkpoint. The pool kernels'
   launches over epochs 0-3, and the program's counters pool.launches and
   pool.vector_launches: every launch on the vector path but the flow's box
   filters (narrow) and those on cotangents that arrive NCHW (strided). Then: the 8-iteration
   mix fed by the port's own pipeline (MIX_WINDOWS_512 windows, images/s and
   peak memory), an even step with and without deterministic algorithms
   (its profile, the warp kernels' device ms by name, is step 10b's remat
   off form, on a fresh seeded state and a synthetic batch), bit-exact resume at 512² in a fresh process, and
   the training monitor once at full width (num_explore 1).
7. Drives the small-map route, the main path of this slice: `python -m
   lcgan_torch.cli --phase train` at the flagship 256² recipe with
   `--warp_pallas_min_res 8` (the flags of step 5, batch 8, freezeD_layer 5)
   on a seeded synthetic folder of 256² JPEGs, epochs 0-3, a resumed call,
   then fake_image_generation from its checkpoint, three batches. Counts set
   to 0 just before each part and read just after: over epochs 0-3 the four
   8²-64² blocks (C = 512) launch warp_fwd_small 4·12 = 48, warp_dgrid_small
   and warp_dx_small 4·8 = 32, the 128² and 256² blocks warp_fwd 24,
   warp_dgrid and warp_dx 16, warp_dx_scatter 0; generation 12 small and 6
   general. args.txt must hold the knob. Then, per layer, windows of the
   8-iteration mix at 256² on one synthetic batch with warp_pallas_min_res 8
   and 128 in turns (images/s each), and an even-step profile of the small
   route with the warp kernels' share. Steps 4-6 run with the default
   (128) and must launch no small-map kernel.
8. Drives this slice's paths, data parallelism, fid_eval and
   video_generation, on the 256² folder of step 7 at the flagship recipe
   (default route). The train phase, epochs 0-3, under `torchrun
   --standalone --nproc_per_node=1` (NCCL, world size 1: a fresh process
   running `chip_smoke.py --cli-worker`, which calls `lcgan_torch.cli.main`
   with the counts set to 0 just before and read just after, and times the
   all-reduce calls) and through the CLI in this process without a group,
   counted the same way (warp_fwd 72, warp_dgrid and warp_dx 48 each);
   both runs' files must exist, their log.txt lines agree and their state.pt
   be bitwise equal (deterministic mode). Then, per layer, the 256² mix on
   one synthetic batch without and with a one-rank NCCL group in this
   process, in turns (P, G, G, P), images/s and the all-reduce calls' host
   µs, and mean_all_reduce's host µs by part and device ms on G's and D's
   gradients. Then `--phase fid_eval` on the torchrun run
   (random Inception weights, 32 reals and 32 fakes; warp_fwd 24): fid.txt,
   best_fid.txt and state_best.pt (the evaluated state); a second call must
   rewrite state_best.pt only if its FID is lower; `--best` generation from
   state_best.pt alone; Inception's features on the card against the CPU on
   2 images (TF32 off; 1e-4 of their scale) and its images/s at 299² fp32.
   Then `--phase video_generation --ctrl_dim 0 --num_videos 1`: one mp4 of
   60 frames (warp_fwd 360), frames/s.
9. Drives this slice's paths: view batching, Adam with beta1 != 0,
   --profile_dir, the 1024² recipe and the Inception converter's CLI.
   First warp_fwd, warp_dgrid and warp_dx / warp_dx_scatter against their
   plain versions at the shapes these paths and step 10's give them first
   (every block of the view-batched 256² G step at B = 24; of the 1024²
   recipe at B = 4; the 512² recipe's blocks of 128² and up at B = 32).
   (a) The flagship 256² recipe in fp32 (deterministic, cuDNN off,
   adam_eps 1): one iteration of epochs 0, 1, 3 and 5 (frozen from 4) from
   one state with the same batch and noise, unbatched and with
   --view_batched_steps: losses within 1e-5, each gradient within 1e-2 in
   l2, every leaf within 1e-3 of its scale, epoch 1 (nothing batched)
   bitwise.
   (b) `python -m lcgan_torch.cli --phase train` at the flagship 256² recipe
   (bf16, batch 8) on step 7's folder with --view_batched_steps --beta1 0.5
   --profile_dir, epochs 0-20: counts set to 0 just before and read just
   after, and each iteration's launches recorded (warp_fwd 12, warp_dgrid
   and warp_dx 6 in every iteration: 2, 1, 1 a block); finite losses, Adam's
   mu in state.pt, a Chrome trace of epochs 12-20 holding the warp kernels,
   the profiler stopped before the phase returned. Then, per layer, the even
   step unbatched and batched in turns (U, B, B, U): host ms, device ms and
   idle share (profiler on, once a form), peak memory.
   (c) The reference's 1024² recipe (batch 4, lr 1e-3, freezeD_layer 5,
   base_nf 32) through the CLI in bf16, epochs 0-3 on 16 synthetic 1024²
   JPEGs: counts set to 0 just before and read just after (warp_fwd 96,
   warp_dgrid 64, warp_dx 48, warp_dx_scatter 16), finite losses, peak
   memory; then on the port's pipeline one window of the 8-iteration mix
   (images/s, peak memory), the even step (min of 3) and its profile.
   (d) `python -m lcgan_torch.eval.convert` on a synthetic pytorch-fid .pth;
   the .npz it writes loaded into InceptionV3FID on the card, its leaves and
   features equal to the .pth's.
10. Drives this slice's path, the remat switches, and the 512² recipe at
   its global batch of 32 on one card.
   (a) The flagship 256² recipe in fp32 under the train phase's
   deterministic settings: one iteration of epochs 0, 1, 3 and 5 (frozen
   from 4) from one state with the same batch and noise, remat off and
   under each policy (no saves; the JAX saves; the saves with
   remat_save_max_res 64), then epoch 0 on the small-map route: losses and
   every gradient bitwise equal to remat off's, and under remat one more
   forward-warp launch for each grid-gradient launch (the recompute's).
   (b) The 512² recipe's even step (bf16, batch 8, deterministic) with
   remat off, on without saves and on with the JAX saves: each alone, its
   peak memory and warp launches (K1 28 off, 49 on; K2 21, K3 18, K4 3),
   and its first step from one seeded state, batch and noise, whose losses
   and gradients must be bitwise equal across the forms (K4 and bf16 under
   remat);
   then in turns (O, N, S, S, N, O), host ms, device ms, idle share and
   K1's device ms (profiler on); then remat off at batch 16 alone, and the
   linear extrapolation of its peak to batch 32 against the card's memory.
   (c) `python -m lcgan_torch.cli --phase train` at the 512² recipe with
   batch 32 and --remat_blocks, epochs 0-3 on 32 synthetic 512² JPEGs:
   counts set to 0 just before and read just after (warp_fwd 84 + 56
   recompute launches = 140, warp_dgrid 56, warp_dx 48, warp_dx_scatter 8),
   finite losses, peak memory under the card's; generation from its
   checkpoint (remat on, no_grad) warp_fwd 7 a batch, as without remat;
   then one window of the 8-iteration mix on the port's pipeline
   (images/s, peak memory).
11. The probes (lcgan_torch.tools), whose path is their own entry points:
   gather_probe against take_along_dim on the (256, 128) fp32 tile,
   exactly, for random, all-0 and all-255 indices; dyn_trip_static and
   dyn_trip_dyn against an fp64 sum at 16 packs (n = 16, 8 and, for the
   loaded count, 0; max abs error <= 1e-5 x max|ref|: fp32 sums of n·256
   products), the two bitwise equal. Times the gather beside its plain
   version, the one PyTorch call for the same function (torch.gather) and
   its bound (the trip-count kernels: step 3).
   Then runs each entry point's main() with its defaults, counts set to 0
   just before and read just after (gather_probe 41 launches, dyn_trip_static
   4130, dyn_trip_dyn 8258), and once more as `python -m` in a fresh
   process, and checks the rows A, B, C and the GO / NO-GO line.
12. Prints the whole run's wall time, each kernel's time and bound per
   launch (a row's sums over the calls it times) with launches x (time -
   bound), the kernels as one JSON line (launches from step 6, from step 7
   for the small-map kernels and from step 11 for the probes'; the pools'
   per launch over step 3's three large maps), the card's
   name and power limit, and last the ok line.
   Exits nonzero, printing no result, on any failure and when no GPU is
   present.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

# Data-sheet rates of the cards this runs on (NVIDIA data sheets, dense):
# device-memory bytes/s and fp32 (non-tensor-core) flop/s. First match wins.
CARD_RATES = [
    ("H200", 4.8e12, 67e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),  # SXM
]

# (B, C, H) of the six warps of one 256² generated batch, block 0 to 5
MAIN_PATH_WARPS = [(8, 512, 8), (8, 512, 16), (8, 512, 32), (8, 512, 64), (8, 256, 128), (8, 128, 256)]
FLOWS = [0.1, 0.03]
FP32_TOL = 1e-5
MIX_WINDOWS = 2  # timed passes over the training schedule's 8-iteration mix
# (B, C, H) of the narrow-map warps (C < 128): the top block of the 512²
# recipe, and of the 1024² one at its per-GPU batch of 4
SCATTER_SHAPES = [(8, 64, 512), (4, 32, 1024)]
SCATTER_FLOWS = [0.1, 0.03, 0.6]  # 0.6: far beyond the tanh bound
# K1 at the six warps of a 256² batch and at the narrow top blocks of the
# 512² and 1024² recipes
FWD_SHAPES = MAIN_PATH_WARPS + SCATTER_SHAPES
FLOW_KINDS = ("iid", "smooth")  # warp_inputs' flows
MIX_WINDOWS_512 = 2
GENERAL_KERNELS = ("warp_fwd", "warp_dgrid", "warp_dx", "warp_dx_scatter")
SMALL_KERNELS = ("warp_fwd_small", "warp_dgrid_small", "warp_dx_small")
KERNELS = GENERAL_KERNELS + SMALL_KERNELS
# the general kernel each small-map kernel replaces on its maps
GENERAL_OF = dict(warp_fwd_small="warp_fwd", warp_dgrid_small="warp_dgrid", warp_dx_small="warp_dx")
# (B, C, H) of the small-map warps of one 256² batch (blocks 0-3), and a
# tiny odd-C map that takes the kernels' scalar path
SMALL_PATH_WARPS = MAIN_PATH_WARPS[:4]
SMALL_CHECK_SHAPES = SMALL_PATH_WARPS + [(2, 5, 12)]
MIX_WINDOWS_ROUTES = 2  # timed windows of the 256² mix per warp route, in turns
# the probes' kernels (lcgan_torch.tools), their sources, and the TPU kernels they replace
PROBE_KERNELS = ("gather_probe", "dyn_trip_static", "dyn_trip_dyn")
PROBE_SOURCE = dict(gather_probe="gather_probe", dyn_trip_static="dyn_trip_probe", dyn_trip_dyn="dyn_trip_probe")
PROBE_REPLACES = dict(gather_probe="tools/gather_probe.py:39", dyn_trip_static="tools/dyn_trip_probe.py:31",
                      dyn_trip_dyn="tools/dyn_trip_probe.py:40")
PROBE_PACKS = 16  # the trip-count probe's default --packs
PROBE_COUNTS = (16, 8, 0)  # loaded counts held against fp64; the static kernel has no count 0

failures: list[str] = []


def check(ok: bool, msg: str):
    print(("ok   " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        failures.append(msg)


def card_rates(name: str):
    for key, bw, flops in CARD_RATES:
        if key in name:
            return bw, flops
    raise SystemExit(f"chip_smoke: no data-sheet rates for {name!r}; add them to CARD_RATES")


def warp_inputs(b, c, h, s, dtype, seed=0, flow="iid"):
    """Features and a grid ``identity + flow · s``. ``flow`` "iid": an
    independent U(-1, 1) draw per pixel, so neighbouring pixels' taps land up
    to ±s·W/2 apart; "smooth": U(-1, 1) at 1/16 of the map's size, upsampled
    bilinearly, so that neighbours move together, as the generator's
    box-filtered, tanh-bounded flows do."""
    import torch
    import torch.nn.functional as F

    from lcgan_torch.ops.grid_sample import identity_like_coordinates

    g = torch.Generator("cuda").manual_seed(seed)  # made on the card: the largest inputs hold 134 M values
    x = torch.randn((b, c, h, h), generator=g, device="cuda").to(dtype).contiguous(memory_format=torch.channels_last)
    if flow == "smooth":
        coarse = torch.rand((b, 2, max(1, h // 16), max(1, h // 16)), generator=g, device="cuda") * 2 - 1
        d = F.interpolate(coarse, size=(h, h), mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    else:
        d = torch.rand((b, h, h, 2), generator=g, device="cuda") * 2 - 1
    grid = (identity_like_coordinates(b, h, h, device="cuda") + d * s).contiguous()
    return x, grid


def cuda_ms(fn, iters: int = 20, hold: bool = True) -> float:
    """Device ms per call, from CUDA events around ``iters`` calls.

    ``hold``: a sleep kernel keeps the device busy while the host enqueues
    all the calls, so that the events bracket device time only, not the
    host's launch overhead (which exceeds a small kernel's run time).
    """
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0  # one call, enqueue and run
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(int(2e9 * 1.5 * host_s * iters))  # cycles at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, n: int = 50) -> float:
    """The wrapper's host cost per call (its enqueue), host clock."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def library_grid_sample(x, grid):
    """F.grid_sample takes its grid in the features' dtype, and a bf16 grid
    cannot address a 256² map; so it always gets fp32 features."""
    import torch.nn.functional as F

    return F.grid_sample(x.float(), grid, mode="bicubic", padding_mode="zeros", align_corners=False)


def build_kernels(names=None) -> None:
    """Builds the named kernels' sources (all by default) and prints ptxas's
    registers and spills of each."""
    from lcgan_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build(list(KERNELS) + sorted(set(PROBE_SOURCE.values())) + ["pool2d"] if names is None else names)
    print(f"build: {sorted(reports) or 'already built'} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, report in reports.items():
        entry = "?"
        for line in report.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
            if m:
                entry = demangle(m[1])
            if "registers" in line or "spill" in line:
                print(f"  {name}: {entry}: {line.strip()}")


def demangle(symbol: str) -> str:
    """A kernel's C++ name, by c++filt where the host has it."""
    import shutil

    if not shutil.which("c++filt"):
        return symbol
    out = subprocess.run(["c++filt", symbol], capture_output=True, text=True, timeout=30).stdout.strip()
    return re.sub(r"\(anonymous namespace\)::", "", out) or symbol


# (flow kind, s) of the kernels' checks beside SCATTER_FLOWS / FLOWS: the
# smooth flow at the tanh bound
FWD_CHECK_FLOWS = [("iid", 0.1), ("iid", 0.03), ("smooth", 0.1)]
SCALAR_SHAPE = (2, 5, 40)  # (B, C, H): odd C takes the scalar path, on a map of several tiles


def check_fwd(tag, x, grid, lib: bool = True) -> float:
    """One warp_fwd check against the plain version (fp32: 1e-5; bf16: one
    ulp of the output scale); returns the error."""
    import torch

    from lcgan_torch.ops.grid_sample import grid_sample_bicubic_plain
    from lcgan_torch.ops.warp import warp_fwd

    out = warp_fwd(x, grid).float()
    torch.cuda.synchronize()
    ref = grid_sample_bicubic_plain(x, grid).float()
    err = (out - ref).abs().max().item()
    extra = f"; vs F.grid_sample {(out - library_grid_sample(x, grid).float()).abs().max().item():.3g}" if lib else ""
    if x.dtype == torch.float32:
        check(err <= FP32_TOL, f"{tag}: max_abs_err {err:.3g} (tol {FP32_TOL}){extra}")
    else:
        ulp = 2.0 ** (math.floor(math.log2(max(ref.abs().max().item(), 1e-30))) - 7)
        check(err <= ulp, f"{tag}: max_abs_err {err:.3g} (tol 1 bf16 ulp = {ulp:.3g}){extra}")
    return err


def check_warp_kernel() -> float:
    """Kernel vs plain at the paths' eight shapes (iid flows at 0.1 and 0.03,
    the smooth flow at 0.1); then at a 64² and the 256² warp (C512 bf16: 4
    pixels a row tile; C128: 16) one pixel thrown across the map among smooth
    near ones, every pixel on one spot by the map's corner (taps across the
    map's edge), and determinism; and the scalar path. Returns the largest
    fp32 error."""
    import torch

    from lcgan_torch.ops.warp import warp_fwd

    worst = 0.0
    for b, c, h in FWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for kind, s in FWD_CHECK_FLOWS:
                x, grid = warp_inputs(b, c, h, s, dtype, flow=kind)
                err = check_fwd(f"warp_fwd {b}x{c}x{h}x{h} {str(dtype)[6:]} {kind} s={s}", x, grid)
                if dtype == torch.float32:
                    worst = max(worst, err)
                del x, grid
    for dtype in (torch.float32, torch.bfloat16):
        for b, c, h in (MAIN_PATH_WARPS[3], MAIN_PATH_WARPS[-1]):
            x, grid = warp_inputs(b, c, h, 0.03, dtype, flow="smooth")
            grid[3, h // 3, 5] = torch.tensor([0.9, -0.95], device="cuda")
            tag = f"warp_fwd {b}x{c}x{h}x{h} {str(dtype)[6:]}"
            check_fwd(f"{tag} smooth s=0.03, one pixel thrown across the map", x, grid, lib=False)
            same = torch.equal(warp_fwd(x, grid), warp_fwd(x, grid))
            check(same, f"determinism {tag} smooth: warp_fwd bitwise equal {same}")
            check_fwd(f"{tag}, every pixel on one spot by the map's corner", x, torch.full_like(grid, -0.99), lib=False)
            del x, grid
        for kind in FLOW_KINDS:
            x, grid = warp_inputs(*SCALAR_SHAPE, 0.1, dtype, flow=kind)
            check_fwd(f"warp_fwd {'x'.join(map(str, SCALAR_SHAPE))}x{SCALAR_SHAPE[-1]} {str(dtype)[6:]} {kind} s=0.1 "
                      "(scalar path)", x, grid)
        del x, grid
    return worst


def cotangent_like(x, seed=1):
    import torch

    g = torch.Generator(x.device).manual_seed(seed)
    return torch.randn(x.shape, generator=g, device=x.device).to(x.dtype).contiguous(memory_format=torch.channels_last)


def library_backward(x, grid, g, mask):
    """aten's bicubic grid_sample backward (fp32 features, like F.grid_sample)."""
    import torch

    return torch.ops.aten.grid_sampler_2d_backward(g.float(), x.float(), grid, 2, 0, False, mask)


def fp32_tol(ref) -> float:
    return FP32_TOL * max(1.0, ref.abs().max().item())


def check_backward_kernels() -> dict:
    """warp_dgrid and warp_dx vs the plain backward at the main path's shapes
    (warp_dgrid also at the 512² recipe's top block, 512²·C64, whose dx is
    warp_dx_scatter's) for flows up to far beyond the tanh bound, one far
    pixel among near ones, a grid that gathers every pixel onto one spot
    (warp_dx), and their determinism; returns each kernel's largest fp32
    error."""
    import torch

    from lcgan_torch.ops.grid_sample import grid_sample_bicubic_plain_backward
    from lcgan_torch.ops.warp import warp_dgrid, warp_dx

    worst = dict(warp_dgrid=0.0, warp_dx=0.0)
    for b, c, h in MAIN_PATH_WARPS + SCATTER_SHAPES[:1]:
        names = ("warp_dgrid", "warp_dx") if c >= 128 else ("warp_dgrid",)  # C < 128: warp_dx_scatter's dx
        for dtype in (torch.float32, torch.bfloat16):
            for s in SCATTER_FLOWS:
                x, grid = warp_inputs(b, c, h, s, dtype)
                g = cotangent_like(x)
                got = dict(warp_dgrid=warp_dgrid(x, grid, g), warp_dx=warp_dx(grid, g) if "warp_dx" in names else None)
                torch.cuda.synchronize()
                ref_dx, ref_dgrid = grid_sample_bicubic_plain_backward(x, grid, g)
                lib_dx, lib_dgrid = library_backward(x, grid, g, [True, True])
                ref = dict(warp_dgrid=ref_dgrid, warp_dx=ref_dx)
                lib = dict(warp_dgrid=lib_dgrid, warp_dx=lib_dx)
                for name in names:
                    out, want = got[name].float(), ref[name].float()
                    err = (out - want).abs().max().item()
                    lib_err = (out - lib[name].float()).abs().max().item()
                    tag = f"{name} {b}x{c}x{h}x{h} {str(dtype)[6:]} s={s}"
                    if dtype == torch.float32 or name == "warp_dgrid":  # dgrid is fp32 from either
                        tol = fp32_tol(want)
                        if dtype == torch.float32:
                            worst[name] = max(worst[name], err)
                        check(err <= tol, f"{tag}: max_abs_err {err:.3g} (tol {tol:.3g} = 1e-5 x max(1, scale)); "
                                          f"vs aten backward {lib_err:.3g}")
                    else:
                        ulp = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
                        check(err <= ulp, f"{tag}: max_abs_err {err:.3g} (tol 1 bf16 ulp = {ulp:.3g}); "
                                          f"vs aten backward {lib_err:.3g}")
                del x, grid, g, got, ref, lib, ref_dx, ref_dgrid, lib_dx, lib_dgrid
    for b, c, h in (MAIN_PATH_WARPS[0], MAIN_PATH_WARPS[3], MAIN_PATH_WARPS[-1]):
        for dtype in (torch.float32, torch.bfloat16):
            x, grid = warp_inputs(b, c, h, 0.1, dtype, seed=2)
            g = cotangent_like(x, seed=3)
            same_dgrid = torch.equal(warp_dgrid(x, grid, g), warp_dgrid(x, grid, g))
            same_dx = torch.equal(warp_dx(grid, g), warp_dx(grid, g))
            check(same_dgrid and same_dx, f"determinism {b}x{c}x{h}x{h} {str(dtype)[6:]}: "
                                          f"warp_dgrid bitwise equal {same_dgrid}, warp_dx bitwise equal {same_dx}")
            del x, grid, g
    # one pixel thrown across the map among near ones (s = 0.03): it widens only
    # the windows its own row reaches; and every pixel on one spot (warp_dx)
    b, c, h = MAIN_PATH_WARPS[-1]
    x, grid = warp_inputs(b, c, h, 0.03, torch.float32)
    grid[3, h // 3, 5] = torch.tensor([0.9, -0.95], device="cuda")
    g = cotangent_like(x)
    ref_dx, ref_dgrid = grid_sample_bicubic_plain_backward(x, grid, g)
    err_dx = (warp_dx(grid, g) - ref_dx).abs().max().item()
    err_dgrid = (warp_dgrid(x, grid, g) - ref_dgrid).abs().max().item()
    check(err_dx <= fp32_tol(ref_dx) and err_dgrid <= fp32_tol(ref_dgrid),
          f"{b}x{c}x{h}x{h} fp32, one pixel thrown across the map: warp_dx max_abs_err {err_dx:.3g} "
          f"(tol {fp32_tol(ref_dx):.3g}), warp_dgrid {err_dgrid:.3g} (tol {fp32_tol(ref_dgrid):.3g})")
    grid = torch.full_like(grid, 0.01)  # every pixel samples one spot
    dx = warp_dx(grid, g)
    want = grid_sample_bicubic_plain_backward(x, grid, g)[0]
    err = (dx - want).abs().max().item()
    same = torch.equal(dx, warp_dx(grid, g))
    check(err <= fp32_tol(want) and same, f"warp_dx {b}x{c}x{h}x{h} fp32, every pixel on one spot: "
                                          f"max_abs_err {err:.3g} (tol {fp32_tol(want):.3g}), bitwise repeatable {same}")
    del x, grid, g, dx, want, ref_dx, ref_dgrid
    return worst


# the warp kernels by their kernel names (K4's memset is not counted)
WARP_KERNEL_NAMES = (("warp_fwd", r"\bwarp_fwd_kernel"), ("warp_dgrid", r"\bwarp_dgrid_kernel"),
                     ("warp_dx", r"\bwarp_dx_(rows_)?kernel"), ("warp_dx_scatter", r"\bwarp_dxs_\w*kernel"),
                     ("warp_fwd_small", r"\bwarp_fwd_small_kernel"), ("warp_dgrid_small", r"\bwarp_dgrid_small_kernel"),
                     ("warp_dx_small", r"\bwarp_dx(sm_\w+|_small)_kernel"))


def profile_forward(fn, iters: int = 5, top: int = 12, what: str = "forward") -> dict:
    """Device time of ``iters`` calls by kernel (torch.profiler), and the
    device's idle share of the window's wall time. Returns the warp
    kernels' device ms per call, by kernel, and the device ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [
        (e.key, e.self_device_time_total / 1e3 / iters, e.count // iters)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0  # kernels, not the ops launching them
    ]
    busy = sum(ms for _, ms, _ in rows)
    print(f"profile: {busy:.3f} ms device time per {what}, {wall_ms / iters:.3f} ms wall, "
          f"device idle {1 - busy * iters / wall_ms:.1%} (profiler on)")
    ranked = sorted(rows, key=lambda r: -r[1])
    # the top kernels, and the port's own warp kernels wherever they rank
    for i, (key, ms, count) in enumerate(ranked):
        if i < top or "warp_" in key:
            print(f"  {ms:8.3f} ms {ms / busy:6.1%} x{count:<3d} {key[:110]}")
    warp_ms = sum(ms for key, ms, _ in rows if re.search(r"\bwarp_\w*kernel", key))
    print(f"  the port's warp kernels: {warp_ms:.3f} ms = {warp_ms / busy:.1%} of the device time", flush=True)
    per_kernel = dict(device_ms=busy, idle=1 - busy * iters / wall_ms)
    for label, pattern in WARP_KERNEL_NAMES:
        ms = sum(m for key, m, _ in rows if re.search(pattern, key))
        launches = sum(n for key, _, n in rows if re.search(pattern, key))
        per_kernel[f"{label}_ms"] = ms
        print(f"  {label} kernels: {ms:.3f} ms device time per {what} ({launches} launches)", flush=True)
    return per_kernel


def run_generation_path() -> int:
    """The generation phase through the CLI; returns the warp kernel's launches."""
    import numpy as np
    import torch
    from PIL import Image

    from lcgan_torch import cli
    from lcgan_torch.config import Config
    from lcgan_torch.gen.artifacts import to_unit
    from lcgan_torch.models.generator import build_generator
    from lcgan_torch.train.loop import load_ema_generator
    from lcgan_torch.train.steps import Trainer
    from lcgan_torch.utils.checkpoint import save_state, state_path
    from lcgan_torch.utils.media import make_grid, to_uint8

    num_fakes = 3
    with tempfile.TemporaryDirectory(prefix="lcgan_smoke_") as run:
        cfg = Config(model_name=run, img_resolution=256, base_nf=128, max_nf=512, geo_noise_dim=64,
                     app_noise_dim=64, geo_latent_dim=64, app_latent_dim=512, compute_dtype="bfloat16",
                     batch_size=8, seed=0)
        cfg.make_run_dirs()
        cfg.dump(os.path.join(run, "args.txt"))
        state = Trainer(cfg).init_state()  # a fresh run's checkpoint: EMA = G
        save_state(state_path(cfg), state)
        g = state.generator
        del state
        print(f"generation path: flagship 256² generator, {sum(p.numel() for p in g.parameters()) / 1e6:.2f} M params", flush=True)

        reset_launches()
        t0 = time.perf_counter()
        cli.main(["--phase", "fake_image_generation", "--model_name", run, "--num_fakes", str(num_fakes)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_launches()
        launches = counts["warp_fwd"]
        small = {k: counts[k] for k in SMALL_KERNELS}

        n_img = num_fakes * cfg.batch_size
        print(f"generation path: {n_img} images in {seconds:.3f} s = {n_img / seconds:.2f} images/s "
              "(checkpoint load, first-call autotuning and JPEG writes included)", flush=True)
        expect = cfg.num_blocks * num_fakes  # one warp per synthesis block
        check(launches == expect, f"warp_fwd launches on the generation path: {launches} (expect {expect})")
        check(not any(small.values()), f"small-map launches on the generation path (warp_pallas_min_res 128): {small}")
        jpgs = [os.path.join(run, "fakes", f"{i:04d}_images.jpg") for i in range(num_fakes)]
        shapes = [np.asarray(Image.open(p)).shape if os.path.exists(p) else None for p in jpgs]
        res = cfg.img_resolution
        check(all(s == (res * cfg.batch_size, res, 3) for s in shapes), f"fakes JPEGs: {shapes}")

        # the outputs: batch 0 again, from the same checkpoint and seed
        gen = load_ema_generator(cfg, torch.device("cuda"))
        rng = torch.Generator().manual_seed(cfg.seed)
        z1 = torch.randn((cfg.batch_size, cfg.geo_noise_dim), generator=rng).cuda()
        z2 = torch.randn((cfg.batch_size, cfg.app_noise_dim), generator=rng).cuda()
        with torch.inference_mode():
            img = gen(z1, z2, w_psi=cfg.w_psi)
            torch.cuda.synchronize()
            check(img.shape == (cfg.batch_size, 3, res, res) and bool(torch.isfinite(img).all()),
                  f"generator output {tuple(img.shape)} {img.dtype}, finite")
            diff = np.abs(to_uint8(make_grid(to_unit(img), nrow=1)).astype(np.float32)
                          - np.asarray(Image.open(jpgs[0])).astype(np.float32)).mean()
            check(diff <= 8.0, f"0000_images.jpg holds this output: mean |diff| {diff:.2f} of 255 (JPEG loss)")
            # no hold: the user's throughput includes the host's launch gaps
            steady = cuda_ms(lambda: gen(z1, z2, w_psi=cfg.w_psi), 10, hold=False)
            print(f"steady generator forward, batch 8 bf16: {steady:.3f} ms = {8e3 / steady:.1f} images/s", flush=True)
            profile_forward(lambda: gen(z1, z2, w_psi=cfg.w_psi))

        # the same weights in fp32: card vs the port's CPU path, one image
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        cpu = build_generator(cfg32)
        cpu.load_state_dict(g.state_dict())
        cpu = cpu.to(memory_format=torch.channels_last).eval()
        card = build_generator(cfg32)
        card.load_state_dict(g.state_dict())
        card = card.to("cuda", memory_format=torch.channels_last).eval()
        z = torch.randn((1, 64), generator=torch.Generator().manual_seed(1))
        with torch.inference_mode():
            ref = cpu(z, z, w_psi=0.7)
            out = card(z.cuda(), z.cuda(), w_psi=0.7).cpu()
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        # fp32 convolutions sum in other orders in cuDNN and on the CPU, through 6 blocks
        check(err <= 1e-3 * max(scale, 1.0), f"fp32 256² generator, card vs CPU: max_abs_err {err:.3g} (output scale {scale:.3g}, tol 1e-3 of it)")
        del gen, cpu, card, g
    return launches


def snapshot(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def synthetic_batch(cfg, device, seed: int = 0) -> dict:
    """image, geometry_change, appearance_change: (B, 3, H, W) in [-1, 1]."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    shape = (cfg.batch_size, cfg.img_ch, cfg.img_resolution, cfg.img_resolution)
    return {k: torch.rand(shape, generator=g, device=device) * 2 - 1
            for k in ("image", "geometry_change", "appearance_change")}


def run_training_path() -> None:
    """Epochs 0-3 of the flagship 256² recipe through Trainer.train_iteration,
    then its timings."""
    import torch

    from lcgan_torch.config import Config
    from lcgan_torch.train.freeze import freeze_mask
    from lcgan_torch.train.steps import Trainer

    cfg = Config(model_name="chip_smoke_train", img_resolution=256, base_nf=128, max_nf=512, geo_noise_dim=64,
                 app_noise_dim=64, geo_latent_dim=64, app_latent_dim=512, compute_dtype="bfloat16", batch_size=8,
                 seed=0, freezeD_start=2, freezeD_layer=5, device="cuda")
    trainer = Trainer(cfg)
    state = trainer.init_state()
    batch = synthetic_batch(cfg, trainer.device)
    n_g = sum(p.numel() for p in state.generator.parameters()) / 1e6
    n_d = sum(p.numel() for p in state.discriminator.parameters()) / 1e6
    print(f"training path: flagship 256² recipe, G {n_g:.2f} M + D {n_d:.2f} M params, bf16, batch 8", flush=True)

    initial = {name: snapshot(m) for name, m in (("G", state.generator), ("D", state.discriminator), ("EMA", state.ema))}
    reset_launches()
    losses, after_epoch1 = [], None
    t0 = time.perf_counter()
    for epoch in range(4):
        state, g_loss, d_loss = trainer.train_iteration(state, batch, epoch)
        losses.append((g_loss.item(), d_loss.item()))
        if epoch == 1:
            after_epoch1 = snapshot(state.discriminator)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    print(f"training path: epochs 0-3 in {seconds:.3f} s (first calls included); losses (g, d) {losses}", flush=True)
    expect = dict(warp_fwd=cfg.num_blocks * (4 + 2 + 4 + 2), warp_dgrid=cfg.num_blocks * (3 + 1 + 3 + 1))
    expect["warp_dx"] = expect["warp_dgrid"]
    expect["warp_dx_scatter"] = 0  # every block of the 256² recipe has C >= 128
    expect.update(dict.fromkeys(SMALL_KERNELS, 0))  # the default warp_pallas_min_res, 128
    for name, n in launches.items():
        check(n == expect[name], f"{name} launches on the training path: {n} (expect {expect[name]})")
    check(all(math.isfinite(v) for pair in losses for v in pair), "training losses finite")

    mask = dict(zip((n for n, _ in state.discriminator.named_parameters()), freeze_mask(state.discriminator, cfg.freezeD_layer)))
    final_d = snapshot(state.discriminator)
    frozen_same = all(torch.equal(after_epoch1[k], final_d[k]) for k, f in mask.items() if f)
    check(frozen_same, f"frozen D leaves ({sum(mask.values())}: from_rgb, block_0-{cfg.freezeD_layer - 1}) unchanged by epochs 2-3")
    stale = [f"{name}.{k}" for name, m in (("G", state.generator), ("D", state.discriminator), ("EMA", state.ema))
             for k, v in m.state_dict().items() if torch.equal(v, initial[name][k])]
    check(not stale, f"every other leaf of G, D and EMA moved over epochs 0-3 (unmoved: {stale[:5]})")

    # per layer: each unfrozen variant alone, host clock around a synchronized iteration
    variants = dict(even=(True, False), odd_r1=(False, True), odd=(False, False))
    for name, (even, with_r1) in variants.items():
        times = []
        for _ in range(3):
            noise = trainer.draw_noise(state, cfg.batch_size)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer._iteration(state, batch, noise, even=even, with_r1=with_r1, frozen=False)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"train step {name}: {min(times):.2f} ms (min of 3: {', '.join(f'{t:.2f}' for t in times)}), "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)

    # end to end: the reference's 8-iteration mix (schedule slots 0-7: 4 even,
    # 1 odd + R1, 3 odd; unfrozen) through train_iteration as a loop calls it,
    # each pass one synchronized window; all the images over all the time
    loop = Trainer(dataclasses.replace(cfg, freezeD_start=10**9))
    windows = []
    for _ in range(MIX_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for epoch in range(8):
            state, _, _ = loop.train_iteration(state, batch, epoch)
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
    n_img = MIX_WINDOWS * 8 * cfg.batch_size
    print(f"train throughput over the 8-iteration mix (4 even, 1 odd+R1, 3 odd), {MIX_WINDOWS} windows: "
          f"{n_img} images in {sum(windows):.3f} s = {n_img / sum(windows):.2f} images/s "
          f"(windows {', '.join(f'{w * 1e3:.1f}' for w in windows)} ms)", flush=True)
    noise = trainer.draw_noise(state, cfg.batch_size)
    profile_forward(lambda: trainer._iteration(state, batch, noise, even=True, with_r1=False, frozen=False),
                    iters=2, top=16, what="even train step")
    del state, trainer, batch, initial, after_epoch1, final_d
    torch.cuda.empty_cache()


def check_none_route() -> None:
    """--warp_impl none, the JAX package's diagnostic ablation: the flagship
    256² generator (bf16, batch 2) forward and backward on the card, counts
    set to 0 just before and read just after: no warp kernel runs."""
    import torch

    from lcgan_torch.models.generator import Generator

    gen = Generator(img_resolution=256, base_nf=128, max_nf=512, warp_impl="none", dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0)).to("cuda", memory_format=torch.channels_last)
    z = torch.randn((2, 64), generator=torch.Generator().manual_seed(1)).cuda()
    reset_launches()
    out = gen(z, z)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    launches = read_launches()
    check(not any(launches.values()) and bool(torch.isfinite(out.float()).all()),
          f"--warp_impl none: generator forward and backward at 256², output {tuple(out.shape)} finite, "
          f"warp kernel launches {launches} (expect all 0)")
    del gen, out


def check_training_card_vs_cpu() -> None:
    """Epochs 0, 1, 3 and 5 (frozen from 4) at the dryrun width in fp32,
    the same weights, batch and noise on the card and on the CPU."""
    import numpy as np
    import torch

    from lcgan_torch.config import Config
    from lcgan_torch.train.steps import Trainer

    kw = dict(model_name="chip_smoke_dryrun", img_resolution=32, batch_size=4, geo_noise_dim=8, app_noise_dim=8,
              geo_latent_dim=8, app_latent_dim=16, geo_projection_dim=8, app_projection_dim=8, base_nf=8, max_nf=16,
              mbstd_group_size=2, compute_dtype="float32", adam_eps=1e-3, freezeD_start=4, freezeD_layer=1)
    runs = {}
    for device in ("cuda", "cpu"):
        cfg = Config(**kw, device=device)
        trainer = Trainer(cfg)
        state = trainer.init_state()
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32)).to(device)
                 for k in ("image", "geometry_change", "appearance_change")}
        losses = []
        for epoch in (0, 1, 3, 5):
            noise = tuple(torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)).to(device) for _ in range(6))
            state, g_loss, d_loss = trainer.step_variant(epoch)(state, batch, noise)
            losses.append((g_loss.item(), d_loss.item()))
        leaves = {f"{name}.{k}": v.cpu() for name, m in (("G", state.generator), ("D", state.discriminator), ("EMA", state.ema))
                  for k, v in m.state_dict().items()}
        leaves.update({f"{name}.v.{k}": v.cpu() for name, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt))
                       for k, v in opt.v.items()})
        runs[device] = (losses, leaves)
    (card_losses, card), (cpu_losses, cpu) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / max(1.0, abs(b)) for pa, pb in zip(card_losses, cpu_losses) for a, b in zip(pa, pb))
    # relative to each leaf's scale: cuDNN picks its own conv algorithms and
    # the gradient kernels sum in other orders than the CPU, over four chained steps
    leaf_err, where = max(((card[k] - cpu[k]).abs().max().item() / max(1e-3, cpu[k].abs().max().item()), k) for k in cpu)
    check(loss_err <= 1e-4 and leaf_err <= 1e-3,
          f"fp32 dryrun-width epochs 0,1,3,5, card vs CPU: losses rel err {loss_err:.3g} (tol 1e-4), "
          f"worst leaf rel err {leaf_err:.3g} at {where} (tol 1e-3 of the leaf's scale), {len(cpu)} leaves")


def check_dx_one(tag, x, grid, g) -> float:
    """One warp_dx_scatter check against the plain backward (fp32: 1e-5 x
    max(1, scale); bf16: one ulp of the scale), with aten's error beside it;
    returns the error."""
    import torch

    from lcgan_torch.ops.grid_sample import grid_sample_bicubic_plain_backward
    from lcgan_torch.ops.warp import warp_dx_scatter

    out = warp_dx_scatter(grid, g).float()
    torch.cuda.synchronize()
    want = grid_sample_bicubic_plain_backward(x, grid, g)[0].float()
    lib = library_backward(x, grid, g, [True, False])[0].float()
    err = (out - want).abs().max().item()
    lib_err = (out - lib).abs().max().item()
    if x.dtype == torch.float32:
        tol = fp32_tol(want)
        check(err <= tol, f"{tag}: max_abs_err {err:.3g} (tol {tol:.3g} = 1e-5 x max(1, scale)); "
                          f"vs aten backward {lib_err:.3g}")
    else:
        ulp = 2.0 ** (math.floor(math.log2(max(want.abs().max().item(), 1e-30))) - 7)
        check(err <= ulp, f"{tag}: max_abs_err {err:.3g} (tol 1 bf16 ulp = {ulp:.3g}); vs aten backward {lib_err:.3g}")
    return err


# warp_dx_scatter's limit on the 512² pile-up against the fp64 oracle, from
# the card's readings (PERF.md, Findings): the kernel's error and the fp32 plain
# backward's lie below it, a kernel that drops or doubles one hit far above
PILEUP_TOL = 0.06


def check_pileup(tag, x, grid, g) -> None:
    """warp_dx_scatter on a grid that puts every pixel on one spot: each of
    the spot's 16 taps sums H·W products. Held against an fp64 oracle (every
    pixel has the spot's weights, so dX at tap (m, k) is wy[m] wx[k] times
    the fp64 sum of g over the map): the fp32 plain backward sums in another
    order and is itself off by about as much as the kernel, more than the
    other checks' 1e-5 x max(1, scale) at 512². The limit is PILEUP_TOL; the
    check also shows that a kernel which drops or doubles one hit (the kernel
    on g with one pixel's row zeroed or doubled) lies above it. Then bitwise
    repeatability."""
    import torch

    from lcgan_torch.ops.grid_sample import cubic_weights, grid_sample_bicubic_plain_backward, unnormalize
    from lcgan_torch.ops.warp import warp_dx_scatter

    b, c, h, w = g.shape
    dx = warp_dx_scatter(grid, g)
    fx, fy = unnormalize(grid[0, 0, 0, 0], w), unnormalize(grid[0, 0, 0, 1], h)
    wx, wy = cubic_weights(fx - torch.floor(fx)), cubic_weights(fy - torch.floor(fy))
    ix0, iy0 = int(torch.floor(fx)) - 1, int(torch.floor(fy)) - 1
    sums = g.double().sum((2, 3))
    want = torch.zeros((b, c, h, w), dtype=torch.float64, device=g.device)
    for m in range(4):
        for k in range(4):
            if 0 <= iy0 + m < h and 0 <= ix0 + k < w:
                want[:, :, iy0 + m, ix0 + k] += float(wy[m]) * float(wx[k]) * sums
    err = (dx.double() - want).abs().max().item()
    plain_err = (grid_sample_bicubic_plain_backward(x, grid, g)[0].double() - want).abs().max().item()
    one_hit = []
    for factor in (0.0, 2.0):  # one hit dropped, one hit doubled
        g1 = g.clone()
        g1[3, :, h // 3, 5] *= factor
        one_hit.append((warp_dx_scatter(grid, g1).double() - want).abs().max().item())
    same = torch.equal(dx, warp_dx_scatter(grid, g))
    check(err <= PILEUP_TOL < min(one_hit) and same,
          f"{tag}, every pixel on one spot: max_abs_err {err:.4g} against an fp64 oracle (limit {PILEUP_TOL}; "
          f"1e-5 x max(1, scale) = {fp32_tol(want):.4g}); the fp32 plain backward's {plain_err:.4g}; one hit dropped "
          f"{one_hit[0]:.4g}, doubled {one_hit[1]:.4g}; bitwise repeatable {same}")


def check_dx_scatter() -> float:
    """warp_dx_scatter vs the plain backward at the narrow maps of the 512²
    and 1024² recipes, for iid flows up to far beyond the tanh bound and the
    smooth flow, its determinism; then the tiled gather's branches: one pixel
    thrown across the map, every pixel on one spot (a tile whose hits
    overflow its buffer many times over), the scalar path. Returns the
    largest fp32 error."""
    import torch

    from lcgan_torch.ops.warp import warp_dx_scatter

    worst = 0.0
    for b, c, h in SCATTER_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for kind, s in [("iid", s) for s in SCATTER_FLOWS] + [("smooth", 0.1)]:
                x, grid = warp_inputs(b, c, h, s, dtype, flow=kind)
                err = check_dx_one(f"warp_dx_scatter {b}x{c}x{h}x{h} {str(dtype)[6:]} {kind} s={s}", x, grid,
                                   cotangent_like(x))
                if dtype == torch.float32:
                    worst = max(worst, err)
                del x, grid
            for kind in FLOW_KINDS:
                x, grid = warp_inputs(b, c, h, 0.1, dtype, seed=2, flow=kind)
                g = cotangent_like(x, seed=3)
                same = torch.equal(warp_dx_scatter(grid, g), warp_dx_scatter(grid, g))
                check(same, f"determinism {b}x{c}x{h}x{h} {str(dtype)[6:]} {kind}: warp_dx_scatter bitwise equal {same}")
                del x, grid, g
    b, c, h = SCATTER_SHAPES[0]
    x, grid = warp_inputs(b, c, h, 0.03, torch.float32, flow="smooth")
    grid[3, h // 3, 5] = torch.tensor([0.9, -0.95], device="cuda")
    g = cotangent_like(x)
    tag = f"warp_dx_scatter {b}x{c}x{h}x{h} fp32"
    worst = max(worst, check_dx_one(f"{tag} smooth s=0.03, one pixel thrown across the map", x, grid, g))
    grid = torch.full_like(grid, 0.01)  # every pixel samples one spot: one bucket holds the map
    check_pileup(tag, x, grid, g)
    del x, grid, g
    for dtype in (torch.float32, torch.bfloat16):
        for kind in FLOW_KINDS:
            x, grid = warp_inputs(*SCALAR_SHAPE, 0.1, dtype, flow=kind)
            check_dx_one(f"warp_dx_scatter {'x'.join(map(str, SCALAR_SHAPE))}x{SCALAR_SHAPE[-1]} {str(dtype)[6:]} "
                         f"{kind} s=0.1 (scalar path)", x, grid, cotangent_like(x))
    return worst


def digest(t) -> str:
    """A hash of a tensor's bytes, to compare two checkouts' outputs bit for bit."""
    import hashlib

    import torch

    t = t.detach()
    raw = (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.blake2b(raw, digest_size=8).hexdigest()


def warp_work(name, b, c, h, es):
    """(bytes, flops) of a warp kernel on a (b, c, h, h) map: each input (the
    features and the cotangent as they take them, the fp32 grid) read once,
    each output written once; 16 taps of one multiply-add per output value,
    two per tap for warp_dgrid (x and g)."""
    n_out = b * h * h
    if name == "warp_dgrid":
        return 2 * n_out * c * es + 2 * n_out * 8, 64 * c * n_out  # x, g, grid; dgrid
    return 2 * n_out * c * es + n_out * 8, 32 * c * n_out  # x (or g), grid; out (or dx)


def kernel_split(fn, iters: int = 5) -> dict:
    """Device ms per call of each kernel (and memset) that ``fn`` launches, by
    name (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"\b(warp_\w+kernel)", e.key)
            key = m[1] if m else e.key[:40]
            split[key] = split.get(key, 0.0) + e.self_device_time_total / 1e3 / iters
    return split


# --time-kernels NAMES (and "even512"): the general kernels, the small-map
# kernels (each beside its general kernel at the same call) and the
# trip-count probe
TIMED_KERNELS = GENERAL_KERNELS + SMALL_KERNELS + ("dyn_trip",)
# the sources each timed name builds
TIMED_SOURCES = dict({k: (k, GENERAL_OF[k]) for k in SMALL_KERNELS}, dyn_trip=("dyn_trip_probe",))
# the shapes each warp kernel is timed at: warp_dx also at the narrow maps,
# the other design in the repo for warp_dx_scatter's sum
TIMED_SHAPES = dict(warp_fwd=FWD_SHAPES, warp_dgrid=MAIN_PATH_WARPS + SCATTER_SHAPES[:1],
                    warp_dx=MAIN_PATH_WARPS + SCATTER_SHAPES, warp_dx_scatter=SCATTER_SHAPES,
                    **dict.fromkeys(SMALL_KERNELS, SMALL_PATH_WARPS))
# the kernels line's basis (iid flow, s = 0.1): the dtype, and the shapes summed
LINE_BASIS = dict(warp_fwd=("bfloat16", MAIN_PATH_WARPS), warp_dgrid=("float32", MAIN_PATH_WARPS),
                  warp_dx=("float32", MAIN_PATH_WARPS), warp_dx_scatter=("bfloat16", SCATTER_SHAPES[:1]),
                  **dict.fromkeys(SMALL_KERNELS, ("bfloat16", SMALL_PATH_WARPS)))
# kernels whose device ms are also reported by launch (profiler)
SPLIT_KERNELS = ("warp_dx_scatter", "warp_dgrid_small", "warp_dx_small")
DYN_TRIP_COUNTS = (1, 8, 16, 64)  # the trip-count probe's timed counts (static and loaded)


def time_kernel_rows(names, bw: float, flops: float, flows=FLOWS, yardsticks: bool = False,
                     hashes: bool = False, split: bool = False) -> list:
    """Per-shape device ms (the lower of two runs of 20 calls) of the named
    warp kernels at TIMED_SHAPES, bf16 and fp32, on the iid and the smooth
    flow at each s of ``flows``, beside the bound (the larger of bytes over
    the card's memory rate and flops over its fp32 rate); each small-map
    kernel in turns with its general kernel at the same call (K, G, G, K).
    In bf16 at s = 0.1 the wrapper's host time per call. With
    ``yardsticks``, at the kernels line's dtype on the iid flow at s = 0.1:
    the plain version and the one PyTorch call for the same function
    (F.grid_sample, aten's bicubic backward; on fp32 copies made outside the
    timed region) in turns K, L, L, K. With ``hashes``, at s = 0.1 a hash of
    the output (fixed inputs); with ``split``, the device ms by launch of
    SPLIT_KERNELS. The small-map kernels are called through their public
    wrappers only, so that the timer also runs on an earlier checkout.
    "dyn_trip": ``time_dyn_trip_rows``."""
    import torch

    from lcgan_torch.ops import warp
    from lcgan_torch.ops.grid_sample import grid_sample_bicubic_plain, grid_sample_bicubic_plain_backward

    rows = []
    for name in (n for n in TIMED_KERNELS if n in names and n in TIMED_SHAPES):
        for b, c, h in TIMED_SHAPES[name]:
            for dtype in (torch.bfloat16, torch.float32):
                for kind in FLOW_KINDS:
                    for s in flows:
                        x, grid = warp_inputs(b, c, h, s, dtype, flow=kind)
                        g = None if name in ("warp_fwd", "warp_fwd_small") else cotangent_like(x)
                        call = {n: (lambda n=n: getattr(warp, n)(x, grid)) for n in ("warp_fwd", "warp_fwd_small")}
                        call.update({n: (lambda n=n: getattr(warp, n)(x, grid, g)) for n in ("warp_dgrid", "warp_dgrid_small")})
                        call.update({n: (lambda n=n: getattr(warp, n)(grid, g))
                                     for n in ("warp_dx", "warp_dx_scatter", "warp_dx_small")})
                        fn = call[name]
                        dt = str(dtype)[6:]
                        nbytes, nflops = warp_work(GENERAL_OF.get(name, name), b, c, h, x.element_size())
                        bytes_ms, flops_ms = nbytes / bw * 1e3, nflops / flops * 1e3
                        row = dict(kernel=name, b=b, c=c, h=h, dtype=dt, flow=kind, s=s,
                                   bound_ms=max(bytes_ms, flops_ms),
                                   bound_by="bytes" if bytes_ms >= flops_ms else "operations")
                        if hashes and s == FLOWS[0]:
                            row["sha"] = digest(fn())
                        line = ""
                        if yardsticks and (dt, kind, s) == (LINE_BASIS[name][0], "iid", FLOWS[0]):
                            if g is None:
                                xf = x.float()
                                plain, library = (lambda: grid_sample_bicubic_plain(x, grid),
                                                  lambda: library_grid_sample(xf, grid))
                            else:
                                xf, gf = x.float(), g.float()
                                dgrid = name in ("warp_dgrid", "warp_dgrid_small")
                                mask = [not dgrid, dgrid]
                                plain, library = (lambda: grid_sample_bicubic_plain_backward(x, grid, g),
                                                  lambda: library_backward(xf, grid, gf, mask))
                            k1, l1, l2, k2 = cuda_ms(fn), cuda_ms(library, 5), cuda_ms(library, 5), cuda_ms(fn)
                            row.update(ms=min(k1, k2), plain_ms=cuda_ms(plain, 3), library_ms=min(l1, l2))
                            line = f", plain {row['plain_ms']:.4f} ms, library (fp32) {row['library_ms']:.4f} ms"
                        else:
                            row["ms"] = min(cuda_ms(fn), cuda_ms(fn))
                        if name in GENERAL_OF:  # the general kernel at the same call, in turns with the kernel
                            general = call[GENERAL_OF[name]]
                            g1, g2, k3 = cuda_ms(general), cuda_ms(general), cuda_ms(fn)
                            row.update(ms=min(row["ms"], k3), general_ms=min(g1, g2))
                            line += (f", {GENERAL_OF[name]} {row['general_ms']:.4f} ms "
                                     f"({row['general_ms'] / row['ms']:.2f}x)")
                        if dtype == torch.bfloat16 and s == FLOWS[0]:
                            row["host_us"] = host_us(fn)
                            line += f", wrapper host cost {row['host_us']:.1f} us per call"
                        if split and name in SPLIT_KERNELS:
                            row["split"] = kernel_split(fn)
                            line += "; by launch " + ", ".join(f"{k} {v:.4f}" for k, v in row["split"].items())
                        rows.append(row)
                        if "sha" in row:
                            line += f"; hash {row['sha']}"
                        print(f"time {name} {b}x{c}x{h}x{h} {dt} {kind} s={s}: kernel {row['ms']:.4f} ms, "
                              f"bound {row['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB, {row['bound_by']}), "
                              f"at {row['bound_ms'] / row['ms']:.1%} of bound{line}", flush=True)
                        del x, grid, g, fn, call
    if "dyn_trip" in names:
        rows += time_dyn_trip_rows(bw, flops, yardsticks, hashes)
    return rows


def time_dyn_trip_rows(bw: float, flops: float, yardsticks: bool = False, hashes: bool = False) -> list:
    """The trip-count probe's two kernels at each count of DYN_TRIP_COUNTS on
    seeded packs (64 of them): static and loaded in turns (S, D, L, L, D, S;
    100 calls each, the lower of each pair), beside the bound (2·256³·n flops
    over the card's fp32 rate, or the n packs, w and out over its memory
    rate) and the one PyTorch call for the same function (one torch.mm of the
    n packs side by side, (256, 256n), against w stacked n times, (256n, 256),
    TF32 off, both made outside the timed region), and each wrapper's host
    time per call; with ``yardsticks``, at n = PROBE_PACKS, the plain version
    (a loop of x[i] @ w); with ``hashes``, a hash of each output. One row per
    (kernel, n)."""
    import torch

    from lcgan_torch.tools import dyn_trip_probe as p2

    gen = torch.Generator(device="cuda").manual_seed(0)
    pack = p2.PACK
    x = torch.randn((max(DYN_TRIP_COUNTS), pack, pack), generator=gen, device="cuda")
    w = torch.randn((pack, pack), generator=gen, device="cuda")
    rows = []
    for n in DYN_TRIP_COUNTS:
        count = trip_count(n)
        xcat = x[:n].permute(1, 0, 2).reshape(pack, pack * n)  # the n packs side by side
        wstack = w.repeat(n, 1)  # w stacked n times
        calls = dict(dyn_trip_static=lambda: p2.dyn_trip_static(x, w, n), dyn_trip_dyn=lambda: p2.dyn_trip_dyn(count, x, w))
        library = lambda: torch.mm(xcat, wstack)  # noqa: E731
        s1, d1, l1, l2, d2, s2 = (cuda_ms(f, 100) for f in (calls["dyn_trip_static"], calls["dyn_trip_dyn"], library,
                                                             library, calls["dyn_trip_dyn"], calls["dyn_trip_static"]))
        nflops = 2 * pack ** 3 * n
        nbytes = (n + 2) * pack * pack * 4  # the n packs and w read, out written
        flops_ms, bytes_ms = nflops / flops * 1e3, nbytes / bw * 1e3
        base = dict(n=n, library_ms=min(l1, l2), bound_ms=max(flops_ms, bytes_ms),
                    bound_by="operations" if flops_ms >= bytes_ms else "bytes")
        if yardsticks and n == PROBE_PACKS:
            # the plain loop is 2n launches a call: few calls, so that they fit behind cuda_ms's hold
            base["plain_ms"] = min(cuda_ms(lambda: p2.packed_sum_plain(x, w, n), 4) for _ in range(2))
        for name, ms in (("dyn_trip_static", min(s1, s2)), ("dyn_trip_dyn", min(d1, d2))):
            row = dict(kernel=name, ms=ms, host_us=host_us(calls[name]), **base)
            if hashes:
                row["sha"] = digest(calls[name]())
            rows.append(row)
        s, d = rows[-2], rows[-1]
        plain = f", plain (loop of x[i] @ w) {base['plain_ms']:.4f} ms" if "plain_ms" in base else ""
        hashed = f"; hashes {s['sha']} {d['sha']}" if hashes else ""
        print(f"time dyn_trip n={n} fp32: static {s['ms']:.4f} ms, dyn {d['ms']:.4f} ms "
              f"({d['ms'] / s['ms']:.3f}x), torch.mm ({pack}, {pack * n}) x ({pack * n}, {pack}) "
              f"{base['library_ms']:.4f} ms (static {base['library_ms'] / s['ms']:.2f}x faster){plain}, "
              f"bound {base['bound_ms']:.4f} ms ({nflops / 1e9:.3f} GFLOP = {flops_ms:.4f} ms; {nbytes / 1e6:.2f} MB = "
              f"{bytes_ms:.4f} ms; {base['bound_by']}), static at {base['bound_ms'] / s['ms']:.1%} and dyn at "
              f"{base['bound_ms'] / d['ms']:.1%} of bound; wrapper host cost {s['host_us']:.1f} / {d['host_us']:.1f} us "
              f"per call{hashed}", flush=True)
    del x, w
    return rows


def line_totals(rows) -> dict:
    """Each timed kernel's kernels-line figures: a warp kernel's rows at
    LINE_BASIS summed (ms, plain, library, bound; a small-map kernel with
    its general kernel's ms at its calls), each trip-count kernel's row at n
    = PROBE_PACKS."""
    totals = {}
    for name, (dtype, shapes) in LINE_BASIS.items():
        picked = [r for r in rows if r["kernel"] == name and r["dtype"] == dtype and r["flow"] == "iid"
                  and r["s"] == FLOWS[0] and (r["b"], r["c"], r["h"]) in shapes]
        assert len(picked) == len(shapes), (name, len(picked))
        keys = ("ms", "plain_ms", "library_ms", "bound_ms") + (("general_ms",) if "general_ms" in picked[0] else ())
        t = {k: sum(r[k] for r in picked) for k in keys}
        t["bound_by"] = "bytes" if {r["bound_by"] for r in picked} == {"bytes"} else "operations"
        totals[name] = t
        general = f", {GENERAL_OF.get(name)} {t['general_ms']:.4f} ms" if "general_ms" in t else ""
        print(f"time {name} summed over {len(shapes)} warp(s) ({dtype}, iid s={FLOWS[0]}): kernel {t['ms']:.4f} ms"
              f"{general}, plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms",
              flush=True)
    for r in rows:
        if r["kernel"] in ("dyn_trip_static", "dyn_trip_dyn") and r["n"] == PROBE_PACKS:
            totals[r["kernel"]] = {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    return totals


# the pool kernels (csrc/pool2d.cu) in place of ATen's avg_pool2d, and the
# (B, C, H) of their timed maps, bf16 channels_last: the 512² recipe's top
# block at batch 8 and 32, the 256² recipe's top block, and the 512² flow at
# batch 32 (the narrow path; the box filter alone runs on the flow)
POOL_KERNELS = ("box_filter", "pool2x2", "pool2x2_grad")
POOL_SHAPES = [(8, 64, 512), (32, 64, 512), (8, 128, 256), (32, 2, 512)]
POOL_LARGE = POOL_SHAPES[:3]  # the three large main-path maps: each kernel within 2x its bound there
# (B, C, H, W, channels_last) of the pools' checks beyond POOL_SHAPES: odd maps, the narrow and strided paths
POOL_CHECK_SHAPES = [(8, 512, 4, 4, True), (8, 3, 7, 5, True), (4, 130, 33, 17, True), (8, 64, 64, 64, False),
                     (1, 2, 2, 3, False)]


def pool_work(name, b, c, h, es):
    """Bytes of a pool kernel on a (b, c, h, h) map: its input read once,
    its output written once."""
    n = b * c * h * h * es
    return 2 * n if name == "box_filter" else n + n // 4


def pool_calls(b, c, h, w, channels_last=True, dtype=None, seed=0):
    """The pool kernels, their plain versions and ATen's pools on one seeded
    map and cotangent: {name: (kernel, plain, library)}."""
    import torch
    import torch.nn.functional as F

    from lcgan_torch.ops import filters

    dtype = dtype or torch.bfloat16
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    gen = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=gen, device="cuda").to(dtype).contiguous(memory_format=fmt)
    g = torch.randn((b, c, h // 2, w // 2), generator=gen, device="cuda").to(dtype).contiguous(memory_format=fmt)
    aten = lambda: F.avg_pool2d(x, 3, stride=1, padding=1)  # noqa: E731
    aten2 = lambda: F.avg_pool2d(x, 2, stride=2)  # noqa: E731
    return dict(
        box_filter=(lambda: filters.box_filter(x), lambda: filters.box_filter_plain(x), aten),
        pool2x2=(lambda: filters.pool2x2(x), lambda: filters.pool2x2_plain(x), aten2),
        pool2x2_grad=(lambda: filters.pool2x2_grad(g, h, w, fmt), lambda: filters.pool2x2_grad_plain(g, h, w),
                      lambda: torch.ops.aten.avg_pool2d_backward(g, x, [2, 2], [2, 2], [0, 0], False, True, None)),
    )


def check_pool_kernels() -> dict:
    """Each pool kernel bitwise against ATen's pool (forward, and the 2x2
    pool's backward) and against its plain version, at POOL_SHAPES and
    POOL_CHECK_SHAPES, and twice on the same input; returns each kernel's
    largest error against the plain version (0 where bitwise)."""
    import torch

    worst = dict.fromkeys(POOL_KERNELS, 0.0)
    for b, c, h, w, cl in [(b, c, h, h, True) for b, c, h in POOL_SHAPES] + POOL_CHECK_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            calls = pool_calls(b, c, h, w, cl, dtype)
            for name in POOL_KERNELS if min(h, w) >= 2 else ("box_filter",):
                kernel, plain, library = calls[name]
                out, out2, ref, lib = kernel(), kernel(), plain(), library()
                same = torch.equal(out.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                                   lib.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
                err = (out.float() - ref.float()).abs().max().item()
                worst[name] = max(worst[name], err)
                check(same and err == 0 and torch.equal(out, out2) and out.stride() == lib.stride(),
                      f"{name} {b}x{c}x{h}x{w} {str(dtype)[6:]} {'channels_last' if cl else 'NCHW'}: bitwise equal "
                      f"to ATen's {same}, to the plain version {err == 0}, two calls {torch.equal(out, out2)}, "
                      f"ATen's strides {out.stride() == lib.stride()}")
            del calls
    torch.cuda.empty_cache()
    return worst


def time_pool_rows(bw: float) -> dict:
    """Each pool kernel's device ms at POOL_SHAPES (bf16 channels_last) in
    turns with ATen's pool (K, L, L, K; ATen's avg_pool2d and its backward,
    the library yardstick) beside the byte bound, the plain version and the
    wrapper's host time per call; returns the kernels-line figures: the
    kernel's rows summed over POOL_LARGE."""
    rows = []
    for b, c, h in POOL_SHAPES:
        calls = pool_calls(b, c, h, h)
        for name in POOL_KERNELS if c > 2 else ("box_filter",):
            kernel, plain, library = calls[name]
            nbytes = pool_work(name, b, c, h, 2)
            k1, l1, l2, k2 = cuda_ms(kernel), cuda_ms(library), cuda_ms(library), cuda_ms(kernel)
            row = dict(kernel=name, b=b, c=c, h=h, ms=min(k1, k2), library_ms=min(l1, l2),
                       plain_ms=cuda_ms(plain, 5), bound_ms=nbytes / bw * 1e3, host_us=host_us(kernel),
                       library_host_us=host_us(library))
            rows.append(row)
            print(f"time {name} {b}x{c}x{h}x{h} bf16 channels_last: kernel {row['ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB, bytes), {row['ms'] / row['bound_ms']:.2f}x the "
                  f"bound ({row['bound_ms'] / row['ms']:.1%}), ATen {row['library_ms']:.4f} ms "
                  f"({row['library_ms'] / row['ms']:.1f}x the kernel), plain {row['plain_ms']:.4f} ms, wrapper host "
                  f"cost {row['host_us']:.1f} us per call (ATen's {row['library_host_us']:.1f})", flush=True)
            if (b, c, h) in POOL_LARGE:
                check(row["ms"] <= 2 * row["bound_ms"], f"{name} {b}x{c}x{h}x{h} within 2x its byte bound: "
                      f"{row['ms'] / row['bound_ms']:.2f}x")
        del calls
    totals = {}
    for name in POOL_KERNELS:
        picked = [r for r in rows if r["kernel"] == name and (r["b"], r["c"], r["h"]) in POOL_LARGE]
        totals[name] = {k: sum(r[k] for r in picked) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        totals[name]["bound_by"] = "bytes"
        print(f"time {name} summed over {len(picked)} map(s) (bf16): kernel {totals[name]['ms']:.4f} ms, plain "
              f"{totals[name]['plain_ms']:.4f} ms, ATen {totals[name]['library_ms']:.4f} ms, bound "
              f"{totals[name]['bound_ms']:.4f} ms", flush=True)
    return totals


def time_pools(root: str) -> int:
    """``python3 chip_smoke.py --time-pools [ROOT]``: build the pool kernels
    of the lcgan_torch under ROOT, check them against ATen's pools and time
    them (``check_pool_kernels``, ``time_pool_rows``)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import lcgan_torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    print(f"time-pools of {os.path.dirname(lcgan_torch.__file__)}: torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {name}", flush=True)
    build_kernels(["pool2d"])
    check_pool_kernels()
    time_pool_rows(card_rates(name)[0])
    return 1 if failures else 0


def time_even_512() -> dict:
    """The 512² recipe (bf16, batch 8, freezeD_layer 4) on one synthetic batch
    in deterministic mode: after 8 warm iterations, 3 windows of the
    8-iteration mix (images/s, peak memory) and an even-step profile (the warp
    kernels' device ms per step, from the generator's own flows)."""
    import torch

    from lcgan_torch.config import Config
    from lcgan_torch.train.loop import deterministic_algorithms
    from lcgan_torch.train.steps import Trainer

    cfg = Config(model_name="chip_smoke_even512", img_resolution=512, batch_size=8, freezeD_layer=4,
                 freezeD_start=10**9, device="cuda")
    with deterministic_algorithms():
        trainer = Trainer(cfg)
        state = trainer.init_state()
        batch = synthetic_batch(cfg, trainer.device)
        for epoch in range(8):
            state, _, _ = trainer.train_iteration(state, batch, epoch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        windows = []
        for _ in range(MIX_WINDOWS_512):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for epoch in range(8):
                state, _, _ = trainer.train_iteration(state, batch, epoch)
            torch.cuda.synchronize()
            windows.append(time.perf_counter() - t0)
        n_img = MIX_WINDOWS_512 * 8 * cfg.batch_size
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"even512: 512² mix on one synthetic batch, deterministic, {MIX_WINDOWS_512} windows: "
              f"{n_img / sum(windows):.2f} images/s (windows {', '.join(f'{w * 1e3:.1f}' for w in windows)} ms); "
              f"peak memory {peak:.2f} GiB", flush=True)
        noise = trainer.draw_noise(state, cfg.batch_size)
        warp_ms = profile_forward(lambda: trainer._iteration(state, batch, noise, even=True, with_r1=False, frozen=False),
                                  iters=2, top=16, what="even train step at 512² (deterministic)")
    del state, trainer, batch
    torch.cuda.empty_cache()
    return dict(kernel="even512", images_per_s=n_img / sum(windows), peak_gib=peak, **warp_ms)


def time_kernels(names, root: str) -> int:
    """``python3 chip_smoke.py --time-kernels NAMES [ROOT]``: the named kernels
    (comma-separated, of TIMED_KERNELS, and ``even512``) of the lcgan_torch
    under ROOT, by ``time_kernel_rows`` (SPLIT_KERNELS split by launch) and
    ``time_even_512``, each timed warp kernel's ms summed at its kernels-line
    basis, then one JSON line of rows. Run it on two checkouts in turns, each
    in its own process, to compare two versions of the kernels on one card,
    time and output bits."""
    sys.path.insert(0, os.path.abspath(root))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import lcgan_torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    unknown = set(names) - set(TIMED_KERNELS) - {"even512"}
    if unknown:
        print(f"chip_smoke: --time-kernels takes {', '.join(TIMED_KERNELS)}, even512; not {sorted(unknown)}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"time-kernels {names} of {os.path.dirname(lcgan_torch.__file__)}", flush=True)
    build_kernels(sorted({src for n in names if n in TIMED_KERNELS for src in TIMED_SOURCES.get(n, (n,))}))
    rows = time_kernel_rows(names, *card_rates(name), hashes=True, split=True)
    for kernel, (dtype, shapes) in LINE_BASIS.items():
        picked = [r for r in rows if r["kernel"] == kernel and r["dtype"] == dtype and r["flow"] == "iid"
                  and r["s"] == FLOWS[0] and (r["b"], r["c"], r["h"]) in shapes]
        if picked:
            general = (f", {GENERAL_OF[kernel]} {sum(r['general_ms'] for r in picked):.4f} ms"
                       if kernel in GENERAL_OF else "")
            print(f"time {kernel} summed over {len(picked)} warp(s) ({dtype}, iid s={FLOWS[0]}): kernel "
                  f"{sum(r['ms'] for r in picked):.4f} ms{general}, bound {sum(r['bound_ms'] for r in picked):.4f} ms",
                  flush=True)
    if "even512" in names:
        rows.append(time_even_512())
    print(json.dumps({"time_kernels": os.path.dirname(lcgan_torch.__file__), "device": name, "rows": rows}), flush=True)
    return 0


def check_small_kernels() -> dict:
    """The three small-map kernels vs the plain versions at the small maps of
    the 256² recipe and a tiny odd-C map, flows up to far beyond the tanh
    bound, a gathered grid, and the gradient kernels' determinism; returns
    each kernel's largest fp32 error."""
    import torch

    from lcgan_torch.ops import warp
    from lcgan_torch.ops.grid_sample import grid_sample_bicubic_plain, grid_sample_bicubic_plain_backward

    worst = dict.fromkeys(SMALL_KERNELS, 0.0)
    for b, c, h in SMALL_CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for s in SCATTER_FLOWS:
                x, grid = warp_inputs(b, c, h, s, dtype)
                g = cotangent_like(x)
                got = dict(warp_fwd_small=warp.warp_fwd_small(x, grid), warp_dgrid_small=warp.warp_dgrid_small(x, grid, g),
                           warp_dx_small=warp.warp_dx_small(grid, g))
                torch.cuda.synchronize()
                ref_dx, ref_dgrid = grid_sample_bicubic_plain_backward(x, grid, g)
                lib_dx, lib_dgrid = library_backward(x, grid, g, [True, True])
                ref = dict(warp_fwd_small=grid_sample_bicubic_plain(x, grid), warp_dgrid_small=ref_dgrid, warp_dx_small=ref_dx)
                lib = dict(warp_fwd_small=library_grid_sample(x, grid), warp_dgrid_small=lib_dgrid, warp_dx_small=lib_dx)
                for name in SMALL_KERNELS:
                    out, want = got[name].float(), ref[name].float()
                    err = (out - want).abs().max().item()
                    lib_err = (out - lib[name].float()).abs().max().item()
                    tag = f"{name} {b}x{c}x{h}x{h} {str(dtype)[6:]} s={s}"
                    if dtype == torch.float32 or name == "warp_dgrid_small":  # dgrid is fp32 from either
                        # the forward sums 16 products per value: 1e-5 flat, as for warp_fwd
                        tol = FP32_TOL if name == "warp_fwd_small" else fp32_tol(want)
                        if dtype == torch.float32:
                            worst[name] = max(worst[name], err)
                        check(err <= tol, f"{tag}: max_abs_err {err:.3g} (tol {tol:.3g}); vs torch's op {lib_err:.3g}")
                    else:
                        ulp = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
                        check(err <= ulp, f"{tag}: max_abs_err {err:.3g} (tol 1 bf16 ulp = {ulp:.3g}); "
                                          f"vs torch's op {lib_err:.3g}")
                del x, grid, g, got, ref, lib, ref_dx, ref_dgrid, lib_dx, lib_dgrid
    for b, c, h in (SMALL_PATH_WARPS[0], SMALL_PATH_WARPS[-1]):
        for dtype in (torch.float32, torch.bfloat16):
            x, grid = warp_inputs(b, c, h, 0.1, dtype, seed=2)
            g = cotangent_like(x, seed=3)
            same_dgrid = torch.equal(warp.warp_dgrid_small(x, grid, g), warp.warp_dgrid_small(x, grid, g))
            same_dx = torch.equal(warp.warp_dx_small(grid, g), warp.warp_dx_small(grid, g))
            check(same_dgrid and same_dx, f"determinism {b}x{c}x{h}x{h} {str(dtype)[6:]}: warp_dgrid_small bitwise "
                                          f"equal {same_dgrid}, warp_dx_small bitwise equal {same_dx}")
            del x, grid, g
    b, c, h = SMALL_PATH_WARPS[-1]
    x, _ = warp_inputs(b, c, h, 0.0, torch.float32)
    grid = torch.full((b, h, h, 2), 0.01, device="cuda")  # every pixel samples one spot: one bucket holds the map
    g = cotangent_like(x)
    dx = warp.warp_dx_small(grid, g)
    want = grid_sample_bicubic_plain_backward(x, grid, g)[0]
    err = (dx - want).abs().max().item()
    same = torch.equal(dx, warp.warp_dx_small(grid, g))
    check(err <= fp32_tol(want) and same, f"warp_dx_small {b}x{c}x{h}x{h} fp32, every pixel on one spot: "
                                          f"max_abs_err {err:.3g} (tol {fp32_tol(want):.3g}), bitwise repeatable {same}")
    return worst


def synthetic_jpeg_folder(root: str, n: int, size: int) -> None:
    """``n`` seeded size² JPEGs under root/train/x: smooth colour fields
    with grain, as photos compress."""
    import numpy as np
    from PIL import Image

    d = os.path.join(root, "train", "x")
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        rng = np.random.default_rng(i)
        low = Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).resize((size, size), Image.BICUBIC)
        img = np.asarray(low, np.int16) + rng.integers(-8, 9, (size, size, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(os.path.join(d, f"{i:03d}.jpg"), quality=90)


TRAIN_512 = ["--img_resolution", "512", "--batch_size", "8", "--freezeD_layer", "4", "--num_data_workers", "4"]
LOG_LINE = re.compile(r"^epoch:(\d+), elapsed:\d+:\d\d:\d\d, g_loss:(-?\d+\.\d{6}), d_loss:(-?\d+\.\d{6}) $")


def run_cli(argv) -> str:
    """cli.main(argv), its standard output captured and echoed."""
    from lcgan_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    text = out.getvalue()
    for line in text.splitlines():
        if not line.startswith("Config("):
            print(f"  | {line}", flush=True)
    return text


def log_epochs(run: str):
    with open(os.path.join(run, "log.txt")) as f:
        matches = [LOG_LINE.match(line) for line in f.read().splitlines()]
    if not all(matches):
        return None
    return [(int(m[1]), float(m[2]), float(m[3])) for m in matches]


def run_train_phase(data: str, run: str) -> dict:
    """The train phase at the 512² recipe through the CLI: epochs 0-3, then a
    resumed call for 4-5, then generation from its checkpoint. Returns the
    kernels' launches over epochs 0-3."""
    import numpy as np
    import torch
    from PIL import Image

    from lcgan_torch import native

    print(f"train phase: 512² recipe, input pipeline on the "
          f"{'native C++ loader' if native.available() else 'Python/cv2 decoder (native loader unavailable)'}",
          flush=True)
    base = ["--phase", "train", "--dataset_path", data, "--model_name", run, *TRAIN_512,
            "--save_interval", "3", "--print_interval", "1", "--show_interval", "1000"]
    reset_launches()
    t0 = time.perf_counter()
    with counting_pools() as pools:
        out = run_cli(base + ["--epoch", "3"])
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    print(f"train phase: epochs 0-3 through the CLI in {seconds:.3f} s (build, first calls, data and one save included)",
          flush=True)
    expect = dict(warp_fwd=7 * 12, warp_dgrid=7 * 8, warp_dx=6 * 8, warp_dx_scatter=1 * 8)
    expect.update(dict.fromkeys(SMALL_KERNELS, 0))  # the default warp_pallas_min_res, 128
    for name, n in launches.items():
        check(n == expect[name], f"{name} launches on the 512² train phase, epochs 0-3: {n} (expect {expect[name]})")
    total, vector = pools["pool.launches"], pools["pool.vector_launches"]
    print(f"pool launches on the 512² train phase, epochs 0-3: " + ", ".join(f"{k} {pools[k]}" for k in POOL_KERNELS)
          + f"; the vector path {vector} of {total} ({vector / max(total, 1):.1%}); narrow: the flow's box filters "
          f"{pools['flow']}, others {pools['narrow']}; strided (NCHW cotangents) {pools['strided']}", flush=True)
    check(total == sum(pools[k] for k in POOL_KERNELS) > 0 and pools["narrow"] == 0
          and vector == total - pools["flow"] - pools["strided"],
          f"pool launches on the vector path, 512² train phase: {vector} (expect every launch but the flow's and "
          f"the NCHW maps', {total} - {pools['flow']} - {pools['strided']})")
    launches.update({k: pools[k] for k in POOL_KERNELS})
    lines = log_epochs(run)
    files = {f: os.path.exists(os.path.join(run, f)) for f in ("args.txt", "log.txt", "epoch.txt", "model/state.pt")}
    check(all(files.values()) and "restart training from" not in out, f"train phase files {files}")
    check(lines is not None and [e for e, _, _ in lines] == [0, 1, 2, 3]
          and all(math.isfinite(v) for _, g, d in lines for v in (g, d)),
          f"log.txt in the JAX package's line format, epochs 0-3, finite losses: {lines}")
    with open(os.path.join(run, "epoch.txt")) as f:
        saved = f.read().strip()
    check(saved == "3", f"epoch.txt after the first call: {saved} (expect 3)")

    t0 = time.perf_counter()
    out = run_cli(base + ["--epoch", "5"])
    print(f"train phase: resumed call in {time.perf_counter() - t0:.3f} s", flush=True)
    lines = log_epochs(run) or []
    check("restart training from: 4" in out and [e for e, _, _ in lines] == [0, 1, 2, 3, 4, 5]
          and all(math.isfinite(v) for _, g, d in lines for v in (g, d)),
          f"second call resumed from epoch.txt + 1: log epochs {[e for e, _, _ in lines]}")

    run_cli(["--phase", "fake_image_generation", "--model_name", run, "--num_fakes", "1"])
    path = os.path.join(run, "fakes", "0000_images.jpg")
    shape = np.asarray(Image.open(path)).shape if os.path.exists(path) else None
    check(shape == (512 * 8, 512, 3), f"fake_image_generation from the train phase's checkpoint: {shape}")
    return launches


@contextlib.contextmanager
def counting_pools():
    """Counts the pool kernels' launches inside the block: each kernel's
    own count, the program's tracing counters ``pool.launches`` and
    ``pool.vector_launches`` (tracing on), and by the path each launch's
    plan takes: "flow" (the generator's 2-channel flow, the narrow path),
    "strided" (an NCHW map: cotangents that arrive so) and "narrow" (any
    other narrow launch). Yields the dict, filled when the block ends."""
    from lcgan_torch.ops import filters
    from lcgan_torch.utils import trace

    counts = dict.fromkeys(("flow", "strided", "narrow"), 0)
    before = {k: getattr(filters, k).launches for k in POOL_KERNELS}
    launch = filters._run

    def counted(name, t, out_hw, fmt=None):
        path = filters._plan(name, t.shape, t.stride(), t.dtype, out_hw, fmt).path
        key = "strided" if path == "strided" else "flow" if t.shape[1] == 2 else "narrow" if path == "narrow" else None
        if key:
            counts[key] += 1
        return launch(name, t, out_hw, fmt)

    trace.enable()
    filters._run = counted  # the wrappers look it up at each call
    try:
        yield counts
    finally:
        filters._run = launch
        trace.disable()
        _, counters = trace.take()
        counts.update({k: getattr(filters, k).launches - before[k] for k in POOL_KERNELS})
        counts.update({k: counters.get(k, 0) for k in ("pool.launches", "pool.vector_launches")})


def run_train_512(data: str, run: str) -> None:
    """The 512² recipe on the port's own pipeline: the 8-iteration mix as
    synchronized windows (images/s, peak memory), an even step with and
    without deterministic algorithms (profiled in step 10b, remat off), and
    the monitor once at full width."""
    import torch

    from lcgan_torch.config import Config
    from lcgan_torch.gen.artifacts import monitor_current_result
    from lcgan_torch.train.loop import deterministic_algorithms, make_train_pipeline
    from lcgan_torch.train.steps import Trainer

    cfg = Config(dataset_path=data, model_name=run, img_resolution=512, batch_size=8, freezeD_layer=4,
                 num_data_workers=4)
    with deterministic_algorithms():
        trainer = Trainer(cfg)
        state = trainer.init_state()
        data_it = make_train_pipeline(cfg, trainer.device)
        n_g = sum(p.numel() for p in state.generator.parameters()) / 1e6
        n_d = sum(p.numel() for p in state.discriminator.parameters()) / 1e6
        print(f"512² recipe: G {n_g:.2f} M + D {n_d:.2f} M params, bf16, batch 8", flush=True)
        for epoch in range(8):  # first calls: cuDNN's algorithm choice for each variant
            state, _, _ = trainer.train_iteration(state, next(data_it), epoch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        windows = []
        for _ in range(MIX_WINDOWS_512):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for epoch in range(8):
                state, g_loss, d_loss = trainer.train_iteration(state, next(data_it), epoch)
            torch.cuda.synchronize()
            windows.append(time.perf_counter() - t0)
        n_img = MIX_WINDOWS_512 * 8 * cfg.batch_size
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"train throughput at 512², the 8-iteration mix fed by the port's pipeline, deterministic, "
              f"{MIX_WINDOWS_512} windows: {n_img} images in {sum(windows):.3f} s = {n_img / sum(windows):.2f} images/s "
              f"(windows {', '.join(f'{w * 1e3:.1f}' for w in windows)} ms); peak memory {peak:.2f} GiB", flush=True)
        check(math.isfinite(g_loss.item()) and math.isfinite(d_loss.item()), "512² mix losses finite")
        batch = next(data_it)

    def even_step_ms(deterministic: bool):
        ctx = deterministic_algorithms() if deterministic else contextlib.nullcontext()
        times = []
        with ctx:
            for _ in range(2):
                noise = trainer.draw_noise(state, cfg.batch_size)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer._iteration(state, batch, noise, even=True, with_r1=False, frozen=False)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        return times

    # turns D, N, N, D of two steps; each mode the min of its four (the first call of the free mode picks its own algorithms)
    runs = {True: [], False: []}
    for det in (True, False, False, True):
        runs[det] += even_step_ms(det)
    det_ms, free_ms = min(runs[True]), min(runs[False])
    print(f"train step even at 512²: deterministic {det_ms:.2f} ms, not deterministic {free_ms:.2f} ms "
          f"(deterministic mode costs {det_ms / free_ms - 1:+.1%}; all: {', '.join(f'{t:.1f}' for t in runs[True])} / "
          f"{', '.join(f'{t:.1f}' for t in runs[False])})", flush=True)

    epoch = 8 * (MIX_WINDOWS_512 + 1)
    t0 = time.perf_counter()
    monitor_current_result(cfg, state.ema, trainer.device, epoch=epoch, num_explore=1, w_psi=cfg.w_psi,
                           images_per_output=cfg.geo_noise_dim)
    torch.cuda.synchronize()
    videos = sorted(f for f in os.listdir(cfg.run_dirs()["samples"]) if f.endswith((".mp4", ".gif")))
    print(f"monitor at full width (num_explore 1, 64 images a frame): {time.perf_counter() - t0:.3f} s", flush=True)
    check([os.path.splitext(v)[0] for v in videos] == [f"appearance_{epoch}_0", f"geometry_{epoch}_0"]
          and all(os.path.getsize(os.path.join(cfg.run_dirs()["samples"], v)) > 0 for v in videos),
          f"monitor_current_result wrote {videos}")
    del state, trainer, data_it, batch
    torch.cuda.empty_cache()


RESUME_CFG = dict(img_resolution=512, batch_size=8, freezeD_layer=4, freezeD_start=3)


def resume_batch(epoch: int) -> dict:
    import torch

    g = torch.Generator(device="cuda").manual_seed(epoch)
    shape = (8, 3, 512, 512)
    return {k: torch.rand(shape, generator=g, device="cuda") * 2 - 1
            for k in ("image", "geometry_change", "appearance_change")}


def resume_worker(run: str, start: int, end: int) -> int:
    """The fresh-process half of check_resume_512: restore, train, save."""
    from lcgan_torch.config import Config
    from lcgan_torch.train.loop import deterministic_algorithms
    from lcgan_torch.train.steps import Trainer
    from lcgan_torch.utils.checkpoint import load_state, save_state, state_path

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(model_name=run, **RESUME_CFG)
    with deterministic_algorithms():
        trainer = Trainer(cfg)
        state = trainer.init_state()
        load_state(state_path(cfg), state)
        for epoch in range(start, end):
            state, _, _ = trainer.train_iteration(state, resume_batch(epoch), epoch)
    save_state(os.path.join(run, "model_resumed", "state.pt"), state)
    return 0


def check_resume_512(run: str) -> None:
    """Epochs 0-1, save, then 2-3 (even; odd, frozen) in a fresh process must
    equal an uninterrupted 0-3 bit for bit: every leaf and buffer of G, D and
    EMA, both Adam v trees and counts, step and the noise generator's state."""
    import torch

    from lcgan_torch.config import Config
    from lcgan_torch.train.loop import deterministic_algorithms
    from lcgan_torch.train.steps import Trainer
    from lcgan_torch.utils.checkpoint import load_state, save_state, state_path

    cfg = Config(model_name=run, **RESUME_CFG)
    n, m = 2, 2
    t0 = time.perf_counter()
    with deterministic_algorithms():
        trainer = Trainer(cfg)
        state = trainer.init_state()
        for epoch in range(n):
            state, _, _ = trainer.train_iteration(state, resume_batch(epoch), epoch)
        save_state(state_path(cfg), state)
        for epoch in range(n, n + m):
            state, _, _ = trainer.train_iteration(state, resume_batch(epoch), epoch)
        want = state.state_dict()
        del state
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--resume-worker", run, str(n), str(n + m)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        check(False, f"resume worker failed (rc {proc.returncode}): {proc.stderr[-2000:]}")
        return
    resumed = trainer.init_state()
    load_state(os.path.join(run, "model_resumed", "state.pt"), resumed)
    got = resumed.state_dict()
    bad = checkpoint_mismatches(want, got)
    n_leaves = sum(len(want[p]) for p in ("generator", "discriminator", "ema")) + len(want["g_opt"]["v"]) + len(want["d_opt"]["v"])
    check(not bad and got["step"] == n + m, f"bit-exact resume at 512² in a fresh process (epochs 0-1 | 2-3): "
                                            f"{n_leaves} tensors, step {got['step']}, counts and rng; mismatches "
                                            f"{bad[:5]} ({time.perf_counter() - t0:.1f} s)")
    del resumed, trainer
    torch.cuda.empty_cache()


TRAIN_256_SMALL = ["--img_resolution", "256", "--batch_size", "8", "--freezeD_layer", "5", "--num_data_workers", "4",
                   "--warp_pallas_min_res", "8"]


def reset_launches() -> None:
    from lcgan_torch.ops import warp

    for k in KERNELS:
        getattr(warp, k).launches = 0


def read_launches() -> dict:
    from lcgan_torch.ops import warp

    return {k: getattr(warp, k).launches for k in KERNELS}


def run_train_phase_small(data: str, run: str) -> dict:
    """The small-map route through the CLI: the flagship 256² recipe's train
    phase with --warp_pallas_min_res 8, epochs 0-3, then a resumed call for
    4-5, then generation from its checkpoint (three batches). Returns the
    kernels' launches over epochs 0-3."""
    import numpy as np
    import torch
    from PIL import Image

    from lcgan_torch.config import Config

    base = ["--phase", "train", "--dataset_path", data, "--model_name", run, *TRAIN_256_SMALL,
            "--save_interval", "3", "--print_interval", "1", "--show_interval", "1000"]
    reset_launches()
    t0 = time.perf_counter()
    out = run_cli(base + ["--epoch", "3"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    print(f"small route: 256² train phase with --warp_pallas_min_res 8, epochs 0-3 through the CLI in {seconds:.3f} s "
          "(first calls, data and one save included)", flush=True)
    # per block over epochs 0-3: 12 forward and 8 backward warps (see step 5)
    expect = dict(warp_fwd_small=4 * 12, warp_dgrid_small=4 * 8, warp_dx_small=4 * 8,  # 8²-64², C = 512
                  warp_fwd=2 * 12, warp_dgrid=2 * 8, warp_dx=2 * 8, warp_dx_scatter=0)  # 128²·256, 256²·128
    for name, n in launches.items():
        check(n == expect[name], f"{name} launches on the 256² train phase with --warp_pallas_min_res 8, "
                                 f"epochs 0-3: {n} (expect {expect[name]})")
    cfg = Config.load(os.path.join(run, "args.txt"))
    check(cfg.warp_pallas_min_res == 8 and cfg.warp_impl == "auto",
          f"args.txt holds warp_pallas_min_res: {cfg.warp_pallas_min_res}, warp_impl: {cfg.warp_impl}")
    lines = log_epochs(run)
    check(lines is not None and [e for e, _, _ in lines] == [0, 1, 2, 3]
          and all(math.isfinite(v) for _, g, d in lines for v in (g, d)) and "restart training from" not in out,
          f"small route log.txt, epochs 0-3, finite losses: {lines}")

    t0 = time.perf_counter()
    out = run_cli(base + ["--epoch", "5"])
    lines = log_epochs(run) or []
    print(f"small route: resumed call in {time.perf_counter() - t0:.3f} s", flush=True)
    check("restart training from: 4" in out and [e for e, _, _ in lines] == [0, 1, 2, 3, 4, 5]
          and all(math.isfinite(v) for _, g, d in lines for v in (g, d)),
          f"small route: second call resumed from epoch.txt + 1: log epochs {[e for e, _, _ in lines]}")

    num_fakes = 3
    reset_launches()
    t0 = time.perf_counter()
    run_cli(["--phase", "fake_image_generation", "--model_name", run, "--num_fakes", str(num_fakes)])
    torch.cuda.synchronize()
    gen = read_launches()
    print(f"small route: fake_image_generation, {num_fakes} batches in {time.perf_counter() - t0:.3f} s", flush=True)
    want = dict.fromkeys(KERNELS, 0)
    want.update(warp_fwd_small=4 * num_fakes, warp_fwd=2 * num_fakes)
    check(gen == want, f"launches of fake_image_generation from the small route's checkpoint: "
                       f"warp_fwd_small {gen['warp_fwd_small']} (expect 12), warp_fwd {gen['warp_fwd']} (expect 6), "
                       f"no other {dict((k, v) for k, v in gen.items() if k not in ('warp_fwd_small', 'warp_fwd'))}")
    shapes = []
    for i in range(num_fakes):
        path = os.path.join(run, "fakes", f"{i:04d}_images.jpg")
        shapes.append(np.asarray(Image.open(path)).shape if os.path.exists(path) else None)
    check(all(s == (256 * 8, 256, 3) for s in shapes), f"small route fakes JPEGs: {shapes}")
    return launches


def compare_routes_256() -> None:
    """Per layer: windows of the 8-iteration mix at 256² on one synthetic
    batch, warp_pallas_min_res 8 (the small-map route) and 128 (the default)
    in turns in one process (S, G, G, S), images/s each; then an even-step
    profile of the small route."""
    import torch

    from lcgan_torch.config import Config
    from lcgan_torch.train.steps import Trainer

    runs = {}
    for min_res in (8, 128):
        cfg = Config(model_name="chip_smoke_routes", img_resolution=256, batch_size=8, freezeD_start=10**9,
                     warp_pallas_min_res=min_res, device="cuda")
        trainer = Trainer(cfg)
        state = trainer.init_state()
        batch = synthetic_batch(cfg, trainer.device)
        for epoch in range(8):  # first calls
            state, _, _ = trainer.train_iteration(state, batch, epoch)
        runs[min_res] = [trainer, state, batch, []]
    for min_res in (8, 128, 128, 8) * (MIX_WINDOWS_ROUTES // 2):
        trainer, state, batch, windows = runs[min_res]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for epoch in range(8):
            state, _, _ = trainer.train_iteration(state, batch, epoch)
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
        runs[min_res][1] = state
    for min_res, (_, _, _, windows) in runs.items():
        n_img = len(windows) * 8 * 8
        print(f"train throughput at 256², 8-iteration mix, warp_pallas_min_res {min_res} "
              f"({'small-map' if min_res == 8 else 'general'} route for the 8²-64² blocks), {len(windows)} windows "
              f"in turns: {n_img} images in {sum(windows):.3f} s = {n_img / sum(windows):.2f} images/s "
              f"(windows {', '.join(f'{w * 1e3:.1f}' for w in windows)} ms)", flush=True)
    trainer, state, batch, _ = runs[8]
    noise = trainer.draw_noise(state, 8)
    profile_forward(lambda: trainer._iteration(state, batch, noise, even=True, with_r1=False, frozen=False),
                    iters=2, top=12, what="even train step at 256², warp_pallas_min_res 8")
    del runs, trainer, state, batch
    torch.cuda.empty_cache()


TRAIN_256 = ["--img_resolution", "256", "--batch_size", "8", "--freezeD_layer", "5", "--num_data_workers", "4"]
# epochs 0-3 of the 256² recipe (even, odd + R1, even, odd; unfrozen), six blocks of C >= 128:
# a G forward per block is one warp_fwd, a G backward one warp_dgrid and one warp_dx
EXPECT_256 = dict(dict.fromkeys(KERNELS, 0), warp_fwd=6 * (4 + 2 + 4 + 2), warp_dgrid=6 * (3 + 1 + 3 + 1),
                  warp_dx=6 * (3 + 1 + 3 + 1))
DP_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def all_reduces():
    """The program's own tracing (``lcgan_torch.utils.trace``) on for the
    block; yields a dict that it fills on exit with the all-reduce calls
    and bytes the program counted under a process group and the host
    seconds of the train steps' ``*.all_reduce`` spans."""
    from lcgan_torch.utils import trace

    trace.enable()
    out: dict = {}
    try:
        yield out
    finally:
        trace.disable()
        spans, counters = trace.take()
        out.update(calls=counters.get("all_reduce.calls", 0), bytes=counters.get("all_reduce.bytes", 0),
                   seconds=sum(sp.end_ns - sp.start_ns for sp in spans if sp.name.endswith(".all_reduce")) / 1e9)


def cli_worker(out: str, argv) -> int:
    """A fresh process's ``lcgan_torch.cli.main(argv)`` (plain, or as a rank
    under torchrun), its kernel launches counted from 0 and its all-reduce
    calls counted and timed by the program (it counts only under a process
    group); rank 0 writes them to ``out`` as JSON."""
    import torch

    from lcgan_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    reset_launches()
    t0 = time.perf_counter()
    with all_reduces() as reduced:
        run_cli(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if int(os.environ.get("RANK", 0)) == 0:
        with open(out, "w") as f:
            json.dump(dict(launches=read_launches(), seconds=seconds, allreduce_calls=reduced["calls"],
                           allreduce_bytes=reduced["bytes"], allreduce_s=reduced["seconds"],
                           group_left=parallel.initialized()), f)
    return 0


def run_torchrun_worker(argv, out: str) -> dict:
    """cli_worker in a fresh process under ``torchrun --standalone
    --nproc_per_node=1`` (``python -m torch.distributed.run``; NCCL)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
           os.path.abspath(__file__), "--cli-worker", out, "--", *argv]
    env = {k: v for k, v in os.environ.items() if k not in DP_ENV}
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, env=env)
    for line in proc.stdout.splitlines():
        if line.startswith("  | "):
            print(f"  torchrun {line}", flush=True)
    if proc.returncode != 0 or not os.path.exists(out):
        check(False, f"torchrun cli worker (rc {proc.returncode}): {proc.stderr[-3000:]}")
        return {}
    with open(out) as f:
        return json.load(f)


def read_checkpoint(path: str) -> dict:
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def checkpoint_mismatches(a: dict, b: dict) -> list:
    """Tensors and counters of two full-state checkpoints that differ."""
    import torch

    bad = [f"{part}.{k}" for part in ("generator", "discriminator", "ema") for k, v in a[part].items()
           if not torch.equal(b[part][k], v)]
    bad += [f"{opt}.v.{k}" for opt in ("g_opt", "d_opt") for k, v in a[opt]["v"].items()
            if not torch.equal(b[opt]["v"][k], v)]
    bad += [f"{opt}.count" for opt in ("g_opt", "d_opt") if a[opt]["count"] != b[opt]["count"]]
    bad += ["step"] * (a["step"] != b["step"]) + ["rng"] * (not torch.equal(a["rng"], b["rng"]))
    return bad


def run_dp_train(data: str, root: str) -> str:
    """Data parallelism at world size 1: the 256² train phase, epochs 0-3,
    through ``torchrun --standalone --nproc_per_node=1`` (NCCL, a fresh
    process) and through the CLI without a process group (this process),
    both in deterministic mode from the same seed: the same files, the same
    log lines, a bitwise-equal checkpoint. Returns the torchrun run's
    directory."""
    import torch

    runs = {}
    for torchrun in (False, True):
        run = os.path.join(root, "dp" if torchrun else "plain")
        argv = ["--phase", "train", "--dataset_path", data, "--model_name", run, *TRAIN_256,
                "--save_interval", "3", "--print_interval", "1", "--show_interval", "1000", "--epoch", "3"]
        if torchrun:
            res = run_torchrun_worker(argv, os.path.join(root, "dp.json"))
            if not res:
                return ""
        else:
            reset_launches()
            t0 = time.perf_counter()
            with all_reduces() as reduced:
                run_cli(argv)
            torch.cuda.synchronize()
            res = dict(launches=read_launches(), seconds=time.perf_counter() - t0, allreduce_calls=reduced["calls"])
        runs[torchrun] = (run, res)
        what = "torchrun --nproc_per_node=1" if torchrun else "plain"
        print(f"DP world size 1: {what} train phase, 256², epochs 0-3, in {res['seconds']:.3f} s "
              f"({'a fresh process: ' if torchrun else ''}first calls, data and one save included)", flush=True)
        for name, n in res["launches"].items():
            check(n == EXPECT_256[name], f"{name} launches on the {what} 256² train phase, epochs 0-3: {n} "
                                         f"(expect {EXPECT_256[name]})")
    (plain, p), (dp, d) = runs[False], runs[True]
    check(d["allreduce_calls"] == 4 * 5 and d["allreduce_bytes"] > 0 and not d["group_left"]
          and p["allreduce_calls"] == 0,
          f"torchrun run: {d['allreduce_calls']} all-reduce calls under its process group (expect {4 * 5}: G, D and "
          f"the w-avg of each training-mode G forward, 4 iterations), {d['allreduce_bytes'] / 4 / 2**20:.2f} MiB an "
          f"iteration, {d['allreduce_s'] / 4 * 1e6:.1f} host µs an iteration in the steps' all_reduce spans (the "
          f"communicator's setup in the first); the group destroyed at the end of the phase: {not d['group_left']}; "
          f"the plain run made {p['allreduce_calls']} (the group's backend is read in the 256² mix below)")
    files = {f: (os.path.exists(os.path.join(plain, f)), os.path.exists(os.path.join(dp, f)))
             for f in ("args.txt", "log.txt", "epoch.txt", "model/state.pt")}
    check(all(a and b for a, b in files.values()), f"torchrun and plain runs write the same files {files}")
    lines = [log_epochs(r) for r in (plain, dp)]
    check(lines[0] is not None and lines[0] == lines[1] and [e for e, _, _ in lines[0]] == [0, 1, 2, 3],
          f"log.txt of the torchrun run equals the plain run's, epochs 0-3 (losses {lines[1]})")
    epochs = [open(os.path.join(r, "epoch.txt")).read().strip() for r in (plain, dp)]
    check(epochs == ["3", "3"], f"epoch.txt of both runs: {epochs}")
    want, got = (read_checkpoint(os.path.join(r, "model", "state.pt")) for r in (plain, dp))
    bad = checkpoint_mismatches(want, got)
    n = sum(len(want[k]) for k in ("generator", "discriminator", "ema"))
    check(not bad, f"torchrun checkpoint bitwise equal to the plain run's (deterministic mode): {n} G/D/EMA "
                   f"tensors, both Adam trees, step and rng; mismatches {bad[:5]}")
    return dp


@contextlib.contextmanager
def torchrun_env():
    """torchrun's environment for this process at world size 1, removed after."""
    saved = {k: os.environ.get(k) for k in DP_ENV}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def compare_dp_mix_256() -> None:
    """Per layer: windows of the 8-iteration mix at 256² on one synthetic
    batch without and with a one-rank NCCL group, in turns (P, G, G, P), in
    one process, each with the program's tracing on; images/s each and the
    host µs of the steps' all-reduce spans."""
    import torch
    import torch.distributed as dist

    from lcgan_torch import parallel
    from lcgan_torch.config import Config
    from lcgan_torch.train.steps import Trainer

    cfg = Config(model_name="chip_smoke_dp", img_resolution=256, batch_size=8, freezeD_start=10**9, device="cuda")
    trainer = Trainer(cfg)
    state = trainer.init_state()
    batch = synthetic_batch(cfg, trainer.device)

    def window():
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for epoch in range(8):
            state, _, _ = trainer.train_iteration(state, batch, epoch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    window()  # first calls
    windows, plain = dict(plain=[], group=[]), []
    with all_reduces() as reduced:  # every window with the program's tracing on, as the group's
        windows["plain"].append(window())
    plain.append(reduced)
    with torchrun_env(), parallel.process_group("on", "cuda"):
        check(parallel.initialized() and parallel.world_size() == 1, "one-rank NCCL group in this process")
        state, _, _ = trainer.train_iteration(state, batch, 0)  # the communicator's first call
        backend = str(dist.get_backend())
        with all_reduces() as reduced:
            windows["group"] += [window(), window()]
    with all_reduces() as after:
        windows["plain"].append(window())
    plain.append(after)
    for name, ws in windows.items():
        n_img = len(ws) * 8 * cfg.batch_size
        print(f"train throughput at 256², 8-iteration mix, {'with a one-rank NCCL group' if name == 'group' else 'no process group'}, "
              f"{len(ws)} windows in turns (P, G, G, P): {n_img} images in {sum(ws):.3f} s = {n_img / sum(ws):.2f} images/s "
              f"(windows {', '.join(f'{w * 1e3:.1f}' for w in ws)} ms)", flush=True)
    iters = 8 * len(windows["group"])
    check([r["calls"] for r in plain] == [0, 0], f"all-reduce calls in the plain windows: {[r['calls'] for r in plain]}")
    check(reduced["calls"] == iters * 5 and backend == "nccl",
          f"all-reduce calls in the group's windows: {reduced['calls']} (expect {iters * 5}: G, D and the w-avg of each "
          f"training-mode G forward), {reduced['bytes'] / iters / 2**20:.2f} MiB an iteration, {backend}; host "
          f"{reduced['seconds'] / iters * 1e6:.1f} µs an iteration in the steps' two all_reduce spans, "
          f"{reduced['seconds'] / (2 * iters) * 1e6:.1f} µs a span")
    del state, trainer, batch
    torch.cuda.empty_cache()


def run_fid_eval(run: str) -> None:
    """fid_eval on the torchrun run's checkpoint (flagship 256² generator,
    random Inception weights, 32 reals and 32 fakes); again, which must not
    rewrite state_best.pt unless its FID is lower; --best generation from
    state_best.pt alone; Inception's card features against the CPU's."""
    import numpy as np
    import torch
    from PIL import Image

    from lcgan_torch.config import Config
    from lcgan_torch.data.dataset import ImageFolderDataset
    from lcgan_torch.eval.fid import fp32_convs
    from lcgan_torch.eval.inception import InceptionV3FID

    argv = ["--phase", "fid_eval", "--model_name", run]
    reset_launches()
    t0 = time.perf_counter()
    run_cli(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    best_pt = os.path.join(run, "model", "state_best.pt")
    files = {f: os.path.exists(os.path.join(run, f)) for f in ("fid.txt", "best_fid.txt", "model/state_best.pt")}
    check(all(files.values()), f"fid_eval files {files}")
    if not all(files.values()):
        return
    with open(os.path.join(run, "fid.txt")) as f:
        text = f.read()
    first = float(text[4:].strip()) if text.startswith("FID:") and text.endswith(" \n") else float("nan")
    print(f"fid_eval: FID {first} (random Inception weights: not comparable to the protocol's) in {seconds:.3f} s "
          "(Inception built and its weights drawn, 32 reals decoded, 32 fakes, both through Inception)", flush=True)
    check(math.isfinite(first) and first >= 0, f"fid.txt holds a finite FID: {text!r}")
    want = dict(dict.fromkeys(KERNELS, 0), warp_fwd=6 * 4)  # 4 batches of fakes, 6 blocks
    check(launches == want, f"launches in the fid_eval phase: warp_fwd {launches['warp_fwd']} (expect 24), "
                            f"no other {dict((k, v) for k, v in launches.items() if k != 'warp_fwd')}")
    check(not checkpoint_mismatches(read_checkpoint(os.path.join(run, "model", "state.pt")), read_checkpoint(best_pt)),
          "state_best.pt holds the evaluated state (equal to state.pt)")

    stamp = os.stat(best_pt).st_mtime_ns
    run_cli(argv)
    with open(os.path.join(run, "fid.txt")) as f:
        second = float(f.read()[4:].strip())
    rewritten = os.stat(best_pt).st_mtime_ns != stamp
    check(rewritten == (second < first), f"second fid_eval: FID {second} (first {first}); state_best.pt "
                                         f"{'rewritten' if rewritten else 'untouched'}, as the rule wants")

    latest = os.path.join(run, "model", "state.pt")
    os.replace(latest, latest + ".aside")
    try:
        reset_launches()
        run_cli(["--phase", "fake_image_generation", "--model_name", run, "--num_fakes", "1", "--best"])
        path = os.path.join(run, "fakes", "0000_images.jpg")
        shape = np.asarray(Image.open(path)).shape if os.path.exists(path) else None
        check(shape == (256 * 8, 256, 3) and read_launches()["warp_fwd"] == 6,
              f"--best generation from state_best.pt alone (state.pt moved aside): {shape}")
    finally:
        os.replace(latest + ".aside", latest)

    # Inception on the card against the CPU, 2 of the run's images, TF32 off
    cfg = Config.load(os.path.join(run, "args.txt"))
    dataset = ImageFolderDataset(cfg.dataset_path, cfg.img_resolution, is_train=False)
    x = torch.from_numpy(np.stack([dataset.get_eval(i)[0] for i in range(2)])).permute(0, 3, 1, 2)
    net = InceptionV3FID(generator=torch.Generator().manual_seed(0)).eval()
    with torch.inference_mode():
        ref = net(x)
        net = net.cuda()
        with fp32_convs():
            out = net(x.cuda()).cpu()
            imgs = torch.rand((32, 3, 299, 299), generator=torch.Generator().manual_seed(0)).cuda() * 2 - 1
            ms = cuda_ms(lambda: net(imgs), iters=5, hold=False)
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True  # what fid_evaluate turns off, read once for the record
        try:
            out_tf32 = net(x.cuda()).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = before
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    # fp32 through ~100 convs summed in other orders: 1e-4 of the features' scale
    check(err <= 1e-4 * scale, f"Inception features card vs CPU, 2 images 256² → 299², fp32, TF32 off: "
                               f"max_abs_err {err:.3g} (scale {scale:.3g}, tol 1e-4 of it)")
    print(f"Inception features card vs CPU with cuDNN's TF32 on instead (not a check): max_abs_err "
          f"{(out_tf32 - ref).abs().max().item():.3g} (scale {scale:.3g})", flush=True)
    print(f"Inception at 299², fp32, TF32 off, batch 32: {ms:.3f} ms = {32e3 / ms:.1f} images/s", flush=True)
    del net, imgs
    torch.cuda.empty_cache()


def run_video_generation(run: str) -> None:
    """video_generation --ctrl_dim 0 --num_videos 1 at 256²: one mp4 of 60
    frames (num_explore 30, up and down); frames/s of the whole phase."""
    import cv2
    import torch

    reset_launches()
    t0 = time.perf_counter()
    run_cli(["--phase", "video_generation", "--model_name", run, "--ctrl_dim", "0", "--num_videos", "1"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    path = os.path.join(run, "demo", "controlled_dim=0_0.mp4")
    size = os.path.getsize(path) if os.path.exists(path) else 0
    cap = cv2.VideoCapture(path)
    frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    print(f"video_generation: 60 frames of batch 8 at 256² in {seconds:.3f} s = {60 / seconds:.2f} frames/s "
          f"({480 / seconds:.1f} images/s; checkpoint load and mp4 encoding included)", flush=True)
    check(size > 0 and frames == 60, f"demo/controlled_dim=0_0.mp4: {size} bytes, {frames} frames (expect 60)")
    want = dict(dict.fromkeys(KERNELS, 0), warp_fwd=60 * 6)
    check(launches == want, f"launches in the video_generation phase: warp_fwd {launches['warp_fwd']} (expect 360), "
                            f"no other {dict((k, v) for k, v in launches.items() if k != 'warp_fwd')}")


def probe_inputs():
    """The gather probe's (256, 128) fp32 tile, and the trip-count probe's
    PROBE_PACKS packs and w, seeded."""
    import torch

    from lcgan_torch.tools import dyn_trip_probe, gather_probe

    g = torch.Generator(device="cuda").manual_seed(0)
    tile = torch.randn(gather_probe.TILE, generator=g, device="cuda")
    x = torch.randn((PROBE_PACKS, dyn_trip_probe.PACK, dyn_trip_probe.PACK), generator=g, device="cuda")
    w = torch.randn((dyn_trip_probe.PACK, dyn_trip_probe.PACK), generator=g, device="cuda")
    return tile, x, w


def trip_count(n: int):
    import torch

    return torch.tensor([n], dtype=torch.int32, device="cuda")


def check_probe_kernels() -> dict:
    """The gather kernel against its plain version at the probe's tile,
    exactly, for random, all-0 and all-255 indices; the two trip-count
    kernels against an fp64 sum at PROBE_PACKS packs for the counts
    PROBE_COUNTS (the static one where it is built for the count), and
    dyn(n) == static(n) bitwise. Returns each kernel's largest error."""
    import torch

    from lcgan_torch.tools import dyn_trip_probe as p2
    from lcgan_torch.tools import gather_probe as p1

    worst = dict.fromkeys(PROBE_KERNELS, 0.0)
    tile, x, w = probe_inputs()
    rows = p1.TILE[0]
    g = torch.Generator(device="cuda").manual_seed(1)
    for kind, idx in (("random", torch.randint(0, rows, p1.TILE, generator=g, device="cuda", dtype=torch.int32)),
                      ("all 0", torch.zeros(p1.TILE, dtype=torch.int32, device="cuda")),
                      (f"all {rows - 1}", torch.full(p1.TILE, rows - 1, dtype=torch.int32, device="cuda"))):
        out = p1.gather_probe(tile, idx)
        want = p1.take_along_rows_plain(tile, idx)
        err = (out - want).abs().max().item()
        worst["gather_probe"] = max(worst["gather_probe"], err)
        same = torch.equal(out, want)
        check(same, f"gather_probe (256,128) fp32, {kind} indices: equal to take_along_dim {same} "
                    f"(max_abs_err {err:.3g}; a gather is exact)")
    for n in PROBE_COUNTS:
        ref = (x[:n].double() @ w.double()).sum(0)
        tol = 1e-5 * ref.abs().max().item()
        got = dict(dyn_trip_dyn=p2.dyn_trip_dyn(trip_count(n), x, w))
        if n in p2.STATIC_COUNTS:
            got["dyn_trip_static"] = p2.dyn_trip_static(x, w, n)
        plain_err = (p2.packed_sum_plain(x, w, n).double() - ref).abs().max().item()
        for name, out in got.items():
            err = (out.double() - ref).abs().max().item()
            worst[name] = max(worst[name], err)
            check(err <= tol, f"{name} packs={PROBE_PACKS} n={n}: max_abs_err {err:.3g} against an fp64 sum "
                              f"(tol {tol:.3g} = 1e-5 x max|ref|); the plain version's {plain_err:.3g}")
        if "dyn_trip_static" in got:
            same = torch.equal(got["dyn_trip_dyn"], got["dyn_trip_static"])
            check(same, f"dyn_trip_dyn(n={n}) == dyn_trip_static({n}) bitwise: {same}")
    return worst


def time_gather_probe(bw: float) -> dict:
    """The gather kernel at its probe's (256, 128) tile beside its plain
    version, the one PyTorch call for the same function (torch.gather) and
    its bound, in turns (K, P, L, L, P, K; the lower of each pair). (The
    trip-count kernels: time_dyn_trip_rows.)"""
    import torch

    from lcgan_torch.tools import gather_probe as p1

    tile, _, _ = probe_inputs()
    idx = torch.randint(0, p1.TILE[0], p1.TILE, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda", dtype=torch.int32)
    idx64 = idx.long()  # torch.gather's index type, converted outside the timed region
    calls = (lambda: p1.gather_probe(tile, idx), lambda: p1.take_along_rows_plain(tile, idx),
             lambda: torch.gather(tile, 0, idx64))
    # 100 single launches (the plain version two each) fit behind cuda_ms's hold
    k1, pl1, l1, l2, pl2, k2 = (cuda_ms(calls[i], (100, 50, 100)[i]) for i in (0, 1, 2, 2, 1, 0))
    nbytes = (tile.numel() + 2 * idx.numel()) * 4  # x and idx read, out written
    r = dict(ms=min(k1, k2), plain_ms=min(pl1, pl2), library_ms=min(l1, l2), bound_ms=nbytes / bw * 1e3,
             bound_by="bytes")
    print(f"time gather_probe (256,128) fp32: kernel {r['ms']:.4f} ms, plain take_along_dim {r['plain_ms']:.4f} ms, "
          f"torch.gather {r['library_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms ({nbytes / 1024:.0f} KiB, bytes), "
          f"kernel at {r['bound_ms'] / r['ms']:.1%} of bound (launch-bound)", flush=True)
    return {"gather_probe": r}


def check_probe_output(module: str, text: str) -> None:
    """The rows and the verdict that the entry point must print."""
    lines = text.splitlines()
    if module.endswith("gather_probe"):
        rows = [line.split(":")[0] for line in lines if "ms device" in line]
        check(rows == ["A", "B", "C", "C"], f"{module}: rows A, B and C (fwd, grad) with device ms: {rows}")
    else:
        verdict = [line for line in lines if line.startswith(("GO:", "NO-GO:"))]
        check("correctness: dynamic bound == static loop at n and n/2 (bitwise)" in lines and len(verdict) == 1
              and any(line.startswith(f"packs={PROBE_PACKS} chain=32 (device, CUDA events") for line in lines),
              f"{module}: the correctness line, device times and the verdict {verdict}")


def run_probe_entry_points() -> dict:
    """The probes' main path: each entry point's main() with its defaults in
    this process, the launch counts set to 0 just before and read just after;
    then each once as ``python -m`` in a fresh process. Returns the launches
    of the in-process runs."""
    from lcgan_torch.tools import dyn_trip_probe as p2
    from lcgan_torch.tools import gather_probe as p1

    reps, chain = 64, 32  # dyn_trip_probe's defaults
    timed = (1 + 2 * reps) * chain  # one warm call, then host-clock and CUDA-event runs of reps chains
    runs = (
        (p1, dict(gather_probe=p1.gather_probe), dict(gather_probe=1 + 2 * 20)),  # row A: one warm call, 20 + 20
        (p2, dict(dyn_trip_static=p2.dyn_trip_static, dyn_trip_dyn=p2.dyn_trip_dyn),
         dict(dyn_trip_static=2 + timed, dyn_trip_dyn=2 + 2 * timed)),  # the correctness calls, then the chains
    )
    launches = {}
    for module, wrappers, expect in runs:
        for fn in wrappers.values():
            fn.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            module.main([])
        got = {name: fn.launches for name, fn in wrappers.items()}
        print(f"probe {module.__name__}.main() in {time.perf_counter() - t0:.3f} s:", flush=True)
        for line in out.getvalue().splitlines():
            print(f"  | {line}", flush=True)
        check_probe_output(module.__name__, out.getvalue())
        for name, n in got.items():
            check(n == expect[name], f"{name} launches on the probe's entry point: {n} (expect {expect[name]})")
        launches.update(got)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", module.__name__], cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        print(f"probe python -m {module.__name__}: rc {proc.returncode} in {time.perf_counter() - t0:.3f} s", flush=True)
        for line in proc.stdout.splitlines():
            print(f"  | {line}", flush=True)
        check(proc.returncode == 0, f"python -m {module.__name__} exits 0 (stderr: {proc.stderr[-1500:]})")
        check_probe_output(f"python -m {module.__name__}", proc.stdout)
    return launches


# ---------------------------------------------------------------------------
# step 9: view batching, Adam with beta1 != 0, --profile_dir, the 1024²
# recipe and the Inception converter's CLI

# (B, C, H) of the warps of the view-batched 256² G step (three views of 8:
# every block at 3B) and of the 1024² recipe at its per-GPU batch of 4
# (base_nf 32: C = 512 at 8²-64², then 256, 128, 64, 32)
BATCHED_WARPS = [(3 * b, c, h) for b, c, h in MAIN_PATH_WARPS]
RECIPE_1024_WARPS = [(4, c, h) for _, c, h in MAIN_PATH_WARPS] + [(4, 64, 512), (4, 32, 1024)]
# (B, C, H) of the 512² recipe's warps of 128² and up at its global batch of
# 32 (step 10c: K1-K3 at 128²·C256 and 256²·C128, K1, K2 and K4 at 512²·C64)
RECIPE_512_B32_WARPS = [(32, 256, 128), (32, 128, 256), (32, 64, 512)]
TRAIN_1024 = ["--img_resolution", "1024", "--batch_size", "4", "--g_lr", "1e-3", "--d_lr", "1e-3",
              "--freezeD_layer", "5", "--num_data_workers", "4"]
BATCHED_TURNS = ("unbatched", "batched", "batched", "unbatched")  # the 256² even step, in turns
EVEN_STEPS_A_TURN = 2


def check_new_shapes() -> dict:
    """warp_fwd, warp_dgrid and warp_dx (C >= 128) or warp_dx_scatter
    (C < 128) against their plain versions at the shapes steps 9 and 10
    give them first: every block of the view-batched 256² G step at B = 24,
    of the 1024² recipe at B = 4, and the 512² recipe's blocks of 128² and
    up at B = 32 (fp32 1e-5 x max(1, scale), bf16 one ulp of the scale; iid
    flow, s = 0.1). The shapes the earlier steps hold
    (1024²·C32 at B = 4 for warp_fwd and warp_dx_scatter) are not repeated.
    Returns each kernel's largest fp32 error."""
    import torch

    from lcgan_torch.ops.grid_sample import grid_sample_bicubic_plain_backward
    from lcgan_torch.ops.warp import warp_dgrid, warp_dx

    worst = dict.fromkeys(GENERAL_KERNELS, 0.0)
    for b, c, h in BATCHED_WARPS + RECIPE_1024_WARPS + RECIPE_512_B32_WARPS:
        for dtype in (torch.float32, torch.bfloat16):
            x, grid = warp_inputs(b, c, h, 0.1, dtype, seed=4)
            g = cotangent_like(x, seed=5)
            tag = f"{b}x{c}x{h}x{h} {str(dtype)[6:]} s=0.1"
            errs = {}
            if (b, c, h) not in SCATTER_SHAPES:
                errs["warp_fwd"] = check_fwd(f"warp_fwd {tag}", x, grid, lib=False)
            if c < 128:
                if (b, c, h) not in SCATTER_SHAPES:
                    errs["warp_dx_scatter"] = check_dx_one(f"warp_dx_scatter {tag}", x, grid, g)
                got = dict(warp_dgrid=warp_dgrid(x, grid, g))
            else:
                got = dict(warp_dgrid=warp_dgrid(x, grid, g), warp_dx=warp_dx(grid, g))
            torch.cuda.synchronize()
            ref_dx, ref_dgrid = grid_sample_bicubic_plain_backward(x, grid, g)
            for name, out in got.items():
                want = (ref_dgrid if name == "warp_dgrid" else ref_dx).float()
                err = (out.float() - want).abs().max().item()
                if dtype == torch.float32 or name == "warp_dgrid":  # dgrid is fp32 from either
                    tol = fp32_tol(want)
                    check(err <= tol, f"{name} {tag}: max_abs_err {err:.3g} (tol {tol:.3g} = 1e-5 x max(1, scale))")
                else:
                    ulp = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
                    check(err <= ulp, f"{name} {tag}: max_abs_err {err:.3g} (tol 1 bf16 ulp = {ulp:.3g})")
                errs[name] = err
            if dtype == torch.float32:
                for name, err in errs.items():
                    worst[name] = max(worst[name], err)
            del x, grid, g, got, ref_dx, ref_dgrid
    torch.cuda.empty_cache()
    return worst


def record_grads(opt, grads: dict, key) -> None:
    """Make ``opt.step`` keep a copy of the gradients it receives in grads[key]."""
    step = opt.step

    def record(params, g, frozen=None):
        grads[key] = [t.detach().clone() for t in g]
        step(params, g, frozen)
    opt.step = record


def check_view_batching() -> None:
    """(a) The flagship 256² recipe in fp32 (batch 8) in deterministic mode:
    one iteration of each variant, epochs 0 (even), 1 (odd + R1), 3 (odd)
    and 5 (odd, frozen from 4), from one state with the same batch and
    noise, unbatched and view-batched. Two settings make the comparison read
    the batching and not the card's fp32 rounding, which the step amplifies:
    cuDNN off (PyTorch's own convolutions compute each sample alone at any
    batch, so batching changes only the order of the sums over samples;
    cuDNN picks other algorithms at 3B and 4B than at B), and adam_eps 1
    (an update lr·g/(sqrt(v̂) + 1) follows its gradient at slope lr instead
    of lr/eps, so the G update's rounding does not reach the D step's fake
    multiplied). Losses within 1e-5 (relative); each gradient Adam receives
    within 1e-2 of its leaf's gradient in l2 norm (near-cancelled sums, such
    as the flow layers' bias gradients over 24·256² pixels, move by up to
    ~2e-3); every leaf of G, D, EMA and both Adam v trees within 1e-3 of
    max(1e-3, its scale). Epoch 1 batches nothing and must agree bitwise."""
    import torch

    from lcgan_torch.config import Config
    from lcgan_torch.train.loop import deterministic_algorithms
    from lcgan_torch.train.steps import Trainer

    cfg = Config(model_name="chip_smoke_batched", img_resolution=256, batch_size=8, compute_dtype="float32",
                 adam_eps=1.0, freezeD_start=4, freezeD_layer=5, seed=0, device="cuda")
    grads = {}
    cudnn_off = torch.backends.cudnn.flags(enabled=False, benchmark=False, deterministic=True, allow_tf32=False)
    with deterministic_algorithms(), cudnn_off:
        forms = {flag: Trainer(dataclasses.replace(cfg, view_batched_steps=flag)) for flag in (False, True)}
        states = {flag: trainer.init_state() for flag, trainer in forms.items()}
        for flag, state in states.items():
            record_grads(state.g_opt, grads, (flag, "G"))
            record_grads(state.d_opt, grads, (flag, "D"))
        names = {"G": [n for n, _ in states[False].generator.named_parameters()],
                 "D": [n for n, _ in states[False].discriminator.named_parameters()]}
        start = states[False].state_dict()
        batch = synthetic_batch(cfg, torch.device("cuda"), seed=1)
        g = torch.Generator(device="cuda").manual_seed(2)
        t0 = time.perf_counter()
        for epoch in (0, 1, 3, 5):
            noise = tuple(torch.randn((8, 64), generator=g, device="cuda") for _ in range(6))
            out = {}
            for flag, trainer in forms.items():
                state = states[flag]
                state.load_state_dict(start)
                state, g_loss, d_loss = trainer.step_variant(epoch)(state, batch, noise)
                leaves = {f"{name}.{k}": v.detach().clone() for name, m in
                          (("G", state.generator), ("D", state.discriminator), ("EMA", state.ema))
                          for k, v in m.state_dict().items()}
                leaves.update({f"{name}.v.{k}": v.clone() for name, opt in
                               (("g_opt", state.g_opt), ("d_opt", state.d_opt)) for k, v in opt.v.items()})
                out[flag] = (g_loss.item(), d_loss.item(), leaves)
            (g0, d0, ref), (g1, d1, got) = out[False], out[True]
            loss_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in ((g1, g0), (d1, d0)))
            leaf_err, where = max(((got[k] - ref[k]).abs().max().item() / max(1e-3, ref[k].abs().max().item()), k)
                                  for k in ref)
            grad_err, grad_at = max(((torch.linalg.vector_norm(b - a) / torch.linalg.vector_norm(a).clamp_min(1e-30)).item(),
                                     f"{net}.{n}") for net in ("G", "D")
                                    for n, a, b in zip(names[net], grads[(False, net)], grads[(True, net)]))
            same = all(torch.equal(got[k], ref[k]) for k in ref) and (g0, d0) == (g1, d1)
            finite = all(math.isfinite(v) for v in (g0, d0, g1, d1))
            check(finite and loss_err <= 1e-5 and grad_err <= 1e-2 and leaf_err <= 1e-3 and (same or epoch != 1),
                  f"view-batched against unbatched, flagship 256² fp32, epoch {epoch}: losses (g, d) {g1:.6f}, "
                  f"{d1:.6f} against {g0:.6f}, {d0:.6f}, rel err {loss_err:.3g} (tol 1e-5); worst gradient l2 rel err "
                  f"{grad_err:.3g} at {grad_at} (tol 1e-2); worst leaf rel err {leaf_err:.3g} at {where} (tol 1e-3 "
                  f"of max(1e-3, the leaf's scale)), {len(ref)} leaves; bitwise equal {same}")
            del out, ref, got
    print(f"view batching card check: 4 variants x 2 forms in {time.perf_counter() - t0:.1f} s", flush=True)
    del forms, states, start, batch, grads
    torch.cuda.empty_cache()


@contextlib.contextmanager
def count_iterations():
    """A block in which Trainer.train_iteration records each epoch's kernel
    launches (the wrappers' counts, read on the host before and after the
    call) into the dict it yields."""
    from lcgan_torch.train import steps

    per_epoch = {}
    original = steps.Trainer.train_iteration

    def counted(self, state, batch, epoch):
        before = read_launches()
        out = original(self, state, batch, epoch)
        after = read_launches()
        per_epoch[epoch] = {k: after[k] - before[k] for k in KERNELS}
        return out

    steps.Trainer.train_iteration = counted
    try:
        yield per_epoch
    finally:
        steps.Trainer.train_iteration = original


def trace_summary(path: str):
    """A Chrome trace's ``train_iteration epoch N`` ranges and its device
    kernels' launches by the warp kernels' names."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    epochs = sorted(int(e["name"].rsplit(" ", 1)[1]) for e in events  # the host's ranges, not their device copies
                    if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("train_iteration epoch "))
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    warps = {label: sum(1 for k in kernels if re.search(pattern, k)) for label, pattern in WARP_KERNEL_NAMES}
    return epochs, len(kernels), warps


def run_view_batched_phase(data: str, run: str) -> dict:
    """(b) The 256² train phase through the CLI in bf16 with
    --view_batched_steps --beta1 0.5 --profile_dir, epochs 0-20 on step 7's
    folder. Counts set to 0 just before and read just after, and each
    iteration's launches recorded: with every block at 3B in the G step and
    the D step's fake once, an even iteration launches warp_fwd 2, warp_dgrid
    1 and warp_dx 1 a block (unbatched: 4, 3, 3), as an odd one does. The
    trace of epochs 12-20 must hold their ranges and the warp kernels, and
    the profiler must have stopped before the phase returned. Returns the
    phase's launches."""
    import torch

    prof = os.path.join(run, "profile")
    argv = ["--phase", "train", "--dataset_path", data, "--model_name", run, *TRAIN_256, "--view_batched_steps",
            "--beta1", "0.5", "--profile_dir", prof, "--epoch", "20", "--save_interval", "20", "--print_interval", "1",
            "--show_interval", "1000"]
    reset_launches()
    t0 = time.perf_counter()
    with count_iterations() as per_epoch:
        out = run_cli(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    returned = time.time()
    launches = read_launches()
    print(f"view-batched 256² train phase, --beta1 0.5, --profile_dir: epochs 0-20 through the CLI in {seconds:.3f} s "
          "(first calls, data, the traced window and one save included)", flush=True)
    blocks = 6
    per_block = dict(warp_fwd=2, warp_dgrid=1, warp_dx=1)
    want = dict(dict.fromkeys(KERNELS, 0), **{k: n * blocks for k, n in per_block.items()})
    bad = {e: n for e, n in per_epoch.items() if n != want}
    check(sorted(per_epoch) == list(range(21)) and not bad,
          f"launches per iteration of the view-batched phase, even and odd alike: warp_fwd {want['warp_fwd']}, "
          f"warp_dgrid {want['warp_dgrid']}, warp_dx {want['warp_dx']} (2, 1, 1 a block over {blocks} blocks; "
          f"unbatched even: 4, 3, 3 a block), no other; epochs that differ: {bad}")
    check(launches == {k: 21 * n for k, n in want.items()},
          f"launches over the phase, epochs 0-20: {launches} (expect 21 x the iteration's)")
    lines = log_epochs(run)
    check(lines is not None and [e for e, _, _ in lines] == list(range(21))
          and all(math.isfinite(v) for _, g, d in lines for v in (g, d)) and "restart training from" not in out,
          f"view-batched phase log.txt, epochs 0-20, finite losses: {lines and lines[-3:]}")
    state = torch.load(os.path.join(run, "model", "state.pt"), map_location="cpu", weights_only=True)
    check(set(state["g_opt"]) == set(state["d_opt"]) == {"mu", "v", "count"} and state["g_opt"]["count"] == 21,
          f"state.pt carries Adam's first moment: g_opt {sorted(state['g_opt'])}, count {state['g_opt']['count']}")
    files = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
    name = "trace_epochs_12-20_rank0.json"
    check(files == [name], f"--profile_dir holds {files} (expect [{name}])")
    if files == [name]:
        path = os.path.join(prof, name)
        epochs, n_kernels, warps = trace_summary(path)
        traced = {k: sum(per_epoch[e][k] for e in range(12, 21)) for k in per_block}
        stopped = not torch.autograd._profiler_enabled() and os.stat(path).st_mtime < returned
        check(epochs == list(range(12, 21)) and warps["warp_fwd"] == traced["warp_fwd"] and warps["warp_dgrid"] > 0
              and warps["warp_dx"] > 0 and stopped,
              f"trace of epochs 12-20 ({os.path.getsize(path) / 2**20:.1f} MiB, {n_kernels} device kernels): ranges of "
              f"epochs {epochs}, warp kernels {dict((k, v) for k, v in warps.items() if v)} (warp_fwd expect "
              f"{traced['warp_fwd']}, launched in the window); profiler stopped before the phase returned: {stopped}")
    del state
    return launches


def time_batched_even_step() -> dict:
    """The flagship 256² even step (bf16, batch 8) unbatched and
    view-batched, in turns (U, B, B, U): each turn times EVEN_STEPS_A_TURN
    synchronized steps on the host clock; each form's first turn then
    profiles two (device ms and the device's idle share, profiler on). Peak
    memory of each form over its turns. Returns the forms' figures."""
    import torch

    from lcgan_torch.config import Config
    from lcgan_torch.train.steps import Trainer

    cfg = Config(model_name="chip_smoke_batched_time", img_resolution=256, batch_size=8, freezeD_start=10**9,
                 device="cuda")
    runs = {}
    for form in ("unbatched", "batched"):
        trainer = Trainer(dataclasses.replace(cfg, view_batched_steps=form == "batched"))
        state = trainer.init_state()
        batch = synthetic_batch(cfg, trainer.device)
        for _ in range(2):  # first calls
            trainer._iteration(state, batch, trainer.draw_noise(state, 8), even=True, with_r1=False, frozen=False)
        runs[form] = dict(trainer=trainer, state=state, batch=batch, host=[], device=[], idle=[], peak=0.0)
    for form in BATCHED_TURNS:
        r = runs[form]
        trainer, state, batch = r["trainer"], r["state"], r["batch"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(EVEN_STEPS_A_TURN):
            noise = trainer.draw_noise(state, 8)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer._iteration(state, batch, noise, even=True, with_r1=False, frozen=False)
            torch.cuda.synchronize()
            r["host"].append((time.perf_counter() - t0) * 1e3)
        r["peak"] = max(r["peak"], torch.cuda.max_memory_allocated() / 2**30)
        if r["device"]:  # one profile a form
            continue
        noise = trainer.draw_noise(state, 8)
        prof = profile_forward(lambda: trainer._iteration(state, batch, noise, even=True, with_r1=False, frozen=False),
                               iters=2, top=3, what=f"even train step at 256², {form}")
        r["device"].append(prof["device_ms"])
        r["idle"].append(prof["idle"])
    summary = {}
    for form, r in runs.items():
        summary[form] = dict(host_ms=statistics.median(r["host"]), device_ms=min(r["device"]),
                             idle=sum(r["idle"]) / len(r["idle"]), peak=r["peak"])
        print(f"train step even at 256², {form}, 2 turns of {EVEN_STEPS_A_TURN} in turns (U, B, B, U): "
              f"host ms median {summary[form]['host_ms']:.2f} (all {', '.join(f'{t:.1f}' for t in r['host'])}); device "
              f"ms {', '.join(f'{t:.2f}' for t in r['device'])}; device idle {', '.join(f'{t:.1%}' for t in r['idle'])} "
              f"(profiler on); peak memory {r['peak']:.2f} GiB", flush=True)
    u, b = summary["unbatched"], summary["batched"]
    print(f"view batching at 256², even step: host {b['host_ms'] / u['host_ms'] - 1:+.1%}, device "
          f"{b['device_ms'] / u['device_ms'] - 1:+.1%}, peak memory {b['peak'] / u['peak'] - 1:+.1%}", flush=True)
    del runs
    torch.cuda.empty_cache()
    return summary


def run_train_1024(data: str, run: str) -> dict:
    """(c) The reference's 1024² recipe (per-GPU batch 4 of the global 32
    on 8 GPUs, lr 1e-3, freezeD_layer 5; base_nf 32) through the CLI in
    bf16, epochs 0-3 on a synthetic folder of 1024² JPEGs. Counts set to 0
    just before and read just after: over the 8 blocks warp_fwd 8·12 = 96,
    warp_dgrid 8·8 = 64, warp_dx 6·8 = 48 (C >= 128), warp_dx_scatter 2·8 =
    16 (512²·C64 and 1024²·C32). Then, in this process on the port's
    pipeline, an iteration to warm up, one window of the 8-iteration mix
    (images/s, peak memory), the even step (min of 3, host clock) and its
    profile. Returns the phase's launches."""
    import torch

    from lcgan_torch.config import Config
    from lcgan_torch.train.loop import deterministic_algorithms, make_train_pipeline
    from lcgan_torch.train.steps import Trainer

    argv = ["--phase", "train", "--dataset_path", data, "--model_name", run, *TRAIN_1024, "--epoch", "3",
            "--save_interval", "3", "--print_interval", "1", "--show_interval", "1000"]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = run_cli(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    peak_phase = torch.cuda.max_memory_allocated() / 2**30
    print(f"1024² recipe: epochs 0-3 through the CLI in {seconds:.3f} s (first calls, data and one save included); "
          f"peak memory {peak_phase:.2f} GiB", flush=True)
    expect = dict(dict.fromkeys(KERNELS, 0), warp_fwd=8 * 12, warp_dgrid=8 * 8, warp_dx=6 * 8, warp_dx_scatter=2 * 8)
    for name, n in launches.items():
        check(n == expect[name], f"{name} launches on the 1024² train phase, epochs 0-3: {n} (expect {expect[name]})")
    lines = log_epochs(run)
    check(lines is not None and [e for e, _, _ in lines] == [0, 1, 2, 3]
          and all(math.isfinite(v) for _, g, d in lines for v in (g, d)) and "restart training from" not in out
          and os.path.exists(os.path.join(run, "model", "state.pt")),
          f"1024² phase log.txt, epochs 0-3, finite losses, state.pt written: {lines}")

    cfg = Config.load(os.path.join(run, "args.txt"))
    with deterministic_algorithms():
        trainer = Trainer(cfg)
        state = trainer.init_state()
        n_g = sum(p.numel() for p in state.generator.parameters()) / 1e6
        n_d = sum(p.numel() for p in state.discriminator.parameters()) / 1e6
        print(f"1024² recipe: G {n_g:.2f} M + D {n_d:.2f} M params, bf16, batch 4", flush=True)
        data_it = make_train_pipeline(cfg, trainer.device)
        state, _, _ = trainer.train_iteration(state, next(data_it), 0)  # a first call (the CLI's warmed cuDNN)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for epoch in range(8):
            state, g_loss, d_loss = trainer.train_iteration(state, next(data_it), epoch)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"train throughput at 1024², the 8-iteration mix fed by the port's pipeline, deterministic, 1 window: "
              f"32 images in {window:.3f} s = {32 / window:.2f} images/s; peak memory {peak:.2f} GiB", flush=True)
        check(math.isfinite(g_loss.item()) and math.isfinite(d_loss.item()), "1024² mix losses finite")
        batch = next(data_it)
        times = []
        for _ in range(3):
            noise = trainer.draw_noise(state, cfg.batch_size)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer._iteration(state, batch, noise, even=True, with_r1=False, frozen=False)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"train step even at 1024²: {min(times):.2f} ms (min of 3: {', '.join(f'{t:.2f}' for t in times)})",
              flush=True)
        noise = trainer.draw_noise(state, cfg.batch_size)
        profile_forward(lambda: trainer._iteration(state, batch, noise, even=True, with_r1=False, frozen=False),
                        iters=1, top=8, what="even train step at 1024² (deterministic)")
    del state, trainer, data_it, batch
    torch.cuda.empty_cache()
    return launches


def synthetic_inception_pth(path: str) -> None:
    """pytorch-fid's state-dict layout (``<prefix>.conv.weight`` and
    ``<prefix>.bn.{weight,bias,running_mean,running_var}`` for each
    BasicConv2d) with seeded random weights and BatchNorm statistics, keyed
    by the port's InceptionV3FID."""
    import torch

    from lcgan_torch.eval.inception import InceptionV3FID

    g = torch.Generator().manual_seed(7)
    sd = {}
    for key, t in InceptionV3FID(generator=g).state_dict().items():
        prefix, leaf = key.rsplit(".", 1)
        if leaf == "weight":
            n = t.shape[0]
            sd[f"{prefix}.conv.weight"] = t
            sd[f"{prefix}.bn.weight"] = 1 + 0.1 * torch.randn(n, generator=g)
            sd[f"{prefix}.bn.bias"] = 0.1 * torch.randn(n, generator=g)
            sd[f"{prefix}.bn.running_mean"] = 0.1 * torch.randn(n, generator=g)
            sd[f"{prefix}.bn.running_var"] = 0.5 + torch.rand(n, generator=g)
            sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)
    torch.save(sd, path)


def run_converter(tmp: str) -> None:
    """(d) ``python -m lcgan_torch.eval.convert`` on a synthetic pytorch-fid
    .pth in a fresh process; the .npz it writes loaded into InceptionV3FID on
    the card: equal leaves and bitwise-equal features to the .pth read
    directly, and the BatchNorm folded as the rule says."""
    import numpy as np
    import torch

    from lcgan_torch.eval.convert import load_weights
    from lcgan_torch.eval.fid import fp32_convs
    from lcgan_torch.eval.inception import InceptionV3FID

    pth, npz = os.path.join(tmp, "synthetic_pt_inception.pth"), os.path.join(tmp, "inception_fid.npz")
    synthetic_inception_pth(pth)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "lcgan_torch.eval.convert", pth, npz],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=300)
    print(f"python -m lcgan_torch.eval.convert: rc {proc.returncode} in {time.perf_counter() - t0:.3f} s: "
          f"{proc.stdout.strip()[-300:]}", flush=True)
    check(proc.returncode == 0 and os.path.exists(npz) and "WARNING" in proc.stdout,
          f"converter CLI wrote {os.path.basename(npz)} (and warned: not the reference fingerprint); "
          f"stderr: {proc.stderr[-800:]}")
    if proc.returncode:
        return
    from_npz, from_pth = load_weights(npz), load_weights(pth)
    raw = torch.load(pth, map_location="cpu", weights_only=True)
    p = "Mixed_6e.branch7x7_2"
    gamma, beta, mean, var = (raw[f"{p}.bn.{k}"].numpy() for k in ("weight", "bias", "running_mean", "running_var"))
    scale = gamma / np.sqrt(var + 1e-3)
    with np.load(npz) as f:
        hwio = f[f"{p.replace('.', '/')}/weight"].shape
        n_keys = len(f.files)
    check(from_npz.keys() == from_pth.keys() and all(torch.equal(from_npz[k], v) for k, v in from_pth.items())
          and np.array_equal(from_npz[f"{p}.bn_scale"].numpy(), scale.astype(np.float32))
          and np.array_equal(from_npz[f"{p}.bn_bias"].numpy(), (beta - mean * scale).astype(np.float32))
          and hwio == tuple(raw[f"{p}.conv.weight"].permute(2, 3, 1, 0).shape),
          f"the .npz ({n_keys} leaves, weights HWIO, e.g. {p} {hwio}) equals the .pth's folded leaves")
    x = torch.rand((2, 3, 256, 256), generator=torch.Generator().manual_seed(3)) * 2 - 1
    feats = []
    for sd in (from_npz, from_pth):
        net = InceptionV3FID()
        net.load_state_dict(sd)
        net = net.cuda().eval()
        with torch.inference_mode(), fp32_convs():
            feats.append(net(x.cuda()).cpu())
    same = torch.equal(*feats)
    check(same and bool(torch.isfinite(feats[0]).all()) and feats[0].shape == (2, 2048),
          f"InceptionV3FID on the card from the .npz: features {tuple(feats[0].shape)} finite, bitwise equal to "
          f"the .pth's: {same}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# step 10: the remat switches, and the 512² recipe at its global batch of 32
# on one card

# form: (remat_blocks, conv saves for G and D, remat_save_max_res)
REMAT_FORMS = {"off": (False, True, 1024), "plain": (True, False, 1024), "saves": (True, True, 1024),
               "saves64": (True, True, 64)}
REMAT_TURNS = ("off", "plain", "saves", "saves", "plain", "off")  # the 512² even step, in turns
TRAIN_512_B32 = ["--img_resolution", "512", "--batch_size", "32", "--freezeD_layer", "4", "--num_data_workers", "4",
                 "--remat_blocks"]


def remat_config(cfg, form: str):
    on, save, max_res = REMAT_FORMS[form]
    return dataclasses.replace(cfg, remat_blocks=on, remat_save_g_convs=save, remat_save_d_convs=save,
                               remat_save_max_res=max_res)


def check_remat_bitwise() -> None:
    """(a) The flagship 256² recipe in fp32 under the train phase's
    deterministic settings (``deterministic_algorithms``: cuDNN on, its
    algorithm fixed per shape): one iteration of epochs 0 (even), 1 (odd +
    R1), 3 (odd) and 5 (odd, frozen from 4) from one state with the same
    batch and noise, with remat off and under each policy (no saves; the JAX
    saves; the saves with remat_save_max_res 64, so G's 128² and 256² blocks
    and D's 256² and 128² blocks take the plain remat), then epoch 0 on the
    small-map route (warp_pallas_min_res 8: K5-K7 on the 8²-64² blocks).
    The losses and every gradient Adam receives must be bitwise equal to
    remat off's: the recompute runs the same kernels on the same inputs.
    Each iteration's warp launches are counted: under remat, each launch of
    a grid-gradient kernel (one per differentiated block application) comes
    with one more forward launch on the same route, the recompute's."""
    import torch

    from lcgan_torch.config import Config
    from lcgan_torch.train.loop import deterministic_algorithms
    from lcgan_torch.train.steps import Trainer

    cfg = Config(model_name="chip_smoke_remat", img_resolution=256, batch_size=8, compute_dtype="float32",
                 freezeD_start=4, freezeD_layer=5, seed=0, device="cuda")
    t0 = time.perf_counter()
    with deterministic_algorithms():
        for route, min_res, epochs in (("general", 128, (0, 1, 3, 5)), ("small-map", 8, (0,))):
            base = dataclasses.replace(cfg, warp_pallas_min_res=min_res)
            trainers = {form: Trainer(remat_config(base, form)) for form in REMAT_FORMS}
            states = {form: trainer.init_state() for form, trainer in trainers.items()}
            grads = {}
            for form, state in states.items():
                record_grads(state.g_opt, grads, (form, "G"))
                record_grads(state.d_opt, grads, (form, "D"))
            start = states["off"].state_dict()
            batch = synthetic_batch(cfg, torch.device("cuda"), seed=1)
            g = torch.Generator(device="cuda").manual_seed(2)
            for epoch in epochs:
                noise = tuple(torch.randn((8, 64), generator=g, device="cuda") for _ in range(6))
                losses, launches = {}, {}
                for form, trainer in trainers.items():
                    state = states[form]
                    state.load_state_dict(start)
                    reset_launches()
                    _, g_loss, d_loss = trainer.step_variant(epoch)(state, batch, noise)
                    losses[form] = (g_loss, d_loss)
                    launches[form] = {k: n for k, n in read_launches().items() if n}
                ref, off = losses["off"], launches["off"]
                want = dict(off)
                for fwd, dgrid in (("warp_fwd", "warp_dgrid"), ("warp_fwd_small", "warp_dgrid_small")):
                    if dgrid in off:
                        want[fwd] += off[dgrid]
                check(all(launches[form] == want for form in list(REMAT_FORMS)[1:]),
                      f"warp launches, {route} route, epoch {epoch}: off {off}, under remat {launches['plain']} "
                      f"(saves {launches['saves']}, saves64 {launches['saves64']}; expect a forward launch more for "
                      f"each grid-gradient launch)")
                for form in list(REMAT_FORMS)[1:]:
                    same_loss = all(torch.equal(a, b) for a, b in zip(losses[form], ref))
                    same_grads = {net: all(torch.equal(a, b) for a, b in zip(grads[(form, net)], grads[("off", net)]))
                                  for net in ("G", "D")}
                    finite = all(math.isfinite(v.item()) for v in losses[form])
                    check(finite and same_loss and all(same_grads.values()),
                          f"remat {form} against remat off, flagship 256² fp32, {route} route, epoch {epoch}: losses "
                          f"(g, d) {losses[form][0].item():.6f}, {losses[form][1].item():.6f} bitwise equal {same_loss}; "
                          f"gradients bitwise equal: G ({len(grads[(form, 'G')])} leaves) {same_grads['G']}, "
                          f"D ({len(grads[(form, 'D')])}) {same_grads['D']}")
            del trainers, states, grads, start, batch
            torch.cuda.empty_cache()
    print(f"remat card check: 5 iterations x 4 forms in {time.perf_counter() - t0:.1f} s", flush=True)


def even_step_alone(cfg) -> dict:
    """A fresh state's even step at cfg (deterministic), after one to warm
    up: its peak memory (GiB: what the state, the batch and the step
    allocate, above what was allocated before the state was built, after
    earlier steps' garbage such as record_grads' reference cycles is
    collected) and the warp launches of the second step, with the trainer,
    the state and the batch for more steps. The first step's losses and the
    gradients Adam receives are kept on the host ("first": G, D, losses),
    out of the second step's peak."""
    import torch

    from lcgan_torch.train.loop import deterministic_algorithms
    from lcgan_torch.train.steps import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2**30
    with deterministic_algorithms():
        trainer = Trainer(cfg)
        state = trainer.init_state()
        batch = synthetic_batch(cfg, trainer.device)
        first = {}
        record_grads(state.g_opt, first, "G")
        record_grads(state.d_opt, first, "D")
        _, g_loss, d_loss = trainer._iteration(state, batch, trainer.draw_noise(state, cfg.batch_size), even=True,
                                               with_r1=False, frozen=False)
        del state.g_opt.step, state.d_opt.step  # the optimizers' own step again
        first = {net: [t.cpu() for t in grads] for net, grads in first.items()}
        first["losses"] = (g_loss.cpu(), d_loss.cpu())
        del g_loss, d_loss
        noise = trainer.draw_noise(state, cfg.batch_size)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        trainer._iteration(state, batch, noise, even=True, with_r1=False, frozen=False)
        torch.cuda.synchronize()
        launches = {k: n for k, n in read_launches().items() if n}
        peak = torch.cuda.max_memory_allocated() / 2**30 - resident
    print(f"  ({resident:.3f} GiB allocated before the {cfg.img_resolution}² batch-{cfg.batch_size} state was built, "
          "not counted)", flush=True)
    return dict(trainer=trainer, state=state, batch=batch, peak=peak, launches=launches, first=first)


def time_remat_512() -> dict:
    """(b) The 512² recipe's even step (bf16, batch 8, deterministic) with
    remat off (O), on without saves (N) and on with the JAX saves (S). Each
    form alone first (the earlier forms' states stay, their bytes not
    counted): its peak memory and the warp launches of one step (off 28,
    21, 18, 3 for K1-K4; on, K1 49: the G step's three differentiated G
    applications recompute their seven blocks, each relaunching K1 to
    rebuild the warp's saved inputs), and its first step's losses and
    gradients, which must be bitwise equal across the forms: the three
    states, batches and noises come from one seed, so this holds K4 and bf16
    under remat to remat off. Then the three forms in turns (O, N,
    S, S, N, O), each turn EVEN_STEPS_A_TURN steps on the host clock; each
    form's first turn then profiles one (device ms, idle share, K1's device
    ms). Last, remat off at batch 16, alone, and the linear extrapolation of
    the off peak to batch 32 against the card's memory (nothing is run at
    32 without remat). Returns the forms' figures."""
    import torch

    from lcgan_torch.config import Config
    from lcgan_torch.train.loop import deterministic_algorithms

    cfg = Config(model_name="chip_smoke_remat_512", img_resolution=512, batch_size=8, freezeD_layer=4,
                 freezeD_start=10**9, device="cuda")
    forms = ("off", "plain", "saves")
    runs = {}
    for form in forms:
        runs[form] = dict(even_step_alone(remat_config(cfg, form)), host=[], device=[], idle=[], k1=[])
        print(f"remat {form} at 512², batch 8, even step alone: peak memory {runs[form]['peak']:.2f} GiB; warp "
              f"launches {runs[form]['launches']}", flush=True)
    want = dict(warp_fwd=28, warp_dgrid=21, warp_dx=18, warp_dx_scatter=3)
    check(runs["off"]["launches"] == want and all(runs[f]["launches"] == dict(want, warp_fwd=49) for f in forms[1:]),
          f"warp launches per 512² even iteration: off {runs['off']['launches']}, plain {runs['plain']['launches']}, "
          f"saves {runs['saves']['launches']} (expect K1 28 off and 49 under remat: +7 a differentiated G "
          f"application; K2 21, K3 18, K4 3 in every form)")
    check(runs["plain"]["peak"] < runs["off"]["peak"] and runs["saves"]["peak"] < runs["off"]["peak"],
          f"remat lowers the 512² batch-8 peak: off {runs['off']['peak']:.2f}, plain {runs['plain']['peak']:.2f}, "
          f"saves {runs['saves']['peak']:.2f} GiB")
    ref = runs["off"]["first"]
    for form in forms[1:]:
        got = runs[form].pop("first")
        same_loss = all(torch.equal(a, b) for a, b in zip(got["losses"], ref["losses"]))
        same_grads = {net: len(got[net]) == len(ref[net]) and all(torch.equal(a, b) for a, b in zip(got[net], ref[net]))
                      for net in ("G", "D")}
        finite = all(math.isfinite(v.item()) for v in got["losses"])
        check(finite and same_loss and all(same_grads.values()),
              f"remat {form} against remat off, 512² bf16 batch 8, the first even step from one seeded state, batch "
              f"and noise: losses (g, d) {got['losses'][0].item():.6f}, {got['losses'][1].item():.6f} bitwise equal "
              f"{same_loss}; gradients bitwise equal: G ({len(got['G'])} leaves) {same_grads['G']}, "
              f"D ({len(got['D'])}) {same_grads['D']}")
    del runs["off"]["first"], ref, got

    with deterministic_algorithms():
        for form in REMAT_TURNS:
            r = runs[form]
            trainer, state, batch = r["trainer"], r["state"], r["batch"]
            for _ in range(EVEN_STEPS_A_TURN):
                noise = trainer.draw_noise(state, 8)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer._iteration(state, batch, noise, even=True, with_r1=False, frozen=False)
                torch.cuda.synchronize()
                r["host"].append((time.perf_counter() - t0) * 1e3)
            if r["device"]:  # one profile a form
                continue
            noise = trainer.draw_noise(state, 8)
            prof = profile_forward(lambda: trainer._iteration(state, batch, noise, even=True, with_r1=False,
                                                              frozen=False),
                                   iters=1, top=16 if form == "off" else 4,
                                   what=f"even train step at 512², remat {form}")
            r["device"].append(prof["device_ms"])
            r["idle"].append(prof["idle"])
            r["k1"].append(prof["warp_fwd_ms"])
    for r in runs.values():
        del r["trainer"], r["state"], r["batch"]
    del trainer, state, batch, noise
    o = runs["off"]
    for form in forms:
        r = runs[form]
        r["host_ms"], r["device_ms"] = statistics.median(r["host"]), r["device"][0]
        print(f"train step even at 512², remat {form}, 2 turns of {EVEN_STEPS_A_TURN} in turns (O, N, S, S, N, O): "
              f"host ms median {r['host_ms']:.2f} (all {', '.join(f'{t:.1f}' for t in r['host'])}); device ms "
              f"{r['device_ms']:.2f}, idle {r['idle'][0]:.1%} (profiler on); K1 {r['k1'][0]:.3f} ms device; peak "
              f"{r['peak']:.2f} GiB; against off: host {r['host_ms'] / o['host_ms'] - 1:+.1%}, device "
              f"{r['device_ms'] / o['device_ms'] - 1:+.1%}, peak {r['peak'] / o['peak'] - 1:+.1%}", flush=True)

    alone16 = even_step_alone(dataclasses.replace(cfg, batch_size=16))
    peak16 = alone16["peak"]
    del alone16
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    peak32 = peak16 + 2 * (peak16 - o["peak"])
    print(f"remat off at 512², even step alone: peak {o['peak']:.2f} GiB at batch 8, {peak16:.2f} GiB at batch 16; "
          f"linear to batch 32: {peak32:.2f} GiB against the card's {total:.2f} GiB "
          f"({'over' if peak32 > total else 'under'} it)", flush=True)
    check(peak16 > o["peak"], f"the off peak grows with the batch: {o['peak']:.2f} -> {peak16:.2f} GiB")
    return dict(runs, peak16=peak16, peak32_linear=peak32, total=total)


def run_train_512_b32(data: str, run: str) -> dict:
    """(c) The slice: ``python -m lcgan_torch.cli --phase train`` at the
    512² recipe with its global batch of 32 on one card, under
    ``--remat_blocks`` (the JAX saves), epochs 0-3 on a seeded folder of 32
    synthetic 512² JPEGs (one full batch). Counts set to 0 just before and
    read just after: warp_fwd 84 + 56 recompute launches (7 blocks x 8
    differentiated G applications) = 140, warp_dgrid 56, warp_dx 48,
    warp_dx_scatter 8, as at batch 8. Finite losses; the phase's peak
    memory under the card's. Generation from the run's checkpoint (remat on
    in its args.txt) launches warp_fwd 7 a batch, as without remat. Then
    one window of the 8-iteration mix on the port's pipeline (images/s,
    peak). Returns the phase's launches."""
    import torch

    from lcgan_torch.config import Config
    from lcgan_torch.train.loop import deterministic_algorithms, make_train_pipeline
    from lcgan_torch.train.steps import Trainer

    argv = ["--phase", "train", "--dataset_path", data, "--model_name", run, *TRAIN_512_B32, "--epoch", "3",
            "--save_interval", "3", "--print_interval", "1", "--show_interval", "1000"]
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  ({torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated before the phase)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = run_cli(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    peak_phase = torch.cuda.max_memory_allocated() / 2**30
    print(f"512² recipe at batch 32, --remat_blocks: epochs 0-3 through the CLI in {seconds:.3f} s (first calls, data "
          f"and one save included); peak memory {peak_phase:.2f} GiB of the card's {total:.2f}", flush=True)
    expect = dict(dict.fromkeys(KERNELS, 0), warp_fwd=7 * 12 + 7 * 8, warp_dgrid=7 * 8, warp_dx=6 * 8,
                  warp_dx_scatter=1 * 8)
    for name, n in launches.items():
        check(n == expect[name], f"{name} launches on the 512² batch-32 remat phase, epochs 0-3: {n} "
                                 f"(expect {expect[name]})")
    lines = log_epochs(run)
    cfg = Config.load(os.path.join(run, "args.txt"))
    check(lines is not None and [e for e, _, _ in lines] == [0, 1, 2, 3]
          and all(math.isfinite(v) for _, g, d in lines for v in (g, d)) and "restart training from" not in out
          and cfg.remat_blocks and cfg.batch_size == 32 and peak_phase < total,
          f"512² batch-32 remat phase: log.txt epochs 0-3, finite losses {lines}; args.txt remat_blocks "
          f"{cfg.remat_blocks}, batch_size {cfg.batch_size}; peak {peak_phase:.2f} < {total:.2f} GiB")
    reset_launches()  # generation from this run (remat on in its args.txt) runs no_grad: no recompute
    run_cli(["--phase", "fake_image_generation", "--model_name", run, "--num_fakes", "1", "--batch_size", "8"])
    gen = {k: n for k, n in read_launches().items() if n}
    check(gen == {"warp_fwd": 7}, f"launches of fake_image_generation from the remat run (one batch of 8): {gen} "
                                  "(expect warp_fwd 7, as without remat)")

    with deterministic_algorithms():
        trainer = Trainer(cfg)
        state = trainer.init_state()
        data_it = make_train_pipeline(cfg, trainer.device)
        state, _, _ = trainer.train_iteration(state, next(data_it), 0)  # a first call
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for epoch in range(8):
            state, g_loss, d_loss = trainer.train_iteration(state, next(data_it), epoch)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
    n_img = 8 * cfg.batch_size
    print(f"train throughput at 512², batch 32, --remat_blocks, the 8-iteration mix fed by the port's pipeline, "
          f"deterministic, 1 window: {n_img} images in {window:.3f} s = {n_img / window:.2f} images/s; peak memory "
          f"{peak:.2f} GiB", flush=True)
    check(math.isfinite(g_loss.item()) and math.isfinite(d_loss.item()) and peak < total,
          f"512² batch-32 remat mix: losses finite, peak {peak:.2f} < {total:.2f} GiB")
    del state, trainer, data_it
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the train phase runs deterministic cuBLAS, which reads this before the first CUDA call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}, {torch.cuda.device_count()} device(s)")
    bw, flops = card_rates(name)

    def stamp(step: str) -> None:
        print(f"chip_smoke: {step} done at {time.perf_counter() - t_start:.1f} s", flush=True)

    build_kernels()
    worst = dict(warp_fwd=check_warp_kernel(), **check_backward_kernels(), warp_dx_scatter=check_dx_scatter(),
                 **check_small_kernels(), **check_pool_kernels())
    stamp("steps 1-2 (build, kernels against their plain versions)")
    times = line_totals(time_kernel_rows(TIMED_KERNELS, bw, flops, flows=FLOWS[:1], yardsticks=True))
    times.update(time_pool_rows(bw))
    stamp("step 3 (kernel times)")
    run_generation_path()
    stamp("step 4 (generation)")
    run_training_path()
    check_none_route()
    check_training_card_vs_cpu()
    stamp("step 5 (training iteration)")
    with tempfile.TemporaryDirectory(prefix="lcgan_smoke_512_") as tmp:
        data = os.path.join(tmp, "data")
        synthetic_jpeg_folder(data, 32, 512)
        launches = run_train_phase(data, os.path.join(tmp, "run"))  # the 512² path: the general kernels' counts
        run_train_512(data, os.path.join(tmp, "mix"))
        check_resume_512(os.path.join(tmp, "resume"))
    stamp("step 6 (512² train phase)")
    with tempfile.TemporaryDirectory(prefix="lcgan_smoke_256_") as tmp:
        data = os.path.join(tmp, "data")
        synthetic_jpeg_folder(data, 32, 256)
        small = run_train_phase_small(data, os.path.join(tmp, "run"))  # the small-map counts
        launches.update({k: small[k] for k in SMALL_KERNELS})
        compare_routes_256()
        stamp("step 7 (small-map route)")
        dp = run_dp_train(data, tmp)  # this slice's paths: data parallelism, fid_eval, video_generation
        compare_dp_mix_256()
        stamp("step 8, data parallelism")
        if dp:
            run_fid_eval(dp)
            stamp("step 8, fid_eval")
            run_video_generation(dp)
            stamp("step 8, video_generation")
        for kernel, err in check_new_shapes().items():  # step 9: view batching, --beta1, --profile_dir, 1024², convert
            worst[kernel] = max(worst[kernel], err)
        check_view_batching()
        stamp("step 9a (view batching on the card)")
        run_view_batched_phase(data, os.path.join(tmp, "batched"))
        time_batched_even_step()
        stamp("step 9b (view-batched train phase, --beta1 0.5, --profile_dir)")
    with tempfile.TemporaryDirectory(prefix="lcgan_smoke_1024_") as tmp:
        data = os.path.join(tmp, "data")
        synthetic_jpeg_folder(data, 16, 1024)
        run_train_1024(data, os.path.join(tmp, "run"))
        stamp("step 9c (1024² recipe)")
        run_converter(tmp)
        stamp("step 9d (Inception converter)")
    check_remat_bitwise()  # step 10: the remat switches, the 512² recipe at batch 32
    stamp("step 10a (remat on against off, bitwise)")
    time_remat_512()
    stamp("step 10b (remat's cost at the 512² recipe's batch of 8)")
    with tempfile.TemporaryDirectory(prefix="lcgan_smoke_512_b32_") as tmp:
        data = os.path.join(tmp, "data")
        synthetic_jpeg_folder(data, 32, 512)
        run_train_512_b32(data, os.path.join(tmp, "run"))
    stamp("step 10c (512² recipe at batch 32 under remat)")
    worst.update(check_probe_kernels())  # the probes: their own entry points
    times.update(time_gather_probe(bw))
    launches.update(run_probe_entry_points())
    print(f"chip_smoke: whole run {time.perf_counter() - t_start:.1f} s", flush=True)

    # per launch: each row's times over the calls it sums, for ranking the
    # kernels by launches x (time - bound)
    summed = dict.fromkeys(("warp_fwd", "warp_dgrid", "warp_dx"), len(MAIN_PATH_WARPS))
    summed.update(dict.fromkeys(SMALL_KERNELS, len(SMALL_PATH_WARPS)))
    summed.update(dict.fromkeys(POOL_KERNELS, len(POOL_LARGE)))
    for kernel in KERNELS + PROBE_KERNELS + POOL_KERNELS:
        ms, bound = (times[kernel][k] / summed.get(kernel, 1) for k in ("ms", "bound_ms"))
        print(f"per launch {kernel}: {ms:.4f} ms, bound {bound:.4f} ms, {launches[kernel]} launches, "
              f"launches x (ms - bound) = {launches[kernel] * (ms - bound):.3f} ms", flush=True)

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    replaces = dict(warp_fwd="lcgan_tpu/ops/warp_pallas.py:442", warp_dgrid="lcgan_tpu/ops/warp_pallas.py:835",
                    warp_dx="lcgan_tpu/ops/warp_pallas.py:901", warp_dx_scatter="lcgan_tpu/ops/warp_pallas.py:988",
                    warp_fwd_small="lcgan_tpu/ops/warp_pallas.py:589", warp_dgrid_small="lcgan_tpu/ops/warp_pallas.py:629",
                    warp_dx_small="lcgan_tpu/ops/warp_pallas.py:679", **PROBE_REPLACES,
                    **dict.fromkeys(POOL_KERNELS, "none: ATen's NHWC avg_pool2d (XLA's pool in the JAX package)"))
    source = {**{name: name for name in KERNELS}, **PROBE_SOURCE, **dict.fromkeys(POOL_KERNELS, "pool2d")}
    kernels = [dict(
        name=name,
        route="cuda",
        source=f"lcgan_torch/ops/csrc/{source[name]}.cu",
        replaces=replaces[name],
        launches=launches[name],
        max_abs_err=worst[name],
        ms=times[name]["ms"],
        plain_ms=times[name]["plain_ms"],
        bound_ms=times[name]["bound_ms"],
        bound_by=times[name]["bound_by"],
        library_ms=times[name]["library_ms"],
    ) for name in KERNELS + PROBE_KERNELS + POOL_KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-worker"]:  # run_dp_train's fresh processes: --cli-worker OUT -- ARGV
        sys.exit(cli_worker(sys.argv[2], sys.argv[4:]))
    if sys.argv[1:2] == ["--resume-worker"]:  # check_resume_512's fresh process
        sys.exit(resume_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4])))
    if sys.argv[1:2] == ["--time-kernels"] and len(sys.argv) > 2:
        sys.exit(time_kernels(sys.argv[2].split(","),
                              sys.argv[3] if len(sys.argv) > 3 else os.path.dirname(os.path.abspath(__file__))))
    if sys.argv[1:2] == ["--time-pools"]:
        sys.exit(time_pools(sys.argv[2] if len(sys.argv) > 2 else os.path.dirname(os.path.abspath(__file__))))
    if sys.argv[1:2] == ["--time-backward"]:  # shorthand for --time-kernels warp_dgrid,warp_dx
        sys.exit(time_kernels(["warp_dgrid", "warp_dx"],
                              sys.argv[2] if len(sys.argv) > 2 else os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
