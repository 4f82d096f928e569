"""Smoke run of the PyTorch/CUDA port (lcgan_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds every CUDA kernel of the generation path from lcgan_torch/ops/csrc
   with nvcc for sm_90a.
2. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes, in fp32 (max abs error <= 1e-5) and bf16 (at most one
   bf16 ulp of the output scale: both round the same fp32 sum once), for
   flows at the tanh bound (0.1) and at the trained magnitude (0.03). The
   error against torch F.grid_sample is printed beside it.
3. Times each kernel, its plain version and the one PyTorch call that computes
   the same function (F.grid_sample, the yardstick; the port never calls it)
   with CUDA events at the six warp shapes of one generated batch (B=8, bf16;
   F.grid_sample on an fp32 copy, since it takes no bf16 features with an fp32 grid),
   beside the bound: the larger of bytes over the card's memory rate and
   flops over its fp32 rate.
4. Drives the main path: `python -m lcgan_torch.cli --phase
   fake_image_generation` on a seeded flagship 256² generator (base_nf 128,
   max_nf 512, latents 64/512, bf16, batch 8), three batches. The kernel
   launch counts are set to 0 just before and read just after; each warp
   kernel must have run 6 times per batch. The JPEGs must exist, the
   outputs be finite, and the same generator in fp32 must agree with the
   port's CPU path (the plain warp, held to the JAX package by the CPU tests).
5. Prints the kernels as one JSON line, the card's name and power limit, and
   last the ok line. Exits nonzero, printing no result, on any failure and
   when no GPU is present.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
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
CHECK_SHAPES = [(8, 512, 8), (8, 512, 64), (8, 256, 128), (8, 128, 256)]
FLOWS = [0.1, 0.03]
FP32_TOL = 1e-5

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


def warp_inputs(b, c, h, s, dtype, seed=0):
    import torch

    from lcgan_torch.ops.grid_sample import identity_like_coordinates

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, c, h, h), generator=g).to("cuda", dtype).contiguous(memory_format=torch.channels_last)
    flow = torch.rand((b, h, h, 2), generator=g) * 2 - 1
    grid = (identity_like_coordinates(b, h, h) + flow * s).to("cuda").contiguous()
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


def library_grid_sample(x, grid):
    """F.grid_sample takes its grid in the features' dtype, and a bf16 grid
    cannot address a 256² map; so it always gets fp32 features."""
    import torch.nn.functional as F

    return F.grid_sample(x.float(), grid, mode="bicubic", padding_mode="zeros", align_corners=False)


def build_kernels() -> None:
    from lcgan_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build(["warp_fwd"])
    print(f"build: {sorted(reports) or 'already built'} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def check_warp_kernel() -> float:
    """Kernel vs plain at the main path's shapes; returns the largest fp32 error."""
    import torch

    from lcgan_torch.ops.grid_sample import grid_sample_bicubic_plain
    from lcgan_torch.ops.warp import warp_fwd

    worst = 0.0
    for b, c, h in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for s in FLOWS:
                x, grid = warp_inputs(b, c, h, s, dtype)
                out = warp_fwd(x, grid).float()
                torch.cuda.synchronize()
                ref = grid_sample_bicubic_plain(x, grid).float()
                lib = library_grid_sample(x, grid).float()
                err = (out - ref).abs().max().item()
                lib_err = (out - lib).abs().max().item()
                tag = f"warp_fwd {b}x{c}x{h}x{h} {str(dtype)[6:]} s={s}"
                if dtype == torch.float32:
                    worst = max(worst, err)
                    check(err <= FP32_TOL, f"{tag}: max_abs_err {err:.3g} (tol {FP32_TOL}); vs F.grid_sample {lib_err:.3g}")
                else:
                    ulp = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
                    check(err <= ulp, f"{tag}: max_abs_err {err:.3g} (tol 1 bf16 ulp = {ulp:.3g}); vs F.grid_sample {lib_err:.3g}")
                del x, grid, out, ref, lib
    return worst


def time_warp_kernel(bw: float, flops: float) -> dict:
    """Times summed over the six warps of one generated batch (B=8, bf16)."""
    import torch

    from lcgan_torch.ops.grid_sample import grid_sample_bicubic_plain
    from lcgan_torch.ops.warp import warp_fwd

    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    bound_by = set()
    for b, c, h in MAIN_PATH_WARPS:
        x, grid = warp_inputs(b, c, h, 0.1, torch.bfloat16)
        xf = x.float()  # the library call's input, converted outside the timed region
        # turns K, P, L, L, P, K; the lower of each pair
        k1 = cuda_ms(lambda: warp_fwd(x, grid))
        p1 = cuda_ms(lambda: grid_sample_bicubic_plain(x, grid), 5)
        l1 = cuda_ms(lambda: library_grid_sample(xf, grid))
        l2 = cuda_ms(lambda: library_grid_sample(xf, grid))
        p2 = cuda_ms(lambda: grid_sample_bicubic_plain(x, grid), 5)
        k2 = cuda_ms(lambda: warp_fwd(x, grid))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            warp_fwd(x, grid)
        host_us = (time.perf_counter() - t0) / 50 * 1e6  # the wrapper's enqueue cost
        torch.cuda.synchronize()
        n_out = b * h * h
        nbytes = x.numel() * x.element_size() + grid.numel() * 4 + n_out * c * x.element_size()
        nflops = 32 * c * n_out  # 16 taps, one multiply-add each, per output value
        bytes_ms, flops_ms = nbytes / bw * 1e3, nflops / flops * 1e3
        bound_by.add("bytes" if bytes_ms >= flops_ms else "operations")
        row = dict(ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=min(l1, l2), bound_ms=max(bytes_ms, flops_ms))
        for k in total:
            total[k] += row[k]
        print(
            f"time warp_fwd {b}x{c}x{h}x{h} bf16: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"F.grid_sample {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({nbytes / 1e6:.1f} MB), kernel at {row['bound_ms'] / row['ms']:.0%} of bound; "
            f"wrapper host cost {host_us:.1f} us per call",
            flush=True,
        )
        del x, xf, grid
    total["bound_by"] = "bytes" if bound_by == {"bytes"} else "operations"
    print(
        f"time warp_fwd per generated batch (6 warps): kernel {total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, "
        f"F.grid_sample {total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms",
        flush=True,
    )
    return total


def profile_forward(fn, iters: int = 5, top: int = 12) -> None:
    """Device time of ``iters`` calls by kernel (torch.profiler), and the
    device's idle share of the window's wall time."""
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
    print(f"profile: {busy:.3f} ms device time per forward, {wall_ms / iters:.3f} ms wall, "
          f"device idle {1 - busy * iters / wall_ms:.1%} (profiler on)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"  {ms:8.3f} ms {ms / busy:6.1%} x{count:<3d} {key[:110]}")


def run_main_path() -> int:
    """The generation phase through the CLI; returns the warp kernel's launches."""
    import numpy as np
    import torch
    from PIL import Image

    from lcgan_torch import cli
    from lcgan_torch.config import Config
    from lcgan_torch.gen.artifacts import to_unit
    from lcgan_torch.models.generator import build_generator
    from lcgan_torch.ops import warp
    from lcgan_torch.train.loop import load_ema_generator
    from lcgan_torch.utils.checkpoint import checkpoint_path, save_generator
    from lcgan_torch.utils.media import make_grid, to_uint8

    num_fakes = 3
    with tempfile.TemporaryDirectory(prefix="lcgan_smoke_") as run:
        cfg = Config(model_name=run, img_resolution=256, base_nf=128, max_nf=512, geo_noise_dim=64,
                     app_noise_dim=64, geo_latent_dim=64, app_latent_dim=512, compute_dtype="bfloat16",
                     batch_size=8, seed=0)
        cfg.make_run_dirs()
        cfg.dump(os.path.join(run, "args.txt"))
        g = build_generator(cfg, torch.Generator().manual_seed(0))
        save_generator(checkpoint_path(cfg), g, g)
        print(f"main path: flagship 256² generator, {sum(p.numel() for p in g.parameters()) / 1e6:.2f} M params", flush=True)

        warp.warp_fwd.launches = 0
        t0 = time.perf_counter()
        cli.main(["--phase", "fake_image_generation", "--model_name", run, "--num_fakes", str(num_fakes)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = warp.warp_fwd.launches

        n_img = num_fakes * cfg.batch_size
        print(f"main path: {n_img} images in {seconds:.3f} s = {n_img / seconds:.2f} images/s "
              "(checkpoint load, first-call autotuning and JPEG writes included)", flush=True)
        expect = cfg.num_blocks * num_fakes  # one warp per synthesis block
        check(launches == expect, f"warp_fwd launches on the main path: {launches} (expect {expect})")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}, {torch.cuda.device_count()} device(s)")
    bw, flops = card_rates(name)

    build_kernels()
    worst = check_warp_kernel()
    times = time_warp_kernel(bw, flops)
    launches = run_main_path()

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    kernels = [dict(
        name="warp_fwd",
        route="cuda",
        source="lcgan_torch/ops/csrc/warp_fwd.cu",
        replaces="lcgan_tpu/ops/warp_pallas.py:442",
        launches=launches,
        max_abs_err=worst,
        ms=times["ms"],
        plain_ms=times["plain_ms"],
        bound_ms=times["bound_ms"],
        bound_by=times["bound_by"],
        library_ms=times["library_ms"],
    )]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
