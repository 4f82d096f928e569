"""The port stands alone: every ``lcgan_torch`` module, and chip_smoke.py,
imports with JAX and the JAX package made unimportable."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CODE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["lcgan_tpu"] = None
import lcgan_torch
names = [m.name for m in pkgutil.walk_packages(lcgan_torch.__path__, "lcgan_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20  # every module of the package was walked


ROUTE_CODE = """
import sys
sys.modules["jax"] = None
sys.modules["lcgan_tpu"] = None
import torch
from lcgan_torch.cli import parse_config
from lcgan_torch.models.generator import build_generator
from lcgan_torch.ops.warp import small_route
cfg = parse_config(["--model_name", "unused", "--img_resolution", "32", "--base_nf", "8", "--max_nf", "16",
                    "--geo_noise_dim", "8", "--app_noise_dim", "8", "--geo_latent_dim", "8", "--app_latent_dim", "16",
                    "--compute_dtype", "float32", "--warp_pallas_min_res", "8", "--device", "cpu"])
g = build_generator(cfg)
routes = [getattr(g, f"block_{i}").small_warp for i in range(g.num_blocks)]
assert routes == [small_route("auto", 8, 8 * 2**i, 8 * 2**i, 16 if i < 2 else 8, 0.1) for i in range(3)], routes
z = torch.randn(2, 8)
g(z, z).float().sum().backward()
print(sum(routes))
"""


def test_small_route_runs_without_jax():
    """The route rule (ops/warp.py), the generator and the CLI's knob, with
    JAX and the JAX package unimportable: the route rule is the port's own
    copy."""
    proc = subprocess.run([sys.executable, "-c", ROUTE_CODE], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) == 3  # every block of the dryrun width on the small route
