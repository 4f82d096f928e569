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
