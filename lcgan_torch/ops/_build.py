"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``lcgan_torch/_build/<name>-<source hash>.so`` at first
use, then loaded with ``ctypes``. The hash covers the source and the shared
headers (``csrc/*.cuh``) it may include. Nothing is compiled when a module is
imported. ``build`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and under $CUDA_HOME/bin)")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, in parallel.

    Returns each newly built kernel's ``ptxas -v`` report (registers, shared
    memory, spills). Raises with the compiler's output if one fails.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        # build under a temporary name, then rename: a reader never sees a
        # half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
            reports[name] = output
        else:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{output}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, typed: it returns
    the launch's cudaError as an int. Built and loaded at first use."""
    key = f"{name}:{symbol}"
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return fn


def raise_on(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a cudaError (its launch was
    refused)."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
