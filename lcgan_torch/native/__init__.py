"""ctypes bindings for the native C++ input pipeline (loader.cpp, a copy of
``lcgan_tpu/native/loader.cpp``): a host loader, not a device kernel.

Builds the shared library on first use (g++, ~2s) into
``lcgan_torch/_build/liblcgan_loader-<source hash>.so``. Falls back
gracefully: ``available()`` is False if the toolchain or libjpeg/libpng are
missing, and the Python/cv2 pipeline is used instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "loader.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"liblcgan_loader-{digest}.so")


def _build(lib_path: str) -> bool:
    # compile to a unique temp name + atomic rename: concurrent processes
    # (multi-process DP on one host) may build simultaneously, and rewriting
    # a .so another live process has dlopen-mapped in place would SIGBUS it
    tmp = f"{lib_path}.build.{os.getpid()}"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp,
        "-ljpeg", "-lpng", "-lpthread",
    ]
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
        return True
    except (OSError, subprocess.SubprocessError):  # no g++, a missing library, a compile error
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        # the library's name carries the source's hash, so a changed source
        # builds anew (available() must degrade gracefully, never raise —
        # module docstring contract)
        lib_path = _lib_path()
        if not os.path.exists(lib_path) and not _build(lib_path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            _build_failed = True
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.lcg_load_triple.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64, u8p, u8p, u8p,
        ]
        lib.lcg_load_triple.restype = ctypes.c_int
        lib.lcg_load_image.argtypes = [ctypes.c_char_p, ctypes.c_int, u8p]
        lib.lcg_load_image.restype = ctypes.c_int
        lib.lcg_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), u8p, u8p, u8p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.lcg_load_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def load_triple(path: str, size: int, seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lib = _load()
    assert lib is not None
    img = np.empty((size, size, 3), np.uint8)
    geo = np.empty((size, size, 3), np.uint8)
    app = np.empty((size, size, 3), np.uint8)
    rc = lib.lcg_load_triple(path.encode(), size, seed & (2**64 - 1), _u8p(img), _u8p(geo), _u8p(app))
    if rc:
        raise IOError(f"native decode failed: {path}")
    return img, geo, app


def load_image(path: str, size: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    img = np.empty((size, size, 3), np.uint8)
    if lib.lcg_load_image(path.encode(), size, _u8p(img)):
        raise IOError(f"native decode failed: {path}")
    return img


def load_batch(
    paths: List[str], size: int, seeds: List[int], num_threads: int = 4
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (image, geo, app, failed); arrays are (N,size,size,3) u8 and
    ``failed`` is an (N,) bool mask of samples the native path could not
    decode (unsupported format / corrupt / IO error) — those output slots
    are uninitialized and the caller handles exactly them (dataset.py falls
    back per-sample instead of abandoning the native path)."""
    lib = _load()
    assert lib is not None
    n = len(paths)
    img = np.empty((n, size, size, 3), np.uint8)
    geo = np.empty((n, size, size, 3), np.uint8)
    app = np.empty((n, size, size, 3), np.uint8)
    status = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_seeds = (ctypes.c_uint64 * n)(*[s & (2**64 - 1) for s in seeds])
    lib.lcg_load_batch(
        c_paths, n, size, c_seeds, _u8p(img), _u8p(geo), _u8p(app), num_threads,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return img, geo, app, status != 0
