"""Native (C++) host-side image ops, built at first use and bound with ctypes.

The port's own copy of ``vitef_tpu/native`` (the port imports nothing of the
JAX package): ``imageops.cpp`` is a PIL-bit-exact batched bilinear resize and
eval transform (Resize of the shorter side + CenterCrop), OpenMP across
images. ``g++`` compiles it at first use into ``_build/libimageops.so``
beside this file (git-ignored), and again when the source is newer than the
library. There is no fallback: without ``g++``, or when the build fails, the
first call raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "imageops.cpp"
BUILD_DIR = Path(__file__).parent / "_build"
_LIB = BUILD_DIR / "libimageops.so"
_CXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()


def _build() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f"{_LIB.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *_CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native image ops cannot be built") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {_SRC.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, _LIB)


@functools.cache
def _library() -> ctypes.CDLL:
    with _lock:
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
    lib = ctypes.CDLL(str(_LIB))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.resize_bilinear_batch.argtypes = [u8p, u8p] + [ctypes.c_int] * 6
    lib.resize_bilinear_batch.restype = None
    lib.eval_transform_batch.argtypes = [u8p, u8p] + [ctypes.c_int] * 5
    lib.eval_transform_batch.restype = None
    return lib


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _batch(batch: np.ndarray) -> np.ndarray:
    batch = np.ascontiguousarray(batch, dtype=np.uint8)
    if batch.ndim != 4:
        raise ValueError(f"expected an (N, H, W, C) batch, got shape {batch.shape}")
    return batch


def resize_bilinear_batch(batch: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(N, H, W, C) uint8 -> (N, out_h, out_w, C) uint8, PIL-BILINEAR-exact."""
    lib = _library()
    batch = _batch(batch)
    n, h, w, c = batch.shape
    out = np.empty((n, out_h, out_w, c), np.uint8)
    lib.resize_bilinear_batch(_as_u8p(batch), _as_u8p(out), n, h, w, c, out_h, out_w)
    return out


def eval_transform_batch(batch: np.ndarray, size: int) -> np.ndarray:
    """(N, H, W, C) uint8 -> (N, size, size, C) uint8: torchvision
    Resize(shorter -> size) + CenterCrop(size), PIL-exact, OpenMP over images."""
    lib = _library()
    batch = _batch(batch)
    n, h, w, c = batch.shape
    out = np.empty((n, size, size, c), np.uint8)
    lib.eval_transform_batch(_as_u8p(batch), _as_u8p(out), n, h, w, c, size)
    return out
