"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>.so`` beside this
file. It is rebuilt when the source, or a ``csrc/*.cuh`` header, is newer
than the library. The sources include no PyTorch header, so a build takes seconds, not minutes;
:func:`build` compiles several sources at once, one ``nvcc`` each. The
compiler's report (``-Xptxas -v``: registers, shared memory, spills) is kept
in ``_build/lib<name>.log``.

There is no fallback: without ``nvcc``, or when the build fails, this raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (not on PATH, nor under CUDA_HOME or "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def _stale(name: str) -> bool:
    lib = BUILD_DIR / f"lib{name}.so"
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(src.stat().st_mtime for src in sources)


def build(names) -> None:
    """Compile every stale ``csrc/<name>.cu`` of ``names``: one ``nvcc`` per
    source, all started together, each waited for. Raises if any fails."""
    with _lock:
        stale = [name for name in names if _stale(name)]
        if not stale:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for name in stale:
            lib = BUILD_DIR / f"lib{name}.so"
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            log = lib.with_suffix(".log")
            with open(log, "w") as out:
                out.write(" ".join(cmd) + "\n")
                out.flush()
                proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
            jobs.append((name, lib, tmp, log, proc))
        failed = []
        for name, lib, tmp, log, proc in jobs:
            if proc.wait() != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{log.read_text()}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("nvcc failed to build " + "\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library."""
    build([name])
    return ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))


@functools.cache
def kernel_function(name: str, n_pointers: int, n_ints: int, n_floats: int = 0,
                    source: str | None = None):
    """The C entry point ``name`` of ``csrc/<source>.cu`` (by default
    ``csrc/<name>.cu``), built and loaded at first use. Every entry point
    takes ``n_pointers`` device pointers, then ``n_ints`` ints, then
    ``n_floats`` floats, then the CUDA stream, and returns a cudaError_t as
    int."""
    fn = getattr(load_library(source or name), name)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def build_log(name: str) -> str:
    """The compiler's output from the last build of ``csrc/<name>.cu``."""
    path = BUILD_DIR / f"lib{name}.log"
    return path.read_text() if path.exists() else ""
