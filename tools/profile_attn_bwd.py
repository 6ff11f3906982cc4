"""How many of its K and V operands the attention backward's dK/dV pass
should hold in registers at head width 128, measured on the card.

``attn_bwd_mma.cuh``'s ``kDkvHeld<D>`` says how many of the warp's K and V
operands ``attn_bwd_dkv_tile`` keeps as A fragments for its whole query loop:
2 (K and V, the design at d = 64 and 80), 1 (K; V read from shared memory by
ldmatrix at each use) or 0 (both read at each use). This script rebuilds
``csrc/packed_mha_bwd.cu`` (K2/K3) and ``csrc/flash_bwd.cu`` (K5) with each
value at d = 128 (a string patch of the header, asserted to apply), prints
each build's ptxas registers and spills and how far each variant's
gradients lie from those of the first (0 where ptxas compiled the same
arithmetic), and times them in turns at Llama-3.1-8B's training shapes: K3 at
8 x 32 heads x 512 (the packed route) and K5 at 4 x 32 x 1024 (the flash
route), both causal, plus K2 (non-causal) at 8 x 512.

Run from the repo root on a machine with an NVIDIA H100 and ``nvcc``:

    python3 tools/profile_attn_bwd.py

Each variant is built by ``nvcc`` with the flags of ``ops/_build.py`` into a
temporary directory; nothing in the repo is written.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from vitef_tpu_torch.ops import _build  # noqa: E402
from vitef_tpu_torch.ops import attention as A  # noqa: E402

HELD = "constexpr int kDkvHeld = D == 128 ? 0 : 2;"
VARIANTS = {f"held {held}": held for held in (0, 1, 2)}
SOURCES = ("packed_mha_bwd", "flash_bwd")


def build(source: str, held: int, tmp: Path):
    """nvcc of csrc/<source>.cu with kDkvHeld<128> = held; (process, library, log)."""
    d = tmp / f"{source}-{held}"
    d.mkdir()
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, d)
    core = d / "attn_bwd_mma.cuh"
    text = core.read_text()
    if HELD not in text:
        raise SystemExit(f"patch does not apply to attn_bwd_mma.cuh: {HELD!r}")
    core.write_text(text.replace(HELD, f"constexpr int kDkvHeld = D == 128 ? {held} : 2;"))
    shutil.copy(_build.CSRC / f"{source}.cu", d)
    lib, log = d / f"lib{source}.so", d / f"lib{source}.log"
    cmd = [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-o", str(lib), str(d / f"{source}.cu")]
    out = open(log, "w")
    return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT), lib, log


def entry(lib: ctypes.CDLL, name: str, n_pointers: int):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def packed_call(lib, n: int, l: int, causal: bool, device):
    """A call of ``lib``'s packed_mha_bwd at (N, L) with the 8B heads on K1's
    residuals, and its outputs."""
    h, e = CS.L8B_HEADS
    gen = torch.Generator().manual_seed(90)
    qkv = (torch.randn(n, l, 3 * e, generator=gen) * 0.5).to(device, torch.bfloat16)
    bias = (torch.randn(3 * e, generator=gen) * 0.1).to(device, torch.bfloat16)
    g = torch.randn(n, l, e, generator=gen).to(device, torch.bfloat16)
    with torch.inference_mode():
        out, lse = A._launch_fwd(qkv, bias, h, causal, want_lse=True)
    dqkv = torch.empty_like(qkv)
    db = torch.empty(3 * e, dtype=torch.float32, device=device)
    stats = torch.empty((n, h, l, 2), dtype=torch.float32, device=device)
    partial = torch.empty((A._DB_SEGMENTS, 3 * e), dtype=torch.float32, device=device)
    operands = (qkv, bias, g, out, lse, dqkv, db, stats, partial)  # alive while call is
    fn = entry(lib, "packed_mha_bwd", 9)

    def call():
        err = fn(*(t.data_ptr() for t in operands), n, l, h, e // h, A._DB_SEGMENTS,
                 int(causal), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"packed_mha_bwd: cudaError {err}")

    def wrapper():
        dqkv, db = A.packed_mha_bwd(qkv, bias, g, out, lse, h, causal=causal)
        return dqkv, db.float()
    return call, (dqkv, db), wrapper


def flash_call(lib, n: int, l: int, device):
    """A call of ``lib``'s bf16 flash_bwd at (N, 32 heads, L, 128), causal,
    on K4's residuals, and its outputs."""
    h = CS.L8B_HEADS[0]
    q, k, v, g = CS.flash_inputs(torch.Generator().manual_seed(91), n, h, l, torch.bfloat16,
                                 device, 128)
    with torch.inference_mode():
        out, lse = A._launch_flash_fwd(q, k, v, True, want_lse=True)
    grads = [torch.empty_like(q) for _ in range(3)]
    stats = torch.empty((n, h, l, 2), dtype=torch.float32, device=device)
    operands = (q, k, v, g, out, lse, *grads, stats)  # alive while call is
    fn = entry(lib, "flash_bwd", 10)

    def call():
        err = fn(*(t.data_ptr() for t in operands), n, h, l, 128, 0, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_bwd: cudaError {err}")
    return call, tuple(grads), lambda: A.flash_bwd(q, k, v, g, out, lse, causal=True)


CASES = {"K3 at 8 x 512 (causal)": ("packed_mha_bwd", lambda lib, dev: packed_call(
             lib, *CS.L8B_PACKED, True, dev)),
         "K2 at 8 x 512 (non-causal)": ("packed_mha_bwd", lambda lib, dev: packed_call(
             lib, *CS.L8B_PACKED, False, dev)),
         "K5 at 4 x 1024 (causal)": ("flash_bwd", lambda lib, dev: flash_call(
             lib, *CS.L8B_FLASH, dev))}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_attn_bwd: no CUDA device")
    device = torch.device("cuda", 0)
    print(CS.card())
    _build.build(["packed_mha_fwd", "flash_fwd"])
    tmp = Path(tempfile.mkdtemp())
    try:
        jobs = {(source, held): build(source, held, tmp)
                for source in SOURCES for held in VARIANTS.values()}
        libs = {}
        for (source, held), (proc, lib, log) in jobs.items():
            if proc.wait():
                raise SystemExit(f"nvcc failed for {source} held {held}:\n"
                                 f"{log.read_text()[-3000:]}")
            for kernel, registers, _, spills in CS.ptxas_kernels(log.read_text()):
                if "<128," in kernel:
                    print(f"held {held}: ptxas {kernel}: {registers} registers; {spills}")
            libs[source, held] = ctypes.CDLL(str(lib))
        for label, (source, make) in CASES.items():
            calls = {name: make(libs[source, held], device) for name, held in VARIANTS.items()}
            first, *_ = calls
            for name, (call, outputs, _) in calls.items():
                call()
            torch.cuda.synchronize()
            apart = {name: max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(outputs, calls[first][1]))
                     for name, (_, outputs, _) in calls.items()}
            finite = {name: all(bool(torch.isfinite(t).all()) for t in outputs)
                      for name, (_, outputs, _) in calls.items()}
            wrapped = calls[first][2]()
            print(f"{label}: every output finite {finite}; the wrapper's (the repo's build) "
                  "max |d| from " + first + "'s: " + ", ".join(
                      f"{(a.float() - b.float()).abs().max().item():.3e}"
                      for a, b in zip(wrapped, calls[first][1])))
            names = list(calls) + list(calls)[::-1]
            times = {}
            for name in names:
                times.setdefault(name, []).append(CS.cuda_ms(calls[name][0], 20))
            print(f"{label}, in turns (ms): " + "; ".join(
                f"{name} {'/'.join(f'{ms:.4f}' for ms in t)}" for name, t in times.items())
                + f"; max |d| of each variant's gradients from {first}'s: " + ", ".join(
                f"{name} {d:.3e}" for name, d in apart.items()))
            del calls
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
