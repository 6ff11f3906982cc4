"""Where the time of K10 (``train_augment``) goes, on the card.

csrc/train_augment.cu rebuilt with one piece changed or taken out by a string
patch (each patch is asserted to apply), timed in turns against the source
at chip_smoke.py's timed shapes (N = 512, 32 x 32 -> 224 and N = 64,
512 x 512 -> 224, bf16):

- ``plain stores``: the 16-byte stores without the streaming hint (``__stcs``);
- ``no resize``: the source rows are not resized along x (the output pass
  reads whatever shared memory holds);
- ``no lerp``: the output pass stores constants, reading no resized row;
- ``no stores``: the output pass computes every value and stores none (the
  stores kept behind a test that never holds, so the values are computed);
- ``R 32 in 48 KB``, ``R 16 in 48 KB``: lower bands, in a 48 KB
  shared-memory aim (the source: up to 64 rows in 64 KB); the variants are
  called through their own entry points, so the wrapper's plan
  (``augment_band_rows``) does not apply to them;
- ``5 blocks an SM``: registers capped so that five blocks share an SM.

The three ``no`` variants compute wrong values on purpose: their time says
what the piece costs, nothing else.

Run from the repo root on a machine with an NVIDIA H100 and ``nvcc``:

    python3 tools/profile_train_augment.py

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

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from vitef_tpu_torch.ops import _build  # noqa: E402

PLAIN_STORES = ("#include <cstdint>\n",
                "#include <cstdint>\n\ntemplate <typename T>\n"
                "__device__ __forceinline__ void plain_store(T* p, T v) { *p = v; }\n")
VARIANTS = {
    "plain stores": [PLAIN_STORES, ("__stcs(", "plain_store(")],
    "no resize": [("dst[j] = lerp_pixel(src, t[j]);",
                   "if (t[j].lo < 0) dst[j] = lerp_pixel(src, t[j]);")],
    "no lerp": [("const float4 p = a[j], q = b[j];",
                 "const float4 p = make_float4(j, r, g, 0.f), q = p;")],
    "no stores": [("        store_run(out + ",
                   "        if (v[c][0] == -1234.5f) store_run(out + ")],
    "R 32 in 48 KB": [("kBandRows = 64;", "kBandRows = 32;"),
                      ("kStageBytes = 64 * 1024;", "kStageBytes = 48 * 1024;")],
    "R 16 in 48 KB": [("kBandRows = 64;", "kBandRows = 16;"),
                      ("kStageBytes = 64 * 1024;", "kStageBytes = 48 * 1024;")],
    "5 blocks an SM": [("__launch_bounds__(kMaxThreadsX * kMaxThreadsY)",
                        "__launch_bounds__(kMaxThreadsX * kMaxThreadsY, 5)")],
}


def patched(patches) -> str:
    """csrc/train_augment.cu with every occurrence of each text replaced."""
    text = (_build.CSRC / "train_augment.cu").read_text()
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"patch does not apply to csrc/train_augment.cu: {old[:80]!r}")
        text = text.replace(old, new)
    return text


def build(text: str, tmp: Path, tag: str):
    """nvcc of ``text`` as csrc/train_augment.cu into tmp/<tag>; (process, library)."""
    d = tmp / tag
    d.mkdir()
    (d / "train_augment.cu").write_text(text)
    lib = d / "libtrain_augment.so"
    cmd = [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-o", str(lib),
           str(d / "train_augment.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def launcher(lib, raw, boxes, flips, out):
    """A call of ``lib``'s entry point as the wrapper makes it."""
    fn = lib.train_augment
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    n, h, w, _ = raw.shape
    flips_u8 = flips.to(torch.uint8)
    args = [raw.data_ptr(), boxes.data_ptr(), flips_u8.data_ptr(), out.data_ptr(),
            n, h, w, out.shape[-1], int(out.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream]

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"train_augment: cudaError {err}")
    call.flips = flips_u8  # alive while the call is
    return call


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_augment: no CUDA device")
    device = torch.device("cuda", 0)
    print(CS.card())
    tmp = Path(tempfile.mkdtemp())
    jobs = {"sources": build(patched([]), tmp, "sources")}
    for variant, patches in VARIANTS.items():
        jobs[variant] = build(patched(patches), tmp, variant.replace(" ", "-"))
    libs = {}
    for key, (proc, lib) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{log[-3000:]}")
        for kernel, registers, smem, spills in CS.ptxas_kernels(log):
            print(f"ptxas {key}: {kernel}: {registers} registers; {spills}")
        libs[key] = ctypes.CDLL(str(lib))
    rng = np.random.default_rng(10)
    for count, src, size in CS.K10_TIMED:
        raw, boxes, flips = CS.k10_inputs(rng, count, src, src, device)
        out = torch.empty((count, 3, size, size), dtype=torch.bfloat16, device=device)
        times = {}
        for key in list(libs) + list(libs)[::-1]:
            call = launcher(libs[key], raw, boxes, flips, out)
            call()
            torch.cuda.synchronize()
            times.setdefault(key, []).append(CS.cuda_ms(call, 20))
        bound = CS.k10_bound(raw, boxes, flips, size)["bound_ms"]
        print(f"K10 at N={count} {src}x{src}->{size} bf16, in turns (ms; bound {bound:.4f}): "
              + "; ".join(f"{key} {'/'.join(f'{ms:.4f}' for ms in t)}"
                          for key, t in times.items()))
    shutil.rmtree(tmp)


if __name__ == "__main__":
    main()
