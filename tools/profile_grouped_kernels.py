"""Where the time of K7 ``gmm_dy_swiglu`` and ``tgmm_swiglu`` goes, on the card.

Two readings, at the 8x124m step's shapes (``chip_smoke.grouped_case``):

- ``variants``: csrc/gmm.cu and csrc/tgmm.cu rebuilt with one piece of work
  taken out by a string patch (each patch is asserted to apply), timed in
  turns against the sources at both column tiles. A variant computes wrong
  values on purpose: its time says what the piece costs, nothing else.
- ``trace``: ``clock64`` stamps of block 0 of ``gmm_dy_swiglu``'s ping-pong
  at 128 x 256, per item and warpgroup: the wait for its turn, the
  mainloop, the wait for h and the epilogue, and the producer's wait to
  load h.

Run from the repo root on a machine with an NVIDIA H100 and ``nvcc``:

    python3 tools/profile_grouped_kernels.py variants
    python3 tools/profile_grouped_kernels.py trace

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
from vitef_tpu_torch.ops import gmm as G  # noqa: E402

# (kernel, source) -> variant -> [(text in the source, its replacement)].
NO_SIGMOID = ("      sigmoid_n(g, s);",
              "#pragma unroll\n      for (int k = 0; k < 2 * kBatch; ++k) s[k] = g[k];")
NO_H = ("""              mbar_arrive_expect_tx(h_full + w, Shape::kOutTile * sizeof(bf16));
              load_h<kHalf>(&b_map, h_full + w, o_s + w * Shape::kOutTile, row0, n0);""",
        "              mbar_arrive(h_full + w);")
NO_STORE = ("""              tma_store_2d(&out_map, dg + c * 64 * kWgChunk, n0 + c * kWgChunk, r0);
              tma_store_2d(&out2_map, du + c * 64 * kWgChunk, n0 + c * kWgChunk, r0);""", "")
NO_Y = ("      if constexpr (kMode == kSwigluIn) swiglu_box(a_tile, rows);", "")
NO_MMA = ("""        wgmma_tile<kBN, 1>(acc, smem_desc_sw128(a_tile + kk * 16 * kWgChunk, kWgBoxBytes, 1024),
                           smem_desc_sw128(b_tile + kk * 16 * kWgChunk, kWgBoxBytes, 1024));""",
          "        acc[0] += __bfloat162float(a_tile[kk]);")
VARIANTS = {
    ("gmm_dy_swiglu", "gmm"): {"no sigmoid": [NO_SIGMOID], "no h load": [NO_H],
                               "no TMA store": [NO_STORE],
                               "mainloop only": [NO_SIGMOID, NO_H, NO_STORE]},
    ("tgmm_swiglu", "tgmm"): {"no y": [NO_Y], "no products": [NO_MMA]},
}

# The stamps of the ping-pong (block 0, thread 0 of each warpgroup; the
# producer's wait for the h tile) into g_trace.
TRACE = [
    ("// --- bfloat16: TMA + wgmma ---",
     "__device__ unsigned long long g_trace[8192];\n// --- bfloat16: TMA + wgmma ---"),
    ("      if (wg > 0 || n > 0) mbar_wait(order + wg, (n - 1 + wg) & 1);",
     """      const long long t_turn = clock64();
      if (wg > 0 || n > 0) mbar_wait(order + wg, (n - 1 + wg) & 1);
      const long long t_start = clock64();"""),
    ("""      if (wg_tid == 0) mbar_arrive(order + 1 - wg);
      wgmma_wait<0>();""", """      if (wg_tid == 0) mbar_arrive(order + 1 - wg);
      wgmma_wait<0>();
      const long long t_ml = clock64();"""),
    ("""      mbar_wait(h_full + wg, n & 1);
      ++n;""", """      mbar_wait(h_full + wg, n & 1);
      const long long t_h = clock64();
      ++n;"""),
    ("      if (masked) named_sync(1 + wg, 128);  // every read done before the tile is released",
     """      if (masked) named_sync(1 + wg, 128);  // every read done before the tile is released
      if (blockIdx.x == 0 && wg_tid == 0 && n <= 64) {
        unsigned long long* t = g_trace + ((n - 1) * 2 + wg) * 8;
        t[0] = t_turn; t[1] = t_start; t[2] = t_ml; t[3] = t_h; t[4] = clock64();
      }"""),
    ("              if (n > 0) mbar_wait(h_empty + w, (n - 1) & 1);",
     """              const long long p0 = clock64();
              if (n > 0) mbar_wait(h_empty + w, (n - 1) & 1);
              if (blockIdx.x == 0 && n < 64) {
                g_trace[4096 + (n * 2 + w) * 2] = p0;
                g_trace[4096 + (n * 2 + w) * 2 + 1] = clock64();
              }"""),
]
TRACE_READ = """
extern "C" int read_trace(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace)));
}
"""


def patched(source: str, patches) -> str:
    text = (_build.CSRC / f"{source}.cu").read_text()
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"patch does not apply to csrc/{source}.cu: {old[:80]!r}")
        text = text.replace(old, new)
    return text


def build(source: str, text: str, tmp: Path, tag: str):
    """nvcc of ``text`` as csrc/<source>.cu into tmp/<tag>; (process, library)."""
    d = tmp / tag
    d.mkdir()
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, d)
    (d / f"{source}.cu").write_text(text)
    lib = d / f"lib{source}.so"
    cmd = [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-o", str(lib), str(d / f"{source}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def step_operands(name: str, device):
    """The step's inputs and outputs of ``name`` (bf16, seeded router
    sizes), as chip_smoke.py's grouped phase draws them."""
    sizes = CS.router_sizes(21, CS.MOE_BATCH * 1024, 8)
    gen = torch.Generator().manual_seed(21)
    return CS.grouped_case(name, sizes, CS.EMB, 2048, torch.bfloat16, device, gen)[3]


def launcher(lib, name: str, tensors, tile: int):
    """A call of ``lib``'s tile entry point on the step's operands."""
    v, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    if name == "tgmm_swiglu":
        h, g, sz, out = tensors
        fn = lib.tgmm_tile
        fn.argtypes = [v] * 4 + [i] * 7 + [v]
        args = [h.data_ptr(), g.data_ptr(), sz.data_ptr(), out.data_ptr(), h.shape[0],
                out.shape[1], g.shape[1], out.shape[0], G.SWIGLU_IN, tile, 1, stream]
    else:
        g, w, h, sz, both = tensors
        fn = lib.gmm_tile
        fn.argtypes = [v] * 7 + [i] * 6 + [v]
        args = [g.data_ptr(), None, w.data_ptr(), h.data_ptr(), sz.data_ptr(),
                both[0].data_ptr(), both[1].data_ptr(), g.shape[0], w.shape[1], w.shape[2],
                w.shape[0], G.SWIGLU_BWD_OUT, tile, stream]

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{name} at 128 x {tile}: cudaError {err}")
    return call


def variants(device) -> None:
    tmp = Path(tempfile.mkdtemp())
    jobs = {}
    for (name, source), table in VARIANTS.items():
        jobs[(name, "sources")] = build(source, patched(source, []), tmp, f"{name}-sources")
        for variant, patches in table.items():
            tag = f"{name}-{variant.replace(' ', '-')}"
            jobs[(name, variant)] = build(source, patched(source, patches), tmp, tag)
    libs = {}
    for key, (proc, lib) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{log[-3000:]}")
        libs[key] = ctypes.CDLL(str(lib))
    for name, _ in VARIANTS:
        tensors = step_operands(name, device)
        tensors = [t.to(torch.int32) if t.dtype == torch.int64 else t for t in tensors]
        keys = [key for key in libs if key[0] == name]
        for tile in (128, 256):
            times = {}
            for key in keys + keys[::-1]:
                call = launcher(libs[key], name, tensors, tile)
                call()
                torch.cuda.synchronize()
                times.setdefault(key[1], []).append(CS.cuda_ms(call, 20))
            print(f"{name} at 128 x {tile}, in turns (ms): " + "; ".join(
                f"{variant} {'/'.join(f'{ms:.4f}' for ms in t)}" for variant, t in times.items()))


def trace(device) -> None:
    tmp = Path(tempfile.mkdtemp())
    proc, lib = build("gmm", patched("gmm", TRACE) + TRACE_READ, tmp, "trace")
    log = proc.communicate()[0]
    if proc.returncode:
        raise SystemExit(f"nvcc failed:\n{log[-3000:]}")
    lib = ctypes.CDLL(str(lib))
    tensors = step_operands("gmm_dy_swiglu", device)
    tensors = [t.to(torch.int32) if t.dtype == torch.int64 else t for t in tensors]
    call = launcher(lib, "gmm_dy_swiglu", tensors, 256)
    ms = CS.cuda_ms(call, 5)
    call()
    torch.cuda.synchronize()
    stamps = (ctypes.c_ulonglong * 8192)()
    lib.read_trace(stamps)
    t = list(stamps)
    base = min(x for x in t[:4096] if x)
    print(f"gmm_dy_swiglu ping-pong at 128 x 256: {ms:.4f} ms a launch; block 0, clock64 "
          "cycles from its first stamp:")
    for n in range(64):
        for wg in range(2):
            turn, start, ml, h, end = (x - base for x in t[(n * 2 + wg) * 8:(n * 2 + wg) * 8 + 5])
            if turn < 0:
                continue
            p0, p1 = (x - base for x in t[4096 + (n * 2 + wg) * 2:4096 + (n * 2 + wg) * 2 + 2])
            print(f"  item {n} warpgroup {wg}: turn waited {start - turn}, mainloop {ml - start}, "
                  f"h waited {h - ml}, epilogue {end - h} (ends at {end}); the producer waited "
                  f"{p1 - p0} to load h")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_grouped_kernels: no CUDA device")
    what = sys.argv[1] if len(sys.argv) > 1 else "variants"
    print(CS.card())
    {"variants": variants, "trace": trace}[what](torch.device("cuda", 0))


if __name__ == "__main__":
    main()
