// Hopper's asynchronous pieces for the grouped products (sm_90a): tensor
// maps and TMA tile loads (cp.async.bulk.tensor) that report to mbarriers in
// shared memory, and warpgroup products (wgmma.mma_async) that read their
// operands from those tiles. K8 gmm's plain mode (csrc/gmm.cu,
// gmm_wgmma_kernel) and K8 tgmm's (csrc/tgmm.cu, tgmm_wgmma_kernel) are built
// on them; the K7 passes can take them next.
//
// Tiles are in the 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B): a box is
// 64 bf16 (128 bytes) along its contiguous dimension, each 128-byte row
// lands at row r of the box with its 16-byte pieces permuted by r % 8, and
// eight rows (1024 bytes, 1024-byte aligned) form one swizzle atom. A wgmma
// descriptor names such a tile by its start address, the byte offset between
// 8-row groups (SBO, 1024 here) and, for an operand whose contiguous
// dimension is M or N, the byte offset between 64-wide column chunks (LBO).
// A K-major operand (gmm's A rows, K contiguous) moves 16 deep by adding 32
// bytes to the start address inside the atom; an MN-major one (gmm's W rows,
// N contiguous; both of tgmm's operands, whose depth is the rows of G) by 16
// rows, 2048 bytes. An MN-major A enters wgmma with imm-trans-a 1, an
// MN-major B with imm-trans-b 1.
//
// Here, for the host: cuTensorMapEncodeTiled, a driver function, fetched
// through the runtime's cudaGetDriverEntryPoint, so the libraries link no
// -lcuda (ops/_build.py), and make_tensor_map_bf16. For the device:
// mbarrier init, arrive, arrive with an expected byte count, and wait on a
// phase; 2-D and 3-D TMA loads and stores with the proxy fence, commit and
// waits; shared-memory descriptors; the wgmma fence, commit and wait;
// m64n128k16 and m64n256k16 bf16 products with float32 accumulators, A
// K-major or (kTransA) MN-major, B MN-major.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: no driver function is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"

namespace {

// --- host: tensor maps -------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, looked up once; null if the
// driver does not offer it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* found = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &found, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &found, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(found)
               : nullptr;
  }();
  return fn;
}

// A tensor map of a row-major bf16 array of `rank` dimensions at `base`:
// dims innermost first, strides (bytes) of dimensions 1 .. rank - 1, boxes of
// `box` elements in the 128-byte swizzle; elements outside dims read as
// zero. TMA wants a 16-byte aligned base and strides that are multiples of
// 16 bytes; cudaErrorInvalidValue if the map cannot be encoded.
inline cudaError_t make_tensor_map_bf16(CUtensorMap* map, const void* base, int rank,
                                        const cuuint64_t* dims, const cuuint64_t* strides,
                                        const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
                            const_cast<void*>(base), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// --- device: mbarriers ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

// Make barriers just initialised visible to TMA (the async proxy); a
// __syncthreads after it makes them visible to the block.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive, and expect `bytes` more of TMA traffic before the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed (a fresh
// barrier is in phase 0, so waiting on parity 1 returns at once). A wait
// past about 10 s of clock traps: a stalled pipeline fails its launch
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > 20000000000LL) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// --- device: TMA loads -----------------------------------------------------------

// The box at element coordinates (c0, c1[, c2]) (innermost first) of `map`
// into shared memory at dst (1024-byte aligned in the 128-byte swizzle); its
// bytes count towards `bar`'s expected traffic.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// --- device: TMA stores ----------------------------------------------------------

// Order this thread's shared-memory writes before TMA reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The box at (c0, c1) of `map` from shared memory at src (its layout as a
// load would leave it); elements outside the map's dims are not written.
// Asynchronous: tma_store_commit closes the group, tma_store_wait_read waits
// until src may be written again, tma_store_wait until the writes are done.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

// The box at (c0, c1, c2) of a 3-D map, likewise.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// --- device: wgmma ---------------------------------------------------------------

// The descriptor of a shared tile in the 128-byte swizzle (layout type 1,
// bits 62-63): start address, LBO and SBO in bytes (multiples of 16; LBO is
// unused for a K-major operand).
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* tile, uint32_t lbo,
                                                    uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// Order this warpgroup's register and shared-memory writes before the next
// wgmma reads them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Close the group of wgmmas issued since the last commit.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most kPending committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// an asynchronous wgmma (no instruction).
template <int kRegs>
__device__ __forceinline__ void fence_regs(float (&d)[kRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+f"(d[i]) : : "memory");
}

// Accumulator i of a thread (lane l of warp w of the warpgroup) of an
// m64nN product is row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2: the mma.sync C fragment repeated over N.

// d (64 x 128: this thread's 64 float32 accumulators) += A (64 x 16) B (16 x 128),
// bf16 from shared memory: A K-major (desc_a; M-major with kTransA 1,
// imm-trans-a), B N-major (desc_b, imm-trans-b 1).
template <int kTransA = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA));
}

// d (64 x 256: this thread's 128 float32 accumulators) += A (64 x 16) B (16 x 256),
// likewise.
template <int kTransA = 0>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA));
}

// m64nBNk16 over a warpgroup's kBN / 2 accumulators (column tiles of 128 or
// 256), A K-major or (kTransA 1) M-major.
template <int kBN, int kTransA = 0>
__device__ __forceinline__ void wgmma_tile(float (&acc)[kBN / 2], uint64_t desc_a,
                                           uint64_t desc_b) {
  if constexpr (kBN == 256) {
    wgmma_m64n256k16<kTransA>(acc, desc_a, desc_b);
  } else {
    static_assert(kBN == 128, "column tiles of 128 or 256");
    wgmma_m64n128k16<kTransA>(acc, desc_a, desc_b);
  }
}

// bar.sync on named barrier `id` (1-15; 0 is __syncthreads) for `threads`
// threads, whole warps.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A warpgroup's 64 x kBN accumulators, in bf16, into its output tile: kBN / 64
// boxes of 64 x 64 in the 128-byte swizzle, the layout a TMA store reads.
// Accumulator 4 j + 2 half + c is row 16 (warp % 4) + lane / 4 + 8 half,
// column 8 j + 2 (lane % 4) + c; row r's 16-byte piece p lies at piece
// p ^ (r % 8), so the fragment writes and the row reads are free of bank
// conflicts.
template <int kBN>
__device__ __forceinline__ void stage_acc_sw128(const float (&acc)[kBN / 2], bf16* tile) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + lane / 4 + 8 * half;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      bf16* piece = tile + (j / 8) * 64 * 64 + r * 64 + ((j % 8) ^ (r % 8)) * 8;
      *reinterpret_cast<__nv_bfloat162*>(piece + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

}  // namespace
