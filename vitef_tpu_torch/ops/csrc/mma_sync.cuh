// Tensor-core and asynchronous-copy wrappers for Hopper (sm_90a), shared by
// the kernels that multiply with mma.sync: csrc/packed_mha_fwd.cu and
// csrc/flash_fwd.cu (through attn_fwd_mma.cuh), csrc/packed_mha_bwd.cu and
// csrc/flash_bwd.cu (through attn_bwd_mma.cuh; K4's and K5's float32 paths
// through mma_3xtf32), and csrc/ring_hop.cu (bf16 and float16). The TMA +
// wgmma kernels of csrc/gmm.cu and csrc/tgmm.cu (wgmma_tma.cuh) take
// smem_addr and ldmatrix from here.
//
// Here: shared-memory addresses, ldmatrix (plain and transposed), the
// m16n8k16 bf16 and float16 products with float32 accumulators, the m16n8k8
// TF32 product and its split ("3xTF32") form for float32 operands, and
// 16-byte cp.async copies with their zero-fill form, commit and wait. No
// tile shapes: each kernel family keeps its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 matrices of 16-bit elements (or 8 x 4 of 32-bit ones) from
// shared memory; lane l gives the address of row l % 8 of matrix l / 8, and
// register i of lane t is the 32 bits at row t / 4, word t % 4 of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a (16 x 16, row) * b (16 x 8, col), float16 in, float32 accumulators.
__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a (16 x 8, row) * b (8 x 8, col), TF32 in, float32 accumulators. A
// TF32 operand is a float32 bit pattern whose low 13 bits are zero.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x as two TF32 values: hi = x rounded to TF32 (nearest, ties away from
// zero) and lo = x - hi rounded likewise, so hi + lo is x to about 2^-22.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c += a * b for float32 a and b split into TF32 pairs (split_tf32): the
// three products lo.hi + hi.lo + hi.hi; lo.lo, about 2^-22 of the product,
// is dropped. Each product of two TF32 values is exact in float32, so the
// result keeps float32's accuracy up to its summation order.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* a_hi, const uint32_t* a_lo,
                                           const uint32_t* b_hi, const uint32_t* b_lo) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// 16 bytes from global to shared memory, bypassing L1; with fill false no
// byte is read and the 16 bytes are zeroed (src must still be a valid
// address). Both addresses are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

// Close the group of this thread's cp.async copies issued since the last one.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` of this thread's groups are in flight; the
// copies of the others are then visible to this thread (to the block after
// a __syncthreads).
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace
