// Pieces shared by the packed-qkv attention kernels for Hopper (sm_90a):
// csrc/packed_mha_fwd.cu (K1) and csrc/packed_mha_bwd.cu (K2 and K3).
//
// qkv (N, L, 3E) holds [q | k | v] columns, head-major within each, with the
// qkv bias (3E,) added in the kernels and rounded to bfloat16 as the plain
// PyTorch version rounds qkv + bias. Every kernel here is instantiated for
// head width 64.
//
// Shared here: the bf16 load/store and warp-reduction helpers; the three
// pieces of a query-row pass over staged key tiles: stage_kv (K and V rows
// of a head into shared memory, bias added), dot_row (a score or dP entry)
// and weighted_rows (a lane's two columns of P.V or dS.K); and allow_smem.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 64;               // the one instantiated head width
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKStride = kHeadDim + 2;     // bf16 elements per staged K / V row
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float2 load_pair(const bf16* base, int pair) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(base)[pair]);
}

__device__ __forceinline__ void store_pair(bf16* base, int pair, float x, float y) {
  reinterpret_cast<__nv_bfloat162*>(base)[pair] = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

// The dot product of a float row held in registers with a staged bf16 row,
// summed in two interleaved halves.
__device__ __forceinline__ float dot_row(const float* x, const bf16* row) {
  float sx = 0.f, sy = 0.f;
#pragma unroll
  for (int c = 0; c < kHeadDim / 2; ++c) {
    const float2 k = load_pair(row, c);
    sx = fmaf(x[2 * c], k.x, sx);
    sy = fmaf(x[2 * c + 1], k.y, sy);
  }
  return sx + sy;
}

// The 64 floats of a staged row, into registers (broadcast reads).
__device__ __forceinline__ void load_row(const float* row, float* x) {
  const float2* r = reinterpret_cast<const float2*>(row);
#pragma unroll
  for (int c = 0; c < kHeadDim / 2; ++c) {
    const float2 t = r[c];
    x[2 * c] = t.x;
    x[2 * c + 1] = t.y;
  }
}

// Stage keys j0 .. j0 + count - 1 of head h into ks and vs (padded rows of
// kKStride), bias added and rounded to bf16: warp w copies rows w, w + kWarps,
// ..., each as 32 coalesced 4-byte column pairs (the lane's pair).
__device__ __forceinline__ void stage_kv(const bf16* slab, const bf16* bias, int E, int h,
                                         int j0, int count, bf16* ks, bf16* vs) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float2 kb = load_pair(bias + E + h * kHeadDim, lane);
  const float2 vb = load_pair(bias + 2 * E + h * kHeadDim, lane);
  for (int j = warp; j < count; j += kWarps) {
    const bf16* row = slab + static_cast<size_t>(j0 + j) * 3 * E + E + h * kHeadDim;
    const float2 k = load_pair(row, lane);
    const float2 v = load_pair(row + E, lane);
    store_pair(ks + static_cast<size_t>(j) * kKStride, lane, k.x + kb.x, k.y + kb.y);
    store_pair(vs + static_cast<size_t>(j) * kKStride, lane, v.x + vb.x, v.y + vb.y);
  }
}

// The sum over j < count of w[j] times column pair `pair` of staged row j
// (padded rows of kKStride), in float32: even and odd j in two partial sums.
__device__ __forceinline__ float2 weighted_rows(const float* w, const bf16* rows, int count,
                                                int pair) {
  float ax = 0.f, ay = 0.f, bx = 0.f, by = 0.f;
  int j = 0;
  for (; j + 1 < count; j += 2) {
    const float w0 = w[j], w1 = w[j + 1];
    const float2 r0 = load_pair(rows + static_cast<size_t>(j) * kKStride, pair);
    const float2 r1 = load_pair(rows + static_cast<size_t>(j + 1) * kKStride, pair);
    ax = fmaf(w0, r0.x, ax);
    ay = fmaf(w0, r0.y, ay);
    bx = fmaf(w1, r1.x, bx);
    by = fmaf(w1, r1.y, by);
  }
  if (j < count) {
    const float w0 = w[j];
    const float2 r0 = load_pair(rows + static_cast<size_t>(j) * kKStride, pair);
    ax = fmaf(w0, r0.x, ax);
    ay = fmaf(w0, r0.y, ay);
  }
  return make_float2(ax + bx, ay + by);
}

// Let `kernel` use `smem` bytes of dynamic shared memory, or report why not.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  int device = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace
