// Pieces shared by the attention kernels for Hopper (sm_90a): the CUDA-core
// csrc/ring_hop.cu (K9) takes the constants, the rounding and the warp
// reductions; the tensor-core kernels K1 (csrc/packed_mha_fwd.cu), K2/K3
// (csrc/packed_mha_bwd.cu) and K4/K5 (csrc/flash_fwd.cu, csrc/flash_bwd.cu)
// take allow_smem and kLog2e, and K2/K3's db pass load_pair.
//
// qkv (N, L, 3E) holds [q | k | v] columns, head-major within each, with the
// qkv bias (3E,) added in the kernels and rounded to bfloat16 as the plain
// PyTorch version rounds qkv + bias. Every kernel here is instantiated for
// head width 64.
//
// Shared here: the bf16 pair load, rounding and warp-reduction helpers, and
// allow_smem.

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
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float2 load_pair(const bf16* base, int pair) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(base)[pair]);
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
