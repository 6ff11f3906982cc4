// Pieces shared by the attention kernels for Hopper (sm_90a): the
// tensor-core kernels K1 (csrc/packed_mha_fwd.cu), K2/K3
// (csrc/packed_mha_bwd.cu), K4/K5 (csrc/flash_fwd.cu, csrc/flash_bwd.cu) and
// K9 (csrc/ring_hop.cu) take allow_smem and kLog2e, and K2/K3's db pass
// load_pair.
//
// qkv (N, L, 3E) holds [q | k | v] columns, head-major within each, with the
// qkv bias (3E,) added in the kernels and rounded to bfloat16 as the plain
// PyTorch version rounds qkv + bias. K1-K3 are instantiated for head widths
// 64 and 80 (ViT-H/14), and K1 also for 128 (Llama-3.1-8B), each a template
// argument of their tiles; K4 and K5 for 64 only, kFlashDim; K9 for 64 and
// 128 (csrc/ring_hop.cu).
//
// Shared here: the flash kernels' head width, the bf16 pair load, log2(e)
// and allow_smem.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kFlashDim = 64;              // K4's and K5's one head width
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float2 load_pair(const bf16* base, int pair) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(base)[pair]);
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
