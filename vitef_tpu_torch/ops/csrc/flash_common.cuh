// Pieces shared by the flash attention kernels for Hopper (sm_90a):
// csrc/flash_fwd.cu (K4) and csrc/flash_bwd.cu (K5).
//
// Both take q, k, v (and the cotangent, output and gradients) as contiguous
// (N, n_heads, L, head_dim) tensors, so one head is a contiguous L x 64
// block, and both are instantiated for bfloat16 and float32 inputs. Elem<T>
// is what differs between the two types: how two neighbouring elements (a
// "pair") or eight are read as floats and written back; float32's round_p
// is the rounding its CUDA-core forward gives P before P.V (none; the bf16
// forward runs on the tensor cores). The rest are row helpers for either
// type: stage_rows (a tile of rows into padded shared rows), dot_row_t and
// weighted_rows_t.

#pragma once

#include "packed_mha_common.cuh"

namespace {

template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  using Pair = __nv_bfloat162;
  __device__ __forceinline__ static float2 load2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ __forceinline__ static void store2(bf16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
  __device__ __forceinline__ static Pair pack(float2 v) { return __floats2bfloat162_rn(v.x, v.y); }
  __device__ __forceinline__ static float2 unpack(Pair v) { return __bfloat1622float2(v); }
  // Eight elements at a 16-byte aligned address, as floats.
  __device__ __forceinline__ static void load8(const bf16* p, float* out) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void copy8(const bf16* src, bf16* dst) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  }
};

template <>
struct Elem<float> {
  using Pair = float2;
  __device__ __forceinline__ static float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ __forceinline__ static void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
  __device__ __forceinline__ static Pair pack(float2 v) { return v; }
  __device__ __forceinline__ static float2 unpack(Pair v) { return v; }
  __device__ __forceinline__ static void load8(const float* p, float* out) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
  __device__ __forceinline__ static void copy8(const float* src, float* dst) {
    reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
    reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
  }
  __device__ __forceinline__ static float round_p(float x) { return x; }
};

// Stage rows j0 .. j0 + count - 1 of one head (a contiguous L x kHeadDim
// block) into padded shared rows of kKStride elements: warp w copies rows
// w, w + kWarps, ..., each as 32 coalesced pairs (the lane's pair). The
// stride of 66 elements puts the rows 33 words apart in bfloat16 and 66 in
// float32, so the lanes of a warp, each reading its own row, hit different
// banks (pairs of banks, for float2).
template <typename T>
__device__ __forceinline__ void stage_rows(const T* head, int j0, int count, T* dst) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int j = warp; j < count; j += kWarps) {
    const float2 x = Elem<T>::load2(head + static_cast<size_t>(j0 + j) * kHeadDim + 2 * lane);
    Elem<T>::store2(dst + static_cast<size_t>(j) * kKStride + 2 * lane, x.x, x.y);
  }
}

// The dot product of a float row held in registers with a staged row.
template <typename T>
__device__ __forceinline__ float dot_row_t(const float* x, const T* row) {
  float sx = 0.f, sy = 0.f;
#pragma unroll
  for (int c = 0; c < kHeadDim / 2; ++c) {
    const float2 k = Elem<T>::load2(row + 2 * c);
    sx = fmaf(x[2 * c], k.x, sx);
    sy = fmaf(x[2 * c + 1], k.y, sy);
  }
  return sx + sy;
}

// The sum over j < count of w[j] times column pair `pair` of staged row j, in
// float32: even and odd j in two partial sums.
template <typename T>
__device__ __forceinline__ float2 weighted_rows_t(const float* w, const T* rows, int count,
                                                  int pair) {
  float ax = 0.f, ay = 0.f, bx = 0.f, by = 0.f;
  int j = 0;
  for (; j + 1 < count; j += 2) {
    const float w0 = w[j], w1 = w[j + 1];
    const float2 r0 = Elem<T>::load2(rows + static_cast<size_t>(j) * kKStride + 2 * pair);
    const float2 r1 = Elem<T>::load2(rows + static_cast<size_t>(j + 1) * kKStride + 2 * pair);
    ax = fmaf(w0, r0.x, ax);
    ay = fmaf(w0, r0.y, ay);
    bx = fmaf(w1, r1.x, bx);
    by = fmaf(w1, r1.y, by);
  }
  if (j < count) {
    const float w0 = w[j];
    const float2 r0 = Elem<T>::load2(rows + static_cast<size_t>(j) * kKStride + 2 * pair);
    ax = fmaf(w0, r0.x, ax);
    ay = fmaf(w0, r0.y, ay);
  }
  return make_float2(ax + bx, ay + by);
}

}  // namespace
