// Grouped transposed product for Hopper (sm_90a): kernel K8 (tgmm) and the
// K7 pass tgmm_swiglu.
//
// Replaces the TPU kernels megablox tgmm (jax/experimental/pallas/ops/tpu/
// megablox/gmm.py:573, call :763), which vitef_tpu/parallel/moe.py calls for
// the expert weight gradients (:457, :630-633), and vitef_tpu/ops/
// gmm_fused.py:tgmm_swiglu (:268, call :342). Over rows sorted by group it
// computes, for every group e,
//     kPlain:    out[e] = A[rows of e]^T @ B[rows of e]        A (G, K), B (G, N)
//     kSwigluIn: out[e] = y[rows of e]^T @ B[rows of e],  y = bf16(silu(h[:, :K]) h[:, K:])
// into out (E, K, N), in bfloat16 (tensor cores, float32 accumulators) or
// float32 (CUDA-core FMAs, no TF32), output in the input dtype; an empty
// group writes zeros. y is rounded to the input dtype before its product, as
// the TPU kernel does.
//
// What bounds it on this card: at the 8x124m step (G = 16384 rows, E = 8) a
// dw1 half is 51.5 GFLOP against 113 MB (0.052 ms at 989 TFLOP/s) and dw2 in
// kSwigluIn 51.5 GFLOP against 169 MB (0.052 ms), bound by the tensor cores'
// rate, near the line.
//
// What the design does about it: one block per (group, K tile of 128, N
// tile of 128), 8 warps of 16 x 8 x 16 mma.sync products; the block walks
// its group's rows 32 at a time in a fixed order, staging the two row
// slices in shared memory (ldmatrix, A read transposed) while the next
// slice is loaded into registers. Each block owns its output tile, so
// there are no atomics and two launches give the same bits. The group's
// first row is the sum of the sizes before it, read on the card. No TMA or
// wgmma yet.
//
// C interface: tgmm(a, b, group_sizes, out, G, K, N, E, mode, fp32, stream)
// returns a cudaError_t as int: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape this kernel does not take. a is A
// (G, K), or h (G, 2K) in kSwigluIn; K and N are multiples of 8.

#include "gmm_common.cuh"

namespace {

struct Args {
  const void* a;
  const void* b;
  const int* sizes;
  void* out;
  int G, K, N, E;
};

// Rows [*lo, *hi) of group e, clamped to G.
__device__ __forceinline__ void group_rows(const Args& p, int e, int* lo, int* hi) {
  int start = 0;
  for (int i = 0; i < e; ++i) start = min(start + max(__ldg(p.sizes + i), 0), p.G);
  *lo = start;
  *hi = min(start + max(__ldg(p.sizes + e), 0), p.G);
}

// --- bfloat16 ---------------------------------------------------------------

struct StageBf16 {
  uint4 a[2], up[2], b[2];
};

template <int kMode>
__device__ __forceinline__ void load_bf16(const Args& p, StageBf16& s, int r0, int hi, int k0,
                                          int n0) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int lda = kMode == kSwigluIn ? 2 * p.K : p.K;
  const bf16* a = static_cast<const bf16*>(p.a);
  const bf16* b = static_cast<const bf16*>(p.b);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int piece = threadIdx.x + i * kThreads;
    const int r = r0 + piece / (kTile / 8);
    const int c = (piece % (kTile / 8)) * 8;
    s.a[i] = s.up[i] = s.b[i] = zero;
    if (r < hi) {
      if (k0 + c < p.K) {
        s.a[i] = ldg16(a + static_cast<size_t>(r) * lda + k0 + c);
        if (kMode == kSwigluIn) s.up[i] = ldg16(a + static_cast<size_t>(r) * lda + p.K + k0 + c);
      }
      if (n0 + c < p.N) s.b[i] = ldg16(b + static_cast<size_t>(r) * p.N + n0 + c);
    }
  }
}

template <int kMode>
__device__ __forceinline__ void store_bf16(const StageBf16& s, bf16* a_tile, bf16* b_tile) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int piece = threadIdx.x + i * kThreads;
    const int at = (piece / (kTile / 8)) * kColStride + (piece % (kTile / 8)) * 8;
    *reinterpret_cast<uint4*>(a_tile + at) =
        kMode == kSwigluIn ? swiglu8(s.a[i], s.up[i]) : s.a[i];
    *reinterpret_cast<uint4*>(b_tile + at) = s.b[i];
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) tgmm_bf16_kernel(Args p) {
  __shared__ __align__(16) bf16 a_s[2][kDepth * kColStride];
  __shared__ __align__(16) bf16 b_s[2][kDepth * kColStride];
  const int n0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile, e = blockIdx.z;
  int lo, hi;
  group_rows(p, e, &lo, &hi);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;

  float acc[4][4][4] = {};
  if (hi > lo) {
    StageBf16 stage;
    load_bf16<kMode>(p, stage, lo, hi, k0, n0);
    store_bf16<kMode>(stage, a_s[0], b_s[0]);
    __syncthreads();
    for (int r0 = lo, buf = 0; r0 < hi; r0 += kDepth, buf ^= 1) {
      const bool more = r0 + kDepth < hi;
      if (more) load_bf16<kMode>(p, stage, r0 + kDepth, hi, k0, n0);
#pragma unroll
      for (int k16 = 0; k16 < kDepth / 16; ++k16) {
        warp_mma_k16<false>(acc, a_s[buf], b_s[buf], k16, wm, wn, lane);
      }
      if (more) store_bf16<kMode>(stage, a_s[buf ^ 1], b_s[buf ^ 1]);
      __syncthreads();
    }
  }

  bf16* out = static_cast<bf16*>(p.out) + static_cast<size_t>(e) * p.K * p.N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = k0 + wm * 64 + mi * 16 + lane / 4 + half * 8;
      if (k >= p.K) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * (lane % 4);
        if (n >= p.N) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(k) * p.N + n) =
            __floats2bfloat162_rn(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
  }
}

// --- float32 ----------------------------------------------------------------

struct StageF32 {
  float4 a, up, b;
};

template <int kMode>
__device__ __forceinline__ void load_f32(const Args& p, StageF32& s, int r0, int hi, int k0,
                                         int n0) {
  const int lda = kMode == kSwigluIn ? 2 * p.K : p.K;
  const float* a = static_cast<const float*>(p.a);
  const int r = r0 + threadIdx.x / (kTileF / 4);
  const int c = (threadIdx.x % (kTileF / 4)) * 4;
  s.a = s.up = s.b = zero4();
  if (r < hi) {
    if (k0 + c < p.K) {
      s.a = ldg4(a + static_cast<size_t>(r) * lda + k0 + c);
      if (kMode == kSwigluIn) s.up = ldg4(a + static_cast<size_t>(r) * lda + p.K + k0 + c);
    }
    if (n0 + c < p.N) {
      s.b = ldg4(static_cast<const float*>(p.b) + static_cast<size_t>(r) * p.N + n0 + c);
    }
  }
}

template <int kMode>
__device__ __forceinline__ void store_f32(const StageF32& s, float* a_tile, float* b_tile) {
  const int at = (threadIdx.x / (kTileF / 4)) * kStrideF + (threadIdx.x % (kTileF / 4)) * 4;
  *reinterpret_cast<float4*>(a_tile + at) = kMode == kSwigluIn ? swiglu4(s.a, s.up) : s.a;
  *reinterpret_cast<float4*>(b_tile + at) = s.b;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) tgmm_f32_kernel(Args p) {
  __shared__ __align__(16) float a_s[2][kDepthF * kStrideF];
  __shared__ __align__(16) float b_s[2][kDepthF * kStrideF];
  const int n0 = blockIdx.x * kTileF, k0 = blockIdx.y * kTileF, e = blockIdx.z;
  int lo, hi;
  group_rows(p, e, &lo, &hi);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[4][4] = {};
  if (hi > lo) {
    StageF32 stage;
    load_f32<kMode>(p, stage, lo, hi, k0, n0);
    store_f32<kMode>(stage, a_s[0], b_s[0]);
    __syncthreads();
    for (int r0 = lo, buf = 0; r0 < hi; r0 += kDepthF, buf ^= 1) {
      const bool more = r0 + kDepthF < hi;
      if (more) load_f32<kMode>(p, stage, r0 + kDepthF, hi, k0, n0);
      fma_tile(acc, a_s[buf], b_s[buf], ty, tx);
      if (more) store_f32<kMode>(stage, a_s[buf ^ 1], b_s[buf ^ 1]);
      __syncthreads();
    }
  }

  const int n = n0 + tx * 4;
  if (n >= p.N) return;
  float* out = static_cast<float*>(p.out) + static_cast<size_t>(e) * p.K * p.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k < p.K) {
      *reinterpret_cast<float4*>(out + static_cast<size_t>(k) * p.N + n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

template <int kMode>
cudaError_t launch(const Args& p, int fp32, cudaStream_t stream) {
  const int tile = fp32 ? kTileF : kTile;
  const dim3 grid((p.N + tile - 1) / tile, (p.K + tile - 1) / tile, p.E);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  if (fp32) {
    tgmm_f32_kernel<kMode><<<grid, kThreads, 0, stream>>>(p);
  } else {
    tgmm_bf16_kernel<kMode><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int tgmm(const void* a, const void* b, const void* group_sizes, void* out, int G,
                    int K, int N, int E, int mode, int fp32, void* stream) {
  if (G < 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args p{a, b, static_cast<const int*>(group_sizes), out, G, K, N, E};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPlain: return static_cast<int>(launch<kPlain>(p, fp32, s));
    case kSwigluIn: return static_cast<int>(launch<kSwigluIn>(p, fp32, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
