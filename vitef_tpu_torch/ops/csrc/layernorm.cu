// LayerNorm (K6) for Hopper (sm_90a): the forward and the input gradient dx.
//
// Replaces the TPU kernels of vitef_tpu/ops/layernorm.py: _ln_fwd_kernel
// (:54; _ln_fwd_kernel_nobias :108 without a bias), launched by
// _ln_fwd_pallas (:80), and _ln_bwd_dx_kernel (:69), launched by
// _ln_bwd_dx_pallas (:112). Over the last axis of a (rows, E) matrix:
//     forward  mean = Σx / E,  var = Σ(x - mean)² / E,  rstd = 1/√(var + eps),
//              out = (x - mean)·rstd·scale [+ bias]   (out in x's dtype,
//              mean and rstd float32, one per row)
//     dx       gw = g·scale,  x̂ = (x - mean)·rstd,
//              dx = rstd·(gw - mean(gw) - x̂·mean(gw·x̂))   (dx in x's dtype)
// The statistics are float32 and two-pass (the mean first, then the centred
// variance), as :55-59 compute them, so that ViT's eps = 1e-12 keeps its
// meaning for a bfloat16 row and a constant row gives 0, not a blow-up.
//
// What bounds it on this card: bytes. Each element is read once and written
// once with about ten float32 operations; at E = 768 that is ~3 operations
// per byte in bfloat16, far below the ~20 operations per byte at which the
// CUDA cores' float32 rate would start to bind. What the design does about it:
//   - one warp per row, eight rows per block of 256 threads; the row is held
//     in registers between the passes, so x is read from device memory once;
//   - 16-byte loads and stores (8 bfloat16 or 4 float32 values a lane),
//     neighbouring lanes on neighbouring addresses;
//   - the reductions are warp-shuffle butterflies: every lane ends with the
//     same bits, in a fixed order, so two launches give identical results;
//   - the ragged last block is masked by the row count: nothing is padded
//     (the TPU wrapper pads rows to 256 for its tiling, :174-179);
//   - one template per power-of-two count of 16-byte vectors a lane holds,
//     so the register arrays are indexed with constants after unrolling.
//
// Widths: E a multiple of 8, 8 <= E <= 2048, which covers every LayerNorm
// model of the repository (ViT-B/L/H 768/1024/1280, GPT-2 768-1600, the
// tests' 32-64). Any other width returns cudaErrorInvalidValue.
//
// C interface (each returns a cudaError_t as int: the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it does not take):
//   layernorm_fwd(x, scale, bias, out, mean, rstd, rows, E, is_bf16, eps, stream)
//     x, out (rows, E) bfloat16 if is_bf16 else float32; scale, bias (E,)
//     float32, bias may be NULL; mean, rstd (rows,) float32, each may be NULL.
//   layernorm_bwd_dx(g, x, scale, mean, rstd, dx, rows, E, is_bf16, stream)
//     g, x, dx (rows, E) in one dtype as above; scale (E,), mean, rstd (rows,)
//     float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxWidth = 2048;

// Values of T in one 16-byte vector.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = r;
}

// V float32 parameters (V a multiple of 4) from a 16-byte aligned address.
template <int V>
__device__ __forceinline__ void load_params(const float* p, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p + i));
    v[i] = r.x;
    v[i + 1] = r.y;
    v[i + 2] = r.z;
    v[i + 3] = r.w;
  }
}

// Sum over the warp; every lane gets the same bits (a + b == b + a at each
// level of the butterfly).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NV: 16-byte vectors a lane holds; vector c = lane + 32 i of the row, for
// c < E / V (the rest of the lanes' slots stay zero and are not stored).
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ out,
                     float* __restrict__ mean_out, float* __restrict__ rstd_out, int rows,
                     int width, float eps) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const size_t base = static_cast<size_t>(row) * width;
  const int nvec = width / V;
  const float w = static_cast<float>(width);

  float v[NV][V];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      load16(x + base + static_cast<size_t>(c) * V, v[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) sum += v[i][j];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[i][j] = 0.f;
    }
  }
  const float mean = warp_sum(sum) / w;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[i][j] -= mean;
        sq += v[i][j] * v[i][j];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / w + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      float s[V], o[V];
      load_params<V>(scale + c * V, s);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = v[i][j] * rstd * s[j];
      if (bias != nullptr) {
        load_params<V>(bias + c * V, s);
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] += s[j];
      }
      store16(out + base + static_cast<size_t>(c) * V, o);
    }
  }
  if (lane == 0) {
    if (mean_out != nullptr) mean_out[row] = mean;
    if (rstd_out != nullptr) rstd_out[row] = rstd;
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_dx_kernel(const T* __restrict__ g, const T* __restrict__ x,
                        const float* __restrict__ scale, const float* __restrict__ mean,
                        const float* __restrict__ rstd, T* __restrict__ dx, int rows,
                        int width) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * width;
  const int nvec = width / V;
  const float mu = mean[row], rs = rstd[row];

  float gw[NV][V], xh[NV][V];
  float sum_g = 0.f, sum_gx = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      float s[V];
      load16(g + base + static_cast<size_t>(c) * V, gw[i]);
      load16(x + base + static_cast<size_t>(c) * V, xh[i]);
      load_params<V>(scale + c * V, s);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        gw[i][j] *= s[j];
        xh[i][j] = (xh[i][j] - mu) * rs;
        sum_g += gw[i][j];
        sum_gx += gw[i][j] * xh[i][j];
      }
    }
  }
  const float w = static_cast<float>(width);
  const float mg = warp_sum(sum_g) / w;
  const float mgx = warp_sum(sum_gx) / w;

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = rs * (gw[i][j] - mg - xh[i][j] * mgx);
      store16(dx + base + static_cast<size_t>(c) * V, o);
    }
  }
}

bool takes(int rows, int width) {
  return rows > 0 && rows <= 0x7fffffff - kWarps && width >= 8 && width <= kMaxWidth &&
         width % 8 == 0;
}

// Calls launch(std::integral_constant<int, NV>()) with the smallest power of
// two NV of 16-byte vectors a lane must hold for a row of `width` values of T
// (at most 8 for bfloat16, 16 for float32 at the widest row).
template <typename T, typename Launch>
void by_vectors(int width, Launch&& launch) {
  const int per_lane = (width / Vec<T>::N + 31) / 32;
  if (per_lane <= 1) {
    launch(std::integral_constant<int, 1>());
  } else if (per_lane <= 2) {
    launch(std::integral_constant<int, 2>());
  } else if (per_lane <= 4) {
    launch(std::integral_constant<int, 4>());
  } else if (per_lane <= 8) {
    launch(std::integral_constant<int, 8>());
  } else if constexpr (kMaxWidth / Vec<T>::N / 32 > 8) {
    launch(std::integral_constant<int, 16>());
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* scale, const void* bias, void* out, void* mean,
                       void* rstd, int rows, int width, float eps, cudaStream_t stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  by_vectors<T>(width, [&](auto nv) {
    layernorm_fwd_kernel<T, decltype(nv)::value><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<T*>(out), static_cast<float*>(mean),
        static_cast<float*>(rstd), rows, width, eps);
  });
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx(const void* g, const void* x, const void* scale, const void* mean,
                      const void* rstd, void* dx, int rows, int width, cudaStream_t stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  by_vectors<T>(width, [&](auto nv) {
    layernorm_bwd_dx_kernel<T, decltype(nv)::value><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(mean), static_cast<const float*>(rstd), static_cast<T*>(dx),
        rows, width);
  });
  return cudaGetLastError();
}

}  // namespace

extern "C" int layernorm_fwd(const void* x, const void* scale, const void* bias, void* out,
                             void* mean, void* rstd, int rows, int width, int is_bf16,
                             float eps, void* stream) {
  if (!takes(rows, width)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_fwd<__nv_bfloat16>(x, scale, bias, out, mean, rstd, rows, width, eps, s)
              : launch_fwd<float>(x, scale, bias, out, mean, rstd, rows, width, eps, s);
  return static_cast<int>(err);
}

extern "C" int layernorm_bwd_dx(const void* g, const void* x, const void* scale,
                                const void* mean, const void* rstd, void* dx, int rows,
                                int width, int is_bf16, void* stream) {
  if (!takes(rows, width)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dx<__nv_bfloat16>(g, x, scale, mean, rstd, dx, rows, width, s)
              : launch_dx<float>(g, x, scale, mean, rstd, dx, rows, width, s);
  return static_cast<int>(err);
}
