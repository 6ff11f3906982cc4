// Grouped matrix product for Hopper (sm_90a): kernel K8 (gmm) and three of
// the K7 passes.
//
// Replaces the TPU kernels megablox gmm (jax/experimental/pallas/ops/tpu/
// megablox/gmm.py:314, call :526), which vitef_tpu/parallel/moe.py:_gmm
// (:428) calls for the expert products, and three of vitef_tpu/ops/
// gmm_fused.py's: gmm_swiglu (:94, call :149), gmm_dy_swiglu (:177, call
// :240) and gmm_dual (:370, call :431). Over rows sorted by group it
// computes, for every row r of group e,
//     kPlain:        out[r] = A[r] @ W[e]                      A (G, K), W (E, K, N)
//     kSwigluIn:     out[r] = bf16(silu(h[r, :K]) h[r, K:]) @ W[e]   h (G, 2K)
//     kSwigluBwdOut: acc = g[r] @ W[e] (float32), then
//                    dhg[r] = acc hu silu'(hg), dhu[r] = acc silu(hg)   h (G, 2N)
//     kDual:         out[r] = a[r] @ W[e, :K/2] + b[r] @ W[e, K/2:]      a, b (G, K/2)
// in bfloat16 (tensor cores, float32 accumulators) or float32 (CUDA-core
// FMAs, no TF32); outputs in the input dtype. In kSwigluIn the gated
// activation is rounded to the input dtype before its product, and in
// kSwigluBwdOut the swiglu backward reads the unrounded float32
// accumulator, as the TPU kernels do.
//
// What bounds it on this card: at the 8x124m step (G = 16384 rows, E = 8,
// d = 768, f = 2048) fc1 is 103 GFLOP against 76 MB, so the products are
// bound by the tensor cores' rate (0.104 ms at 989 TFLOP/s); kSwigluIn and
// kSwigluBwdOut move about as many bytes as they multiply (h is 134 MB) and
// sit near the line.
//
// What the design does about it: one block per (row tile of 128, column
// tile of 128) of one group, 8 warps of 16 x 8 x 16 mma.sync products on
// tiles staged in shared memory (ldmatrix), the next depth slice loaded into
// registers while the current one multiplies (one barrier per slice). The
// work list is built on the card: block y walks group_sizes and takes the
// y-th (group, row tile) pair, a row tile that spans a group boundary being
// visited once per group with loads and stores masked to that group's rows
// (megablox's store mask); the grid is sized from the host-known bound
// ceil(G / 128) + E - 1 and surplus blocks return. So no launch reads the
// sizes on the host. The swiglu prologue (kSwigluIn) is applied while the
// tile moves from registers to shared memory; the swiglu backward
// (kSwigluBwdOut) in the store epilogue. No TMA or wgmma yet.
//
// C interface: gmm(a, b, w, h, group_sizes, out, out2, G, K, N, E, mode, fp32,
// stream) returns a cudaError_t as int: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape this kernel does not take. K is the
// contracted width (kDual: the 2f rows of W), N the output width; K and N
// are multiples of 8 (kDual: K of 16). b is read in kDual only, h and out2
// in kSwigluBwdOut only.

#include "gmm_common.cuh"

namespace {

struct Args {
  const void* a;
  const void* b;
  const void* w;
  const void* h;
  const int* sizes;
  void* out;
  void* out2;
  int G, K, N, E;
};

// The (group, row tile, rows [lo, hi)) of work slot `slot` over row tiles of
// `tile` rows, walking the group sizes; false for a surplus slot.
__device__ __forceinline__ bool find_work(const Args& p, int tile, int slot, int* group,
                                          int* row0, int* lo, int* hi) {
  int start = 0;
  for (int e = 0; e < p.E; ++e) {
    const int size = max(__ldg(p.sizes + e), 0);
    const int end = min(start + size, p.G);
    if (end > start) {
      const int first = start / tile;
      const int count = (end - 1) / tile - first + 1;
      if (slot < count) {
        *group = e;
        *row0 = (first + slot) * tile;
        *lo = max(start, *row0);
        *hi = min(end, *row0 + tile);
        return true;
      }
      slot -= count;
    }
    start = end;
  }
  return false;
}

// The row stride of A, in elements, for each mode.
template <int kMode>
__device__ __forceinline__ int a_stride(const Args& p) {
  return kMode == kSwigluIn ? 2 * p.K : (kMode == kDual ? p.K / 2 : p.K);
}

// --- bfloat16 ---------------------------------------------------------------

// One thread's share of a depth slice: two 16-byte pieces of A (with their
// up-halves in kSwigluIn) and two of W, held in registers.
struct StageBf16 {
  uint4 a[2], up[2], w[2];
};

template <int kMode>
__device__ __forceinline__ void load_bf16(const Args& p, StageBf16& s, int e, int row0, int lo,
                                          int hi, int n0, int k0) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int lda = a_stride<kMode>(p);
  const bf16* a = static_cast<const bf16*>(p.a);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int piece = threadIdx.x + i * kThreads;
    const int r = row0 + piece / (kDepth / 8);
    const int k = k0 + (piece % (kDepth / 8)) * 8;
    s.a[i] = s.up[i] = zero;
    if (r >= lo && r < hi && k < p.K) {
      if (kMode == kDual) {
        const int f = p.K / 2;
        const bf16* src = k < f ? a : static_cast<const bf16*>(p.b);
        s.a[i] = ldg16(src + static_cast<size_t>(r) * lda + (k < f ? k : k - f));
      } else {
        s.a[i] = ldg16(a + static_cast<size_t>(r) * lda + k);
        if (kMode == kSwigluIn) s.up[i] = ldg16(a + static_cast<size_t>(r) * lda + p.K + k);
      }
    }
    const int kw = k0 + piece / (kTile / 8);
    const int n = n0 + (piece % (kTile / 8)) * 8;
    s.w[i] = zero;
    if (kw < p.K && n < p.N) {
      s.w[i] = ldg16(static_cast<const bf16*>(p.w) +
                     (static_cast<size_t>(e) * p.K + kw) * p.N + n);
    }
  }
}

template <int kMode>
__device__ __forceinline__ void store_bf16(const StageBf16& s, bf16* a_tile, bf16* w_tile) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int piece = threadIdx.x + i * kThreads;
    const uint4 a = kMode == kSwigluIn ? swiglu8(s.a[i], s.up[i]) : s.a[i];
    *reinterpret_cast<uint4*>(a_tile + (piece / (kDepth / 8)) * kRowStride +
                              (piece % (kDepth / 8)) * 8) = a;
    *reinterpret_cast<uint4*>(w_tile + (piece / (kTile / 8)) * kColStride +
                              (piece % (kTile / 8)) * 8) = s.w[i];
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) gmm_bf16_kernel(Args p) {
  __shared__ __align__(16) bf16 a_s[2][kTile * kRowStride];
  __shared__ __align__(16) bf16 w_s[2][kDepth * kColStride];
  int e, row0, lo, hi;
  if (!find_work(p, kTile, blockIdx.y, &e, &row0, &lo, &hi)) return;
  const int n0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;

  float acc[4][4][4] = {};
  StageBf16 stage;
  const int steps = (p.K + kDepth - 1) / kDepth;
  load_bf16<kMode>(p, stage, e, row0, lo, hi, n0, 0);
  store_bf16<kMode>(stage, a_s[0], w_s[0]);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load_bf16<kMode>(p, stage, e, row0, lo, hi, n0, (step + 1) * kDepth);
#pragma unroll
    for (int k16 = 0; k16 < kDepth / 16; ++k16) {
      warp_mma_k16<true>(acc, a_s[buf], w_s[buf], k16, wm, wn, lane);
    }
    if (step + 1 < steps) store_bf16<kMode>(stage, a_s[buf ^ 1], w_s[buf ^ 1]);
    __syncthreads();
  }

  // Epilogue: accumulator (mi, ni, c) holds row wm*64 + mi*16 + lane/4 (+8
  // for c >= 2), columns wn*32 + ni*8 + 2*(lane%4) (+1 for odd c).
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + wm * 64 + mi * 16 + lane / 4 + half * 8;
      if (r < lo || r >= hi) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * (lane % 4);
        if (n >= p.N) continue;
        const float x = acc[mi][ni][2 * half], y = acc[mi][ni][2 * half + 1];
        const size_t at = static_cast<size_t>(r) * p.N + n;
        if (kMode == kSwigluBwdOut) {
          const bf16* h = static_cast<const bf16*>(p.h) + static_cast<size_t>(r) * 2 * p.N + n;
          const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h));
          const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h + p.N));
          float dg0, du0, dg1, du1;
          swiglu_bwd_f32(x, g.x, u.x, &dg0, &du0);
          swiglu_bwd_f32(y, g.y, u.y, &dg1, &du1);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + at) =
              __floats2bfloat162_rn(dg0, dg1);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out2) + at) =
              __floats2bfloat162_rn(du0, du1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + at) =
              __floats2bfloat162_rn(x, y);
        }
      }
    }
  }
}

// --- float32 ----------------------------------------------------------------

struct StageF32 {
  float4 a, up, w;
};

template <int kMode>
__device__ __forceinline__ void load_f32(const Args& p, StageF32& s, int e, int row0, int lo,
                                         int hi, int n0, int k0) {
  const int lda = a_stride<kMode>(p);
  const float* a = static_cast<const float*>(p.a);
  const int r = row0 + threadIdx.x / (kDepthF / 4);
  const int k = k0 + (threadIdx.x % (kDepthF / 4)) * 4;
  s.a = s.up = zero4();
  if (r >= lo && r < hi && k < p.K) {
    if (kMode == kDual) {
      const int f = p.K / 2;
      const float* src = k < f ? a : static_cast<const float*>(p.b);
      s.a = ldg4(src + static_cast<size_t>(r) * lda + (k < f ? k : k - f));
    } else {
      s.a = ldg4(a + static_cast<size_t>(r) * lda + k);
      if (kMode == kSwigluIn) s.up = ldg4(a + static_cast<size_t>(r) * lda + p.K + k);
    }
  }
  const int kw = k0 + threadIdx.x / (kTileF / 4);
  const int n = n0 + (threadIdx.x % (kTileF / 4)) * 4;
  s.w = zero4();
  if (kw < p.K && n < p.N) {
    s.w = ldg4(static_cast<const float*>(p.w) + (static_cast<size_t>(e) * p.K + kw) * p.N + n);
  }
}

template <int kMode>
__device__ __forceinline__ void store_f32(const StageF32& s, float* a_tile, float* w_tile) {
  const float4 a = kMode == kSwigluIn ? swiglu4(s.a, s.up) : s.a;
  const int r = threadIdx.x / (kDepthF / 4), k = (threadIdx.x % (kDepthF / 4)) * 4;
  a_tile[(k + 0) * kStrideF + r] = a.x;  // depth-major: A is stored transposed
  a_tile[(k + 1) * kStrideF + r] = a.y;
  a_tile[(k + 2) * kStrideF + r] = a.z;
  a_tile[(k + 3) * kStrideF + r] = a.w;
  *reinterpret_cast<float4*>(w_tile + (threadIdx.x / (kTileF / 4)) * kStrideF +
                             (threadIdx.x % (kTileF / 4)) * 4) = s.w;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) gmm_f32_kernel(Args p) {
  __shared__ __align__(16) float a_s[2][kDepthF * kStrideF];
  __shared__ __align__(16) float w_s[2][kDepthF * kStrideF];
  int e, row0, lo, hi;
  if (!find_work(p, kTileF, blockIdx.y, &e, &row0, &lo, &hi)) return;
  const int n0 = blockIdx.x * kTileF;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[4][4] = {};
  StageF32 stage;
  const int steps = (p.K + kDepthF - 1) / kDepthF;
  load_f32<kMode>(p, stage, e, row0, lo, hi, n0, 0);
  store_f32<kMode>(stage, a_s[0], w_s[0]);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load_f32<kMode>(p, stage, e, row0, lo, hi, n0, (step + 1) * kDepthF);
    fma_tile(acc, a_s[buf], w_s[buf], ty, tx);
    if (step + 1 < steps) store_f32<kMode>(stage, a_s[buf ^ 1], w_s[buf ^ 1]);
    __syncthreads();
  }

  const int n = n0 + tx * 4;
  if (n >= p.N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r < lo || r >= hi) continue;
    const size_t at = static_cast<size_t>(r) * p.N + n;
    if (kMode == kSwigluBwdOut) {
      const float* h = static_cast<const float*>(p.h) + static_cast<size_t>(r) * 2 * p.N + n;
      const float4 g = ldg4(h), u = ldg4(h + p.N);
      float4 dg, du;
      swiglu_bwd_f32(acc[i][0], g.x, u.x, &dg.x, &du.x);
      swiglu_bwd_f32(acc[i][1], g.y, u.y, &dg.y, &du.y);
      swiglu_bwd_f32(acc[i][2], g.z, u.z, &dg.z, &du.z);
      swiglu_bwd_f32(acc[i][3], g.w, u.w, &dg.w, &du.w);
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + at) = dg;
      *reinterpret_cast<float4*>(static_cast<float*>(p.out2) + at) = du;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + at) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

template <int kMode>
cudaError_t launch(const Args& p, int fp32, cudaStream_t stream) {
  const int tile = fp32 ? kTileF : kTile;
  const long long slots = (static_cast<long long>(p.G) + tile - 1) / tile + p.E - 1;
  if (slots > 65535) return cudaErrorInvalidValue;
  const dim3 grid((p.N + tile - 1) / tile, static_cast<unsigned>(slots));
  if (fp32) {
    gmm_f32_kernel<kMode><<<grid, kThreads, 0, stream>>>(p);
  } else {
    gmm_bf16_kernel<kMode><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int gmm(const void* a, const void* b, const void* w, const void* h,
                   const void* group_sizes, void* out, void* out2, int G, int K, int N, int E,
                   int mode, int fp32, void* stream) {
  if (G < 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8 || (mode == kDual && K % 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (G == 0) return static_cast<int>(cudaSuccess);
  const Args p{a, b, w, h, static_cast<const int*>(group_sizes), out, out2, G, K, N, E};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPlain: return static_cast<int>(launch<kPlain>(p, fp32, s));
    case kSwigluIn: return static_cast<int>(launch<kSwigluIn>(p, fp32, s));
    case kSwigluBwdOut: return static_cast<int>(launch<kSwigluBwdOut>(p, fp32, s));
    case kDual: return static_cast<int>(launch<kDual>(p, fp32, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
