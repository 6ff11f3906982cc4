// Packed-qkv multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel vitef_tpu/ops/attention.py:_packed_mha_fwd_kernel
// (:99, launched by _packed_call_fwd :355) in its non-causal, unmasked mode.
// For image n and head h it computes
//     out[n, :, h*d:(h+1)*d] = softmax(Q_h K_h^T / sqrt(d)) V_h
// reading Q_h, K_h and V_h straight from the packed projection qkv (N, L, 3E),
// whose columns are [q | k | v], head-major within each, with the qkv bias
// (3E,) added in the kernel. Scores, softmax statistics and the P.V sums are
// float32; the output (N, L, E) is bfloat16.
//
// What bounds it on this card: per image and head, two L x L x d products
// (4*L*L*d FLOPs) and L*L exponentials, against (N*L*3E + N*L*E) * 2 bytes of
// device memory for the whole call. At ViT-B/16 (L=197, d=64, E=768) that is
// about 98 FLOPs per byte: memory is not the limit for a kernel that keeps
// the L x L scores on chip. This first version multiplies on the CUDA cores
// (FMA, not tensor cores), so arithmetic and shared-memory reads bound it.
//
// What the design does about it:
//   - one block per (image, head, 64-row query tile), 4 warps;
//   - the block stages K_h and V_h for all L keys in shared memory (with the
//     bias added), so each byte of K and V is read from device memory once
//     per query tile and never re-read per query row; the K rows are padded
//     to an odd word stride so the 32 lanes of a warp, each scoring its own
//     key, hit 32 different banks;
//   - a warp owns one query row at a time: each lane scores keys lane,
//     lane+32, ... against the row held in registers, the row's max and sum
//     are warp reductions, the probabilities stay in a per-warp shared
//     buffer, and each lane accumulates two output columns of P.V;
//   - the L x L scores never reach device memory.
// Tensor cores (wgmma) and TMA are later work.
//
// C interface: packed_mha_fwd(qkv, bias, out, N, L, n_heads, head_dim, stream)
// returns a cudaError_t as int: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape this kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kHeadDim = 64;               // the one instantiated head width
constexpr int kQTile = 64;                 // query rows per block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKStride = kHeadDim + 2;     // bf16 elements per staged K row
constexpr unsigned kFullMask = 0xffffffffu;

// Dynamic shared memory of one block: K (padded rows), V, and one float
// probability row per warp.
__host__ __device__ constexpr size_t smem_bytes(int L) {
  return static_cast<size_t>(L) * kKStride * sizeof(__nv_bfloat16) +
         static_cast<size_t>(L) * kHeadDim * sizeof(__nv_bfloat16) +
         static_cast<size_t>(kWarps) * L * sizeof(float);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* base, int pair) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(base)[pair]);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* base, int pair, float x, float y) {
  reinterpret_cast<__nv_bfloat162*>(base)[pair] = __floats2bfloat162_rn(x, y);
}

__global__ void __launch_bounds__(kThreads)
packed_mha_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                      const __nv_bfloat16* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out,
                      int L, int n_heads, float score_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + static_cast<size_t>(L) * kKStride;
  float* probs = reinterpret_cast<float*>(vs + static_cast<size_t>(L) * kHeadDim);

  const int E = n_heads * kHeadDim;
  const int F = 3 * E;
  const int n_tiles = (L + kQTile - 1) / kQTile;
  const int tile = blockIdx.x % n_tiles;
  const int h = (blockIdx.x / n_tiles) % n_heads;
  const int n = blockIdx.x / (n_tiles * n_heads);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* slab = qkv + static_cast<size_t>(n) * L * F;

  // Stage K_h + bias and V_h + bias. kThreads is a multiple of 32, so every
  // thread always handles the same column pair (its lane): warp w copies rows
  // w, w + kWarps, ..., each row as 32 coalesced 4-byte pairs.
  const float2 kb = load_pair(bias + E + h * kHeadDim, lane);
  const float2 vb = load_pair(bias + 2 * E + h * kHeadDim, lane);
  for (int j = warp; j < L; j += kWarps) {
    const __nv_bfloat16* row = slab + static_cast<size_t>(j) * F + E + h * kHeadDim;
    const float2 k = load_pair(row, lane);
    const float2 v = load_pair(row + E, lane);
    store_pair(ks + static_cast<size_t>(j) * kKStride, lane, k.x + kb.x, k.y + kb.y);
    store_pair(vs + static_cast<size_t>(j) * kHeadDim, lane, v.x + vb.x, v.y + vb.y);
  }
  __syncthreads();

  float* p = probs + static_cast<size_t>(warp) * L;
  const float2 qb = load_pair(bias + h * kHeadDim, lane);
  const int row_end = min(L, (tile + 1) * kQTile);
  for (int r = tile * kQTile + warp; r < row_end; r += kWarps) {
    // The query row, pre-scaled by log2(e)/sqrt(d), broadcast to every lane.
    const float2 qv = load_pair(slab + static_cast<size_t>(r) * F + h * kHeadDim, lane);
    const float qx = (qv.x + qb.x) * score_scale;
    const float qy = (qv.y + qb.y) * score_scale;
    float q[kHeadDim];
#pragma unroll
    for (int c = 0; c < kHeadDim / 2; ++c) {
      q[2 * c] = __shfl_sync(kFullMask, qx, c);
      q[2 * c + 1] = __shfl_sync(kFullMask, qy, c);
    }

    // Scores (in log2 units) for keys lane, lane + 32, ...; running max.
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const __nv_bfloat16* krow = ks + static_cast<size_t>(j) * kKStride;
      float sx = 0.f, sy = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim / 2; ++c) {
        const float2 k = load_pair(krow, c);
        sx = fmaf(q[2 * c], k.x, sx);
        sy = fmaf(q[2 * c + 1], k.y, sy);
      }
      const float s = sx + sy;
      p[j] = s;
      m = fmaxf(m, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFullMask, m, o));

    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = exp2f(p[j] - m);
      p[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFullMask, sum, o);
    __syncwarp();  // every lane's probabilities are visible to the whole warp

    // P.V: lane owns output columns 2*lane and 2*lane + 1.
    float ax = 0.f, ay = 0.f, bx = 0.f, by = 0.f;
    int j = 0;
    for (; j + 1 < L; j += 2) {
      const float p0 = p[j], p1 = p[j + 1];
      const float2 v0 = load_pair(vs + static_cast<size_t>(j) * kHeadDim, lane);
      const float2 v1 = load_pair(vs + static_cast<size_t>(j + 1) * kHeadDim, lane);
      ax = fmaf(p0, v0.x, ax);
      ay = fmaf(p0, v0.y, ay);
      bx = fmaf(p1, v1.x, bx);
      by = fmaf(p1, v1.y, by);
    }
    if (j < L) {
      const float p0 = p[j];
      const float2 v0 = load_pair(vs + static_cast<size_t>(j) * kHeadDim, lane);
      ax = fmaf(p0, v0.x, ax);
      ay = fmaf(p0, v0.y, ay);
    }
    const float inv = 1.f / sum;
    store_pair(out + (static_cast<size_t>(n) * L + r) * E + h * kHeadDim, lane,
               (ax + bx) * inv, (ay + by) * inv);
    __syncwarp();  // the next row may overwrite p only after every lane read it
  }
}

}  // namespace

extern "C" int packed_mha_fwd(const void* qkv, const void* bias, void* out, int n,
                              int L, int n_heads, int head_dim, void* stream) {
  if (head_dim != kHeadDim || n <= 0 || L <= 0 || n_heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  int smem_optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(L);
  if (smem > static_cast<size_t>(smem_optin)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(packed_mha_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long blocks =
      static_cast<long long>(n) * n_heads * ((L + kQTile - 1) / kQTile);
  const float score_scale = 1.4426950408889634f / sqrtf(static_cast<float>(kHeadDim));
  packed_mha_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), L, n_heads, score_scale);
  return static_cast<int>(cudaGetLastError());
}
