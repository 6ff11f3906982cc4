// Packed-qkv multi-head attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel vitef_tpu/ops/attention.py:_packed_mha_bwd_kernel
// (:270, launched by _packed_mha_bwd :400) in its non-causal mode. It is the
// backward of csrc/packed_mha_fwd.cu. For image n and head h, with
// Q, K, V = (qkv + bias)[n, :, head h of q | k | v] rounded to bfloat16,
// P = softmax(Q K^T / sqrt(d)) and the cotangent G = g[n, :, head h]:
//     dV = P^T G,  dP = G V^T,  dS = P * (dP - rowsum(P * dP)) / sqrt(d),
//     dQ = dS K,   dK = dS^T Q,
// written back into dqkv (N, L, 3E) in the packed [q | k | v] head-major
// layout; the qkv-bias gradient db (3E,) is the float32 column sum of that
// bfloat16 dqkv over all N*L rows. Everything between the bf16 inputs and
// the bf16 dqkv is float32.
//
// What bounds it on this card, and what the design does about it:
//   - Arithmetic. Per (image, head) the algebra is five L x L x d products;
//     this version also recomputes the scores and dP in the dK/dV pass, so it
//     does seven, on the CUDA cores (FMA, not tensor cores). Shared-memory
//     reads feed the FMAs: each pass keeps one operand of its products in
//     registers and reads the other as a broadcast.
//   - Reductions across blocks. dK and dV sum over every query row, db over
//     all N*L rows, and Hopper's blocks run in no order. So there are three
//     passes and no atomics, which also makes two launches on the same inputs
//     bit-identical:
//       (a) dq_kernel, one block per (image, head, 64-row query tile), shaped
//           like the forward kernel: K and V staged in shared memory, a warp
//           per query row recomputes the row's softmax, dP and its
//           rowsum(P * dP), writes dQ, and keeps the row's log2-sum-exp and
//           rowsum as float32 statistics (8 bytes per row and head);
//       (b) dkv_kernel, one block per (image, head, 32-key tile), a lane per
//           key with that key's K and V rows in registers: it walks all L
//           query rows in chunks staged in shared memory, rebuilds P and dS
//           for its keys from (a)'s statistics, and accumulates dK and dV in
//           registers;
//       (c) db_partial_kernel and db_final_kernel, a column reduction of the
//           bf16 dqkv in a fixed order (row segments, then the segments).
//   - Shared memory. One (image, head) at L = 197 with its L x L float32
//     probabilities would not fit a block's 227 KB; no L x L tensor is kept,
//     in shared memory or in device memory. Pass (a) holds K and V (padded
//     rows) and two float rows per warp: 296 bytes per key, so L <= 785.
// Tensor cores (mma/wgmma) and TMA are later work.
//
// C interface:
//   packed_mha_bwd(qkv, bias, g, dqkv, db, stats, partial, N, L, n_heads,
//                  head_dim, db_segments, stream)
// qkv (N, L, 3E), bias (3E,), g (N, L, E) and dqkv (N, L, 3E) are bfloat16;
// db (3E,) is float32; stats is float32 scratch of N * n_heads * L * 2 and
// partial float32 scratch of db_segments * 3E. Returns a cudaError_t as int:
// the last launch's cudaGetLastError(), or cudaErrorInvalidValue for a shape
// this kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 64;               // the one instantiated head width
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQTile = 64;                 // query rows per block of dq_kernel
constexpr int kKStride = kHeadDim + 2;     // bf16 elements per staged K / V row
constexpr int kKTile = 32;                 // keys per block of dkv_kernel (a lane each)
constexpr int kQChunk = 32;                // query rows staged per step of dkv_kernel
constexpr int kColsPerWarp = kHeadDim / kWarps;  // dK / dV columns a thread owns
constexpr int kDbWarps = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory of one dq_kernel block: K and V (padded rows), and a
// probability row and a dP/dS row for each warp.
__host__ __device__ constexpr size_t dq_smem_bytes(int L) {
  return static_cast<size_t>(L) * kKStride * sizeof(bf16) * 2 +
         static_cast<size_t>(kWarps) * 2 * L * sizeof(float);
}

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

// Eight bf16 values of a 16-byte word, as floats.
__device__ __forceinline__ void unpack8(const uint4& w, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// (a) dQ and the per-row statistics (log2-sum-exp of the scaled scores, and
// delta = rowsum(P * dP)).
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
          const bf16* __restrict__ g, bf16* __restrict__ dqkv,
          float2* __restrict__ stats, int L, int n_heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + static_cast<size_t>(L) * kKStride;
  float* rows = reinterpret_cast<float*>(vs + static_cast<size_t>(L) * kKStride);

  const int E = n_heads * kHeadDim;
  const int F = 3 * E;
  const int n_tiles = (L + kQTile - 1) / kQTile;
  const int tile = blockIdx.x % n_tiles;
  const int h = (blockIdx.x / n_tiles) % n_heads;
  const int n = blockIdx.x / (n_tiles * n_heads);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bf16* slab = qkv + static_cast<size_t>(n) * L * F;
  const bf16* gslab = g + static_cast<size_t>(n) * L * E;

  // Stage K_h + bias and V_h + bias, rounded to bf16: lane owns column pair
  // `lane` of every row its warp copies.
  const float2 kb = load_pair(bias + E + h * kHeadDim, lane);
  const float2 vb = load_pair(bias + 2 * E + h * kHeadDim, lane);
  for (int j = warp; j < L; j += kWarps) {
    const bf16* row = slab + static_cast<size_t>(j) * F + E + h * kHeadDim;
    const float2 k = load_pair(row, lane);
    const float2 v = load_pair(row + E, lane);
    store_pair(ks + static_cast<size_t>(j) * kKStride, lane, k.x + kb.x, k.y + kb.y);
    store_pair(vs + static_cast<size_t>(j) * kKStride, lane, v.x + vb.x, v.y + vb.y);
  }
  __syncthreads();

  float* p = rows + static_cast<size_t>(warp) * 2 * L;
  float* dp = p + L;
  const float score_scale = kLog2e / sqrtf(static_cast<float>(kHeadDim));
  const float sm_scale = 1.f / sqrtf(static_cast<float>(kHeadDim));
  const float2 qb = load_pair(bias + h * kHeadDim, lane);
  const int row_end = min(L, (tile + 1) * kQTile);
  for (int r = tile * kQTile + warp; r < row_end; r += kWarps) {
    // The query row (bias added, rounded to bf16, scaled by log2(e)/sqrt(d)),
    // broadcast to every lane.
    const float2 qv = load_pair(slab + static_cast<size_t>(r) * F + h * kHeadDim, lane);
    const float qx = round_bf16(qv.x + qb.x) * score_scale;
    const float qy = round_bf16(qv.y + qb.y) * score_scale;
    float x[kHeadDim];
#pragma unroll
    for (int c = 0; c < kHeadDim / 2; ++c) {
      x[2 * c] = __shfl_sync(kFullMask, qx, c);
      x[2 * c + 1] = __shfl_sync(kFullMask, qy, c);
    }

    // Scores (log2 units) for keys lane, lane + 32, ...; the row max.
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const bf16* krow = ks + static_cast<size_t>(j) * kKStride;
      float sx = 0.f, sy = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim / 2; ++c) {
        const float2 k = load_pair(krow, c);
        sx = fmaf(x[2 * c], k.x, sx);
        sy = fmaf(x[2 * c + 1], k.y, sy);
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
    sum = warp_sum(sum);
    const float inv = 1.f / sum;

    // The cotangent row, broadcast; dP = G V^T for this lane's keys, and the
    // probabilities normalised.
    const float2 gv = load_pair(gslab + static_cast<size_t>(r) * E + h * kHeadDim, lane);
#pragma unroll
    for (int c = 0; c < kHeadDim / 2; ++c) {
      x[2 * c] = __shfl_sync(kFullMask, gv.x, c);
      x[2 * c + 1] = __shfl_sync(kFullMask, gv.y, c);
    }
    float delta = 0.f;
    for (int j = lane; j < L; j += 32) {
      const bf16* vrow = vs + static_cast<size_t>(j) * kKStride;
      float ax = 0.f, ay = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim / 2; ++c) {
        const float2 v = load_pair(vrow, c);
        ax = fmaf(x[2 * c], v.x, ax);
        ay = fmaf(x[2 * c + 1], v.y, ay);
      }
      const float pj = p[j] * inv;
      const float dpj = ax + ay;
      dp[j] = dpj;
      delta = fmaf(pj, dpj, delta);
      p[j] = pj;
    }
    delta = warp_sum(delta);
    for (int j = lane; j < L; j += 32) dp[j] = p[j] * (dp[j] - delta) * sm_scale;
    __syncwarp();  // every lane's dS is visible to the whole warp

    // dQ = dS K: lane owns columns 2*lane and 2*lane + 1.
    float ax = 0.f, ay = 0.f, bx = 0.f, by = 0.f;
    int j = 0;
    for (; j + 1 < L; j += 2) {
      const float d0 = dp[j], d1 = dp[j + 1];
      const float2 k0 = load_pair(ks + static_cast<size_t>(j) * kKStride, lane);
      const float2 k1 = load_pair(ks + static_cast<size_t>(j + 1) * kKStride, lane);
      ax = fmaf(d0, k0.x, ax);
      ay = fmaf(d0, k0.y, ay);
      bx = fmaf(d1, k1.x, bx);
      by = fmaf(d1, k1.y, by);
    }
    if (j < L) {
      const float d0 = dp[j];
      const float2 k0 = load_pair(ks + static_cast<size_t>(j) * kKStride, lane);
      ax = fmaf(d0, k0.x, ax);
      ay = fmaf(d0, k0.y, ay);
    }
    store_pair(dqkv + (static_cast<size_t>(n) * L + r) * F + h * kHeadDim, lane,
               ax + bx, ay + by);
    if (lane == 0) {
      stats[(static_cast<size_t>(n) * n_heads + h) * L + r] = make_float2(m + log2f(sum), delta);
    }
    __syncwarp();  // the next row may overwrite p and dp only after every lane read them
  }
}

// (b) dK and dV. Lane = key of the tile; warp w takes the query rows
// i = w (mod kWarps) of each staged chunk when it builds P and dS, and owns
// columns [w * kColsPerWarp, (w + 1) * kColsPerWarp) of dK and dV.
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
           const bf16* __restrict__ g, const float2* __restrict__ stats,
           bf16* __restrict__ dqkv, int L, int n_heads) {
  __shared__ __align__(16) bf16 qs[kQChunk][kHeadDim];
  __shared__ __align__(16) bf16 gs[kQChunk][kHeadDim];
  __shared__ float2 st[kQChunk];
  __shared__ float ps[kQChunk][kKTile];
  __shared__ float dss[kQChunk][kKTile];

  const int E = n_heads * kHeadDim;
  const int F = 3 * E;
  const int n_tiles = (L + kKTile - 1) / kKTile;
  const int tile = blockIdx.x % n_tiles;
  const int h = (blockIdx.x / n_tiles) % n_heads;
  const int n = blockIdx.x / (n_tiles * n_heads);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = tile * kKTile + lane;
  const bool valid = j < L;
  const bf16* slab = qkv + static_cast<size_t>(n) * L * F;
  const bf16* gslab = g + static_cast<size_t>(n) * L * E;
  const float2* row_stats = stats + (static_cast<size_t>(n) * n_heads + h) * L;
  const float score_scale = kLog2e / sqrtf(static_cast<float>(kHeadDim));
  const float sm_scale = 1.f / sqrtf(static_cast<float>(kHeadDim));

  // This lane's key and value rows, bias added and rounded to bf16.
  __nv_bfloat162 kr[kHeadDim / 2], vr[kHeadDim / 2];
#pragma unroll
  for (int c = 0; c < kHeadDim / 2; ++c) {
    float2 k = make_float2(0.f, 0.f), v = make_float2(0.f, 0.f);
    if (valid) {
      const bf16* row = slab + static_cast<size_t>(j) * F + E + h * kHeadDim;
      const float2 kb = load_pair(bias + E + h * kHeadDim, c);
      const float2 vb = load_pair(bias + 2 * E + h * kHeadDim, c);
      k = load_pair(row, c);
      v = load_pair(row + E, c);
      k = make_float2(k.x + kb.x, k.y + kb.y);
      v = make_float2(v.x + vb.x, v.y + vb.y);
    }
    kr[c] = __floats2bfloat162_rn(k.x, k.y);
    vr[c] = __floats2bfloat162_rn(v.x, v.y);
  }

  float dk[kColsPerWarp], dv[kColsPerWarp];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c) dk[c] = dv[c] = 0.f;
  const int c0 = warp * kColsPerWarp;

  for (int i0 = 0; i0 < L; i0 += kQChunk) {
    const int rows = min(kQChunk, L - i0);
    __syncthreads();  // the previous chunk has been read by every thread
    // Stage the chunk's query rows (bias added, rounded to bf16), cotangent
    // rows and statistics: 8 columns per thread and step.
    for (int idx = threadIdx.x; idx < rows * (kHeadDim / 8); idx += kThreads) {
      const int r = idx / (kHeadDim / 8);
      const int part = idx % (kHeadDim / 8);
      const size_t i = static_cast<size_t>(i0 + r);
      const uint4 qw = *reinterpret_cast<const uint4*>(slab + i * F + h * kHeadDim + part * 8);
      const uint4 bw = *reinterpret_cast<const uint4*>(bias + h * kHeadDim + part * 8);
      float qf[8], bf[8];
      unpack8(qw, qf);
      unpack8(bw, bf);
      uint4 out;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[e] = __floats2bfloat162_rn(qf[2 * e] + bf[2 * e], qf[2 * e + 1] + bf[2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(&qs[r][part * 8]) = out;
      *reinterpret_cast<uint4*>(&gs[r][part * 8]) =
          *reinterpret_cast<const uint4*>(gslab + i * E + h * kHeadDim + part * 8);
    }
    if (threadIdx.x < rows) st[threadIdx.x] = row_stats[i0 + threadIdx.x];
    __syncthreads();

    // P and dS of this lane's key for rows warp, warp + kWarps, ...
    for (int r = warp; r < rows; r += kWarps) {
      const uint4* qrow = reinterpret_cast<const uint4*>(qs[r]);
      const uint4* grow = reinterpret_cast<const uint4*>(gs[r]);
      float sx = 0.f, sy = 0.f, dx = 0.f, dy = 0.f;
#pragma unroll
      for (int w = 0; w < kHeadDim / 8; ++w) {
        float qf[8], gf[8];
        unpack8(qrow[w], qf);
        unpack8(grow[w], gf);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 k = __bfloat1622float2(kr[4 * w + e]);
          const float2 v = __bfloat1622float2(vr[4 * w + e]);
          sx = fmaf(qf[2 * e], k.x, sx);
          sy = fmaf(qf[2 * e + 1], k.y, sy);
          dx = fmaf(gf[2 * e], v.x, dx);
          dy = fmaf(gf[2 * e + 1], v.y, dy);
        }
      }
      const float2 rs = st[r];
      const float pij = exp2f((sx + sy) * score_scale - rs.x);
      ps[r][lane] = pij;
      dss[r][lane] = pij * ((dx + dy) - rs.y) * sm_scale;
    }
    __syncthreads();

    // dV[j] += P[i, j] G[i], dK[j] += dS[i, j] Q[i] over the chunk's rows.
    for (int r = 0; r < rows; ++r) {
      const float pij = ps[r][lane];
      const float dsij = dss[r][lane];
      const uint4* qrow = reinterpret_cast<const uint4*>(&qs[r][c0]);
      const uint4* grow = reinterpret_cast<const uint4*>(&gs[r][c0]);
#pragma unroll
      for (int w = 0; w < kColsPerWarp / 8; ++w) {
        float qf[8], gf[8];
        unpack8(qrow[w], qf);
        unpack8(grow[w], gf);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dv[8 * w + e] = fmaf(pij, gf[e], dv[8 * w + e]);
          dk[8 * w + e] = fmaf(dsij, qf[e], dk[8 * w + e]);
        }
      }
    }
  }

  if (valid) {
    bf16* out = dqkv + (static_cast<size_t>(n) * L + j) * F + E + h * kHeadDim + c0;
#pragma unroll
    for (int c = 0; c < kColsPerWarp / 2; ++c) {
      store_pair(out, c, dk[2 * c], dk[2 * c + 1]);
      store_pair(out + E, c, dv[2 * c], dv[2 * c + 1]);
    }
  }
}

// (c) db, in two passes with a fixed order: column pair `lane` of a 64-column
// block; warp w sums rows w, w + kDbWarps, ... of one row segment.
__global__ void __launch_bounds__(32 * kDbWarps)
db_partial_kernel(const bf16* __restrict__ dqkv, float* __restrict__ partial,
                  long long n_rows, int F, long long seg_rows) {
  __shared__ float2 acc[kDbWarps][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pair = blockIdx.x * 32 + lane;
  const long long r0 = blockIdx.y * seg_rows;
  const long long r1 = min(n_rows, r0 + seg_rows);
  float sx = 0.f, sy = 0.f;
  if (2 * pair < F) {
    for (long long r = r0 + warp; r < r1; r += kDbWarps) {
      const float2 v = load_pair(dqkv + r * F, pair);
      sx += v.x;
      sy += v.y;
    }
  }
  acc[warp][lane] = make_float2(sx, sy);
  __syncthreads();
  if (warp == 0 && 2 * pair < F) {
    float tx = 0.f, ty = 0.f;
#pragma unroll
    for (int w = 0; w < kDbWarps; ++w) {
      tx += acc[w][lane].x;
      ty += acc[w][lane].y;
    }
    partial[static_cast<size_t>(blockIdx.y) * F + 2 * pair] = tx;
    partial[static_cast<size_t>(blockIdx.y) * F + 2 * pair + 1] = ty;
  }
}

__global__ void db_final_kernel(const float* __restrict__ partial, float* __restrict__ db,
                                int F, int segments) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= F) return;
  float s = 0.f;
  for (int seg = 0; seg < segments; ++seg) s += partial[static_cast<size_t>(seg) * F + c];
  db[c] = s;
}

}  // namespace

extern "C" int packed_mha_bwd(const void* qkv, const void* bias, const void* g, void* dqkv,
                              void* db, void* stats, void* partial, int n, int L,
                              int n_heads, int head_dim, int db_segments, void* stream) {
  if (head_dim != kHeadDim || n <= 0 || L <= 0 || n_heads <= 0 || db_segments <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  int smem_optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = dq_smem_bytes(L);
  if (smem > static_cast<size_t>(smem_optin)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qkv_p = static_cast<const bf16*>(qkv);
  const bf16* bias_p = static_cast<const bf16*>(bias);
  const bf16* g_p = static_cast<const bf16*>(g);
  bf16* dqkv_p = static_cast<bf16*>(dqkv);
  float2* stats_p = static_cast<float2*>(stats);

  const long long q_blocks = static_cast<long long>(n) * n_heads * ((L + kQTile - 1) / kQTile);
  dq_kernel<<<static_cast<unsigned>(q_blocks), kThreads, smem, s>>>(
      qkv_p, bias_p, g_p, dqkv_p, stats_p, L, n_heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long k_blocks = static_cast<long long>(n) * n_heads * ((L + kKTile - 1) / kKTile);
  dkv_kernel<<<static_cast<unsigned>(k_blocks), kThreads, 0, s>>>(
      qkv_p, bias_p, g_p, stats_p, dqkv_p, L, n_heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int F = 3 * n_heads * kHeadDim;
  const long long n_rows = static_cast<long long>(n) * L;
  const long long seg_rows = (n_rows + db_segments - 1) / db_segments;
  const dim3 db_grid((F / 2 + 31) / 32, db_segments);
  db_partial_kernel<<<db_grid, 32 * kDbWarps, 0, s>>>(dqkv_p, static_cast<float*>(partial),
                                                      n_rows, F, seg_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  db_final_kernel<<<(F + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partial),
                                                  static_cast<float*>(db), F, db_segments);
  return static_cast<int>(cudaGetLastError());
}
