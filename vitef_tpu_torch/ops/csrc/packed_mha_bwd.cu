// Packed-qkv multi-head attention backward for Hopper (sm_90a): K2 and K3.
//
// Replaces the TPU kernels vitef_tpu/ops/attention.py:_packed_mha_bwd_kernel
// (K2, :270, launched by _packed_mha_bwd :400) and
// _packed_mha_bwd_causal_blocked_kernel (K3, :181, launched at :423 when
// _causal_q_block :345 is set, L % 256 == 0 and L >= 512). The TPU computes
// the causal backward in K3 at those lengths and in K2's causal mode
// (:286-290) at the others; this file computes the non-causal and the causal
// backward at every L, the mode chosen by a flag as in csrc/packed_mha_fwd.cu,
// whose backward it is. For sequence n and head h, with
// Q, K, V = (qkv + bias)[n, :, head h of q | k | v] rounded to bfloat16,
// P = softmax(Q K^T / sqrt(d)) (causal: key j is visible to query i iff
// j <= i) and the cotangent G = g[n, :, head h]:
//     dV = P^T G,  dP = G V^T,  dS = P * (dP - delta) / sqrt(d),
//     dQ = dS K,   dK = dS^T Q,   delta = rowsum(P * dP) = rowsum(G * O),
// written back into dqkv (N, L, 3E) in the packed [q | k | v] head-major
// layout; db (3E,) is the float32 column sum of that bfloat16 dqkv over all
// N*L rows. Everything between the bf16 inputs and the bf16 dqkv is float32
// (the TPU kernels round p and ds to bf16 before their products; this one
// does not).
//
// It reads two residuals of the forward: the output O (N, L, E) bf16, for
// delta, and each row's log2-sum-exp (N, n_heads, L) float32. So no pass
// recomputes a row's softmax statistics, and the dq pass walks the keys tile
// by tile at any L.
//
// What bounds it on this card, and what the design does about it:
//   - Arithmetic. Per (sequence, head) the algebra is five L x L x d products
//     (causal: on the lower triangle); this version recomputes the scores and
//     dP in both passes, so it does seven, on the CUDA cores (FMA, not tensor
//     cores). Causal, nothing above the diagonal is loaded or computed, except
//     inside the diagonal tiles, where it is masked by index.
//   - Reductions across blocks. dK and dV sum over the query rows and db over
//     all N*L rows, and Hopper's blocks run in no order. So there are three
//     passes and no atomics, which also makes two launches on the same inputs
//     bit-identical:
//       (a) dq_kernel, one block per (sequence, head, 64-row query tile): it
//           walks the 64-key tiles (causal: up to and including the diagonal
//           one), staged in shared memory, and for each of its rows rebuilds
//           P from the forward's log2-sum-exp, dP = G V^T and dS, and
//           accumulates dQ = dS K in shared memory. It writes dQ and each
//           row's (log2-sum-exp, delta) for pass (b). Shared memory is fixed
//           (about 68 KB), whatever L is;
//       (b) dkv_kernel, one block per (sequence, head, 32-key tile), a lane
//           per key with that key's K and V rows in registers: it walks the
//           query rows (causal: only those at or after its first key) in
//           chunks staged in shared memory, rebuilds P and dS for its keys
//           from (a)'s statistics, and accumulates dK and dV in registers;
//       (c) db_partial_kernel and db_final_kernel, a column reduction of the
//           bf16 dqkv in a fixed order (row segments, then the segments).
// Tensor cores (mma/wgmma) and TMA are later work.
//
// C interface:
//   packed_mha_bwd(qkv, bias, g, out, lse, dqkv, db, stats, partial,
//                  N, L, n_heads, head_dim, db_segments, causal, stream)
// qkv (N, L, 3E), bias (3E,), g (N, L, E), out (N, L, E) and dqkv
// (N, L, 3E) are bfloat16; lse (N, n_heads, L) and db (3E,) are float32;
// stats is float32 scratch of N * n_heads * L * 2 and partial float32
// scratch of db_segments * 3E. Returns a cudaError_t as int: the last
// launch's cudaGetLastError(), or cudaErrorInvalidValue for a shape this
// kernel does not take.

#include "packed_mha_common.cuh"

namespace {

constexpr int kTile = 64;       // query rows per block of the dq pass, and keys per staged tile
constexpr int kKTile = 32;      // keys per block of dkv_kernel (a lane each)
constexpr int kQChunk = 32;     // query rows staged per step of dkv_kernel
constexpr int kColsPerWarp = kHeadDim / kWarps;  // dK / dV columns a thread owns
constexpr int kDbWarps = 8;

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

// Dynamic shared memory of one dq_kernel block: K and V tiles (padded rows);
// the query rows (scaled), cotangent rows and dQ accumulators of the block's
// query tile in float32; a dS row per warp; each row's statistics.
constexpr size_t kDqSmemBytes =
    2 * kTile * kKStride * sizeof(bf16) + 3 * kTile * kHeadDim * sizeof(float) +
    kWarps * kTile * sizeof(float) + kTile * sizeof(float2);

// (a) dQ and the per-row statistics (log2-sum-exp of the scaled scores, and
// delta = G . O).
template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
          const bf16* __restrict__ g, const bf16* __restrict__ out,
          const float* __restrict__ lse, bf16* __restrict__ dqkv,
          float2* __restrict__ stats, int L, int n_heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile * kKStride;
  float* qs = reinterpret_cast<float*>(vs + kTile * kKStride);
  float* gs = qs + kTile * kHeadDim;
  float* acc = gs + kTile * kHeadDim;
  float* dsb = acc + kTile * kHeadDim;
  float2* row_stats = reinterpret_cast<float2*>(dsb + kWarps * kTile);

  const int E = n_heads * kHeadDim;
  const int F = 3 * E;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles);  // longest first
  const int h = (blockIdx.x / n_tiles) % n_heads;
  const int n = blockIdx.x / (n_tiles * n_heads);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = tile * kTile;
  const int rows = min(kTile, L - q0);
  const bf16* slab = qkv + static_cast<size_t>(n) * L * F;
  const size_t head_row0 = (static_cast<size_t>(n) * n_heads + h) * L;
  const float score_scale = kLog2e / sqrtf(static_cast<float>(kHeadDim));
  const float sm_scale = 1.f / sqrtf(static_cast<float>(kHeadDim));

  // The tile's rows: Q (bias added, rounded to bf16, scaled by
  // log2(e)/sqrt(d)), G, zeroed dQ accumulators, and the statistics
  // (log2-sum-exp from the forward, delta = G . O). Warp w owns rows
  // w, w + kWarps, ... here and below.
  const float2 qb = load_pair(bias + h * kHeadDim, lane);
  for (int r = warp; r < rows; r += kWarps) {
    const size_t row = static_cast<size_t>(n) * L + q0 + r;
    const float2 q = load_pair(qkv + row * F + h * kHeadDim, lane);
    const float2 gv = load_pair(g + row * E + h * kHeadDim, lane);
    const float2 o = load_pair(out + row * E + h * kHeadDim, lane);
    reinterpret_cast<float2*>(qs + r * kHeadDim)[lane] =
        make_float2(round_bf16(q.x + qb.x) * score_scale, round_bf16(q.y + qb.y) * score_scale);
    reinterpret_cast<float2*>(gs + r * kHeadDim)[lane] = gv;
    reinterpret_cast<float2*>(acc + r * kHeadDim)[lane] = make_float2(0.f, 0.f);
    const float delta = warp_sum(fmaf(gv.x, o.x, gv.y * o.y));
    if (lane == 0) {
      const float2 st = make_float2(lse[head_row0 + q0 + r], delta);
      row_stats[r] = st;
      stats[head_row0 + q0 + r] = st;
    }
  }

  float* ds = dsb + warp * kTile;
  const int kv_end = kCausal ? q0 + rows : L;  // the keys a row of this tile may see
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    const int klen = min(kTile, kv_end - k0);
    __syncthreads();  // the previous tile has been read by every warp
    stage_kv(slab, bias, E, h, k0, klen, ks, vs);
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps) {
      // Keys k0 .. k0 + lim - 1 are visible to query row q0 + r; lim >= 1,
      // since a causal tile starts at or before q0.
      const int lim = kCausal ? min(klen, q0 + r - k0 + 1) : klen;
      const float2 st = row_stats[r];
      float x[kHeadDim];
      load_row(qs + r * kHeadDim, x);
      float p0 = 0.f, p1 = 0.f;
      if (lane < lim) p0 = exp2f(dot_row(x, ks + lane * kKStride) - st.x);
      if (lane + 32 < lim) p1 = exp2f(dot_row(x, ks + (lane + 32) * kKStride) - st.x);
      load_row(gs + r * kHeadDim, x);
      float dp0 = 0.f, dp1 = 0.f;
      if (lane < lim) dp0 = dot_row(x, vs + lane * kKStride);
      if (lane + 32 < lim) dp1 = dot_row(x, vs + (lane + 32) * kKStride);
      ds[lane] = p0 * (dp0 - st.y) * sm_scale;
      ds[lane + 32] = p1 * (dp1 - st.y) * sm_scale;
      __syncwarp();  // every lane's dS is visible to the whole warp

      // dQ += dS K: lane owns columns 2*lane and 2*lane + 1.
      float2* arow = reinterpret_cast<float2*>(acc + r * kHeadDim);
      const float2 a = arow[lane];
      const float2 dq = weighted_rows(ds, ks, lim, lane);
      arow[lane] = make_float2(a.x + dq.x, a.y + dq.y);
      __syncwarp();  // the next row may overwrite ds only after every lane read it
    }
  }

  for (int r = warp; r < rows; r += kWarps) {
    const float2 a = reinterpret_cast<const float2*>(acc + r * kHeadDim)[lane];
    store_pair(dqkv + (static_cast<size_t>(n) * L + q0 + r) * F + h * kHeadDim, lane, a.x, a.y);
  }
}

// (b) dK and dV. Lane = key of the tile; warp w takes the query rows
// i = w (mod kWarps) of each staged chunk when it builds P and dS, and owns
// columns [w * kColsPerWarp, (w + 1) * kColsPerWarp) of dK and dV.
template <bool kCausal>
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

  // Causal: query rows before the tile's first key see none of its keys
  // (kQChunk == kKTile, so the first chunk is the diagonal one).
  const int i_begin = kCausal ? tile * kKTile : 0;
  for (int i0 = i_begin; i0 < L; i0 += kQChunk) {
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
      float pij = exp2f((sx + sy) * score_scale - rs.x);
      float dsij = pij * ((dx + dy) - rs.y) * sm_scale;
      if (kCausal && j > i0 + r) pij = dsij = 0.f;  // key after the query row
      ps[r][lane] = pij;
      dss[r][lane] = dsij;
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

// The three passes in order on `stream`; returns the first launch error.
template <bool kCausal>
cudaError_t launch(const bf16* qkv, const bf16* bias, const bf16* g, const bf16* out,
                   const float* lse, bf16* dqkv, float* db, float2* stats, float* partial,
                   int n, int L, int n_heads, int db_segments, cudaStream_t stream) {
  cudaError_t err = allow_smem(dq_kernel<kCausal>, kDqSmemBytes);
  if (err != cudaSuccess) return err;
  const long long q_blocks = static_cast<long long>(n) * n_heads * ((L + kTile - 1) / kTile);
  dq_kernel<kCausal><<<static_cast<unsigned>(q_blocks), kThreads, kDqSmemBytes, stream>>>(
      qkv, bias, g, out, lse, dqkv, stats, L, n_heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long k_blocks = static_cast<long long>(n) * n_heads * ((L + kKTile - 1) / kKTile);
  dkv_kernel<kCausal><<<static_cast<unsigned>(k_blocks), kThreads, 0, stream>>>(
      qkv, bias, g, stats, dqkv, L, n_heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int F = 3 * n_heads * kHeadDim;
  const long long n_rows = static_cast<long long>(n) * L;
  const long long seg_rows = (n_rows + db_segments - 1) / db_segments;
  const dim3 db_grid((F / 2 + 31) / 32, db_segments);
  db_partial_kernel<<<db_grid, 32 * kDbWarps, 0, stream>>>(dqkv, partial, n_rows, F, seg_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  db_final_kernel<<<(F + 255) / 256, 256, 0, stream>>>(partial, db, F, db_segments);
  return cudaGetLastError();
}

}  // namespace

extern "C" int packed_mha_bwd(const void* qkv, const void* bias, const void* g, const void* out,
                              const void* lse, void* dqkv, void* db, void* stats, void* partial,
                              int n, int L, int n_heads, int head_dim, int db_segments,
                              int causal, void* stream) {
  if (head_dim != kHeadDim || n <= 0 || L <= 0 || n_heads <= 0 || db_segments <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto run = causal ? launch<true> : launch<false>;
  return static_cast<int>(run(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(g), static_cast<const bf16*>(out),
      static_cast<const float*>(lse), static_cast<bf16*>(dqkv), static_cast<float*>(db),
      static_cast<float2*>(stats), static_cast<float*>(partial), n, L, n_heads, db_segments,
      static_cast<cudaStream_t>(stream)));
}
