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
// N*L rows. P and dS are rounded to bf16 before their products, as the TPU
// kernels round them (pb = p.astype, ds = (...).astype); everything else
// between the bf16 inputs and the bf16 dqkv is float32.
//
// It reads two residuals of the forward: the output O (N, L, E) bf16, for
// delta, and each row's log2-sum-exp (N, n_heads, L) float32. So no pass
// recomputes a row's softmax statistics, and each pass walks its tiles one
// by one at any L.
//
// What bounds it on this card, and what the design does about it:
//   - Arithmetic. Per (sequence, head) the algebra is five L x L x d products
//     (causal: on the lower triangle); the two passes each rebuild the scores
//     and dP, so it does seven. They belong on the tensor cores: all seven
//     are mma.sync.m16n8k16 (bf16 in, float32 accumulators) in the tiles of
//     attn_bwd_mma.cuh, with P and dS kept in registers and fed to the next
//     product straight from the accumulators. Causal, nothing above the
//     diagonal is loaded or multiplied; the diagonal tiles are masked by
//     index.
//   - Reductions across blocks. dK and dV sum over the query rows and db over
//     all N*L rows, and Hopper's blocks run in no order. So there are three
//     passes and no atomics, which also makes two launches on the same inputs
//     bit-identical:
//       (a) packed_bwd_dq_kernel, one block per (sequence, head, 64-row query
//           tile), 4 warps of 16 rows: it walks the 64-key tiles (causal: up
//           to and including the diagonal one), double-buffered by cp.async,
//           and accumulates dQ = dS K in registers. It writes dQ and each
//           row's (log2-sum-exp, delta) for pass (b);
//       (b) packed_bwd_dkv_kernel, one block per (sequence, head, 64-key
//           tile), 4 warps of 16 keys with their K and V rows as register
//           fragments: it walks the 64-row query tiles (causal: from the
//           diagonal one on) with (a)'s statistics and accumulates dK and dV
//           in registers;
//       (c) db_partial_kernel and db_final_kernel, a column reduction of the
//           bf16 dqkv in a fixed order (row segments, then the segments).
//     Shared memory is fixed at 55 KB a block at d = 64 and 67 KB at d = 80
//     in (a) and (b), whatever L is.
// wgmma, TMA and warp specialisation are later work.
//
// Head widths: both modes are instantiated at d = 64 and d = 80 (ViT-H/14),
// the widths the wrapper's gate admits, as csrc/packed_mha_fwd.cu is.
//
// C interface:
//   packed_mha_bwd(qkv, bias, g, out, lse, dqkv, db, stats, partial,
//                  N, L, n_heads, head_dim, db_segments, causal, stream)
// qkv (N, L, 3E), bias (3E,), g (N, L, E), out (N, L, E) and dqkv
// (N, L, 3E) are bfloat16; lse (N, n_heads, L) and db (3E,) are float32;
// stats is float32 scratch of N * n_heads * L * 2 and partial float32
// scratch of db_segments * 3E. Returns a cudaError_t as int: the last
// launch's cudaGetLastError(), or cudaErrorInvalidValue for a shape this
// kernel does not take (head_dim other than 64 and 80 among them).

#include "packed_mha_common.cuh"
#include "attn_bwd_mma.cuh"

namespace {

constexpr int kDbWarps = 8;

// Head h of sequence n in the packed layout: Q, K, V and dQ, dK, dV are
// column blocks of qkv and dqkv (row stride 3E), G and O of g and out (row
// stride E), all at head width D. The dK/dV pass passes no out and no lse.
template <int D>
__device__ __forceinline__ AttnBwdHead packed_head(const bf16* qkv, const bf16* bias,
                                                   const bf16* g, const bf16* out,
                                                   const float* lse, bf16* dqkv,
                                                   float2* stats, int n, int h, int L,
                                                   int n_heads) {
  const int E = n_heads * D;
  const size_t F = 3 * static_cast<size_t>(E);
  const size_t row0 = static_cast<size_t>(n) * L;
  const size_t head_row0 = (static_cast<size_t>(n) * n_heads + h) * L;
  const bf16* slab = qkv + row0 * F + h * D;
  const bf16* head_bias = bias + h * D;
  bf16* dslab = dqkv + row0 * F + h * D;
  return AttnBwdHead{slab, slab + E, slab + 2 * E, F,
                     head_bias, head_bias + E, head_bias + 2 * E,
                     g + row0 * E + h * D,
                     out == nullptr ? nullptr : out + row0 * E + h * D,
                     static_cast<size_t>(E), lse == nullptr ? nullptr : lse + head_row0,
                     stats + head_row0,
                     dslab, dslab + E, dslab + 2 * E, F};
}

// (a) dQ and the per-row statistics; the heaviest (causal: the last) query
// tiles first.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kAttnThreads)
packed_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                     const bf16* __restrict__ g, const bf16* __restrict__ out,
                     const float* __restrict__ lse, bf16* __restrict__ dqkv,
                     float2* __restrict__ stats, int L, int n_heads, float scale,
                     float ds_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = (L + kAttnRows - 1) / kAttnRows;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles);
  const int h = (blockIdx.x / n_tiles) % n_heads;
  const int n = blockIdx.x / (n_tiles * n_heads);
  const AttnBwdHead head =
      packed_head<D>(qkv, bias, g, out, lse, dqkv, stats, n, h, L, n_heads);
  attn_bwd_dq_tile<D, true, kCausal>(head, L, tile * kAttnRows, scale, ds_scale, smem);
}

// (b) dK and dV; the heaviest (causal: the first) key tiles first.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kAttnThreads)
packed_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                      const bf16* __restrict__ g, float2* __restrict__ stats,
                      bf16* __restrict__ dqkv, int L, int n_heads, float scale,
                      float ds_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = (L + kAttnKeys - 1) / kAttnKeys;
  const int tile = static_cast<int>(blockIdx.x % n_tiles);
  const int h = (blockIdx.x / n_tiles) % n_heads;
  const int n = blockIdx.x / (n_tiles * n_heads);
  const AttnBwdHead head =
      packed_head<D>(qkv, bias, g, nullptr, nullptr, dqkv, stats, n, h, L, n_heads);
  attn_bwd_dkv_tile<D, true, kCausal>(head, L, tile * kAttnKeys, scale, ds_scale, smem);
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

// The three passes in order on `stream` at head width D; returns the first
// launch error.
template <int D, bool kCausal>
cudaError_t launch(const bf16* qkv, const bf16* bias, const bf16* g, const bf16* out,
                   const float* lse, bf16* dqkv, float* db, float2* stats, float* partial,
                   int n, int L, int n_heads, int db_segments, cudaStream_t stream) {
  const float scale = kLog2e / sqrtf(static_cast<float>(D));
  const float ds_scale = 1.f / sqrtf(static_cast<float>(D));
  const long long tiles = static_cast<long long>(n) * n_heads * ((L + kAttnRows - 1) / kAttnRows);
  const unsigned blocks = static_cast<unsigned>(tiles);  // query tiles = key tiles
  constexpr size_t smem = kAttnBwdSmemBytes<D>;
  cudaError_t err = allow_smem(packed_bwd_dq_kernel<D, kCausal>, smem);
  if (err != cudaSuccess) return err;
  packed_bwd_dq_kernel<D, kCausal><<<blocks, kAttnThreads, smem, stream>>>(
      qkv, bias, g, out, lse, dqkv, stats, L, n_heads, scale, ds_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = allow_smem(packed_bwd_dkv_kernel<D, kCausal>, smem);
  if (err != cudaSuccess) return err;
  packed_bwd_dkv_kernel<D, kCausal><<<blocks, kAttnThreads, smem, stream>>>(
      qkv, bias, g, stats, dqkv, L, n_heads, scale, ds_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int F = 3 * n_heads * D;
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
  if ((head_dim != 64 && head_dim != 80) || n <= 0 || L <= 0 || n_heads <= 0 ||
      db_segments <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto run = head_dim == 64 ? (causal ? launch<64, true> : launch<64, false>)
                                  : (causal ? launch<80, true> : launch<80, false>);
  return static_cast<int>(run(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(g), static_cast<const bf16*>(out),
      static_cast<const float*>(lse), static_cast<bf16*>(dqkv), static_cast<float*>(db),
      static_cast<float2*>(stats), static_cast<float*>(partial), n, L, n_heads, db_segments,
      static_cast<cudaStream_t>(stream)));
}
