// The tensor-core backward of softmax attention for Hopper (sm_90a), used by
// K2 and K3 (csrc/packed_mha_bwd.cu, packed qkv with its bias) and K5's
// bfloat16 path (csrc/flash_bwd.cu, head-major, no bias). It is the
// backward of attn_fwd_mma.cuh and is built from its pieces: head width 64,
// 64-row query tiles and 64-key tiles, 4 warps of 16 rows, rows padded by 8
// elements in shared memory, 16-byte cp.async copies double buffered, rows
// past L zero-filled, the bias added in place as bf16(x + b), and the warp
// products on 16 x 64 register tiles.
//
// For one head, with P rebuilt from the forward's per-row log2-sum-exp of
// the scaled scores (P = exp2(S * log2(e)/sqrt(d) - lse)) and
// delta = rowsum(G * O):
//     dP = G V^T,  dS = P * (dP - delta) / sqrt(d),
//     dV = P^T G,  dQ = dS K,  dK = dS^T Q.
// All five products (S = Q K^T, dP, dV, dQ, dK) are mma.sync.m16n8k16 with
// bf16 operands and float32 accumulators. P and dS are rounded to bf16 where
// they become A operands, as the TPU kernels round them (p.astype, ds.astype)
// before their products; dS is formed from the float32 P, as there.
//
// Two passes, each a block per 64-row tile, deterministic (no atomics):
//
// - attn_bwd_dq_tile, a block per query tile: each warp keeps its 16 Q and
//   G rows as A fragments for the whole key loop; per 64-key tile it
//   computes S and dP (16 x 64 float32 accumulators), P and dS in registers,
//   and dQ += dS K with dS fed from the accumulators as A fragments (the
//   m16n8k16 C -> A layout identity) and K through ldmatrix.trans. It writes
//   dQ and each row's (lse, delta) for the second pass;
// - attn_bwd_dkv_tile, a block per key tile: each warp keeps its 16 K and V
//   rows as A fragments and walks the query tiles (causal: from the diagonal
//   one on) with their (lse, delta); it computes S^T = K Q^T and
//   dP^T = V G^T, then P^T and dS^T in registers, and dV += P^T G and
//   dK += dS^T Q through the same identity, with G and Q through
//   ldmatrix.trans. In this layout a thread's accumulator columns are query
//   rows, so it reads their statistics from shared memory by column.
//
// Tiles above the causal diagonal are neither loaded nor multiplied; only
// the diagonal tile and the last partial key tile are masked by index. A
// query row past L gets the statistics (+inf, 0), so its P and dS are 0
// without a test: exp2(s - inf) = 0 for every finite score.
//
// Shared memory: six 64-row tiles (two of them double buffered) and the
// statistics, 56,320 bytes a block in either pass.

#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "attn_fwd_mma.cuh"

namespace {

constexpr size_t kAttnBwdSmemBytes =
    static_cast<size_t>(2 * kAttnRows + 4 * kAttnKeys) * kAttnStride * sizeof(bf16) +
    2 * kAttnRows * sizeof(float2);

// Where one (sequence, head) of the backward lives: row r of Q, K and V at
// q, k, v plus r * stride; their bias (kBias only); row r of the cotangent G
// and of the forward's output O at g and out plus r * g_stride; the
// forward's per-row log2-sum-exp lse[r]; stats[r], the (lse, delta) scratch
// the first pass writes and the second reads; row r of dQ, dK and dV at dq,
// dk, dv plus r * d_stride. Every row is 64 contiguous bf16, 16-byte
// aligned.
struct AttnBwdHead {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  size_t stride;
  const bf16* q_bias;
  const bf16* k_bias;
  const bf16* v_bias;
  const bf16* g;
  const bf16* out;
  size_t g_stride;
  const float* lse;
  float2* stats;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  size_t d_stride;
};

// Pass 1 for query rows q0 .. q0 + 63 (those < L) of one head: dQ, and each
// row's (lse, delta) into hd.stats. scale = log2(e)/sqrt(d) (the forward's
// units), ds_scale = 1/sqrt(d). Called by all kAttnThreads threads with
// kAttnBwdSmemBytes of dynamic shared memory at smem.
template <bool kBias, bool kCausal>
__device__ __forceinline__ void attn_bwd_dq_tile(const AttnBwdHead& hd, int L, int q0,
                                                 float scale, float ds_scale,
                                                 unsigned char* smem) {
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sg = sq + kAttnRows * kAttnStride;
  bf16* sk = sg + kAttnRows * kAttnStride;        // two stages of kAttnKeys rows
  bf16* sv = sk + 2 * kAttnKeys * kAttnStride;    // likewise
  float2* st = reinterpret_cast<float2*>(sv + 2 * kAttnKeys * kAttnStride);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;             // the accumulator row (and row + 8) of this thread
  const int tig = lane & 3;            // its column pair within each n8 tile
  const int copy_row = tid >> 3;       // this thread's copies: rows copy_row + 16 i,
  const int copy_col = (tid & 7) * 8;  // columns copy_col .. + 7
  const int row0 = q0 + warp * 16 + g; // this thread's query rows: row0 and row0 + 8
  const int kv_end = kCausal ? min(q0 + kAttnRows, L) : L;  // keys this tile may see
  const int n_kv = (kv_end + kAttnKeys - 1) / kAttnKeys;

  stage_tile(hd.q, hd.stride, q0, L, sq, copy_row, copy_col);
  stage_tile(hd.g, hd.g_stride, q0, L, sg, copy_row, copy_col);
  cp_async_commit();
  stage_tile(hd.k, hd.stride, 0, L, sk, copy_row, copy_col);
  stage_tile(hd.v, hd.stride, 0, L, sv, copy_row, copy_col);
  cp_async_commit();

  uint4 k_bias = make_uint4(0, 0, 0, 0), v_bias = k_bias;
  if constexpr (kBias) {
    k_bias = *reinterpret_cast<const uint4*>(hd.k_bias + copy_col);
    v_bias = *reinterpret_cast<const uint4*>(hd.v_bias + copy_col);
  }
  // delta = G . O per row from device memory, two threads a row (32
  // columns each), while the tiles are in flight; rows past L get (+inf, 0).
  {
    const int r = tid >> 1;
    const int c0 = (tid & 1) * 32;
    const int qi = q0 + r;
    float delta = 0.f;
    if (qi < L) {
      const bf16* grow = hd.g + static_cast<size_t>(qi) * hd.g_stride + c0;
      const bf16* orow = hd.out + static_cast<size_t>(qi) * hd.g_stride + c0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 gw = *reinterpret_cast<const uint4*>(grow + 8 * i);
        const uint4 ow = *reinterpret_cast<const uint4*>(orow + 8 * i);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gw);
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ow);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 gv = __bfloat1622float2(gp[e]);
          const float2 o = __bfloat1622float2(op[e]);
          delta = fmaf(gv.x, o.x, fmaf(gv.y, o.y, delta));
        }
      }
    }
    delta += __shfl_xor_sync(0xffffffffu, delta, 1);
    if ((tid & 1) == 0) {
      const float2 s = qi < L ? make_float2(hd.lse[qi], delta) : make_float2(INFINITY, 0.f);
      st[r] = s;
      if (qi < L) hd.stats[qi] = s;
    }
  }

  cp_async_wait<1>();  // this thread's pieces of Q and G have landed
  if constexpr (kBias) {
    add_bias_tile(sq, *reinterpret_cast<const uint4*>(hd.q_bias + copy_col), copy_row,
                  copy_col);
  }
  __syncthreads();

  uint32_t qf[4][4], gf[4][4];         // the warp's Q and G rows as A fragments
  load_a_frags(qf, sq, warp * 16);
  load_a_frags(gf, sg, warp * 16);
  float dq[8][4];                      // dQ, 16 x 64: n8 tiles of head columns
  zero_acc(dq);
  const float2 rs[2] = {st[warp * 16 + g], st[warp * 16 + g + 8]};  // rows row0, row0 + 8

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kAttnKeys;
    bf16* ks = sk + (j & 1) * kAttnKeys * kAttnStride;
    bf16* vs = sv + (j & 1) * kAttnKeys * kAttnStride;
    if (j + 1 < n_kv) {  // the next tile's stage was last read before the previous barrier
      const int next = (j + 1) & 1;
      stage_tile(hd.k, hd.stride, k0 + kAttnKeys, L, sk + next * kAttnKeys * kAttnStride,
                 copy_row, copy_col);
      stage_tile(hd.v, hd.stride, k0 + kAttnKeys, L, sv + next * kAttnKeys * kAttnStride,
                 copy_row, copy_col);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's pieces of tile j have landed
    if constexpr (kBias) {
      add_bias_tile(ks, k_bias, copy_row, copy_col);
      add_bias_tile(vs, v_bias, copy_row, copy_col);
    }
    __syncthreads();

    // S = Q K^T and dP = G V^T: element (t, 2 rr + e) is row row0 + 8 rr,
    // key k0 + 8 t + 2 tig + e.
    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    mma_a_bt(s, qf, ks);
    mma_a_bt(dp, gf, vs);
    const bool edge = k0 + kAttnKeys > L || (kCausal && k0 + kAttnKeys > q0);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = c >> 1;
        float p = exp2f(s[t][c] * scale - rs[rr].x);
        if (edge) {
          const int key = k0 + 8 * t + 2 * tig + (c & 1);
          if (key >= L || (kCausal && key > row0 + 8 * rr)) p = 0.f;
        }
        s[t][c] = p * (dp[t][c] - rs[rr].y) * ds_scale;  // dS
      }
    }

    // dQ += dS K.
    uint32_t dsf[4][4];
    c_to_a(dsf, s);
    mma_a_b(dq, dsf, ks);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // The warp's rows of the Q tile were read only for its fragments.
  store_warp_rows(dq, sq + warp * 16 * kAttnStride, hd.dq, hd.d_stride, q0 + warp * 16, L);
}

// (lse, delta) of query row i for the second pass; (+inf, 0) past L.
__device__ __forceinline__ float2 row_stats(const AttnBwdHead& hd, int i, int L) {
  return i < L ? hd.stats[i] : make_float2(INFINITY, 0.f);
}

// Pass 2 for keys k0 .. k0 + 63 (those < L) of one head: dK and dV, from the
// statistics pass 1 wrote. Called as attn_bwd_dq_tile.
template <bool kBias, bool kCausal>
__device__ __forceinline__ void attn_bwd_dkv_tile(const AttnBwdHead& hd, int L, int k0,
                                                  float scale, float ds_scale,
                                                  unsigned char* smem) {
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kAttnKeys * kAttnStride;
  bf16* sq = sv + kAttnKeys * kAttnStride;        // two stages of kAttnRows rows
  bf16* sg = sq + 2 * kAttnRows * kAttnStride;    // likewise
  float2* st = reinterpret_cast<float2*>(sg + 2 * kAttnRows * kAttnStride);  // likewise

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int copy_row = tid >> 3;
  const int copy_col = (tid & 7) * 8;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0 and key0 + 8
  // Causal: query rows before the tile's first key see none of its keys
  // (kAttnRows == kAttnKeys, so the first query tile is the diagonal one).
  const int i_begin = kCausal ? k0 : 0;
  const int n_q = (L - i_begin + kAttnRows - 1) / kAttnRows;

  stage_tile(hd.k, hd.stride, k0, L, sk, copy_row, copy_col);
  stage_tile(hd.v, hd.stride, k0, L, sv, copy_row, copy_col);
  stage_tile(hd.q, hd.stride, i_begin, L, sq, copy_row, copy_col);
  stage_tile(hd.g, hd.g_stride, i_begin, L, sg, copy_row, copy_col);
  cp_async_commit();
  if (tid < kAttnRows) st[tid] = row_stats(hd, i_begin + tid, L);

  uint4 q_bias = make_uint4(0, 0, 0, 0);
  if constexpr (kBias) q_bias = *reinterpret_cast<const uint4*>(hd.q_bias + copy_col);

  uint32_t kf[4][4], vf[4][4];         // the warp's K and V rows as A fragments
  float dk[8][4], dv[8][4];            // dK and dV, 16 x 64: n8 tiles of head columns
  zero_acc(dk);
  zero_acc(dv);

  for (int j = 0; j < n_q; ++j) {
    const int i0 = i_begin + j * kAttnRows;
    bf16* qs = sq + (j & 1) * kAttnRows * kAttnStride;
    bf16* gs = sg + (j & 1) * kAttnRows * kAttnStride;
    float2 next_st = make_float2(0.f, 0.f);
    if (j + 1 < n_q) {  // the next tile's stage was last read before the previous barrier
      const int next = (j + 1) & 1;
      stage_tile(hd.q, hd.stride, i0 + kAttnRows, L, sq + next * kAttnRows * kAttnStride,
                 copy_row, copy_col);
      stage_tile(hd.g, hd.g_stride, i0 + kAttnRows, L, sg + next * kAttnRows * kAttnStride,
                 copy_row, copy_col);
      if (tid < kAttnRows) next_st = row_stats(hd, i0 + kAttnRows + tid, L);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's pieces of tile j (and of K, V) have landed
    if constexpr (kBias) {
      if (j == 0) {
        add_bias_tile(sk, *reinterpret_cast<const uint4*>(hd.k_bias + copy_col), copy_row,
                      copy_col);
        add_bias_tile(sv, *reinterpret_cast<const uint4*>(hd.v_bias + copy_col), copy_row,
                      copy_col);
      }
      add_bias_tile(qs, q_bias, copy_row, copy_col);
    }
    __syncthreads();
    if (j == 0) {
      load_a_frags(kf, sk, warp * 16);
      load_a_frags(vf, sv, warp * 16);
    }

    // S^T = K Q^T and dP^T = V G^T: element (t, 2 rr + e) is key key0 + 8 rr,
    // query row i0 + 8 t + 2 tig + e, whose (lse, delta) are the pair at
    // st[8 t + 2 tig + e] of this stage.
    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    mma_a_bt(s, kf, qs);
    mma_a_bt(dp, vf, gs);
    const float4* cols = reinterpret_cast<const float4*>(st + (j & 1) * kAttnRows);
    const bool diag = kCausal && i0 == k0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float4 rs = cols[4 * t + tig];  // rows 8 t + 2 tig and the next one
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float lse = (c & 1) ? rs.z : rs.x;
        const float delta = (c & 1) ? rs.w : rs.y;
        float p = exp2f(s[t][c] * scale - lse);
        if (diag && i0 + 8 * t + 2 * tig + (c & 1) < key0 + 8 * (c >> 1)) p = 0.f;
        s[t][c] = p;                                   // P^T
        dp[t][c] = p * (dp[t][c] - delta) * ds_scale;  // dS^T
      }
    }

    // dV += P^T G and dK += dS^T Q.
    uint32_t af[4][4];
    c_to_a(af, s);
    mma_a_b(dv, af, gs);
    c_to_a(af, dp);
    mma_a_b(dk, af, qs);
    if (j + 1 < n_q && tid < kAttnRows) st[((j + 1) & 1) * kAttnRows + tid] = next_st;
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // The warp's rows of the K and V tiles were read only for its fragments.
  store_warp_rows(dk, sk + warp * 16 * kAttnStride, hd.dk, hd.d_stride, k0 + warp * 16, L);
  store_warp_rows(dv, sv + warp * 16 * kAttnStride, hd.dv, hd.d_stride, k0 + warp * 16, L);
}

}  // namespace
