// The tensor-core backward of softmax attention for Hopper (sm_90a), used by
// K2 and K3 (csrc/packed_mha_bwd.cu, packed qkv with its bias) and K5
// (csrc/flash_bwd.cu, head-major, no bias; float32 in split TF32, below). It
// is the backward of attn_fwd_mma.cuh and is built from its pieces: head
// width D (64 or 80 in bf16, 64 in float32), 64-row query tiles and 64-key
// tiles, 4 warps of 16 rows, rows padded by 8 elements in shared memory,
// 16-byte cp.async copies double buffered, rows past L zero-filled, the bias
// added in place as bf16(x + b), and the warp products on 16 x 64 and
// 16 x D register tiles.
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
// statistics, 56,320 bytes a block at D = 64 and 68,608 at D = 80, in either
// pass.
//
// K5's float32 path takes the same two passes in split TF32
// (attn_bwd_dq_tile_f32, attn_bwd_dkv_tile_f32; head-major, no bias): all
// seven products are mma.sync.m16n8k8 TF32 through mma_3xtf32, with every
// float32 operand, P and dS included, split into hi and lo, so nothing is
// rounded below float32's accuracy. The TF32 A fragment is not the C
// fragment of the score product, so P, dS, P^T and dS^T enter their second
// products as they lie, and the B operand (rows of K, G or Q) is read at the
// rows the A index stands for (mma_tf32_c_b). The per-warp A operands that
// bf16 keeps as register fragments stay in shared memory, read by ldmatrix
// and split at each use (mma_tf32_a_bt), since split they would double the
// registers of the accumulators. dQ, dK and dV take each tile's products in a
// fresh register tile before adding them up in float32 (add_tf32_c_b): the
// tensor cores' accumulation truncates. Rows of 68 floats keep every
// ldmatrix and column read free of bank conflicts: 105,472 bytes a block in
// either pass, two blocks an SM.

#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "attn_fwd_mma.cuh"

namespace {

template <int D>
constexpr size_t kAttnBwdSmemBytes =
    static_cast<size_t>(2 * kAttnRows + 4 * kAttnKeys) * kAttnStride<D> * sizeof(bf16) +
    2 * kAttnRows * sizeof(float2);

// Where one (sequence, head) of the backward lives: row r of Q, K and V at
// q, k, v plus r * stride; their bias (kBias only); row r of the cotangent G
// and of the forward's output O at g and out plus r * g_stride; the
// forward's per-row log2-sum-exp lse[r]; stats[r], the (lse, delta) scratch
// the first pass writes and the second reads; row r of dQ, dK and dV at dq,
// dk, dv plus r * d_stride. Every row is D contiguous bf16, 16-byte
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
// kAttnBwdSmemBytes<D> of dynamic shared memory at smem.
template <int D, bool kBias, bool kCausal>
__device__ __forceinline__ void attn_bwd_dq_tile(const AttnBwdHead& hd, int L, int q0,
                                                 float scale, float ds_scale,
                                                 unsigned char* smem) {
  constexpr int kStride = kAttnStride<D>;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sg = sq + kAttnRows * kStride;
  bf16* sk = sg + kAttnRows * kStride;            // two stages of kAttnKeys rows
  bf16* sv = sk + 2 * kAttnKeys * kStride;        // likewise
  float2* st = reinterpret_cast<float2*>(sv + 2 * kAttnKeys * kStride);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;             // the accumulator row (and row + 8) of this thread
  const int tig = lane & 3;            // its column pair within each n8 tile
  const int copy_row = tid >> 3;       // this thread's copies (tile_piece): rows
  const int copy_col = (tid & 7) * 8;  // copy_row + 16 i, columns copy_col .. + 7
  const int row0 = q0 + warp * 16 + g; // this thread's query rows: row0 and row0 + 8
  const int kv_end = kCausal ? min(q0 + kAttnRows, L) : L;  // keys this tile may see
  const int n_kv = (kv_end + kAttnKeys - 1) / kAttnKeys;

  stage_tile<D>(hd.q, hd.stride, q0, L, sq, copy_row, copy_col);
  stage_tile<D>(hd.g, hd.g_stride, q0, L, sg, copy_row, copy_col);
  cp_async_commit();
  stage_tile<D>(hd.k, hd.stride, 0, L, sk, copy_row, copy_col);
  stage_tile<D>(hd.v, hd.stride, 0, L, sv, copy_row, copy_col);
  cp_async_commit();

  TileBias<D> k_bias{}, v_bias{};
  if constexpr (kBias) {
    k_bias = load_tile_bias<D>(hd.k_bias, copy_col);
    v_bias = load_tile_bias<D>(hd.v_bias, copy_col);
  }
  // delta = G . O per row from device memory, two threads a row (D/2
  // columns each), while the tiles are in flight; rows past L get (+inf, 0).
  {
    const int r = tid >> 1;
    const int c0 = (tid & 1) * (D / 2);
    const int qi = q0 + r;
    float delta = 0.f;
    if (qi < L) {
      const bf16* grow = hd.g + static_cast<size_t>(qi) * hd.g_stride + c0;
      const bf16* orow = hd.out + static_cast<size_t>(qi) * hd.g_stride + c0;
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
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
    add_bias_tile<D>(sq, load_tile_bias<D>(hd.q_bias, copy_col), copy_row, copy_col);
  }
  __syncthreads();

  uint32_t qf[D / 16][4], gf[D / 16][4];  // the warp's Q and G rows as A fragments
  load_a_frags<D>(qf, sq, warp * 16);
  load_a_frags<D>(gf, sg, warp * 16);
  float dq[D / 8][4];                  // dQ, 16 x D: n8 tiles of head columns
  zero_acc(dq);
  const float2 rs[2] = {st[warp * 16 + g], st[warp * 16 + g + 8]};  // rows row0, row0 + 8

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kAttnKeys;
    bf16* ks = sk + (j & 1) * kAttnKeys * kStride;
    bf16* vs = sv + (j & 1) * kAttnKeys * kStride;
    if (j + 1 < n_kv) {  // the next tile's stage was last read before the previous barrier
      const int next = (j + 1) & 1;
      stage_tile<D>(hd.k, hd.stride, k0 + kAttnKeys, L, sk + next * kAttnKeys * kStride,
                    copy_row, copy_col);
      stage_tile<D>(hd.v, hd.stride, k0 + kAttnKeys, L, sv + next * kAttnKeys * kStride,
                    copy_row, copy_col);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's pieces of tile j have landed
    if constexpr (kBias) {
      add_bias_tile<D>(ks, k_bias, copy_row, copy_col);
      add_bias_tile<D>(vs, v_bias, copy_row, copy_col);
    }
    __syncthreads();

    // S = Q K^T and dP = G V^T: element (t, 2 rr + e) is row row0 + 8 rr,
    // key k0 + 8 t + 2 tig + e.
    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    mma_a_bt<D>(s, qf, ks);
    mma_a_bt<D>(dp, gf, vs);
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
    mma_a_b<D>(dq, dsf, ks);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // The warp's rows of the Q tile were read only for its fragments.
  store_warp_rows<D>(dq, sq + warp * 16 * kStride, hd.dq, hd.d_stride, q0 + warp * 16, L);
}

// (lse, delta) of query row i for the second pass; (+inf, 0) past L.
__device__ __forceinline__ float2 row_stats(const float2* stats, int i, int L) {
  return i < L ? stats[i] : make_float2(INFINITY, 0.f);
}

// Pass 2 for keys k0 .. k0 + 63 (those < L) of one head: dK and dV, from the
// statistics pass 1 wrote. Called as attn_bwd_dq_tile.
template <int D, bool kBias, bool kCausal>
__device__ __forceinline__ void attn_bwd_dkv_tile(const AttnBwdHead& hd, int L, int k0,
                                                  float scale, float ds_scale,
                                                  unsigned char* smem) {
  constexpr int kStride = kAttnStride<D>;
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kAttnKeys * kStride;
  bf16* sq = sv + kAttnKeys * kStride;            // two stages of kAttnRows rows
  bf16* sg = sq + 2 * kAttnRows * kStride;        // likewise
  float2* st = reinterpret_cast<float2*>(sg + 2 * kAttnRows * kStride);  // likewise

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

  stage_tile<D>(hd.k, hd.stride, k0, L, sk, copy_row, copy_col);
  stage_tile<D>(hd.v, hd.stride, k0, L, sv, copy_row, copy_col);
  stage_tile<D>(hd.q, hd.stride, i_begin, L, sq, copy_row, copy_col);
  stage_tile<D>(hd.g, hd.g_stride, i_begin, L, sg, copy_row, copy_col);
  cp_async_commit();
  if (tid < kAttnRows) st[tid] = row_stats(hd.stats, i_begin + tid, L);

  TileBias<D> q_bias{};
  if constexpr (kBias) q_bias = load_tile_bias<D>(hd.q_bias, copy_col);

  uint32_t kf[D / 16][4], vf[D / 16][4];  // the warp's K and V rows as A fragments
  float dk[D / 8][4], dv[D / 8][4];    // dK and dV, 16 x D: n8 tiles of head columns
  zero_acc(dk);
  zero_acc(dv);

  for (int j = 0; j < n_q; ++j) {
    const int i0 = i_begin + j * kAttnRows;
    bf16* qs = sq + (j & 1) * kAttnRows * kStride;
    bf16* gs = sg + (j & 1) * kAttnRows * kStride;
    float2 next_st = make_float2(0.f, 0.f);
    if (j + 1 < n_q) {  // the next tile's stage was last read before the previous barrier
      const int next = (j + 1) & 1;
      stage_tile<D>(hd.q, hd.stride, i0 + kAttnRows, L, sq + next * kAttnRows * kStride,
                    copy_row, copy_col);
      stage_tile<D>(hd.g, hd.g_stride, i0 + kAttnRows, L, sg + next * kAttnRows * kStride,
                    copy_row, copy_col);
      if (tid < kAttnRows) next_st = row_stats(hd.stats, i0 + kAttnRows + tid, L);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's pieces of tile j (and of K, V) have landed
    if constexpr (kBias) {
      if (j == 0) {
        add_bias_tile<D>(sk, load_tile_bias<D>(hd.k_bias, copy_col), copy_row, copy_col);
        add_bias_tile<D>(sv, load_tile_bias<D>(hd.v_bias, copy_col), copy_row, copy_col);
      }
      add_bias_tile<D>(qs, q_bias, copy_row, copy_col);
    }
    __syncthreads();
    if (j == 0) {
      load_a_frags<D>(kf, sk, warp * 16);
      load_a_frags<D>(vf, sv, warp * 16);
    }

    // S^T = K Q^T and dP^T = V G^T: element (t, 2 rr + e) is key key0 + 8 rr,
    // query row i0 + 8 t + 2 tig + e, whose (lse, delta) are the pair at
    // st[8 t + 2 tig + e] of this stage.
    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    mma_a_bt<D>(s, kf, qs);
    mma_a_bt<D>(dp, vf, gs);
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
    mma_a_b<D>(dv, af, gs);
    c_to_a(af, dp);
    mma_a_b<D>(dk, af, qs);
    if (j + 1 < n_q && tid < kAttnRows) st[((j + 1) & 1) * kAttnRows + tid] = next_st;
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // The warp's rows of the K and V tiles were read only for its fragments.
  store_warp_rows<D>(dk, sk + warp * 16 * kStride, hd.dk, hd.d_stride, k0 + warp * 16, L);
  store_warp_rows<D>(dv, sv + warp * 16 * kStride, hd.dv, hd.d_stride, k0 + warp * 16, L);
}

// ---------------------------------------------------------------------------
// float32 in split TF32 (K5's float32 path, head-major, no bias)
// ---------------------------------------------------------------------------

// Six float32 64-row tiles of 68-float rows and the statistics, 105,472
// bytes a block in either pass: two blocks an SM.
constexpr size_t kAttnBwdF32SmemBytes =
    6 * static_cast<size_t>(kAttnF32Tile) * sizeof(float) + 2 * kAttnRows * sizeof(float2);

// One (sequence, head) of the float32 backward on the head-major layout:
// row r of Q, K, V, G, O, dQ, dK and dV at the pointer plus r * kAttnF32Dim
// (contiguous floats, 16-byte aligned); lse and stats as in AttnBwdHead. A
// pass leaves the pointers it does not use null.
struct AttnBwdHeadF32 {
  const float* q;
  const float* k;
  const float* v;
  const float* g;
  const float* out;
  const float* lse;
  float2* stats;
  float* dq;
  float* dk;
  float* dv;
};

// c (16 x 64) += p (16 x 64) tile in split TF32 (m16n8k8), p a warp's
// accumulators as they lie: p's columns are the staged tile's rows, and n8
// tile t of c holds the tile's columns 8 t .. 8 t + 7. The TF32 A layout is
// not the C layout, so k8 step kk takes p's n8 tile kk as it lies (A index
// tig is tile row 8 kk + 2 tig, tig + 4 is row 8 kk + 2 tig + 1) and reads
// the tile's B fragment at those rows, column 8 dj + g: the sum runs over the
// step's rows in another order, and every operand is split into hi and lo.
__device__ __forceinline__ void mma_tf32_c_b(float (&c)[8][4], const float (&p)[8][4],
                                             const float* tile) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t a_hi[4], a_lo[4];
    split_tf32(p[kk][0], a_hi[0], a_lo[0]);
    split_tf32(p[kk][2], a_hi[1], a_lo[1]);
    split_tf32(p[kk][1], a_hi[2], a_lo[2]);
    split_tf32(p[kk][3], a_hi[3], a_lo[3]);
    const float* row = tile + (8 * kk + 2 * tig) * kAttnF32Stride + g;
#pragma unroll
    for (int dj = 0; dj < 8; ++dj) {
      uint32_t b_hi[2], b_lo[2];
      split_tf32(row[8 * dj], b_hi[0], b_lo[0]);
      split_tf32(row[kAttnF32Stride + 8 * dj], b_hi[1], b_lo[1]);
      mma_3xtf32(c[dj], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

// c += p tile (mma_tf32_c_b) through a zeroed register tile added to c with
// IEEE float32 adds. The tensor cores' float32 accumulation truncates its
// aligned sums, so a sum carried in the accumulators over a whole sequence
// drifts with the number of products (384 mma.sync per running sum at
// L = 1024; in causal mode the first keys' dV, the largest values, drifted
// most); through the tile, each product spans 24.
__device__ __forceinline__ void add_tf32_c_b(float (&c)[8][4], const float (&p)[8][4],
                                             const float* tile) {
  float t[8][4];
  zero_acc(t);
  mma_tf32_c_b(t, p, tile);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] += t[i][e];
  }
}

// c (16 x 64) += rows row0 .. row0 + 15 of the staged float32 tile a times
// tile b^T, in split TF32: n8 tile t of c holds rows 8 t .. 8 t + 7 of b.
// Both operands are read from shared memory with ldmatrix (32-bit rows as
// 8 x 4 matrices) and split at each use, so no operand lives in registers
// across the key loop.
__device__ __forceinline__ void mma_tf32_a_bt(float (&c)[8][4], const float* a, int row0,
                                              const float* b) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    // A: matrices (rows 0-7 | 8-15) x (columns 0-3 | 4-7) of the k8 step.
    uint32_t x[4], a_hi[4], a_lo[4];
    ldmatrix_x4(x, a + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kAttnF32Stride + kk * 8 +
                       (lane >> 4) * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(x[e]), a_hi[e], a_lo[e]);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      // B of n8 tiles 2 nj and 2 nj + 1: matrices (rows 0-7 | 8-15 of the
      // pair) x (columns 0-3 | 4-7 of the step).
      uint32_t y[4], b_hi[4], b_lo[4];
      ldmatrix_x4(y, b + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kAttnF32Stride + kk * 8 +
                         ((lane >> 3) & 1) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(y[e]), b_hi[e], b_lo[e]);
      mma_3xtf32(c[2 * nj], a_hi, a_lo, b_hi, b_lo);
      mma_3xtf32(c[2 * nj + 1], a_hi, a_lo, b_hi + 2, b_lo + 2);
    }
  }
}

// The warp's 16 x 64 float32 accumulator rows r0 .. r0 + 15 (those < L) into
// dst + r * kAttnF32Dim, as float2 stores (a quad writes 32 contiguous bytes).
__device__ __forceinline__ void store_warp_rows_f32(const float (&c)[8][4], float* dst, int r0,
                                                    int L) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + g + 8 * rr;
    if (r >= L) continue;
    float* row = dst + static_cast<size_t>(r) * kAttnF32Dim + 2 * tig;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      *reinterpret_cast<float2*>(row + 8 * t) = make_float2(c[t][2 * rr], c[t][2 * rr + 1]);
    }
  }
}

// Pass 1 in float32: attn_bwd_dq_tile's schedule and algebra with every
// product in split TF32 and P and dS kept in float32. Q and G stay in shared
// memory and are split at each use (held split in registers they would take
// 128 of them beside the 96 of S, dP and dQ). Called by all kAttnThreads
// threads with kAttnBwdF32SmemBytes of dynamic shared memory at smem.
template <bool kCausal>
__device__ __forceinline__ void attn_bwd_dq_tile_f32(const AttnBwdHeadF32& hd, int L, int q0,
                                                     float scale, float ds_scale,
                                                     unsigned char* smem) {
  float* sq = reinterpret_cast<float*>(smem);
  float* sg = sq + kAttnF32Tile;
  float* sk = sg + kAttnF32Tile;                  // two stages of kAttnKeys rows
  float* sv = sk + 2 * kAttnF32Tile;              // likewise
  float2* st = reinterpret_cast<float2*>(sv + 2 * kAttnF32Tile);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int copy_row = tid >> 4;        // this thread's copies: rows copy_row + 8 i,
  const int copy_col = (tid & 15) * 4;  // floats copy_col .. + 3
  const int row0 = q0 + warp * 16 + g;  // this thread's query rows: row0 and row0 + 8
  const int kv_end = kCausal ? min(q0 + kAttnRows, L) : L;
  const int n_kv = (kv_end + kAttnKeys - 1) / kAttnKeys;

  stage_tile_f32(hd.q, q0, L, sq, copy_row, copy_col);
  stage_tile_f32(hd.g, q0, L, sg, copy_row, copy_col);
  stage_tile_f32(hd.k, 0, L, sk, copy_row, copy_col);
  stage_tile_f32(hd.v, 0, L, sv, copy_row, copy_col);
  cp_async_commit();

  // delta = G . O per row from device memory, two threads a row (32
  // columns each), while the tiles are in flight; rows past L get (+inf, 0).
  {
    const int r = tid >> 1;
    const int c0 = (tid & 1) * 32;
    const int qi = q0 + r;
    float delta = 0.f;
    if (qi < L) {
      const size_t at = static_cast<size_t>(qi) * kAttnF32Dim + c0;
      const float4* grow = reinterpret_cast<const float4*>(hd.g + at);
      const float4* orow = reinterpret_cast<const float4*>(hd.out + at);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 gv = grow[i];
        const float4 o = orow[i];
        delta = fmaf(gv.x, o.x, fmaf(gv.y, o.y, fmaf(gv.z, o.z, fmaf(gv.w, o.w, delta))));
      }
    }
    delta += __shfl_xor_sync(0xffffffffu, delta, 1);
    if ((tid & 1) == 0) {
      const float2 s = qi < L ? make_float2(hd.lse[qi], delta) : make_float2(INFINITY, 0.f);
      st[r] = s;
      if (qi < L) hd.stats[qi] = s;
    }
  }

  float dq[8][4];                       // dQ, 16 x 64: n8 tiles of head columns
  zero_acc(dq);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kAttnKeys;
    const float* ks = sk + (j & 1) * kAttnF32Tile;
    const float* vs = sv + (j & 1) * kAttnF32Tile;
    if (j + 1 < n_kv) {  // the next tile's stage was last read before the previous barrier
      const int next = (j + 1) & 1;
      stage_tile_f32(hd.k, k0 + kAttnKeys, L, sk + next * kAttnF32Tile, copy_row, copy_col);
      stage_tile_f32(hd.v, k0 + kAttnKeys, L, sv + next * kAttnF32Tile, copy_row, copy_col);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's pieces of tile j (and of Q and G) have landed
    __syncthreads();
    const float2 rs[2] = {st[warp * 16 + g], st[warp * 16 + g + 8]};  // rows row0, row0 + 8

    // S = Q K^T and dP = G V^T: element (t, 2 rr + e) is row row0 + 8 rr,
    // key k0 + 8 t + 2 tig + e.
    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    mma_tf32_a_bt(s, sq, warp * 16, ks);
    mma_tf32_a_bt(dp, sg, warp * 16, vs);
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

    // dQ += dS K, dS as it lies in the accumulators.
    add_tf32_c_b(dq, s, ks);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  store_warp_rows_f32(dq, hd.dq, q0 + warp * 16, L);
}

// Pass 2 in float32: attn_bwd_dkv_tile's schedule and algebra in split TF32,
// P^T and dS^T in float32. K and V stay in shared memory and are split at
// each use, beside the 128 registers of S^T, dP^T, dK and dV. Called as
// attn_bwd_dq_tile_f32.
template <bool kCausal>
__device__ __forceinline__ void attn_bwd_dkv_tile_f32(const AttnBwdHeadF32& hd, int L, int k0,
                                                      float scale, float ds_scale,
                                                      unsigned char* smem) {
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + kAttnF32Tile;
  float* sq = sv + kAttnF32Tile;                  // two stages of kAttnRows rows
  float* sg = sq + 2 * kAttnF32Tile;              // likewise
  float2* st = reinterpret_cast<float2*>(sg + 2 * kAttnF32Tile);  // likewise

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int copy_row = tid >> 4;
  const int copy_col = (tid & 15) * 4;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0 and key0 + 8
  const int i_begin = kCausal ? k0 : 0;
  const int n_q = (L - i_begin + kAttnRows - 1) / kAttnRows;

  stage_tile_f32(hd.k, k0, L, sk, copy_row, copy_col);
  stage_tile_f32(hd.v, k0, L, sv, copy_row, copy_col);
  stage_tile_f32(hd.q, i_begin, L, sq, copy_row, copy_col);
  stage_tile_f32(hd.g, i_begin, L, sg, copy_row, copy_col);
  cp_async_commit();
  if (tid < kAttnRows) st[tid] = row_stats(hd.stats, i_begin + tid, L);

  float dk[8][4], dv[8][4];             // dK and dV, 16 x 64: n8 tiles of head columns
  zero_acc(dk);
  zero_acc(dv);
  for (int j = 0; j < n_q; ++j) {
    const int i0 = i_begin + j * kAttnRows;
    const float* qs = sq + (j & 1) * kAttnF32Tile;
    const float* gs = sg + (j & 1) * kAttnF32Tile;
    float2 next_st = make_float2(0.f, 0.f);
    if (j + 1 < n_q) {  // the next tile's stage was last read before the previous barrier
      const int next = (j + 1) & 1;
      stage_tile_f32(hd.q, i0 + kAttnRows, L, sq + next * kAttnF32Tile, copy_row, copy_col);
      stage_tile_f32(hd.g, i0 + kAttnRows, L, sg + next * kAttnF32Tile, copy_row, copy_col);
      if (tid < kAttnRows) next_st = row_stats(hd.stats, i0 + kAttnRows + tid, L);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's pieces of tile j (and of K, V) have landed
    __syncthreads();

    // S^T = K Q^T and dP^T = V G^T: element (t, 2 rr + e) is key key0 + 8 rr,
    // query row i0 + 8 t + 2 tig + e, whose (lse, delta) are the pair at
    // st[8 t + 2 tig + e] of this stage.
    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    mma_tf32_a_bt(s, sk, warp * 16, qs);
    mma_tf32_a_bt(dp, sv, warp * 16, gs);
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

    // dV += P^T G and dK += dS^T Q, P^T and dS^T as they lie.
    add_tf32_c_b(dv, s, gs);
    add_tf32_c_b(dk, dp, qs);
    if (j + 1 < n_q && tid < kAttnRows) st[((j + 1) & 1) * kAttnRows + tid] = next_st;
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  store_warp_rows_f32(dk, hd.dk, k0 + warp * 16, L);
  store_warp_rows_f32(dv, hd.dv, k0 + warp * 16, L);
}

}  // namespace
