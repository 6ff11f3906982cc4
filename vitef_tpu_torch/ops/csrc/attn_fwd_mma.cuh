// The tensor-core forward of softmax attention for Hopper (sm_90a), shared
// by K1 (csrc/packed_mha_fwd.cu, packed qkv with its bias) and K4's bfloat16
// path (csrc/flash_fwd.cu, head-major q, k, v). Its tiles, copies and warp
// products (load_a_frags, mma_a_bt, mma_a_b, c_to_a, store_warp_rows) are
// also the backward's (attn_bwd_mma.cuh).
//
// One block of 4 warps computes 64 query rows of one head at head width 64,
// a FlashAttention-2 schedule on mma.sync.m16n8k16 (bf16 in, float32
// accumulators):
//
// - the block's Q tile goes to shared memory once, and each warp keeps its
//   16 rows as A fragments in registers (ldmatrix) for the whole key loop;
// - 64-key tiles of K and V are staged with 16-byte cp.async copies, double
//   buffered (tile j + 1 is in flight while tile j is multiplied), in rows
//   padded by 8 elements so that every ldmatrix is free of bank conflicts;
//   rows past L (of Q, K and V) are zero-filled, never left stale;
// - with a bias (K1) each staged row gets it added in one in-place pass,
//   rounded to bf16 as the plain version rounds qkv + bias;
// - per warp S = Q K^T is 16 x 64 float32 scores in registers (8 n8-tiles x
//   4 k16 steps, K read by ldmatrix as the "col" operand), scaled after the
//   product by log2(e)/sqrt(d) (no second rounding of Q);
// - the online softmax runs in registers: a thread holds pieces of 2 rows,
//   whose max is two __shfl_xor steps in the quad, and exp2f of the scaled
//   scores. Only the causal diagonal tile and the last partial tile are
//   masked by index (-inf); tiles above the diagonal are never loaded. The
//   key-masked mode gives a visible but invalid key the finite score -1e30,
//   so a row that sees no valid key stays finite;
// - O += P V without shared memory: P is rounded to bf16 in registers and
//   two adjacent n8 accumulator tiles are one k16 A fragment (the m16n8k16
//   C -> A layout identity); V comes through ldmatrix.trans. The row sum adds
//   the unrounded p. The 16 x 64 O accumulator stays in registers;
// - the epilogue divides by the row sum, rounds to bf16, stages the warp's
//   16 rows in its own rows of the Q tile and writes them with 16-byte
//   stores; on request each row's m + log2(l), the log2-sum-exp of the
//   scaled scores (the units K2, K3 and K5 rebuild P from), is written.
//
// No atomics: two launches on the same inputs give bit-identical results.
// Shared memory: Q 9 KB and two K/V stages 36 KB (45 KB).

#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "mma_sync.cuh"

namespace {

constexpr int kAttnDim = 64;                 // the one instantiated head width
constexpr int kAttnRows = 64;                // query rows per block, 16 per warp
constexpr int kAttnKeys = 64;                // keys per staged tile
constexpr int kAttnWarps = kAttnRows / 16;
constexpr int kAttnThreads = 32 * kAttnWarps;
constexpr int kAttnStride = kAttnDim + 8;    // bf16 elements per padded shared row
constexpr float kAttnMaskedScore = -1e30f;   // a key-masked key's scaled score
constexpr size_t kAttnSmemBytes =
    static_cast<size_t>(kAttnRows + 4 * kAttnKeys) * kAttnStride * sizeof(bf16);

// Where one (sequence, head) lives: row r of Q, K and V at q, k, v plus
// r * stride (64 contiguous bf16 each, 16-byte aligned); their bias (64
// each, kBias only); row r of the output at out + r * out_stride; the row
// statistics lse[r] (null: not wanted); the sequence's key mask
// key_mask[r], nonzero for a valid key (kMasked only).
struct AttnHead {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  size_t stride;
  const bf16* q_bias;
  const bf16* k_bias;
  const bf16* v_bias;
  bf16* out;
  size_t out_stride;
  float* lse;
  const uint8_t* key_mask;
};

// This thread's four 16-byte pieces of a 64-row tile: rows first_row + 16 i,
// columns col .. col + 7; the thread mapping of the copies and bias passes.
__device__ __forceinline__ void stage_tile(const bf16* base, size_t stride, int r0, int L,
                                           bf16* dst, int first_row, int col) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = first_row + 16 * i;
    const bool inside = r0 + row < L;
    const bf16* src = inside ? base + static_cast<size_t>(r0 + row) * stride + col : base;
    cp_async16(dst + row * kAttnStride + col, src, inside);
  }
}

// bf16(x + b) in place over the same four pieces, b the eight bias values of
// the pieces' columns (as bf16 in 16 bytes).
__device__ __forceinline__ void add_bias_tile(bf16* dst, uint4 b, int first_row, int col) {
  const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint4* p = reinterpret_cast<uint4*>(dst + (first_row + 16 * i) * kAttnStride + col);
    uint4 w = *p;
    __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(xp[e]);
      const float2 y = __bfloat1622float2(bp[e]);
      xp[e] = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
    }
    *p = w;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows row0 .. row0 + 15 of a staged tile as the A fragments of the four k16
// steps over its 64 columns.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4], const bf16* tile, int row0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldmatrix_x4(a[kk], tile + (row0 + (lane & 15)) * kAttnStride + kk * 16 + (lane >> 4) * 8);
  }
}

// c (16 x 64) += a (16 x 64) tile^T: n8 tile t of c holds rows 8 t .. 8 t + 7
// of the staged tile (ldmatrix: the tile's rows are the "col" operand).
__device__ __forceinline__ void mma_a_bt(float (&c)[8][4], const uint32_t (&a)[4][4],
                                         const bf16* tile) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t b[4];
      ldmatrix_x4(b, tile + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kAttnStride +
                         kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(c[2 * nj], a[kk], b);
      mma_bf16(c[2 * nj + 1], a[kk], b + 2);
    }
  }
}

// c (16 x 64) += a (16 x 64) tile: a's columns are the staged tile's rows,
// and n8 tile t of c holds the tile's columns 8 t .. 8 t + 7 (ldmatrix.trans).
__device__ __forceinline__ void mma_a_b(float (&c)[8][4], const uint32_t (&a)[4][4],
                                        const bf16* tile) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dj = 0; dj < 4; ++dj) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kAttnStride +
                               dj * 16 + (lane >> 4) * 8);
      mma_bf16(c[2 * dj], a[kk], b);
      mma_bf16(c[2 * dj + 1], a[kk], b + 2);
    }
  }
}

// The 16 x 64 accumulators c, rounded to bf16, as the A fragments of the next
// product: k16 step kk is n8 tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    a[t >> 1][2 * (t & 1)] = pack_bf16(c[t][0], c[t][1]);
    a[t >> 1][2 * (t & 1) + 1] = pack_bf16(c[t][2], c[t][3]);
  }
}

__device__ __forceinline__ void zero_acc(float (&c)[8][4]) {
#pragma unroll
  for (int t = 0; t < 8; ++t) c[t][0] = c[t][1] = c[t][2] = c[t][3] = 0.f;
}

// The warp's 16 x 64 accumulator rows r0 .. r0 + 15 (those < L), in bf16,
// into dst + r * stride: staged in the warp's own 16 rows `so` of a tile,
// then written with 16-byte stores.
__device__ __forceinline__ void store_warp_rows(const float (&c)[8][4], bf16* so, bf16* dst,
                                                size_t stride, int r0, int L) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    *reinterpret_cast<uint32_t*>(so + g * kAttnStride + 8 * t + 2 * tig) =
        pack_bf16(c[t][0], c[t][1]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * kAttnStride + 8 * t + 2 * tig) =
        pack_bf16(c[t][2], c[t][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int piece = lane + 32 * i;
    const int row = piece >> 3;
    const int col = (piece & 7) * 8;
    if (r0 + row < L) {
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r0 + row) * stride + col) =
          *reinterpret_cast<const uint4*>(so + row * kAttnStride + col);
    }
  }
}

// Rows q0 .. q0 + 63 (those < L) of one head: out = softmax(Q K^T * scale'
// [+ masks]) V, with scale = log2(e)/sqrt(d) applied in exp2 units. Called
// by all kAttnThreads threads of the block with kAttnSmemBytes of dynamic
// shared memory at smem.
template <bool kBias, bool kCausal, bool kMasked>
__device__ __forceinline__ void attn_fwd_tile(const AttnHead& hd, int L, int q0, float scale,
                                              unsigned char* smem) {
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kAttnRows * kAttnStride;        // two stages of kAttnKeys rows
  bf16* sv = sk + 2 * kAttnKeys * kAttnStride;    // likewise

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

  uint4 k_bias = make_uint4(0, 0, 0, 0), v_bias = k_bias;
  if constexpr (kBias) {
    k_bias = *reinterpret_cast<const uint4*>(hd.k_bias + copy_col);
    v_bias = *reinterpret_cast<const uint4*>(hd.v_bias + copy_col);
  }

  stage_tile(hd.q, hd.stride, q0, L, sq, copy_row, copy_col);
  stage_tile(hd.k, hd.stride, 0, L, sk, copy_row, copy_col);
  stage_tile(hd.v, hd.stride, 0, L, sv, copy_row, copy_col);
  cp_async_commit();

  uint32_t qf[4][4];                   // the warp's Q rows as A fragments, per k16 step
  float o[8][4];                       // O, 16 x 64: n8 tiles of head columns
  zero_acc(o);
  float row_m[2] = {-INFINITY, -INFINITY};
  float row_l[2] = {0.f, 0.f};         // this thread's part of each row's sum

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
    cp_async_wait<1>();  // this thread's pieces of tile j (and of Q) have landed
    if constexpr (kBias) {
      if (j == 0) {
        add_bias_tile(sq, *reinterpret_cast<const uint4*>(hd.q_bias + copy_col), copy_row,
                      copy_col);
      }
      add_bias_tile(ks, k_bias, copy_row, copy_col);
      add_bias_tile(vs, v_bias, copy_row, copy_col);
    }
    __syncthreads();

    if (j == 0) load_a_frags(qf, sq, warp * 16);

    // S = Q K^T: n8 tile t holds keys k0 + 8 t .. + 7.
    float s[8][4];
    zero_acc(s);
    mma_a_bt(s, qf, ks);

    // Scale; mask by index on the diagonal and the last partial tile, and by
    // the key mask. Element (t, 2 rr + e) is row row0 + 8 rr, key
    // k0 + 8 t + 2 tig + e.
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[t][c] *= scale;
    }
    const bool edge = k0 + kAttnKeys > L || (kCausal && k0 + kAttnKeys > q0);
    if (kMasked || edge) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * t + 2 * tig + e;
          bool valid = true;
          if constexpr (kMasked) valid = key < L && hd.key_mask[key] != 0;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const bool visible = key < L && (!kCausal || key <= row0 + 8 * rr);
            float& x = s[t][2 * rr + e];
            x = !visible ? -INFINITY : (valid ? x : kAttnMaskedScore);
          }
        }
      }
    }

    // Online softmax. Every row sees key k0 of each tile it walks (k0 < L,
    // and causal k0 <= q0), so the new max is finite and a -inf start gives
    // alpha = exp2(-inf) = 0.
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = row_m[rr];
#pragma unroll
      for (int t = 0; t < 8; ++t) mx = fmaxf(mx, fmaxf(s[t][2 * rr], s[t][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[rr] = exp2f(row_m[rr] - mx);
      row_m[rr] = mx;
      row_l[rr] *= alpha[rr];
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }
    // P as A fragments (as c_to_a packs them), each n8 tile packed as soon as
    // it is exponentiated: k16 step kk of P V is n8 tiles 2 kk and 2 kk + 1.
    uint32_t pf[4][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float p0 = exp2f(s[t][0] - row_m[0]);
      const float p1 = exp2f(s[t][1] - row_m[0]);
      const float p2 = exp2f(s[t][2] - row_m[1]);
      const float p3 = exp2f(s[t][3] - row_m[1]);
      row_l[0] += p0 + p1;
      row_l[1] += p2 + p3;
      pf[t >> 1][2 * (t & 1)] = pack_bf16(p0, p1);
      pf[t >> 1][2 * (t & 1) + 1] = pack_bf16(p2, p3);
    }

    // O += P V: n8 tile t of O holds head columns 8 t .. + 7.
    mma_a_b(o, pf, vs);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Epilogue: the quad's partial sums, O / l in bf16 through the warp's own
  // rows of the Q tile (read only on the first tile).
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row_l[rr] += __shfl_xor_sync(0xffffffffu, row_l[rr], 1);
    row_l[rr] += __shfl_xor_sync(0xffffffffu, row_l[rr], 2);
    inv[rr] = 1.f / row_l[rr];
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    o[t][0] *= inv[0];
    o[t][1] *= inv[0];
    o[t][2] *= inv[1];
    o[t][3] *= inv[1];
  }
  store_warp_rows(o, sq + warp * 16 * kAttnStride, hd.out, hd.out_stride, q0 + warp * 16, L);
  if (hd.lse != nullptr && tig == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qi = row0 + 8 * rr;
      if (qi < L) hd.lse[qi] = row_m[rr] + log2f(row_l[rr]);
    }
  }
}

}  // namespace
