// The tensor-core forward of softmax attention for Hopper (sm_90a), shared
// by K1 (csrc/packed_mha_fwd.cu, packed qkv with its bias) and K4's bfloat16
// path (csrc/flash_fwd.cu, head-major q, k, v). Its tiles, copies and warp
// products (load_a_frags, mma_a_bt, mma_a_b, c_to_a, store_warp_rows) are
// also the backward's (attn_bwd_mma.cuh).
//
// One block of 4 warps computes 64 query rows of one head at head width D,
// a template parameter (64; 80 for ViT-H/14; 128 for Llama-3.1-8B's
// serving prefill, K1 only: K1 takes all three, K2 and K3 64 and 80, K4 and
// K5 64), in a FlashAttention-2 schedule on mma.sync.m16n8k16 (bf16 in,
// float32 accumulators):
//
// - the block's Q tile goes to shared memory once, and each warp keeps its
//   16 rows as A fragments in registers (ldmatrix, D/16 k16 steps) for the
//   whole key loop;
// - 64-key tiles of K and V are staged with 16-byte cp.async copies, double
//   buffered (tile j + 1 is in flight while tile j is multiplied), in rows
//   padded by 8 elements (D + 8: 144, 176 or 272 bytes, an odd number of
//   16-byte groups, so the eight rows of an ldmatrix fall in eight distinct
//   bank groups and every ldmatrix is free of bank conflicts); rows past L
//   (of Q, K and V) are zero-filled, never left stale. A 64-row tile is 8 D
//   pieces of 16 bytes, D/16 a thread: four in each 64 columns and, at
//   D = 80, one in the last 16;
// - with a bias (K1) each staged row gets it added in one in-place pass,
//   rounded to bf16 as the plain version rounds qkv + bias;
// - per warp S = Q K^T is 16 x 64 float32 scores in registers (8 n8-tiles x
//   D/16 k16 steps, K read by ldmatrix as the "col" operand), scaled after
//   the product by log2(e)/sqrt(d) (no second rounding of Q);
// - the online softmax runs in registers: a thread holds pieces of 2 rows,
//   whose max is two __shfl_xor steps in the quad, and exp2f of the scaled
//   scores. Only the causal diagonal tile and the last partial tile are
//   masked by index (-inf); tiles above the diagonal are never loaded. The
//   key-masked mode gives a visible but invalid key the finite score -1e30,
//   so a row that sees no valid key stays finite;
// - O += P V without shared memory: P is rounded to bf16 in registers and
//   two adjacent n8 accumulator tiles are one k16 A fragment (the m16n8k16
//   C -> A layout identity); V comes through ldmatrix.trans. The row sum adds
//   the unrounded p. The 16 x D O accumulator (D/8 n8 tiles, D/2 floats a
//   thread: 64 at D = 128, beside D/4 registers of Q fragments and 32 of S)
//   stays in registers;
// - the epilogue divides by the row sum, rounds to bf16, stages the warp's
//   16 rows in its own rows of the Q tile and writes them with 16-byte
//   stores; on request each row's m + log2(l), the log2-sum-exp of the
//   scaled scores (the units K2, K3 and K5 rebuild P from), is written.
//
// No atomics: two launches on the same inputs give bit-identical results.
// Shared memory: Q and two K/V stages, 45 KB at D = 64, 55 KB at D = 80 and
// 85 KB at D = 128 (above 48 KB only through allow_smem's opt-in).
//
// The float32 paths of K4 and K5 share its tiles and its thread mapping in
// split TF32 (m16n8k8) at head width 64 only: stage_tile_f32 stages rows of
// 68 floats.

#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "mma_sync.cuh"

namespace {

constexpr int kAttnRows = 64;                // query rows per block, 16 per warp
constexpr int kAttnKeys = 64;                // keys per staged tile
constexpr int kAttnWarps = kAttnRows / 16;
constexpr int kAttnThreads = 32 * kAttnWarps;
constexpr float kAttnMaskedScore = -1e30f;   // a key-masked key's scaled score

template <int D>
constexpr bool kAttnWidthOk = D == 64 || D == 80 || D == 128;  // the bf16 tiles' head widths
template <int D>
constexpr int kAttnStride = D + 8;           // bf16 elements per padded shared row
template <int D>
constexpr int kAttnPieces = D / 16;          // 16-byte pieces of a 64-row tile per thread
template <int D>
constexpr size_t kAttnSmemBytes =
    static_cast<size_t>(kAttnRows + 4 * kAttnKeys) * kAttnStride<D> * sizeof(bf16);

// Where one (sequence, head) lives: row r of Q, K and V at q, k, v plus
// r * stride (D contiguous bf16 each, 16-byte aligned); their bias (D
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

// Where piece i of this thread's pieces of a 64-row tile lies: pieces 4 c
// .. 4 c + 3 at rows first_row + 16 (i % 4), columns 64 c + col .. + 7 (the
// c-th 64 columns, eight pieces a row; first_row = threadIdx.x / 8, col =
// 8 (threadIdx.x % 8)): pieces 0-3 at D = 64 and 80, 0-7 at D = 128; and at
// D = 80 piece 4 at row threadIdx.x / 2, columns 64 + 8 (threadIdx.x % 2)
// .. + 7 (the last 16 columns, two pieces a row). The copies and bias passes
// map their threads so.
struct TilePiece {
  int row;
  int col;
};

template <int D>
__device__ __forceinline__ TilePiece tile_piece(int i, int first_row, int col) {
  static_assert(kAttnWidthOk<D>, "the bf16 attention tiles take head widths 64, 80 and 128");
  if (D == 80 && i == 4) {
    return {static_cast<int>(threadIdx.x >> 1), 64 + 8 * static_cast<int>(threadIdx.x & 1)};
  }
  return {first_row + 16 * (i & 3), 64 * (i >> 2) + col};
}

// This thread's pieces of a 64-row tile of D columns, rows r0 + row of
// base + row * stride, into dst; rows past L are zero-filled.
template <int D>
__device__ __forceinline__ void stage_tile(const bf16* base, size_t stride, int r0, int L,
                                           bf16* dst, int first_row, int col) {
#pragma unroll
  for (int i = 0; i < kAttnPieces<D>; ++i) {
    const TilePiece p = tile_piece<D>(i, first_row, col);
    const bool inside = r0 + p.row < L;
    const bf16* src = inside ? base + static_cast<size_t>(r0 + p.row) * stride + p.col : base;
    cp_async16(dst + p.row * kAttnStride<D> + p.col, src, inside);
  }
}

// The bias of this thread's pieces' columns, eight bf16 in 16 bytes each:
// b[0] for pieces 0-3 and, past D = 64, b[1] for the others (piece 4 at
// D = 80, pieces 4-7 at D = 128: the same columns in the second 64).
template <int D>
struct TileBias {
  uint4 b[D > 64 ? 2 : 1];
};

template <int D>
__device__ __forceinline__ TileBias<D> load_tile_bias(const bf16* bias, int col) {
  TileBias<D> t;
  t.b[0] = *reinterpret_cast<const uint4*>(bias + col);
  if constexpr (D > 64) {
    t.b[1] = *reinterpret_cast<const uint4*>(bias + tile_piece<D>(4, 0, col).col);
  }
  return t;
}

// bf16(x + b) in place over the same pieces.
template <int D>
__device__ __forceinline__ void add_bias_tile(bf16* dst, const TileBias<D>& bias, int first_row,
                                              int col) {
#pragma unroll
  for (int i = 0; i < kAttnPieces<D>; ++i) {
    const TilePiece p = tile_piece<D>(i, first_row, col);
    const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&bias.b[i < 4 ? 0 : 1]);
    uint4* ptr = reinterpret_cast<uint4*>(dst + p.row * kAttnStride<D> + p.col);
    uint4 w = *ptr;
    __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(xp[e]);
      const float2 y = __bfloat1622float2(bp[e]);
      xp[e] = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
    }
    *ptr = w;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows row0 .. row0 + 15 of a staged tile as the A fragments of the D/16
// k16 steps over its D columns.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], const bf16* tile,
                                             int row0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(a[kk], tile + (row0 + (lane & 15)) * kAttnStride<D> + kk * 16 + (lane >> 4) * 8);
  }
}

// c (16 x 64) += a (16 x D) tile^T: n8 tile t of c holds rows 8 t .. 8 t + 7
// of the staged tile (ldmatrix: the tile's rows are the "col" operand).
template <int D>
__device__ __forceinline__ void mma_a_bt(float (&c)[8][4], const uint32_t (&a)[D / 16][4],
                                         const bf16* tile) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t b[4];
      ldmatrix_x4(b, tile + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kAttnStride<D> +
                         kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(c[2 * nj], a[kk], b);
      mma_bf16(c[2 * nj + 1], a[kk], b + 2);
    }
  }
}

// c (16 x D) += a (16 x 64) tile: a's columns are the staged tile's rows,
// and n8 tile t of c holds the tile's columns 8 t .. 8 t + 7 (ldmatrix.trans).
template <int D>
__device__ __forceinline__ void mma_a_b(float (&c)[D / 8][4], const uint32_t (&a)[4][4],
                                        const bf16* tile) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      kAttnStride<D> + dj * 16 + (lane >> 4) * 8);
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

template <int N>
__device__ __forceinline__ void zero_acc(float (&c)[N][4]) {
#pragma unroll
  for (int t = 0; t < N; ++t) c[t][0] = c[t][1] = c[t][2] = c[t][3] = 0.f;
}

// The warp's 16 x D accumulator rows r0 .. r0 + 15 (those < L), in bf16,
// into dst + r * stride: staged in the warp's own 16 rows `so` of a tile,
// then written with 16-byte stores (D/8 a row, D/16 a lane).
template <int D>
__device__ __forceinline__ void store_warp_rows(const float (&c)[D / 8][4], bf16* so, bf16* dst,
                                                size_t stride, int r0, int L) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    *reinterpret_cast<uint32_t*>(so + g * kAttnStride<D> + 8 * t + 2 * tig) =
        pack_bf16(c[t][0], c[t][1]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * kAttnStride<D> + 8 * t + 2 * tig) =
        pack_bf16(c[t][2], c[t][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const int piece = lane + 32 * i;
    const int row = piece / (D / 8);
    const int col = (piece % (D / 8)) * 8;
    if (r0 + row < L) {
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r0 + row) * stride + col) =
          *reinterpret_cast<const uint4*>(so + row * kAttnStride<D> + col);
    }
  }
}

// --- float32 in split TF32 (K4's and K5's float32 paths) --------------------

// Rows padded to 68 floats (272 bytes): ldmatrix on 32-bit rows and the
// column reads of a B operand (8 rows 2 apart, 8 columns) are free of bank
// conflicts.
constexpr int kAttnF32Dim = 64;                           // their one head width
constexpr int kAttnF32Stride = kAttnF32Dim + 4;           // floats per padded shared row
constexpr int kAttnF32Tile = kAttnKeys * kAttnF32Stride;  // floats per staged 64-row tile
static_assert(kAttnRows == kAttnKeys, "float32 query and key tiles share one shape");

// This thread's eight 16-byte pieces of a 64-row float32 tile of a
// head-major head (rows of kAttnF32Dim contiguous floats): rows first_row + 8 i,
// floats col .. col + 3; rows past L are zero-filled.
__device__ __forceinline__ void stage_tile_f32(const float* base, int r0, int L, float* dst,
                                               int first_row, int col) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = first_row + 8 * i;
    const bool inside = r0 + row < L;
    const float* src = inside ? base + static_cast<size_t>(r0 + row) * kAttnF32Dim + col : base;
    cp_async16(dst + row * kAttnF32Stride + col, src, inside);
  }
}

// Rows q0 .. q0 + 63 (those < L) of one head: out = softmax(Q K^T * scale'
// [+ masks]) V, with scale = log2(e)/sqrt(d) applied in exp2 units. Called
// by all kAttnThreads threads of the block with kAttnSmemBytes<D> of
// dynamic shared memory at smem.
template <int D, bool kBias, bool kCausal, bool kMasked>
__device__ __forceinline__ void attn_fwd_tile(const AttnHead& hd, int L, int q0, float scale,
                                              unsigned char* smem) {
  bf16* sq = reinterpret_cast<bf16*>(smem);
  constexpr int kStride = kAttnStride<D>;
  bf16* sk = sq + kAttnRows * kStride;            // two stages of kAttnKeys rows
  bf16* sv = sk + 2 * kAttnKeys * kStride;        // likewise

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

  TileBias<D> k_bias{}, v_bias{};
  if constexpr (kBias) {
    k_bias = load_tile_bias<D>(hd.k_bias, copy_col);
    v_bias = load_tile_bias<D>(hd.v_bias, copy_col);
  }

  stage_tile<D>(hd.q, hd.stride, q0, L, sq, copy_row, copy_col);
  stage_tile<D>(hd.k, hd.stride, 0, L, sk, copy_row, copy_col);
  stage_tile<D>(hd.v, hd.stride, 0, L, sv, copy_row, copy_col);
  cp_async_commit();

  uint32_t qf[D / 16][4];              // the warp's Q rows as A fragments, per k16 step
  float o[D / 8][4];                   // O, 16 x D: n8 tiles of head columns
  zero_acc(o);
  float row_m[2] = {-INFINITY, -INFINITY};
  float row_l[2] = {0.f, 0.f};         // this thread's part of each row's sum

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
    cp_async_wait<1>();  // this thread's pieces of tile j (and of Q) have landed
    if constexpr (kBias) {
      if (j == 0) {
        add_bias_tile<D>(sq, load_tile_bias<D>(hd.q_bias, copy_col), copy_row, copy_col);
      }
      add_bias_tile<D>(ks, k_bias, copy_row, copy_col);
      add_bias_tile<D>(vs, v_bias, copy_row, copy_col);
    }
    __syncthreads();

    if (j == 0) load_a_frags<D>(qf, sq, warp * 16);

    // S = Q K^T: n8 tile t holds keys k0 + 8 t .. + 7.
    float s[8][4];
    zero_acc(s);
    mma_a_bt<D>(s, qf, ks);

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
    for (int t = 0; t < D / 8; ++t) {
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
    mma_a_b<D>(o, pf, vs);
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
  for (int t = 0; t < D / 8; ++t) {
    o[t][0] *= inv[0];
    o[t][1] *= inv[0];
    o[t][2] *= inv[1];
    o[t][3] *= inv[1];
  }
  store_warp_rows<D>(o, sq + warp * 16 * kStride, hd.out, hd.out_stride, q0 + warp * 16, L);
  if (hd.lse != nullptr && tig == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qi = row0 + 8 * rr;
      if (qi < L) hd.lse[qi] = row_m[rr] + log2f(row_l[rr]);
    }
  }
}

}  // namespace
