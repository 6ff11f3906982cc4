// Flash attention forward for Hopper (sm_90a): kernel K4.
//
// Replaces the TPU kernel vitef_tpu/ops/attention.py:_flash_kernel (:490,
// launched by _flash_forward :543, call :558). For sequence n and head h it
// computes
//     out[n, h] = softmax(Q K^T / sqrt(d) [+ causal mask]) V
// on q, k, v (N, n_heads, L, d), contiguous: bfloat16 at d = 64 or 128
// (Llama-1B's and Llama-3.1-8B's head widths), float32 at d = 64. The
// TPU kernel pads L to a multiple of its 128-row blocks and masks keys past
// kv_len; this one takes any L and masks by index (the last tiles are
// partial). Scores, the running max and sum and the P.V accumulator are
// float32. With bfloat16 inputs P is rounded to bfloat16 before P.V, as the
// TPU kernel's p.astype(v.dtype) (:533-535) does, while the row sum adds the
// unrounded values; with float32 inputs every product keeps float32's
// accuracy, as the TPU kernel's float32 dot_generals do. On request it also
// writes each row's log2-sum-exp of the scaled scores (float32,
// (N, n_heads, L)), which the backward (csrc/flash_bwd.cu, K5) reads.
//
// What bounds it on this card: per sequence and head two L x L x d products
// (causal: on the lower triangle) and as many exponentials as scores, against
// 4 * N * n_heads * L * d elements of device memory: at the Llama-1B shape
// (N=4, h=32, L=1024, causal) 17.2 GFLOP against 67 MB in bf16, so a kernel
// that keeps the scores on chip is bound by its products. Both types run
// them on the tensor cores (mma.sync), in one FlashAttention-2 schedule: one
// block per (sequence, head, 64-row query tile), 4 warps of 16 rows, the
// heaviest (causal: the last) query tiles launched first; Q as register
// fragments; 64-key tiles of K and V staged with double-buffered 16-byte
// cp.async, zero-filled past L; scores, online softmax (exp2 on the
// log2(e)/sqrt(d) scale) and the O accumulator in registers; nothing above
// the causal diagonal loaded, the diagonal and last partial tiles masked by
// index.
//
// - bfloat16 (flash_fwd_bf16_kernel<D>): K1's core, attn_fwd_mma.cuh, on the
//   head-major layout: m16n8k16 products, P fed from the score accumulators
//   into P.V; 45 KB of shared memory a block at d = 64, 85 KB at d = 128. At
//   d = 128 a thread holds 64 float32 of O, 32 registers of Q fragments and
//   32 of scores (K1 at that width takes 229-251 registers), so that
//   instantiation is bounded by the block size alone, as K1's are: the
//   float32 kernel's cap of 168 registers (three blocks an SM) would spill
//   it.
// - float32 (flash_fwd_tf32_kernel): split TF32 ("3xTF32"). A single TF32
//   product keeps about three decimal digits, so every float32 operand x
//   (Q, K, P, V) is split into hi = tf32(x) and lo = tf32(x - hi), and each
//   m16n8k8 product is hi.hi + hi.lo + lo.hi in float32 (mma_3xtf32): the
//   dropped lo.lo is about 2^-22 of the product, inside float32's summation
//   noise. Three TF32 products per float32 product, so its bound is 3 x the
//   products over the 495 TFLOP/s of dense TF32. Rows are padded to 68
//   floats (272 bytes), so ldmatrix on Q and K rows and the column reads of
//   V are free of bank conflicts. The TF32 A layout is not the C layout of
//   the score product, so P goes into P.V as it lies in the accumulators
//   and the sum runs over the tile's keys in another order: the k index tig
//   of the A fragment is key 2 tig and tig + 4 is key 2 tig + 1, and V's B
//   fragment is read at those keys. Q stays split in registers for the
//   whole key loop; it is staged once in K's second stage, before that
//   stage first holds K. Shared memory: two K and two V stages, 68 KB, so
//   three blocks fit an SM, as do their registers (capped at 168).
// wgmma, TMA and warp specialisation are the next step.
//
// No atomics: two launches on the same inputs give bit-identical results.
//
// C interface: flash_fwd(q, k, v, out, lse, N, n_heads, L, head_dim, fp32,
// causal, stream) returns a cudaError_t as int: the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for a shape this kernel does
// not take (float32 at d = 128 among them). fp32 selects float32 inputs and
// output (else bfloat16); lse may be null.

#include "packed_mha_common.cuh"
#include "attn_fwd_mma.cuh"

namespace {

// The bfloat16 path at head width D: one (sequence, head, 64-row query tile)
// per block on the tensor-core core of attn_fwd_mma.cuh.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kAttnThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int L, float score_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = (L + kAttnRows - 1) / kAttnRows;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles);  // longest first
  const size_t head = blockIdx.x / n_tiles;                              // n * n_heads + h
  const size_t head_off = head * L * D;
  const AttnHead view{q + head_off, k + head_off, v + head_off, D,
                      nullptr, nullptr, nullptr, out + head_off, D,
                      lse == nullptr ? nullptr : lse + head * L, nullptr};
  attn_fwd_tile<D, false, kCausal, false>(view, L, tile * kAttnRows, score_scale, smem);
}

constexpr size_t kF32SmemBytes = 4 * static_cast<size_t>(kAttnF32Tile) * sizeof(float);

// The float32 path: rows q0 .. q0 + 63 (those < L) of one head, in split
// TF32 on the tensor cores (m16n8k8). Element (t, 2 rr + e) of a 16 x 64
// accumulator is row row0 + 8 rr and column (key or head column)
// 8 t + 2 tig + e. Three blocks an SM: under the cap of 168 registers
// (uncapped it takes 171-174, so two blocks fit) the non-causal mode spills
// 8 bytes, and both modes ran faster than uncapped when the two were timed
// in turns on the card.
template <bool kCausal>
__global__ void __launch_bounds__(kAttnThreads, 3)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int L, float score_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);  // two stages of kAttnKeys rows
  float* sv = sk + 2 * kAttnF32Tile;           // likewise
  float* sq = sk + kAttnF32Tile;               // Q, until K's second stage is first filled

  const int n_tiles = (L + kAttnRows - 1) / kAttnRows;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles);  // longest first
  const size_t head = blockIdx.x / n_tiles;                              // n * n_heads + h
  const size_t head_off = head * L * kAttnF32Dim;
  const float* qh = q + head_off;
  const float* kh = k + head_off;
  const float* vh = v + head_off;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;              // the accumulator row (and row + 8) of this thread
  const int tig = lane & 3;             // its column pair within each n8 tile
  const int copy_row = tid >> 4;        // this thread's copies: rows copy_row + 8 i,
  const int copy_col = (tid & 15) * 4;  // floats copy_col .. + 3
  const int q0 = tile * kAttnRows;
  const int row0 = q0 + warp * 16 + g;  // this thread's query rows: row0 and row0 + 8
  const int kv_end = kCausal ? min(q0 + kAttnRows, L) : L;  // keys this tile may see
  const int n_kv = (kv_end + kAttnKeys - 1) / kAttnKeys;

  stage_tile_f32(qh, q0, L, sq, copy_row, copy_col);
  stage_tile_f32(kh, 0, L, sk, copy_row, copy_col);
  stage_tile_f32(vh, 0, L, sv, copy_row, copy_col);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // The warp's 16 Q rows as split A fragments of the eight k8 steps over the
  // head columns: matrices (rows 0-7 | 8-15) x (columns 0-3 | 4-7).
  uint32_t q_hi[8][4], q_lo[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sq + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kAttnF32Stride +
                       kk * 8 + (lane >> 4) * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), q_hi[kk][e], q_lo[kk][e]);
  }
  __syncthreads();  // every warp has its Q fragments: K's second stage is free

  float o[8][4];                        // O, 16 x 64: n8 tiles of head columns
  zero_acc(o);
  float row_m[2] = {-INFINITY, -INFINITY};
  float row_l[2] = {0.f, 0.f};          // this thread's part of each row's sum

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kAttnKeys;
    const float* ks = sk + (j & 1) * kAttnF32Tile;
    const float* vs = sv + (j & 1) * kAttnF32Tile;
    if (j + 1 < n_kv) {  // the next tile's stage was last read before the previous barrier
      const int next = (j + 1) & 1;
      stage_tile_f32(kh, k0 + kAttnKeys, L, sk + next * kAttnF32Tile, copy_row, copy_col);
      stage_tile_f32(vh, k0 + kAttnKeys, L, sv + next * kAttnF32Tile, copy_row, copy_col);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's pieces of tile j have landed
    __syncthreads();

    // S = Q K^T: n8 tile t holds keys k0 + 8 t .. + 7. One ldmatrix gives the
    // B fragments of n8 tiles 2 nj and 2 nj + 1 at k8 step kk: matrices
    // (keys 0-7 | 8-15 of the pair) x (columns 0-3 | 4-7 of the step).
    float s[8][4];
    zero_acc(s);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4], b_hi[4], b_lo[4];
        ldmatrix_x4(b, ks + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kAttnF32Stride +
                           kk * 8 + ((lane >> 3) & 1) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(b[e]), b_hi[e], b_lo[e]);
        mma_3xtf32(s[2 * nj], q_hi[kk], q_lo[kk], b_hi, b_lo);
        mma_3xtf32(s[2 * nj + 1], q_hi[kk], q_lo[kk], b_hi + 2, b_lo + 2);
      }
    }

    // Scale; mask by index on the diagonal and the last partial tile.
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[t][c] *= score_scale;
    }
    const bool edge = k0 + kAttnKeys > L || (kCausal && k0 + kAttnKeys > q0);
    if (edge) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + 8 * t + 2 * tig + (c & 1);
          if (key >= L || (kCausal && key > row0 + 8 * (c >> 1))) s[t][c] = -INFINITY;
        }
      }
    }

    // Online softmax. Every row sees key k0 of each tile it walks (k0 < L,
    // and causal k0 <= q0), so the new max is finite and a -inf start gives
    // alpha = exp2(-inf) = 0.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = row_m[rr];
#pragma unroll
      for (int t = 0; t < 8; ++t) mx = fmaxf(mx, fmaxf(s[t][2 * rr], s[t][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(row_m[rr] - mx);
      row_m[rr] = mx;
      row_l[rr] *= alpha;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        o[t][2 * rr] *= alpha;
        o[t][2 * rr + 1] *= alpha;
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[t][c] = exp2f(s[t][c] - row_m[c >> 1]);  // P, 0 for a masked key
        row_l[c >> 1] += s[t][c];
      }
    }

    // O += P V over the tile's keys, eight at a time: k8 step kk takes P's
    // n8 tile kk as it lies (A index tig is key 8 kk + 2 tig, tig + 4 is
    // key 8 kk + 2 tig + 1) and V's rows at those keys, column 8 dj + g.
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      split_tf32(s[kk][0], a_hi[0], a_lo[0]);
      split_tf32(s[kk][2], a_hi[1], a_lo[1]);
      split_tf32(s[kk][1], a_hi[2], a_lo[2]);
      split_tf32(s[kk][3], a_hi[3], a_lo[3]);
      const float* vrow = vs + (8 * kk + 2 * tig) * kAttnF32Stride + g;
#pragma unroll
      for (int dj = 0; dj < 8; ++dj) {
        uint32_t b_hi[2], b_lo[2];
        split_tf32(vrow[8 * dj], b_hi[0], b_lo[0]);
        split_tf32(vrow[kAttnF32Stride + 8 * dj], b_hi[1], b_lo[1]);
        mma_3xtf32(o[dj], a_hi, a_lo, b_hi, b_lo);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Epilogue: the quad's partial sums, O / l as float2 stores (a quad writes
  // 32 contiguous bytes of a row), and each row's m + log2(l).
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row_l[rr] += __shfl_xor_sync(0xffffffffu, row_l[rr], 1);
    row_l[rr] += __shfl_xor_sync(0xffffffffu, row_l[rr], 2);
    const int qi = row0 + 8 * rr;
    if (qi >= L) continue;
    const float inv = 1.f / row_l[rr];
    float* orow = out + head_off + static_cast<size_t>(qi) * kAttnF32Dim + 2 * tig;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      *reinterpret_cast<float2*>(orow + 8 * t) =
          make_float2(o[t][2 * rr] * inv, o[t][2 * rr + 1] * inv);
    }
    if (lse != nullptr && tig == 0) lse[head * L + qi] = row_m[rr] + log2f(row_l[rr]);
  }
}

// The bfloat16 kernel of the mode at head width D on `stream`.
template <int D>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse,
                        unsigned blocks, int L, bool causal, cudaStream_t stream) {
  const auto kernel = causal ? flash_fwd_bf16_kernel<D, true> : flash_fwd_bf16_kernel<D, false>;
  constexpr size_t smem = kAttnSmemBytes<D>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kAttnThreads, smem, stream>>>(q, k, v, out, lse, L,
                                                 kLog2e / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         int n, int n_heads, int L, int head_dim, int fp32, int causal,
                         void* stream) {
  const bool width_ok = fp32 ? head_dim == kAttnF32Dim : head_dim == 64 || head_dim == 128;
  if (!width_ok || n <= 0 || L <= 0 || n_heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks =
      static_cast<long long>(n) * n_heads * ((L + kAttnRows - 1) / kAttnRows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) {
    const auto kernel = causal ? flash_fwd_tf32_kernel<true> : flash_fwd_tf32_kernel<false>;
    const cudaError_t err = allow_smem(kernel, kF32SmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(blocks), kAttnThreads, kF32SmemBytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(lse), L,
        kLog2e / sqrtf(static_cast<float>(kAttnF32Dim)));
    return static_cast<int>(cudaGetLastError());
  }
  const auto run = head_dim == 64 ? launch_bf16<64> : launch_bf16<128>;
  return static_cast<int>(run(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v), static_cast<bf16*>(out),
                              static_cast<float*>(lse), static_cast<unsigned>(blocks), L,
                              causal != 0, s));
}
