// Packed-qkv multi-head attention forward for Hopper (sm_90a): kernel K1.
//
// Replaces the TPU kernel vitef_tpu/ops/attention.py:_packed_mha_fwd_kernel
// (:99, launched by _packed_call_fwd :355) in its non-causal and causal
// modes, each with or without the per-row key mask (masked=True, :101-106,
// :140-141, :171-172). The TPU kernel computes the causal function in two
// branches, full-L (:152-157) and block-triangular (q_block 256, :110-151);
// this file computes it, and the non-causal one, at every L with one kernel
// tiled over keys.
// For sequence n and head h it computes
//     out[n, :, h*d:(h+1)*d] = softmax(Q_h K_h^T / sqrt(d) [+ causal mask]) V_h
// reading Q_h, K_h and V_h straight from the packed projection qkv (N, L, 3E),
// whose columns are [q | k | v], head-major within each, with the qkv bias
// (3E,) added in the kernel. Scores, softmax statistics and the P.V sums are
// float32; the output (N, L, E) is bfloat16. On request the kernel also
// writes each row's log2-sum-exp (float32, (N, n_heads, L)), which the
// backward (csrc/packed_mha_bwd.cu) reads instead of recomputing it.
//
// What bounds it on this card: per sequence and head, two L x L x d products
// (4*L*L*d FLOPs; causal, the lower triangle's half) and as many
// exponentials as scores, against (N*L*3E + N*L*E) * 2 bytes of device
// memory for the whole call: about 98 FLOPs per byte at ViT-B/16 (L=197) and
// 256 causal at GPT-2 (L=1024), so memory is not the limit for a kernel that
// keeps the L x L scores on chip. This kernel multiplies on the CUDA cores
// (FMA, not tensor cores), so arithmetic and shared-memory reads bound it.
//
// What the design does about it: one block per (sequence, head, 64-row
// query tile), 4 warps, walks 64-key tiles of K_h and V_h staged in shared
// memory (bias added), up to and including the tile on the diagonal when
// causal: it never loads a tile above the diagonal, which is what the TPU
// kernel's block-triangular branch buys. Each query row keeps an online
// softmax (running max and sum in float32, exp2 with log2(e) folded into the
// scale) and a float32 accumulator in shared memory; keys after the row are
// masked by index on the diagonal tile. A warp owns one query row at a time
// and rows go to warps round-robin, so the diagonal tile's triangle is shared
// evenly; each lane scores two keys of the tile, the row's max and sum are
// warp reductions, the tile's probabilities stay in a per-warp shared buffer
// and each lane accumulates two output columns of P.V. The heaviest query
// tiles are launched first. The K rows are padded to an odd word stride so
// the 32 lanes of a warp, each scoring its own key, hit 32 different banks,
// and the L x L scores never reach device memory. Shared memory is fixed
// (about 51 KB), whatever L is. Tensor cores (wgmma) and TMA are later work.
//
// The key mask (serving's ragged prefill) is a compile-time flag: the
// unmasked instantiation is the kernel above, unchanged. The masked one
// reads a (N, L) byte mask, nonzero for a valid key, two bytes per lane and
// tile (a lane scores the same two keys for every row of the tile), and
// gives a masked key the finite scaled score -1e30, as the TPU kernel does,
// never -inf. A query row that sees no valid key (the leading rows of a
// left-padded prompt, or every row of an empty one) then averages the values
// of the keys it may see and stays finite: with -inf it would read 0/0 or
// -inf - -inf, and the NaN would reach the next layer's K/V of those pad
// slots, where 0 x NaN in P.V poisons every real row. Which finite average
// such a row gets differs between the TPU kernel's branches and this one; no
// real row reads it. The online softmax needs nothing else: a tile of only
// masked keys leaves the running max at -1e30, and the first valid key's
// rescale exp2(-1e30 - m) is exactly 0. Tiles whose keys are all padding are
// still computed.
//
// C interface: packed_mha_fwd(qkv, bias, key_mask, out, lse, N, L, n_heads,
// head_dim, causal, stream) returns a cudaError_t as int: the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for a shape this kernel does
// not take. key_mask (uint8, (N, L)) may be null for the unmasked kernel;
// lse may be null.

#include <cstdint>

#include "packed_mha_common.cuh"

namespace {

constexpr int kQTile = 64;                 // query rows per block
constexpr int kTile = 64;                  // keys per staged tile
constexpr float kMaskedScore = -1e30f;     // a masked key's scaled score

// Dynamic shared memory of one block: K and V tiles (padded rows), the query
// rows (scaled, float32), the output accumulators, a probability row per
// warp, and each query row's running max and sum.
constexpr size_t kSmemBytes =
    2 * kTile * kKStride * sizeof(bf16) + 2 * kQTile * kHeadDim * sizeof(float) +
    kWarps * kTile * sizeof(float) + 2 * kQTile * sizeof(float);

template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
packed_mha_fwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                      const uint8_t* __restrict__ key_mask, bf16* __restrict__ out,
                      float* __restrict__ lse, int L, int n_heads, int causal,
                      float score_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile * kKStride;
  float* qs = reinterpret_cast<float*>(vs + kTile * kKStride);
  float* acc = qs + kQTile * kHeadDim;
  float* probs = acc + kQTile * kHeadDim;
  float* row_m = probs + kWarps * kTile;
  float* row_l = row_m + kQTile;

  const int E = n_heads * kHeadDim;
  const int F = 3 * E;
  const int n_tiles = (L + kQTile - 1) / kQTile;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles);  // longest first
  const int h = (blockIdx.x / n_tiles) % n_heads;
  const int n = blockIdx.x / (n_tiles * n_heads);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = tile * kQTile;
  const int rows = min(kQTile, L - q0);
  const bf16* slab = qkv + static_cast<size_t>(n) * L * F;

  // The tile's query rows: bias added and rounded to bf16 (as the plain
  // version rounds qkv + bias), scaled by log2(e)/sqrt(d). Warp w owns rows
  // w, w + kWarps, ... here and below.
  const float2 qb = load_pair(bias + h * kHeadDim, lane);
  for (int r = warp; r < rows; r += kWarps) {
    const float2 q = load_pair(slab + static_cast<size_t>(q0 + r) * F + h * kHeadDim, lane);
    reinterpret_cast<float2*>(qs + r * kHeadDim)[lane] =
        make_float2(round_bf16(q.x + qb.x) * score_scale, round_bf16(q.y + qb.y) * score_scale);
    reinterpret_cast<float2*>(acc + r * kHeadDim)[lane] = make_float2(0.f, 0.f);
    if (lane == 0) {
      row_m[r] = -INFINITY;
      row_l[r] = 0.f;
    }
  }

  float* p = probs + warp * kTile;
  const int kv_end = causal ? q0 + rows : L;  // the keys a row of this tile may see
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    const int klen = min(kTile, kv_end - k0);
    __syncthreads();  // the previous tile has been read by every warp
    stage_kv(slab, bias, E, h, k0, klen, ks, vs);
    bool valid0 = true, valid1 = true;  // this lane's two keys of the tile
    if constexpr (kMasked) {
      const uint8_t* m = key_mask + static_cast<size_t>(n) * L + k0;
      valid0 = lane < klen && m[lane] != 0;
      valid1 = lane + 32 < klen && m[lane + 32] != 0;
    }
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps) {
      // Keys k0 .. k0 + lim - 1 are visible to query row q0 + r; lim >= 1,
      // since a causal tile starts at or before q0.
      const int lim = causal ? min(klen, q0 + r - k0 + 1) : klen;
      float x[kHeadDim];
      load_row(qs + r * kHeadDim, x);
      float s0 = -INFINITY, s1 = -INFINITY;
      if (lane < lim) s0 = dot_row(x, ks + lane * kKStride);
      if (lane + 32 < lim) s1 = dot_row(x, ks + (lane + 32) * kKStride);
      if constexpr (kMasked) {
        if (lane < lim && !valid0) s0 = kMaskedScore;
        if (lane + 32 < lim && !valid1) s1 = kMaskedScore;
      }

      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float alpha = exp2f(m_old - m_new);  // 0 on the row's first tile
      const float p0 = exp2f(s0 - m_new);        // 0 for a key past lim
      const float p1 = exp2f(s1 - m_new);
      p[lane] = p0;
      p[lane + 32] = p1;
      const float l_new = row_l[r] * alpha + warp_sum(p0 + p1);
      __syncwarp();  // every lane's probabilities are visible to the whole warp

      // P.V into the row's accumulator: lane owns columns 2*lane, 2*lane + 1.
      float2* arow = reinterpret_cast<float2*>(acc + r * kHeadDim);
      const float2 a = arow[lane];
      const float2 pv = weighted_rows(p, vs, lim, lane);
      arow[lane] = make_float2(fmaf(a.x, alpha, pv.x), fmaf(a.y, alpha, pv.y));
      if (lane == 0) {
        row_m[r] = m_new;
        row_l[r] = l_new;
      }
      __syncwarp();  // the next row may overwrite p only after every lane read it
    }
  }

  for (int r = warp; r < rows; r += kWarps) {
    const float inv = 1.f / row_l[r];
    const float2 a = reinterpret_cast<const float2*>(acc + r * kHeadDim)[lane];
    store_pair(out + (static_cast<size_t>(n) * L + q0 + r) * E + h * kHeadDim, lane,
               a.x * inv, a.y * inv);
    if (lse != nullptr && lane == 0) {
      lse[(static_cast<size_t>(n) * n_heads + h) * L + q0 + r] = row_m[r] + log2f(row_l[r]);
    }
  }
}

}  // namespace

extern "C" int packed_mha_fwd(const void* qkv, const void* bias, const void* key_mask,
                              void* out, void* lse, int n, int L, int n_heads, int head_dim,
                              int causal, void* stream) {
  if (head_dim != kHeadDim || n <= 0 || L <= 0 || n_heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks =
      static_cast<long long>(n) * n_heads * ((L + kQTile - 1) / kQTile);
  const float score_scale = kLog2e / sqrtf(static_cast<float>(kHeadDim));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qkv_p = static_cast<const bf16*>(qkv);
  const bf16* bias_p = static_cast<const bf16*>(bias);
  bf16* out_p = static_cast<bf16*>(out);

  const uint8_t* mask_p = static_cast<const uint8_t*>(key_mask);
  const auto kernel = mask_p != nullptr ? packed_mha_fwd_kernel<true>
                                        : packed_mha_fwd_kernel<false>;

  const cudaError_t err = allow_smem(kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, s>>>(
      qkv_p, bias_p, mask_p, out_p, static_cast<float*>(lse), L, n_heads, causal,
      score_scale);
  return static_cast<int>(cudaGetLastError());
}
