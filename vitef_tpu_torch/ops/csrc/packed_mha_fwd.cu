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
// (3E,) added in the kernel and rounded to bf16, as the plain version rounds
// qkv + bias. Scores, softmax statistics and the P.V sums are float32; P is
// rounded to bf16 for P.V, as the TPU kernel's p.astype(v.dtype) (:143,
// :174), while the row sum adds the unrounded p; the output (N, L, E) is
// bfloat16. On request the kernel also writes each row's log2-sum-exp of the
// scaled scores (float32, (N, n_heads, L)), which the backward
// (csrc/packed_mha_bwd.cu) rebuilds P from.
//
// What bounds it on this card: per sequence and head, two L x L x d products
// (4*L*L*d FLOPs; causal, the lower triangle's half) and as many
// exponentials as scores, against (N*L*3E + N*L*E) * 2 bytes of device
// memory for the whole call: about 98 FLOPs per byte at ViT-B/16 (L=197),
// 128 at ViT-H/14 (L=257), 256 causal at GPT-2 (L=1024) and about 128
// causal at Llama-3.1-8B's serving prefill (d=128, L=512). A kernel that
// keeps the L x L scores on chip is bound by the products, and those belong
// on the tensor cores: on the CUDA cores, shared-memory reads and FMA issue
// hold such a kernel to 12-14 TFLOP/s on this card.
//
// What the design does about it: both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, float32 accumulators) in the FlashAttention-2
// schedule of attn_fwd_mma.cuh: one block per (sequence, head, 64-row query
// tile), 4 warps of 16 rows, the heaviest (causal: the last) query tiles
// launched first; Q as register fragments for the whole key loop; 64-key
// tiles of K and V staged with double-buffered cp.async and biased in place;
// the scores, the online softmax and P in registers, P fed to the second
// product straight from the first one's accumulators; no tile above the
// causal diagonal is loaded. The L x L scores never reach device or shared
// memory. Shared memory is fixed at 45 KB a block at d = 64, 55 KB at
// d = 80 and 85 KB at d = 128, whatever L is. wgmma, TMA and warp
// specialisation are the next step.
//
// Head widths: every mode is instantiated at d = 64, d = 80 (ViT-H/14) and
// d = 128 (Llama-3.1-8B, whose serving prefill runs the causal modes), the
// widths the wrapper's gate admits (vitef_tpu_torch/ops/attention.py
// packed_mha_supported), so no mode of an admitted width lacks its kernel.
// At d = 128 a thread holds 64 float32 of O, 32 registers of Q fragments
// and 32 of scores; the backward (csrc/packed_mha_bwd.cu) is not
// instantiated there, and the wrapper refuses a d = 128 call that wants a
// gradient.
//
// The key mask (serving's ragged prefill) is a compile-time flag. The masked
// instantiation reads a (N, L) byte mask, nonzero for a valid key, and gives
// a visible but masked key the finite scaled score -1e30, as the TPU kernel
// does, never -inf. A query row that sees no valid key (the leading rows of
// a left-padded prompt, or every row of an empty one) then averages the
// values of the keys it may see and stays finite: with -inf it would read
// 0/0 or -inf - -inf, and the NaN would reach the next layer's K/V of those
// pad slots, where 0 x NaN in P.V poisons every real row. Which finite
// average such a row gets differs between the TPU kernel's branches and this
// one; no real row reads it. The online softmax needs nothing else: a tile
// of only masked keys leaves the running max at -1e30, and the first valid
// key's rescale exp2(-1e30 - m) is exactly 0. With an all-true mask the
// masked instantiation computes bit for bit what the unmasked one does.
//
// C interface: packed_mha_fwd(qkv, bias, key_mask, out, lse, N, L, n_heads,
// head_dim, causal, stream) returns a cudaError_t as int: the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for a shape this kernel does
// not take (head_dim other than 64, 80 and 128 among them). key_mask (uint8,
// (N, L)) may be null for the unmasked kernel; lse may be null.

#include <cstdint>

#include "packed_mha_common.cuh"
#include "attn_fwd_mma.cuh"

namespace {

template <int D, bool kCausal, bool kMasked>
__global__ void __launch_bounds__(kAttnThreads)
packed_mha_fwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                      const uint8_t* __restrict__ key_mask, bf16* __restrict__ out,
                      float* __restrict__ lse, int L, int n_heads, float score_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = n_heads * D;
  const int F = 3 * E;
  const int n_tiles = (L + kAttnRows - 1) / kAttnRows;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles);  // longest first
  const int h = (blockIdx.x / n_tiles) % n_heads;
  const int n = blockIdx.x / (n_tiles * n_heads);
  const bf16* slab = qkv + static_cast<size_t>(n) * L * F + h * D;
  const bf16* head_bias = bias + h * D;
  const AttnHead head{slab, slab + E, slab + 2 * E, static_cast<size_t>(F),
                      head_bias, head_bias + E, head_bias + 2 * E,
                      out + static_cast<size_t>(n) * L * E + h * D, static_cast<size_t>(E),
                      lse == nullptr ? nullptr : lse + (static_cast<size_t>(n) * n_heads + h) * L,
                      kMasked ? key_mask + static_cast<size_t>(n) * L : nullptr};
  attn_fwd_tile<D, true, kCausal, kMasked>(head, L, tile * kAttnRows, score_scale, smem);
}

// The mode's kernel at head width D on `stream`.
template <int D>
cudaError_t launch(const bf16* qkv, const bf16* bias, const uint8_t* key_mask, bf16* out,
                   float* lse, int n, int L, int n_heads, bool causal, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>(n) * n_heads * ((L + kAttnRows - 1) / kAttnRows);
  const float score_scale = kLog2e / sqrtf(static_cast<float>(D));
  const auto kernel =
      causal ? (key_mask != nullptr ? packed_mha_fwd_kernel<D, true, true>
                                    : packed_mha_fwd_kernel<D, true, false>)
             : (key_mask != nullptr ? packed_mha_fwd_kernel<D, false, true>
                                    : packed_mha_fwd_kernel<D, false, false>);
  const cudaError_t err = allow_smem(kernel, kAttnSmemBytes<D>);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kAttnThreads, kAttnSmemBytes<D>, stream>>>(
      qkv, bias, key_mask, out, lse, L, n_heads, score_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int packed_mha_fwd(const void* qkv, const void* bias, const void* key_mask,
                              void* out, void* lse, int n, int L, int n_heads, int head_dim,
                              int causal, void* stream) {
  if ((head_dim != 64 && head_dim != 80 && head_dim != 128) || n <= 0 || L <= 0 ||
      n_heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto run = head_dim == 64 ? launch<64> : head_dim == 80 ? launch<80> : launch<128>;
  return static_cast<int>(run(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const uint8_t*>(key_mask), static_cast<bf16*>(out), static_cast<float*>(lse),
      n, L, n_heads, causal != 0, static_cast<cudaStream_t>(stream)));
}
