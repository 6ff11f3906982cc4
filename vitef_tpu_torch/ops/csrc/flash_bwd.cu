// Flash attention backward for Hopper (sm_90a): kernel K5.
//
// Replaces the TPU kernel vitef_tpu/ops/attention.py:_flash_bwd_kernel (:588,
// launched by _flash_bwd :645, call :656). The TPU takes that kernel only
// while two (h, L, L) float32 tensors fit its 10 MiB VMEM budget, and above
// it (Llama-1B at L=1024: 256 MiB) recomputes attention_reference in XLA and
// differentiates it (:668-674); both branches compute the same gradient. This
// kernel serves every L, so the backward of csrc/flash_fwd.cu (K4) never
// takes a plain version. For sequence n and head h, with Q, K, V, the
// cotangent G and the forward's output O (N, n_heads, L, d = 64), bfloat16 or
// float32, and P = softmax(Q K^T / sqrt(d)) (causal: key j is visible to
// query i iff j <= i):
//     dV = P^T G,  dP = G V^T,  dS = P * (dP - delta) / sqrt(d),
//     dQ = dS K,   dK = dS^T Q,  delta = rowsum(P * dP) = rowsum(G * O),
// the algebra of _flash_bwd_kernel (:604-638), with dq, dk, dv in the input
// type.
//
// It reads two residuals of the forward, O (for delta) and each row's
// log2-sum-exp (N, n_heads, L) float32, so no pass recomputes a row's softmax
// statistics and P is rebuilt tile by tile at any L.
//
// What bounds it on this card, and what the design does about it:
//   - Arithmetic. Per (sequence, head) the algebra is five L x L x d products
//     (causal: on the lower triangle); both passes below recompute the
//     scores and dP, so seven are done, all on the tensor cores. Causal,
//     nothing above the diagonal is loaded or computed, except inside the
//     diagonal tiles, where it is masked by index.
//   - Reductions across blocks. dK and dV sum over the query rows, and
//     Hopper's blocks run in no order. So there are two passes and no atomics,
//     which also makes two launches on the same inputs bit-identical: a dQ
//     pass, one block per (sequence, head, 64-row query tile), that writes dQ
//     and each row's (log2-sum-exp, delta) into the (N, n_heads, L) float2
//     scratch `stats`, then a dK/dV pass, one block per 64-key tile, that
//     reads them. The heaviest tiles are launched first in both passes; rows
//     past L get the statistics (+inf, 0), so their P and dS are 0.
//
// Both types run attn_bwd_mma.cuh's two passes on the head-major layout
// without a bias (64-row tiles of 4 warps, double-buffered cp.async, rows
// past L zero-filled; S, dP, P and dS in registers; dQ, dK and dV in
// registers):
//
// - bfloat16 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): K2/K3's core,
//   mma.sync m16n8k16 with float32 accumulators, 55 KB of shared memory a
//   block. P and dS are rounded to bfloat16 before their products, as the
//   TPU kernel rounds them (pb = p.astype(v.dtype), ds = (...).astype(q.dtype),
//   :616, :627); dS is formed from the float32 P.
// - float32 (flash_bwd_dq_tf32_kernel, flash_bwd_dkv_tf32_kernel): the same
//   schedule in split TF32, as K4's float32 forward (csrc/flash_fwd.cu): every
//   operand of all seven products, P and dS included, is split into TF32 hi
//   and lo, and each m16n8k8 product is lo.hi + hi.lo + hi.hi (mma_3xtf32),
//   so P and dS keep float32's accuracy. The bound is 3 TF32 products per
//   float32 product at 495 TFLOP/s, or the CUDA cores' 67, whichever is
//   less. P, dS, P^T and dS^T enter their second products as they lie in the
//   accumulators (the TF32 A layout is not the C layout), and the B operand
//   (rows of K, G or Q) is read at the rows the A index stands for. The A
//   operands that bf16 keeps as register fragments (Q and G, or K and V)
//   stay in shared memory and are split at each use: split, they would take
//   128 registers beside the 96-128 of the accumulators. Rows of 68 floats;
//   six tiles and the statistics are 103 KB a block, two blocks an SM.
//
// C interface:
//   flash_bwd(q, k, v, g, out, lse, dq, dk, dv, stats,
//             N, n_heads, L, head_dim, fp32, causal, stream)
// q, k, v, g, out, dq, dk and dv are (N, n_heads, L, head_dim), float32 when
// fp32 is set, else bfloat16; lse (N, n_heads, L) is float32; stats is
// float32 scratch of N * n_heads * L * 2. Returns a cudaError_t as int: the
// last launch's cudaGetLastError(), or cudaErrorInvalidValue for a shape this
// kernel does not take.

#include "packed_mha_common.cuh"
#include "attn_bwd_mma.cuh"

namespace {

static_assert(kAttnF32Dim == kFlashDim, "flash_bwd takes one head width");

// Head `head` (n * n_heads + h) of the head-major layout: every row 64
// contiguous bf16. A pass leaves the pointers it does not use null.
__device__ __forceinline__ AttnBwdHead flash_head(const bf16* q, const bf16* k, const bf16* v,
                                                  const bf16* g, const bf16* out,
                                                  const float* lse, float2* stats, bf16* dq,
                                                  bf16* dk, bf16* dv, size_t head, int L) {
  const size_t off = head * L * kFlashDim;
  const size_t row_off = head * L;
  return AttnBwdHead{q + off, k + off, v + off, kFlashDim,
                     nullptr, nullptr, nullptr,
                     g + off, out == nullptr ? nullptr : out + off, kFlashDim,
                     lse == nullptr ? nullptr : lse + row_off, stats + row_off,
                     dq == nullptr ? nullptr : dq + off, dk == nullptr ? nullptr : dk + off,
                     dv == nullptr ? nullptr : dv + off, kFlashDim};
}

// The same head in float32: rows of 64 contiguous floats.
__device__ __forceinline__ AttnBwdHeadF32 flash_head(const float* q, const float* k,
                                                     const float* v, const float* g,
                                                     const float* out, const float* lse,
                                                     float2* stats, float* dq, float* dk,
                                                     float* dv, size_t head, int L) {
  const size_t off = head * L * kFlashDim;
  const size_t row_off = head * L;
  return AttnBwdHeadF32{q + off, k + off, v + off, g + off,
                        out == nullptr ? nullptr : out + off,
                        lse == nullptr ? nullptr : lse + row_off, stats + row_off,
                        dq == nullptr ? nullptr : dq + off, dk == nullptr ? nullptr : dk + off,
                        dv == nullptr ? nullptr : dv + off};
}

// bfloat16, pass 1: dQ and the per-row statistics; the heaviest (causal:
// the last) query tiles first.
template <bool kCausal>
__global__ void __launch_bounds__(kAttnThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const bf16* __restrict__ out, const float* __restrict__ lse,
                    bf16* __restrict__ dq, float2* __restrict__ stats, int L, float scale,
                    float ds_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = (L + kAttnRows - 1) / kAttnRows;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles);
  const AttnBwdHead head = flash_head(q, k, v, g, out, lse, stats, dq, nullptr, nullptr,
                                      blockIdx.x / n_tiles, L);
  attn_bwd_dq_tile<kFlashDim, false, kCausal>(head, L, tile * kAttnRows, scale, ds_scale,
                                              smem);
}

// bfloat16, pass 2: dK and dV from the first pass's statistics; the
// heaviest (causal: the first) key tiles first.
template <bool kCausal>
__global__ void __launch_bounds__(kAttnThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     float2* __restrict__ stats, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int L, float scale, float ds_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = (L + kAttnKeys - 1) / kAttnKeys;
  const int tile = static_cast<int>(blockIdx.x % n_tiles);
  const AttnBwdHead head = flash_head(q, k, v, g, nullptr, nullptr, stats, nullptr, dk, dv,
                                      blockIdx.x / n_tiles, L);
  attn_bwd_dkv_tile<kFlashDim, false, kCausal>(head, L, tile * kAttnKeys, scale, ds_scale,
                                               smem);
}

// float32, pass 1, in split TF32; tiles in the order of flash_bwd_dq_kernel.
template <bool kCausal>
__global__ void __launch_bounds__(kAttnThreads)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ g,
                         const float* __restrict__ out, const float* __restrict__ lse,
                         float* __restrict__ dq, float2* __restrict__ stats, int L, float scale,
                         float ds_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = (L + kAttnRows - 1) / kAttnRows;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles);
  const AttnBwdHeadF32 head = flash_head(q, k, v, g, out, lse, stats, dq, nullptr, nullptr,
                                         blockIdx.x / n_tiles, L);
  attn_bwd_dq_tile_f32<kCausal>(head, L, tile * kAttnRows, scale, ds_scale, smem);
}

// float32, pass 2, in split TF32; tiles in the order of flash_bwd_dkv_kernel.
template <bool kCausal>
__global__ void __launch_bounds__(kAttnThreads)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ g,
                          float2* __restrict__ stats, float* __restrict__ dk,
                          float* __restrict__ dv, int L, float scale, float ds_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = (L + kAttnKeys - 1) / kAttnKeys;
  const int tile = static_cast<int>(blockIdx.x % n_tiles);
  const AttnBwdHeadF32 head = flash_head(q, k, v, g, nullptr, nullptr, stats, nullptr, dk, dv,
                                         blockIdx.x / n_tiles, L);
  attn_bwd_dkv_tile_f32<kCausal>(head, L, tile * kAttnKeys, scale, ds_scale, smem);
}

// The two passes in order on `stream`, each with `smem` bytes of dynamic
// shared memory, on operands of type T; returns the first launch error.
template <typename T, typename DqKernel, typename DkvKernel>
cudaError_t launch(DqKernel dq_kernel, DkvKernel dkv_kernel, size_t smem, const void* q,
                   const void* k, const void* v, const void* g, const void* out,
                   const float* lse, void* dq, void* dk, void* dv, float2* stats,
                   long long heads, int L, cudaStream_t stream) {
  const float scale = kLog2e / sqrtf(static_cast<float>(kFlashDim));
  const float ds_scale = 1.f / sqrtf(static_cast<float>(kFlashDim));
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  // query tiles = key tiles (kAttnRows == kAttnKeys)
  const unsigned blocks = static_cast<unsigned>(heads * ((L + kAttnRows - 1) / kAttnRows));
  cudaError_t err = allow_smem(dq_kernel, smem);
  if (err != cudaSuccess) return err;
  dq_kernel<<<blocks, kAttnThreads, smem, stream>>>(qp, kp, vp, gp, static_cast<const T*>(out),
                                                    lse, static_cast<T*>(dq), stats, L, scale,
                                                    ds_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = allow_smem(dkv_kernel, smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<blocks, kAttnThreads, smem, stream>>>(qp, kp, vp, gp, stats, static_cast<T*>(dk),
                                                     static_cast<T*>(dv), L, scale, ds_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* g,
                         const void* out, const void* lse, void* dq, void* dk, void* dv,
                         void* stats, int n, int n_heads, int L, int head_dim, int fp32,
                         int causal, void* stream) {
  if (head_dim != kFlashDim || n <= 0 || L <= 0 || n_heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long heads = static_cast<long long>(n) * n_heads;
  const float* lse_p = static_cast<const float*>(lse);
  float2* stats_p = static_cast<float2*>(stats);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) {
    return static_cast<int>(launch<float>(
        causal ? flash_bwd_dq_tf32_kernel<true> : flash_bwd_dq_tf32_kernel<false>,
        causal ? flash_bwd_dkv_tf32_kernel<true> : flash_bwd_dkv_tf32_kernel<false>,
        kAttnBwdF32SmemBytes, q, k, v, g, out, lse_p, dq, dk, dv, stats_p, heads, L, s));
  }
  return static_cast<int>(launch<bf16>(
      causal ? flash_bwd_dq_kernel<true> : flash_bwd_dq_kernel<false>,
      causal ? flash_bwd_dkv_kernel<true> : flash_bwd_dkv_kernel<false>,
      kAttnBwdSmemBytes<kFlashDim>, q, k, v, g, out, lse_p, dq, dk, dv, stats_p, heads, L, s));
}
