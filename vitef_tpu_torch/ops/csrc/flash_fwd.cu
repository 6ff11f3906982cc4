// Flash attention forward for Hopper (sm_90a): kernel K4.
//
// Replaces the TPU kernel vitef_tpu/ops/attention.py:_flash_kernel (:490,
// launched by _flash_forward :543, call :558). For sequence n and head h it
// computes
//     out[n, h] = softmax(Q K^T / sqrt(d) [+ causal mask]) V
// on q, k, v (N, n_heads, L, d = 64), contiguous, bfloat16 or float32. The
// TPU kernel pads L to a multiple of its 128-row blocks and masks keys past
// kv_len; this one takes any L and masks by index (the last tiles are
// partial). Scores, the running max and sum and the P.V accumulator are
// float32. With bfloat16 inputs P is rounded to bfloat16 before P.V, as the
// TPU kernel's p.astype(v.dtype) (:533-535) does, while the row sum adds the
// unrounded values; with float32 inputs everything is float32. On request it
// also writes each row's log2-sum-exp of the scaled scores (float32,
// (N, n_heads, L)), which the backward (csrc/flash_bwd.cu, K5) reads.
//
// What bounds it on this card: per sequence and head two L x L x d products
// (causal: on the lower triangle) and as many exponentials as scores, against
// 4 * N * n_heads * L * d elements of device memory: at the Llama-1B shape
// (N=4, h=32, L=1024, causal) 17.2 GFLOP against 67 MB, so a kernel that keeps
// the scores on chip is bound by its arithmetic. This one multiplies on the
// CUDA cores (FMA, not tensor cores), so arithmetic and shared-memory reads
// bound it.
//
// What the design does about it: K1's schedule (csrc/packed_mha_fwd.cu) on
// the head-major layout. One block per (sequence, head, 64-row query tile), 4
// warps, the heaviest (causal: the last) query tiles launched first. It walks
// 64-key tiles of K and V staged in shared memory, up to and including the
// diagonal tile when causal, so nothing above the diagonal is loaded, and
// masks by index inside the diagonal and the last tile. A warp owns one query
// row at a time: each lane scores two keys, the row's max and sum are warp
// reductions, the tile's probabilities sit in a per-warp shared row and each
// lane accumulates two output columns of P.V in a float32 accumulator in
// shared memory. Shared memory is fixed whatever L is: about 51 KB (bf16),
// 68 KB (float32). Tensor cores (wgmma) and TMA are later work.
//
// C interface: flash_fwd(q, k, v, out, lse, N, n_heads, L, head_dim, fp32,
// causal, stream) returns a cudaError_t as int: the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for a shape this kernel does
// not take. fp32 selects float32 inputs and output (else bfloat16); lse may
// be null.

#include "flash_common.cuh"

namespace {

constexpr int kQTile = 64;                 // query rows per block
constexpr int kTile = 64;                  // keys per staged tile

// Dynamic shared memory of one block: K and V tiles (padded rows), the query
// rows (scaled, float32), the output accumulators, a probability row per
// warp, and each query row's running max and sum.
template <typename T>
constexpr size_t smem_bytes() {
  return 2 * kTile * kKStride * sizeof(T) + 2 * kQTile * kHeadDim * sizeof(float) +
         kWarps * kTile * sizeof(float) + 2 * kQTile * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int L, int causal,
                 float score_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kTile * kKStride;
  float* qs = reinterpret_cast<float*>(vs + kTile * kKStride);
  float* acc = qs + kQTile * kHeadDim;
  float* probs = acc + kQTile * kHeadDim;
  float* row_m = probs + kWarps * kTile;
  float* row_l = row_m + kQTile;

  const int n_tiles = (L + kQTile - 1) / kQTile;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles);  // longest first
  const size_t head = blockIdx.x / n_tiles;                              // n * n_heads + h
  const size_t head_off = head * L * kHeadDim;
  const T* qh = q + head_off;
  const T* kh = k + head_off;
  const T* vh = v + head_off;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = tile * kQTile;
  const int rows = min(kQTile, L - q0);

  // The tile's query rows, scaled by log2(e)/sqrt(d). Warp w owns rows
  // w, w + kWarps, ... here and below.
  for (int r = warp; r < rows; r += kWarps) {
    const float2 x = Elem<T>::load2(qh + static_cast<size_t>(q0 + r) * kHeadDim + 2 * lane);
    reinterpret_cast<float2*>(qs + r * kHeadDim)[lane] =
        make_float2(x.x * score_scale, x.y * score_scale);
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
    stage_rows(kh, k0, klen, ks);
    stage_rows(vh, k0, klen, vs);
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps) {
      // Keys k0 .. k0 + lim - 1 are visible to query row q0 + r; lim >= 1,
      // since a causal tile starts at or before q0.
      const int lim = causal ? min(klen, q0 + r - k0 + 1) : klen;
      float x[kHeadDim];
      load_row(qs + r * kHeadDim, x);
      float s0 = -INFINITY, s1 = -INFINITY;
      if (lane < lim) s0 = dot_row_t(x, ks + lane * kKStride);
      if (lane + 32 < lim) s1 = dot_row_t(x, ks + (lane + 32) * kKStride);

      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float alpha = exp2f(m_old - m_new);  // 0 on the row's first tile
      const float p0 = exp2f(s0 - m_new);        // 0 for a masked key
      const float p1 = exp2f(s1 - m_new);
      p[lane] = Elem<T>::round_p(p0);
      p[lane + 32] = Elem<T>::round_p(p1);
      const float l_new = row_l[r] * alpha + warp_sum(p0 + p1);
      __syncwarp();  // every lane's probabilities are visible to the whole warp

      // P.V into the row's accumulator: lane owns columns 2*lane, 2*lane + 1.
      float2* arow = reinterpret_cast<float2*>(acc + r * kHeadDim);
      const float2 a = arow[lane];
      const float2 pv = weighted_rows_t(p, vs, lim, lane);
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
    Elem<T>::store2(out + head_off + static_cast<size_t>(q0 + r) * kHeadDim + 2 * lane,
                    a.x * inv, a.y * inv);
    if (lse != nullptr && lane == 0) {
      lse[head * L + q0 + r] = row_m[r] + log2f(row_l[r]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   long long blocks, int L, int causal, float score_scale, cudaStream_t s) {
  const cudaError_t err = allow_smem(flash_fwd_kernel<T>, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem_bytes<T>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, L, causal, score_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         int n, int n_heads, int L, int head_dim, int fp32, int causal,
                         void* stream) {
  if (head_dim != kHeadDim || n <= 0 || L <= 0 || n_heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks =
      static_cast<long long>(n) * n_heads * ((L + kQTile - 1) / kQTile);
  const float score_scale = kLog2e / sqrtf(static_cast<float>(kHeadDim));
  const auto run = fp32 ? launch<float> : launch<bf16>;
  return static_cast<int>(run(q, k, v, out, static_cast<float*>(lse), blocks, L, causal,
                              score_scale, static_cast<cudaStream_t>(stream)));
}
