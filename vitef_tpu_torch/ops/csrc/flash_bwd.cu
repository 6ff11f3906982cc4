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
//     (causal: on the lower triangle); both types recompute the scores and dP
//     in both passes below, so they do seven. Causal, nothing above the
//     diagonal is loaded or computed, except inside the diagonal tiles, where
//     it is masked by index.
//   - Reductions across blocks. dK and dV sum over the query rows, and
//     Hopper's blocks run in no order. So there are two passes and no atomics,
//     which also makes two launches on the same inputs bit-identical: a dQ
//     pass, one block per (sequence, head, 64-row query tile), that writes dQ
//     and each row's (log2-sum-exp, delta) into the (N, n_heads, L) float2
//     scratch `stats`, then a dK/dV pass over key tiles that reads them.
//
// bfloat16 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel) runs all seven
// products on the tensor cores: K2/K3's core, attn_bwd_mma.cuh, on the
// head-major layout without a bias (mma.sync m16n8k16, float32
// accumulators; 64-row tiles of 4 warps, double-buffered cp.async; S, dP, P
// and dS in registers; dQ, dK and dV in registers; the heaviest tiles
// launched first; 55 KB of shared memory a block). P and dS are rounded to
// bfloat16 before their products, as the TPU kernel rounds them
// (pb = p.astype(v.dtype), ds = (...).astype(q.dtype), :616, :627); dS is
// formed from the float32 P.
//
// float32 (flash_dq_kernel, flash_dkv_kernel) stays on the CUDA cores (FMA)
// in full float32:
//   (a) flash_dq_kernel, one block per (sequence, head, 64-row query tile):
//       it walks the 64-key tiles (causal: up to and including the diagonal
//       one) staged in shared memory, and for each of its rows rebuilds P
//       from the forward's log2-sum-exp, dP = G V^T and dS, and accumulates
//       dQ = dS K in shared memory (84 KB a block, whatever L is);
//   (b) flash_dkv_kernel, one block per (sequence, head, 32-key tile), a
//       lane per key with that key's K and V rows in registers: it walks the
//       query rows (causal: only those at or after its first key) in chunks
//       staged in shared memory, rebuilds P and dS for its keys from (a)'s
//       statistics, and accumulates dK and dV in registers.
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

static_assert(kAttnDim == kHeadDim, "flash_bwd takes one head width");

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core core of attn_bwd_mma.cuh
// ---------------------------------------------------------------------------

// Head `head` (n * n_heads + h) of the head-major layout: every row 64
// contiguous bf16. A pass leaves the pointers it does not use null.
__device__ __forceinline__ AttnBwdHead flash_head(const bf16* q, const bf16* k, const bf16* v,
                                                  const bf16* g, const bf16* out,
                                                  const float* lse, float2* stats, bf16* dq,
                                                  bf16* dk, bf16* dv, size_t head, int L) {
  const size_t off = head * L * kAttnDim;
  const size_t row_off = head * L;
  return AttnBwdHead{q + off, k + off, v + off, kAttnDim,
                     nullptr, nullptr, nullptr,
                     g + off, out == nullptr ? nullptr : out + off, kAttnDim,
                     lse == nullptr ? nullptr : lse + row_off, stats + row_off,
                     dq == nullptr ? nullptr : dq + off, dk == nullptr ? nullptr : dk + off,
                     dv == nullptr ? nullptr : dv + off, kAttnDim};
}

// dQ and the per-row statistics; the heaviest (causal: the last) query
// tiles first.
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
  attn_bwd_dq_tile<false, kCausal>(head, L, tile * kAttnRows, scale, ds_scale, smem);
}

// dK and dV from the first pass's statistics; the heaviest (causal: the
// first) key tiles first.
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
  attn_bwd_dkv_tile<false, kCausal>(head, L, tile * kAttnKeys, scale, ds_scale, smem);
}

// The two passes in order on `stream`; returns the first launch error.
template <bool kCausal>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* g,
                        const void* out, const float* lse, void* dq, void* dk, void* dv,
                        float2* stats, long long heads, int L, cudaStream_t stream) {
  const float scale = kLog2e / sqrtf(static_cast<float>(kAttnDim));
  const float ds_scale = 1.f / sqrtf(static_cast<float>(kAttnDim));
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(g);
  // query tiles = key tiles (kAttnRows == kAttnKeys)
  const unsigned blocks = static_cast<unsigned>(heads * ((L + kAttnRows - 1) / kAttnRows));
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<kCausal>, kAttnBwdSmemBytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<kCausal><<<blocks, kAttnThreads, kAttnBwdSmemBytes, stream>>>(
      qp, kp, vp, gp, static_cast<const bf16*>(out), lse, static_cast<bf16*>(dq), stats, L,
      scale, ds_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = allow_smem(flash_bwd_dkv_kernel<kCausal>, kAttnBwdSmemBytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<kCausal><<<blocks, kAttnThreads, kAttnBwdSmemBytes, stream>>>(
      qp, kp, vp, gp, stats, static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, scale,
      ds_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTile = 64;       // query rows per block of the dq pass, and keys per staged tile
constexpr int kKTile = 32;      // keys per block of flash_dkv_kernel (a lane each)
constexpr int kQChunk = 32;     // query rows staged per step of flash_dkv_kernel
constexpr int kColsPerWarp = kHeadDim / kWarps;  // dK / dV columns a thread owns

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Eight floats at a 16-byte aligned address.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Stage rows j0 .. j0 + count - 1 of one head (a contiguous L x kHeadDim
// block) into padded shared rows of kKStride floats: warp w copies rows
// w, w + kWarps, ..., each as 32 coalesced pairs (the lane's pair). The
// stride of 66 floats puts the rows 66 words apart, so the lanes of a warp,
// each reading its own row, hit different pairs of banks.
__device__ __forceinline__ void stage_rows(const float* head, int j0, int count, float* dst) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int j = warp; j < count; j += kWarps) {
    const float2 x = load2(head + static_cast<size_t>(j0 + j) * kHeadDim + 2 * lane);
    store2(dst + static_cast<size_t>(j) * kKStride + 2 * lane, x.x, x.y);
  }
}

// The dot product of a row held in registers with a staged row.
__device__ __forceinline__ float dot_row(const float* x, const float* row) {
  float sx = 0.f, sy = 0.f;
#pragma unroll
  for (int c = 0; c < kHeadDim / 2; ++c) {
    const float2 k = load2(row + 2 * c);
    sx = fmaf(x[2 * c], k.x, sx);
    sy = fmaf(x[2 * c + 1], k.y, sy);
  }
  return sx + sy;
}

// The sum over j < count of w[j] times column pair `pair` of staged row j:
// even and odd j in two partial sums.
__device__ __forceinline__ float2 weighted_rows(const float* w, const float* rows, int count,
                                                int pair) {
  float ax = 0.f, ay = 0.f, bx = 0.f, by = 0.f;
  int j = 0;
  for (; j + 1 < count; j += 2) {
    const float w0 = w[j], w1 = w[j + 1];
    const float2 r0 = load2(rows + static_cast<size_t>(j) * kKStride + 2 * pair);
    const float2 r1 = load2(rows + static_cast<size_t>(j + 1) * kKStride + 2 * pair);
    ax = fmaf(w0, r0.x, ax);
    ay = fmaf(w0, r0.y, ay);
    bx = fmaf(w1, r1.x, bx);
    by = fmaf(w1, r1.y, by);
  }
  if (j < count) {
    const float w0 = w[j];
    const float2 r0 = load2(rows + static_cast<size_t>(j) * kKStride + 2 * pair);
    ax = fmaf(w0, r0.x, ax);
    ay = fmaf(w0, r0.y, ay);
  }
  return make_float2(ax + bx, ay + by);
}

// Dynamic shared memory of one flash_dq_kernel block: K and V tiles (padded
// rows); the query rows (scaled), cotangent rows and dQ accumulators of the
// block's query tile; a dS row per warp; each row's statistics.
constexpr size_t kDqSmemBytes = (2 * kTile * kKStride + 3 * kTile * kHeadDim + kWarps * kTile) *
                                    sizeof(float) + kTile * sizeof(float2);

// (a) dQ and the per-row statistics (log2-sum-exp of the scaled scores, and
// delta = G . O).
template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ g,
                const float* __restrict__ out, const float* __restrict__ lse,
                float* __restrict__ dq, float2* __restrict__ stats, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kTile * kKStride;
  float* qs = vs + kTile * kKStride;
  float* gs = qs + kTile * kHeadDim;
  float* acc = gs + kTile * kHeadDim;
  float* dsb = acc + kTile * kHeadDim;
  float2* row_stats = reinterpret_cast<float2*>(dsb + kWarps * kTile);

  const int n_tiles = (L + kTile - 1) / kTile;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x % n_tiles);  // longest first
  const size_t head = blockIdx.x / n_tiles;                              // n * n_heads + h
  const size_t head_off = head * L * kHeadDim;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = tile * kTile;
  const int rows = min(kTile, L - q0);
  const float score_scale = kLog2e / sqrtf(static_cast<float>(kHeadDim));
  const float sm_scale = 1.f / sqrtf(static_cast<float>(kHeadDim));

  // The tile's rows: Q scaled by log2(e)/sqrt(d), G, zeroed dQ accumulators,
  // and the statistics (log2-sum-exp from the forward, delta = G . O). Warp w
  // owns rows w, w + kWarps, ... here and below.
  for (int r = warp; r < rows; r += kWarps) {
    const size_t row = head_off + static_cast<size_t>(q0 + r) * kHeadDim + 2 * lane;
    const float2 x = load2(q + row);
    const float2 gv = load2(g + row);
    const float2 o = load2(out + row);
    reinterpret_cast<float2*>(qs + r * kHeadDim)[lane] =
        make_float2(x.x * score_scale, x.y * score_scale);
    reinterpret_cast<float2*>(gs + r * kHeadDim)[lane] = gv;
    reinterpret_cast<float2*>(acc + r * kHeadDim)[lane] = make_float2(0.f, 0.f);
    const float delta = warp_sum(fmaf(gv.x, o.x, gv.y * o.y));
    if (lane == 0) {
      const float2 st = make_float2(lse[head * L + q0 + r], delta);
      row_stats[r] = st;
      stats[head * L + q0 + r] = st;
    }
  }

  float* ds = dsb + warp * kTile;
  const int kv_end = kCausal ? q0 + rows : L;  // the keys a row of this tile may see
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    const int klen = min(kTile, kv_end - k0);
    __syncthreads();  // the previous tile has been read by every warp
    stage_rows(k + head_off, k0, klen, ks);
    stage_rows(v + head_off, k0, klen, vs);
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps) {
      // Keys k0 .. k0 + lim - 1 are visible to query row q0 + r; lim >= 1,
      // since a causal tile starts at or before q0.
      const int lim = kCausal ? min(klen, q0 + r - k0 + 1) : klen;
      const float2 st = row_stats[r];
      float x[kHeadDim];
      load_row(qs + r * kHeadDim, x);
      float p0 = 0.f, p1 = 0.f;
      if (lane < lim) p0 = exp2f(dot_row(x, ks + lane * kKStride) - st.x);
      if (lane + 32 < lim) p1 = exp2f(dot_row(x, ks + (lane + 32) * kKStride) - st.x);
      load_row(gs + r * kHeadDim, x);
      float dp0 = 0.f, dp1 = 0.f;
      if (lane < lim) dp0 = dot_row(x, vs + lane * kKStride);
      if (lane + 32 < lim) dp1 = dot_row(x, vs + (lane + 32) * kKStride);
      ds[lane] = p0 * (dp0 - st.y) * sm_scale;
      ds[lane + 32] = p1 * (dp1 - st.y) * sm_scale;
      __syncwarp();  // every lane's dS is visible to the whole warp

      // dQ += dS K: lane owns columns 2*lane and 2*lane + 1.
      float2* arow = reinterpret_cast<float2*>(acc + r * kHeadDim);
      const float2 a = arow[lane];
      const float2 d = weighted_rows(ds, ks, lim, lane);
      arow[lane] = make_float2(a.x + d.x, a.y + d.y);
      __syncwarp();  // the next row may overwrite ds only after every lane read it
    }
  }

  for (int r = warp; r < rows; r += kWarps) {
    const float2 a = reinterpret_cast<const float2*>(acc + r * kHeadDim)[lane];
    store2(dq + head_off + static_cast<size_t>(q0 + r) * kHeadDim + 2 * lane, a.x, a.y);
  }
}

// (b) dK and dV. Lane = key of the tile; warp w takes the query rows
// i = w (mod kWarps) of each staged chunk when it builds P and dS, and owns
// columns [w * kColsPerWarp, (w + 1) * kColsPerWarp) of dK and dV.
template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ g,
                 const float2* __restrict__ stats, float* __restrict__ dk_out,
                 float* __restrict__ dv_out, int L) {
  __shared__ __align__(16) float qs[kQChunk][kHeadDim];
  __shared__ __align__(16) float gs[kQChunk][kHeadDim];
  __shared__ float2 st[kQChunk];
  __shared__ float ps[kQChunk][kKTile];
  __shared__ float dss[kQChunk][kKTile];

  const int n_tiles = (L + kKTile - 1) / kKTile;
  const int tile = blockIdx.x % n_tiles;
  const size_t head = blockIdx.x / n_tiles;                              // n * n_heads + h
  const size_t head_off = head * L * kHeadDim;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = tile * kKTile + lane;
  const bool valid = j < L;
  const float* qh = q + head_off;
  const float* gh = g + head_off;
  const float2* row_stats = stats + head * L;
  const float score_scale = kLog2e / sqrtf(static_cast<float>(kHeadDim));
  const float sm_scale = 1.f / sqrtf(static_cast<float>(kHeadDim));

  // This lane's key and value rows (zeros past L: that lane writes nothing).
  float2 kr[kHeadDim / 2], vr[kHeadDim / 2];
#pragma unroll
  for (int c = 0; c < kHeadDim / 2; ++c) {
    float2 kx = make_float2(0.f, 0.f), vx = make_float2(0.f, 0.f);
    if (valid) {
      kx = load2(k + head_off + static_cast<size_t>(j) * kHeadDim + 2 * c);
      vx = load2(v + head_off + static_cast<size_t>(j) * kHeadDim + 2 * c);
    }
    kr[c] = kx;
    vr[c] = vx;
  }

  float dk[kColsPerWarp], dv[kColsPerWarp];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c) dk[c] = dv[c] = 0.f;
  const int c0 = warp * kColsPerWarp;

  // Causal: query rows before the tile's first key see none of its keys
  // (kQChunk == kKTile, so the first chunk is the diagonal one).
  const int i_begin = kCausal ? tile * kKTile : 0;
  for (int i0 = i_begin; i0 < L; i0 += kQChunk) {
    const int rows = min(kQChunk, L - i0);
    __syncthreads();  // the previous chunk has been read by every thread
    // Stage the chunk's query rows, cotangent rows and statistics: 8 columns
    // per thread and step.
    for (int idx = threadIdx.x; idx < rows * (kHeadDim / 8); idx += kThreads) {
      const int r = idx / (kHeadDim / 8);
      const int part = idx % (kHeadDim / 8);
      const size_t i = static_cast<size_t>(i0 + r);
      float4* qd = reinterpret_cast<float4*>(&qs[r][part * 8]);
      float4* gd = reinterpret_cast<float4*>(&gs[r][part * 8]);
      const float4* qsrc = reinterpret_cast<const float4*>(qh + i * kHeadDim + part * 8);
      const float4* gsrc = reinterpret_cast<const float4*>(gh + i * kHeadDim + part * 8);
      qd[0] = qsrc[0];
      qd[1] = qsrc[1];
      gd[0] = gsrc[0];
      gd[1] = gsrc[1];
    }
    if (threadIdx.x < rows) st[threadIdx.x] = row_stats[i0 + threadIdx.x];
    __syncthreads();

    // P and dS of this lane's key for rows warp, warp + kWarps, ...
    for (int r = warp; r < rows; r += kWarps) {
      float sx = 0.f, sy = 0.f, dx = 0.f, dy = 0.f;
#pragma unroll
      for (int w = 0; w < kHeadDim / 8; ++w) {
        float qf[8], gf[8];
        load8(&qs[r][8 * w], qf);
        load8(&gs[r][8 * w], gf);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 kx = kr[4 * w + e];
          const float2 vx = vr[4 * w + e];
          sx = fmaf(qf[2 * e], kx.x, sx);
          sy = fmaf(qf[2 * e + 1], kx.y, sy);
          dx = fmaf(gf[2 * e], vx.x, dx);
          dy = fmaf(gf[2 * e + 1], vx.y, dy);
        }
      }
      const float2 rs = st[r];
      float pij = exp2f((sx + sy) * score_scale - rs.x);
      float dsij = pij * ((dx + dy) - rs.y) * sm_scale;
      if (kCausal && j > i0 + r) pij = dsij = 0.f;  // key after the query row
      ps[r][lane] = pij;
      dss[r][lane] = dsij;
    }
    __syncthreads();

    // dV[j] += P[i, j] G[i], dK[j] += dS[i, j] Q[i] over the chunk's rows.
    for (int r = 0; r < rows; ++r) {
      const float pij = ps[r][lane];
      const float dsij = dss[r][lane];
#pragma unroll
      for (int w = 0; w < kColsPerWarp / 8; ++w) {
        float qf[8], gf[8];
        load8(&qs[r][c0 + 8 * w], qf);
        load8(&gs[r][c0 + 8 * w], gf);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dv[8 * w + e] = fmaf(pij, gf[e], dv[8 * w + e]);
          dk[8 * w + e] = fmaf(dsij, qf[e], dk[8 * w + e]);
        }
      }
    }
  }

  if (valid) {
    const size_t row = head_off + static_cast<size_t>(j) * kHeadDim + c0;
#pragma unroll
    for (int c = 0; c < kColsPerWarp / 2; ++c) {
      store2(dk_out + row + 2 * c, dk[2 * c], dk[2 * c + 1]);
      store2(dv_out + row + 2 * c, dv[2 * c], dv[2 * c + 1]);
    }
  }
}

// The two passes in order on `stream`; returns the first launch error.
template <bool kCausal>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* g,
                       const void* out, const float* lse, void* dq, void* dk, void* dv,
                       float2* stats, long long heads, int L, cudaStream_t stream) {
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* gp = static_cast<const float*>(g);
  cudaError_t err = allow_smem(flash_dq_kernel<kCausal>, kDqSmemBytes);
  if (err != cudaSuccess) return err;
  const long long q_blocks = heads * ((L + kTile - 1) / kTile);
  flash_dq_kernel<kCausal><<<static_cast<unsigned>(q_blocks), kThreads, kDqSmemBytes, stream>>>(
      qp, kp, vp, gp, static_cast<const float*>(out), lse, static_cast<float*>(dq), stats, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long k_blocks = heads * ((L + kKTile - 1) / kKTile);
  flash_dkv_kernel<kCausal><<<static_cast<unsigned>(k_blocks), kThreads, 0, stream>>>(
      qp, kp, vp, gp, stats, static_cast<float*>(dk), static_cast<float*>(dv), L);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* g,
                         const void* out, const void* lse, void* dq, void* dk, void* dv,
                         void* stats, int n, int n_heads, int L, int head_dim, int fp32,
                         int causal, void* stream) {
  if (head_dim != kHeadDim || n <= 0 || L <= 0 || n_heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto run = fp32 ? (causal ? launch_f32<true> : launch_f32<false>)
                        : (causal ? launch_bf16<true> : launch_bf16<false>);
  return static_cast<int>(run(q, k, v, g, out, static_cast<const float*>(lse), dq, dk, dv,
                              static_cast<float2*>(stats), static_cast<long long>(n) * n_heads,
                              L, static_cast<cudaStream_t>(stream)));
}
