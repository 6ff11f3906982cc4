// One ring-attention hop for Hopper (sm_90a): kernel K9.
//
// Replaces the TPU kernel vitef_tpu/parallel/sequence.py:_hop_state_kernel
// (:166, launched by _hop_pallas_call :209, call :228). It folds one visiting
// K/V block into the online-softmax state of a query block: for sequence n,
// head h and query row i, over the keys j of the block,
//     score_ij = scale * q_i . k_j             (masked: kpos_j > qpos_i, causal)
//     m'       = max(m_i, max_j score_ij)
//     p_ij     = exp(score_ij - m')            (0 where masked)
//     corr     = exp(m_i - m')
//     s'       = s_i * corr + sum_j p_ij
//     acc'     = acc_i * corr + sum_j round(p_ij) v_j
// with float32 scores, statistics and accumulator. round() is the rounding
// of p to the input type (bfloat16 or float16) before P.V, as the TPU
// kernel's p.astype(v.dtype) (:197-199) does; the row sum adds the unrounded
// values. A masked score is the finite -1e30 and its probability is zeroed,
// so a block that no key of a row may see leaves that row's state exactly
// as it was, whatever the state (the -1e30 start included). Masking is by
// the global position vectors qpos (lq) and kpos (lk), never by an assumed
// diagonal, so any layout of rows onto ranks is right.
//
// Where the TPU kernel covers its block only for lq <= 256 or a multiple of
// 256 and lk <= 512 or a multiple of 512 (its grid and key loop round
// down, :213-215, :202-203), this one takes every lq and lk: the last query
// and key tiles are partial and masked by index.
//
// Operands: q (N, h, lq, d) and k, v (N, h, lk, d) in bfloat16 or float16,
// each row contiguous but the sequence, head and row strides free (in
// elements, even), so a zigzag segment or a head view of the qkv
// projection is read in place; qpos, kpos int32; the state m, s (N, h, lq)
// and acc (N, h, lq, d) float32, contiguous. The new state is written to
// separate tensors (the ring's backward replays each hop from its inputs).
//
// What bounds it on this card: per (sequence, head) two lq x lk x d products
// and lq * lk exponentials, against the bytes of q, k, v and the float32
// state read and written once: at a ring hop of N=1, h=12, lq=lk=1024, d=64
// 3.2 GFLOP against 11.2 MB, so a kernel on the tensor cores would be bound
// by its bytes (3.3 us at 3.35 TB/s). This one multiplies on the CUDA cores
// (FMA), so its arithmetic and shared-memory reads bound it.
//
// What the design does about it: the schedule of K4 (csrc/flash_fwd.cu) with
// the state as input and output. One block per (sequence, head, 64-row
// query tile), 4 warps. The state of the tile's rows is read once into
// shared memory and written once at the end. The block walks 64-key tiles of
// K and V staged in shared memory; under the causal mask a tile with no key
// visible to any row of the block is skipped (it would change no state). A
// warp owns one query row at a time: each lane scores two keys, the row's
// max and sum are warp reductions, the tile's probabilities sit in a
// per-warp shared row and each lane accumulates d/32 output columns of P.V.
// Instantiated for d = 64 and d = 128; shared memory about 51 KB (d = 64)
// and 99 KB (d = 128) per block. Tensor cores (mma.sync, wgmma) are later
// work.
//
// C interface: ring_hop(q, k, v, qpos, kpos, m_in, s_in, acc_in, m_out,
// s_out, acc_out, N, h, lq, lk, d, fp16, causal, q strides (n, h, row),
// k strides, v strides, scale, stream) returns a cudaError_t as int: the
// launch's cudaGetLastError(), or cudaErrorInvalidValue for a shape this
// kernel does not take. fp16 selects float16 inputs (else bfloat16).

#include <cuda_fp16.h>

#include <climits>

#include "packed_mha_common.cuh"

namespace {

constexpr int kRows = 64;                  // query rows per block
constexpr int kKeys = 64;                  // keys per staged tile
constexpr float kMasked = -1e30f;          // the score of a masked key

struct Strides {
  long long n, h, row;                     // elements between sequences, heads, rows
};

struct HopArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* qpos;
  const int* kpos;
  const float* m_in;
  const float* s_in;
  const float* acc_in;
  float* m_out;
  float* s_out;
  float* acc_out;
  int heads, lq, lk, causal;
  Strides sq, sk, sv;
  float scale;
};

// How a pair of neighbouring elements of each input type is read as floats,
// and the rounding that P.V sees.
template <typename T>
struct Pair;

template <>
struct Pair<bf16> {
  __device__ __forceinline__ static float2 load(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ __forceinline__ static float round(float x) { return round_bf16(x); }
};

template <>
struct Pair<__half> {
  __device__ __forceinline__ static float2 load(const __half* p) {
    return __half22float2(*reinterpret_cast<const __half2*>(p));
  }
  __device__ __forceinline__ static float round(float x) {
    return __half2float(__float2half_rn(x));
  }
};

// Elements per staged K or V row: two more than d, so that rows are an odd
// number of 4-byte words apart and the lanes of a warp, each reading its
// own row, hit different banks.
template <int D>
__host__ __device__ constexpr int staged_stride() {
  return D + 2;
}

// Dynamic shared memory of one block: K and V tiles, the query rows (scaled,
// float32), the state's accumulator rows, a probability row per warp, the
// rows' running max and sum, and the rows' and keys' positions.
template <typename T, int D>
constexpr size_t smem_bytes() {
  return 2 * kKeys * staged_stride<D>() * sizeof(T) + 2 * kRows * D * sizeof(float) +
         kWarps * kKeys * sizeof(float) + 2 * kRows * sizeof(float) +
         (kRows + kKeys) * sizeof(int);
}

// Stage rows j0 .. j0 + count - 1 of one head (row stride `row` elements)
// into padded shared rows, as 4-byte pairs: warp w copies rows w, w + kWarps,
// ..., its lanes on neighbouring pairs.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* head, long long row, int j0, int count,
                                           T* dst) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int j = warp; j < count; j += kWarps) {
    const unsigned* src = reinterpret_cast<const unsigned*>(head + (j0 + j) * row);
    unsigned* out = reinterpret_cast<unsigned*>(dst + j * staged_stride<D>());
#pragma unroll
    for (int c = lane; c < D / 2; c += 32) out[c] = src[c];
  }
}

// The dot product of a float row held in registers with a staged row, in
// two interleaved partial sums.
template <typename T, int D>
__device__ __forceinline__ float dot_row(const float* x, const T* row) {
  float sx = 0.f, sy = 0.f;
#pragma unroll
  for (int c = 0; c < D / 2; ++c) {
    const float2 k = Pair<T>::load(row + 2 * c);
    sx = fmaf(x[2 * c], k.x, sx);
    sy = fmaf(x[2 * c + 1], k.y, sy);
  }
  return sx + sy;
}

// The sum over j < count of w[j] times the lane's column pairs (lane, lane +
// 32, ...) of staged row j, in float32: even and odd j in two partial sums.
template <typename T, int D>
__device__ __forceinline__ void weighted_rows(const float* w, const T* rows, int count, int lane,
                                              float2* out) {
  constexpr int kLanePairs = D / 64;
  constexpr int kStride = staged_stride<D>();
  float2 a[kLanePairs], b[kLanePairs];
#pragma unroll
  for (int i = 0; i < kLanePairs; ++i) a[i] = b[i] = make_float2(0.f, 0.f);
  int j = 0;
  for (; j + 1 < count; j += 2) {
    const float w0 = w[j], w1 = w[j + 1];
#pragma unroll
    for (int i = 0; i < kLanePairs; ++i) {
      const int col = 2 * (lane + 32 * i);
      const float2 r0 = Pair<T>::load(rows + j * kStride + col);
      const float2 r1 = Pair<T>::load(rows + (j + 1) * kStride + col);
      a[i].x = fmaf(w0, r0.x, a[i].x);
      a[i].y = fmaf(w0, r0.y, a[i].y);
      b[i].x = fmaf(w1, r1.x, b[i].x);
      b[i].y = fmaf(w1, r1.y, b[i].y);
    }
  }
  if (j < count) {
    const float w0 = w[j];
#pragma unroll
    for (int i = 0; i < kLanePairs; ++i) {
      const float2 r0 = Pair<T>::load(rows + j * kStride + 2 * (lane + 32 * i));
      a[i].x = fmaf(w0, r0.x, a[i].x);
      a[i].y = fmaf(w0, r0.y, a[i].y);
    }
  }
#pragma unroll
  for (int i = 0; i < kLanePairs; ++i) out[i] = make_float2(a[i].x + b[i].x, a[i].y + b[i].y);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) ring_hop_kernel(HopArgs a) {
  constexpr int kStride = staged_stride<D>();
  constexpr int kLanePairs = D / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kKeys * kStride;
  float* qs = reinterpret_cast<float*>(vs + kKeys * kStride);
  float* acc = qs + kRows * D;
  float* probs = acc + kRows * D;
  float* row_m = probs + kWarps * kKeys;
  float* row_s = row_m + kRows;
  int* qp = reinterpret_cast<int*>(row_s + kRows);
  int* kp = qp + kRows;
  __shared__ int q_last;                   // the largest query position of the block

  const int n_tiles = (a.lq + kRows - 1) / kRows;
  const int tile = static_cast<int>(blockIdx.x % n_tiles);
  const long long head = blockIdx.x / n_tiles;  // sequence * heads + head
  const long long seq = head / a.heads, hd = head % a.heads;
  const T* qh = static_cast<const T*>(a.q) + seq * a.sq.n + hd * a.sq.h;
  const T* kh = static_cast<const T*>(a.k) + seq * a.sk.n + hd * a.sk.h;
  const T* vh = static_cast<const T*>(a.v) + seq * a.sv.n + hd * a.sv.h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = tile * kRows;
  const int rows = min(kRows, a.lq - q0);
  const long long state_row = head * a.lq + q0;  // the tile's first row of m, s, acc

  if (threadIdx.x == 0) q_last = INT_MIN;
  __syncthreads();
  if (threadIdx.x < rows) {
    const int pos = a.qpos[q0 + threadIdx.x];
    qp[threadIdx.x] = pos;
    atomicMax(&q_last, pos);
  }
  // The tile's query rows, scaled, and its incoming state. Warp w owns rows
  // w, w + kWarps, ... here and below.
  for (int r = warp; r < rows; r += kWarps) {
    const T* qrow = qh + (q0 + r) * a.sq.row;
    const float2* arow = reinterpret_cast<const float2*>(a.acc_in + (state_row + r) * D);
    for (int c = lane; c < D / 2; c += 32) {
      const float2 x = Pair<T>::load(qrow + 2 * c);
      reinterpret_cast<float2*>(qs + r * D)[c] = make_float2(x.x * a.scale, x.y * a.scale);
      reinterpret_cast<float2*>(acc + r * D)[c] = arow[c];
    }
    if (lane == 0) {
      row_m[r] = a.m_in[state_row + r];
      row_s[r] = a.s_in[state_row + r];
    }
  }
  __syncthreads();
  const int q_max = q_last;

  float* p = probs + warp * kKeys;
  for (int k0 = 0; k0 < a.lk; k0 += kKeys) {
    const int klen = min(kKeys, a.lk - k0);
    __syncthreads();  // every warp has read the previous tile
    int visible = 0;
    if (threadIdx.x < klen) {
      const int pos = a.kpos[k0 + threadIdx.x];
      kp[threadIdx.x] = pos;
      visible = pos <= q_max;
    }
    // A tile that no row of the block may see changes no state: skip it.
    if (a.causal && !__syncthreads_or(visible)) continue;
    stage_rows<T, D>(kh, a.sk.row, k0, klen, ks);
    stage_rows<T, D>(vh, a.sv.row, k0, klen, vs);
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps) {
      const int qpos_r = qp[r];
      const int j0 = lane, j1 = lane + 32;
      const bool see0 = j0 < klen && (!a.causal || kp[j0] <= qpos_r);
      const bool see1 = j1 < klen && (!a.causal || kp[j1] <= qpos_r);
      float x[D];
      const float2* qrow = reinterpret_cast<const float2*>(qs + r * D);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) {
        const float2 t = qrow[c];
        x[2 * c] = t.x;
        x[2 * c + 1] = t.y;
      }
      const float s0 = see0 ? dot_row<T, D>(x, ks + j0 * kStride) : kMasked;
      const float s1 = see1 ? dot_row<T, D>(x, ks + j1 * kStride) : kMasked;

      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = see0 ? expf(s0 - m_new) : 0.f;
      const float p1 = see1 ? expf(s1 - m_new) : 0.f;
      const float corr = expf(m_old - m_new);  // exactly 1 when the row sees no key here
      p[j0] = Pair<T>::round(p0);
      p[j1] = Pair<T>::round(p1);
      const float s_new = row_s[r] * corr + warp_sum(p0 + p1);
      __syncwarp();  // every lane's probabilities are visible to the whole warp

      float2 pv[kLanePairs];
      weighted_rows<T, D>(p, vs, klen, lane, pv);
      float2* arow = reinterpret_cast<float2*>(acc + r * D);
#pragma unroll
      for (int i = 0; i < kLanePairs; ++i) {
        const float2 old = arow[lane + 32 * i];
        arow[lane + 32 * i] = make_float2(fmaf(old.x, corr, pv[i].x), fmaf(old.y, corr, pv[i].y));
      }
      if (lane == 0) {
        row_m[r] = m_new;
        row_s[r] = s_new;
      }
      __syncwarp();  // the next row may overwrite p only after every lane read it
    }
  }

  __syncthreads();
  for (int r = warp; r < rows; r += kWarps) {
    float2* out = reinterpret_cast<float2*>(a.acc_out + (state_row + r) * D);
    const float2* row = reinterpret_cast<const float2*>(acc + r * D);
    for (int c = lane; c < D / 2; c += 32) out[c] = row[c];
    if (lane == 0) {
      a.m_out[state_row + r] = row_m[r];
      a.s_out[state_row + r] = row_s[r];
    }
  }
}

template <typename T, int D>
cudaError_t launch(const HopArgs& args, long long blocks, cudaStream_t stream) {
  const cudaError_t err = allow_smem(ring_hop_kernel<T, D>, smem_bytes<T, D>());
  if (err != cudaSuccess) return err;
  ring_hop_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, smem_bytes<T, D>(), stream>>>(
      args);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ring_hop(const void* q, const void* k, const void* v, const void* qpos,
                        const void* kpos, const void* m_in, const void* s_in, const void* acc_in,
                        void* m_out, void* s_out, void* acc_out, int n, int heads, int lq,
                        int lk, int d, int fp16, int causal, int q_sn, int q_sh, int q_sl,
                        int k_sn, int k_sh, int k_sl, int v_sn, int v_sh, int v_sl, float scale,
                        void* stream) {
  const long long blocks =
      static_cast<long long>(n) * heads * ((static_cast<long long>(lq) + kRows - 1) / kRows);
  if ((d != 64 && d != 128) || n <= 0 || heads <= 0 || lq <= 0 || lk <= 0 ||
      blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HopArgs args{q,
               k,
               v,
               static_cast<const int*>(qpos),
               static_cast<const int*>(kpos),
               static_cast<const float*>(m_in),
               static_cast<const float*>(s_in),
               static_cast<const float*>(acc_in),
               static_cast<float*>(m_out),
               static_cast<float*>(s_out),
               static_cast<float*>(acc_out),
               heads,
               lq,
               lk,
               causal,
               {q_sn, q_sh, q_sl},
               {k_sn, k_sh, k_sl},
               {v_sn, v_sh, v_sl},
               scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fp16) {
    err = d == 64 ? launch<__half, 64>(args, blocks, s) : launch<__half, 128>(args, blocks, s);
  } else {
    err = d == 64 ? launch<bf16, 64>(args, blocks, s) : launch<bf16, 128>(args, blocks, s);
  }
  return static_cast<int>(err);
}
