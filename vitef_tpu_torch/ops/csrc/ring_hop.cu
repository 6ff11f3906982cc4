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
// and key tiles are partial, zero-filled and masked by index.
//
// Operands: q (N, h, lq, d) and k, v (N, h, lk, d) in bfloat16 or float16,
// each row contiguous but the sequence, head and row strides free (in
// elements, multiples of 8, the rows 16-byte aligned for cp.async), so a
// zigzag segment or a head view of the qkv projection is read in place;
// qpos, kpos int32; the state m, s (N, h, lq) and acc (N, h, lq, d) float32,
// contiguous. The new state is written to separate tensors (the ring's
// backward replays each hop from its inputs).
//
// What bounds it on this card: per (sequence, head) two lq x lk x d products
// and lq * lk exponentials, against the bytes of q, k, v and the float32
// state read and written once: at the GPT-2 sp step's hop (N=8, h=12,
// lq=lk=512, d=64) 6.4 GFLOP against 44.6 MB, so it is bound by its bytes
// (0.013 ms at 3.35 TB/s), the float32 state more than half of them.
//
// What the design does about it: the tensor-core forward's schedule
// (attn_fwd_mma.cuh) with the state carried in registers. One block of 4
// warps per (sequence, head, 64-row query tile); each warp keeps its 16 rows
// of Q as mma.sync A fragments (ldmatrix) for the whole key loop; 64-key K/V
// tiles arrive by 16-byte cp.async, double buffered, in rows padded by 16
// bytes; S = Q K^T (m16n8k16, float32 accumulators, scaled after the
// product) and the online softmax stay in registers; P, rounded to the input
// type, becomes the A operand of P.V through the m16n8k16 C -> A identity,
// and V is read with ldmatrix.trans. The O accumulator starts from acc_in
// and the row max and sum from m_in and s_in; all three are written back
// unnormalised. The state's m stays in natural-log units of scale * q.k (the
// exponentials are exp2 of (x - m) log2(e)), so a row that sees no key of a
// tile gets corr = exp2(0) = 1 and p = 0 and keeps its state bit for bit.
// Before the key loop the block marks each key tile from the positions: no
// row of the block sees any of its keys (skipped: never loaded), every row
// sees every key (multiplied without a mask: every tile of a mid-ring hop),
// or some (masked per element by position and, past lk, by index). The
// warp tile is templated on the input type (bf16 or float16 products) and
// on d (64 or 128: 4 or 8 k16 steps for S, 8 or 16 n8 tiles of O). No
// atomics on the values: two launches give the same bits. Shared memory: Q
// and two K/V stages, 45 KB (d = 64) or 85 KB (d = 128), and a byte per key
// tile.
//
// C interface: ring_hop(q, k, v, qpos, kpos, m_in, s_in, acc_in, m_out,
// s_out, acc_out, N, h, lq, lk, d, fp16, causal, q strides (n, h, row),
// k strides, v strides, scale, stream) returns a cudaError_t as int: the
// launch's cudaGetLastError(), or cudaErrorInvalidValue for a shape, stride
// or alignment this kernel does not take. fp16 selects float16 inputs (else
// bfloat16).

#include <cuda_fp16.h>

#include <climits>

#include "mma_sync.cuh"
#include "packed_mha_common.cuh"

namespace {

constexpr int kRows = 64;                  // query rows per block, 16 per warp
constexpr int kKeys = 64;                  // keys per staged tile
constexpr int kWarps = kRows / 16;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kMaskedScore = -1e30f;     // the score of a masked key

// How a key tile is multiplied (one byte per tile in shared memory).
enum TileKind : unsigned char { kSkip = 0, kMaskedTile = 1, kWholeTile = 2 };

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

// The product and the rounding of P for each input type.
template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  __device__ __forceinline__ static void mma(float* c, const uint32_t* a, const uint32_t* b) {
    mma_bf16(c, a, b);
  }
};

template <>
struct Elem<__half> {
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  __device__ __forceinline__ static void mma(float* c, const uint32_t* a, const uint32_t* b) {
    mma_f16(c, a, b);
  }
};

// Elements per padded shared row: d + 8, so the 8 rows an ldmatrix reads
// fall in distinct banks.
template <int D>
constexpr int kStride = D + 8;

// Dynamic shared memory of one block: the Q tile, two K and two V stages,
// and one byte per key tile.
template <typename T, int D>
size_t smem_bytes(int lk) {
  const size_t tiles = (static_cast<size_t>(lk) + kKeys - 1) / kKeys;
  return static_cast<size_t>(kRows + 4 * kKeys) * kStride<D> * sizeof(T) + ((tiles + 15) & ~15);
}

// Rows r0 .. r0 + 63 of one head (row stride `row` elements) into padded
// shared rows by 16-byte cp.async; rows at or past `len` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* head, long long row, int r0, int len, T* dst) {
  constexpr int kPieces = D / 8;           // 16-byte pieces per row
#pragma unroll
  for (int i = 0; i < kRows * kPieces / kThreads; ++i) {
    const int piece = threadIdx.x + kThreads * i;
    const int r = piece / kPieces, col = (piece % kPieces) * 8;
    const bool inside = r0 + r < len;
    const T* src = inside ? head + (r0 + r) * row + col : head;
    cp_async16(dst + r * kStride<D> + col, src, inside);
  }
}

// c (16 x 64 keys) += a (the warp's 16 rows of Q, D wide) tile^T: n8 tile t
// of c holds keys 8 t .. 8 t + 7 of the staged K tile.
template <typename T, int D>
__device__ __forceinline__ void mma_q_kt(float (&c)[8][4], const uint32_t (&a)[D / 16][4],
                                         const T* tile) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t b[4];
      ldmatrix_x4(b, tile + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kStride<D> + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      Elem<T>::mma(c[2 * nj], a[kk], b);
      Elem<T>::mma(c[2 * nj + 1], a[kk], b + 2);
    }
  }
}

// c (16 x D) += a (16 x 64 keys: P) tile: n8 tile t of c holds head columns
// 8 t .. 8 t + 7 of the staged V tile (ldmatrix.trans).
template <typename T, int D>
__device__ __forceinline__ void mma_p_v(float (&c)[D / 8][4], const uint32_t (&a)[4][4],
                                        const T* tile) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, reinterpret_cast<const bf16*>(
                               tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride<D> +
                               dj * 16 + (lane >> 4) * 8));
      Elem<T>::mma(c[2 * dj], a[kk], b);
      Elem<T>::mma(c[2 * dj + 1], a[kk], b + 2);
    }
  }
}

// The first key tile at or after j that some row of the block sees.
__device__ __forceinline__ int next_tile(const unsigned char* kinds, int j, int n_tiles) {
  while (j < n_tiles && kinds[j] == kSkip) ++j;
  return j;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) ring_hop_mma_kernel(HopArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + kRows * kStride<D>;         // two stages of kKeys rows
  T* sv = sk + 2 * kKeys * kStride<D>;     // likewise
  unsigned char* kinds = reinterpret_cast<unsigned char*>(sv + 2 * kKeys * kStride<D>);
  __shared__ int q_lo, q_hi;               // the block's least and largest query position

  const int n_qtiles = (a.lq + kRows - 1) / kRows;
  const int n_ktiles = (a.lk + kKeys - 1) / kKeys;
  const long long head = blockIdx.x / n_qtiles;  // sequence * heads + head
  const long long seq = head / a.heads, hd = head % a.heads;
  const T* qh = static_cast<const T*>(a.q) + seq * a.sq.n + hd * a.sq.h;
  const T* kh = static_cast<const T*>(a.k) + seq * a.sk.n + hd * a.sk.h;
  const T* vh = static_cast<const T*>(a.v) + seq * a.sv.n + hd * a.sv.h;
  const int q0 = static_cast<int>(blockIdx.x % n_qtiles) * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;                 // this thread's accumulator rows: g and g + 8
  const int tig = lane & 3;                // its column pair within each n8 tile
  const int row0 = q0 + warp * 16 + g;
  const long long state0 = head * a.lq;    // the head's first row of m, s, acc

  // This thread's two rows: their positions (INT_MIN past lq: such a row is
  // never written) and incoming state.
  int qp[2];
  float row_m[2], row_l[2];
  float o[D / 8][4];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = row0 + 8 * rr;
    const bool inside = qi < a.lq;
    qp[rr] = inside ? a.qpos[qi] : INT_MIN;
    row_m[rr] = inside ? a.m_in[state0 + qi] : kMaskedScore;
    // The quad's first thread carries s_in; the quad's partial sums are
    // added at the end.
    row_l[rr] = inside && tig == 0 ? a.s_in[state0 + qi] : 0.f;
    const float* acc = a.acc_in + (state0 + qi) * D + 2 * tig;
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      const float2 x = inside ? *reinterpret_cast<const float2*>(acc + 8 * t)
                              : make_float2(0.f, 0.f);
      o[t][2 * rr] = x.x;
      o[t][2 * rr + 1] = x.y;
    }
  }

  // The kind of each key tile, from the positions: the block's rows span
  // [q_lo, q_hi]; a key past lk is never visible, and without the causal
  // mask every key below lk is.
  if (threadIdx.x == 0) {
    q_lo = INT_MAX;
    q_hi = INT_MIN;
  }
  __syncthreads();
  if (threadIdx.x < kRows && q0 + threadIdx.x < a.lq) {
    const int pos = a.qpos[q0 + threadIdx.x];
    atomicMin(&q_lo, pos);
    atomicMax(&q_hi, pos);
  }
  __syncthreads();
  const int q_min = q_lo, q_max = q_hi;
  for (int t = warp; t < n_ktiles; t += kWarps) {
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = t * kKeys + lane + 32 * half;
      const int pos = key >= a.lk ? INT_MAX : (a.causal ? a.kpos[key] : INT_MIN);
      lo = min(lo, pos);
      hi = max(hi, pos);
    }
    lo = __reduce_min_sync(kFullMask, lo);
    hi = __reduce_max_sync(kFullMask, hi);
    if (lane == 0) kinds[t] = lo > q_max ? kSkip : (hi <= q_min ? kWholeTile : kMaskedTile);
  }
  __syncthreads();

  int j = next_tile(kinds, 0, n_ktiles);
  if (j < n_ktiles) {
    stage_rows<T, D>(qh, a.sq.row, q0, a.lq, sq);
    stage_rows<T, D>(kh, a.sk.row, j * kKeys, a.lk, sk);
    stage_rows<T, D>(vh, a.sv.row, j * kKeys, a.lk, sv);
  }
  cp_async_commit();

  uint32_t qf[D / 16][4];                  // the warp's Q rows as A fragments, per k16 step
  bool first = true;
  for (int buf = 0; j < n_ktiles; buf ^= 1) {
    const int next = next_tile(kinds, j + 1, n_ktiles);
    const T* ks = sk + buf * kKeys * kStride<D>;
    const T* vs = sv + buf * kKeys * kStride<D>;
    if (next < n_ktiles) {  // the other stage was last read before the previous barrier
      stage_rows<T, D>(kh, a.sk.row, next * kKeys, a.lk, sk + (buf ^ 1) * kKeys * kStride<D>);
      stage_rows<T, D>(vh, a.sv.row, next * kKeys, a.lk, sv + (buf ^ 1) * kKeys * kStride<D>);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's pieces of tile j (and of Q) have landed
    __syncthreads();
    if (first) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldmatrix_x4(qf[kk], sq + (warp * 16 + (lane & 15)) * kStride<D> + kk * 16 +
                                (lane >> 4) * 8);
      }
      first = false;
    }

    // S = scale Q K^T: element (t, 2 rr + e) is row row0 + 8 rr, key
    // j * kKeys + 8 t + 2 tig + e.
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    mma_q_kt<T, D>(s, qf, ks);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[t][c] *= a.scale;
    }
    // On a masked tile, bit 4 t + 2 rr + e of `hidden` marks a masked score.
    uint32_t hidden = 0;
    if (kinds[j] == kMaskedTile) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j * kKeys + 8 * t + 2 * tig + e;
          const int pos = key < a.lk && a.causal ? a.kpos[key] : INT_MIN;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            if (key >= a.lk || pos > qp[rr]) {
              hidden |= 1u << (4 * t + 2 * rr + e);
              s[t][2 * rr + e] = kMaskedScore;
            }
          }
        }
      }
    }

    // Online softmax in natural-log units: corr = exp(m - m') is exactly 1
    // when the tile raises no row max.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = row_m[rr];
#pragma unroll
      for (int t = 0; t < 8; ++t) mx = fmaxf(mx, fmaxf(s[t][2 * rr], s[t][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
      const float corr = exp2f((row_m[rr] - mx) * kLog2e);
      row_m[rr] = mx;
      row_l[rr] *= corr;
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        o[t][2 * rr] *= corr;
        o[t][2 * rr + 1] *= corr;
      }
    }
    // P as A fragments, rounded to the input type; the row sums add the
    // unrounded p. k16 step kk of P V is n8 tiles 2 kk and 2 kk + 1.
    uint32_t pf[4][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = hidden >> (4 * t + c) & 1u ? 0.f : exp2f((s[t][c] - row_m[c >> 1]) * kLog2e);
      }
      row_l[0] += p[0] + p[1];
      row_l[1] += p[2] + p[3];
      pf[t >> 1][2 * (t & 1)] = Elem<T>::pack(p[0], p[1]);
      pf[t >> 1][2 * (t & 1) + 1] = Elem<T>::pack(p[2], p[3]);
    }
    mma_p_v<T, D>(o, pf, vs);
    __syncthreads();  // every warp is done with this stage before it is refilled
    j = next;
  }
  cp_async_wait<0>();  // no copy in flight at exit (the last group is empty)

  // Epilogue: the quad's partial sums, then the new state, unnormalised.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row_l[rr] += __shfl_xor_sync(kFullMask, row_l[rr], 1);
    row_l[rr] += __shfl_xor_sync(kFullMask, row_l[rr], 2);
    const int qi = row0 + 8 * rr;
    if (qi >= a.lq) continue;
    if (tig == 0) {
      a.m_out[state0 + qi] = row_m[rr];
      a.s_out[state0 + qi] = row_l[rr];
    }
    float* acc = a.acc_out + (state0 + qi) * D + 2 * tig;
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      *reinterpret_cast<float2*>(acc + 8 * t) = make_float2(o[t][2 * rr], o[t][2 * rr + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const HopArgs& args, long long blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(args.lk);
  const cudaError_t err = allow_smem(ring_hop_mma_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  ring_hop_mma_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// Whether cp.async can copy the rows of an operand in 16-byte pieces.
bool rows_aligned(const void* base, int sn, int sh, int sl) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && sn % 8 == 0 && sh % 8 == 0 &&
         sl % 8 == 0;
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
      blocks > INT_MAX || !rows_aligned(q, q_sn, q_sh, q_sl) ||
      !rows_aligned(k, k_sn, k_sh, k_sl) || !rows_aligned(v, v_sn, v_sh, v_sl)) {
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
