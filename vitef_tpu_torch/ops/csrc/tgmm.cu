// Grouped transposed product for Hopper (sm_90a): kernel K8 (tgmm) and the
// K7 pass tgmm_swiglu.
//
// Replaces the TPU kernels megablox tgmm (jax/experimental/pallas/ops/tpu/
// megablox/gmm.py:573, call :763), which vitef_tpu/parallel/moe.py calls for
// the expert weight gradients (:457, :630-633), and vitef_tpu/ops/
// gmm_fused.py:tgmm_swiglu (:268, call :342). Over rows sorted by group it
// computes, for every group e,
//     kPlain:    out[e] = A[rows of e]^T @ B[rows of e]        A (G, K), B (G, N)
//     kSwigluIn: out[e] = y[rows of e]^T @ B[rows of e],  y = bf16(silu(h[:, :K]) h[:, K:])
// into out (E, K, N), in bfloat16 (tensor cores, float32 accumulators) or
// float32 (CUDA-core FMAs, no TF32), output in the input dtype; an empty
// group writes zeros. y is rounded to the input dtype before its product, as
// the TPU kernel does.
//
// What bounds it on this card: at the 8x124m step (G = 16384 rows, E = 8) a
// dw1 half is 51.5 GFLOP against 113 MB (0.052 ms at 989 TFLOP/s) and dw2 in
// kSwigluIn 51.5 GFLOP against 169 MB (0.052 ms), bound by the tensor cores'
// rate, near the line.
//
// kPlain in bf16 (tgmm_wgmma_kernel, K8 tgmm on the MoE path) is Hopper's
// asynchronous pipeline (wgmma_tma.cuh), gmm_wgmma_kernel's design with both
// operands MN-major: the depth of the product is the rows of G, the outer
// dimension of A and B alike. A persistent block on each SM walks the output
// tiles (group, 128 rows of K, kBN columns of N); one producer warp keeps a
// ring of stages 64 rows deep filled by TMA (A's two 64 x 64 boxes and B's
// kBN / 64, from 2-D maps (K, G) and (N, G), in the 128-byte swizzle) and
// signals each through an mbarrier; two consumer warpgroups, each 64 rows of
// K, multiply each stage with wgmma m64nNk16 (A with imm-trans-a 1, B with
// imm-trans-b 1; a 16-deep step is 16 rows, 2048 bytes) into float32
// accumulators in registers. A group starts at any row, and TMA takes any row
// coordinate, so the first box starts at the group's first row; the last box
// reaches into the next group's rows, which the consumers zero in both tiles
// before wgmma reads them (each is one whole 128-byte swizzle row; a proxy
// fence orders the generic stores before the asynchronous read); rows past G
// read as zeros. The epilogue stages the tile in bf16 and writes it with TMA
// stores through a 3-D map (N, K, E), which clips at K and N inside expert e
// and overlaps the next tile's products. An empty group's tiles load nothing
// and store zeros. Each tile sums its group's rows in one fixed order (no
// split of the depth across blocks, no atomics), so two launches give the
// same bits. The group sizes are read on the card: every block turns them
// into each group's rows and, with largest_first, a walk that deals the
// largest group's tiles first (ties to the lower group) in rounds that
// snake over the blocks, since a tile's work is its group's rows: on the
// step's uneven groups a block that takes a large tile in one round takes a
// small one in the next. The column tile is 256 with three stages (about
// 209 KB of shared memory) or 128 with four (161 KB).
//
// kSwigluIn and every float32 mode take the first design: one block per
// (group, K tile of 128, N tile of 128), 8 warps of 16 x 8 x 16 mma.sync
// products (float32: CUDA-core FMAs on 64 x 64 tiles); the block walks its
// group's rows 32 (float32: 16) at a time in a fixed order, staging the two
// row slices in shared memory (ldmatrix, A read transposed) while the next
// slice is loaded into registers; no atomics, the same bits every launch.
//
// C interface: tgmm(a, b, group_sizes, out, G, K, N, E, mode, fp32, stream)
// returns a cudaError_t as int: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape this kernel does not take. a is A
// (G, K), or h (G, 2K) in kSwigluIn; K and N are multiples of 8. kPlain in
// bf16 also needs a, b and out 16-byte aligned (TMA); the wrapper passes them
// so. tgmm_plain_tile(a, b, group_sizes, out, G, K, N, E, tile_n,
// largest_first, stream) runs kPlain in bf16 at column tile 128 or 256, the
// tiles walked largest group first or in group order, so chip_smoke.py can
// time each.

#include "gmm_common.cuh"
#include "wgmma_tma.cuh"

namespace {

struct Args {
  const void* a;
  const void* b;
  const int* sizes;
  void* out;
  int G, K, N, E;
};

// Rows [*lo, *hi) of group e, clamped to G.
__device__ __forceinline__ void group_rows(const Args& p, int e, int* lo, int* hi) {
  int start = 0;
  for (int i = 0; i < e; ++i) start = min(start + max(__ldg(p.sizes + i), 0), p.G);
  *lo = start;
  *hi = min(start + max(__ldg(p.sizes + e), 0), p.G);
}

// --- bfloat16 ---------------------------------------------------------------

struct StageBf16 {
  uint4 a[2], up[2], b[2];
};

template <int kMode>
__device__ __forceinline__ void load_bf16(const Args& p, StageBf16& s, int r0, int hi, int k0,
                                          int n0) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int lda = kMode == kSwigluIn ? 2 * p.K : p.K;
  const bf16* a = static_cast<const bf16*>(p.a);
  const bf16* b = static_cast<const bf16*>(p.b);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int piece = threadIdx.x + i * kThreads;
    const int r = r0 + piece / (kTile / 8);
    const int c = (piece % (kTile / 8)) * 8;
    s.a[i] = s.up[i] = s.b[i] = zero;
    if (r < hi) {
      if (k0 + c < p.K) {
        s.a[i] = ldg16(a + static_cast<size_t>(r) * lda + k0 + c);
        if (kMode == kSwigluIn) s.up[i] = ldg16(a + static_cast<size_t>(r) * lda + p.K + k0 + c);
      }
      if (n0 + c < p.N) s.b[i] = ldg16(b + static_cast<size_t>(r) * p.N + n0 + c);
    }
  }
}

template <int kMode>
__device__ __forceinline__ void store_bf16(const StageBf16& s, bf16* a_tile, bf16* b_tile) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int piece = threadIdx.x + i * kThreads;
    const int at = (piece / (kTile / 8)) * kColStride + (piece % (kTile / 8)) * 8;
    *reinterpret_cast<uint4*>(a_tile + at) =
        kMode == kSwigluIn ? swiglu8(s.a[i], s.up[i]) : s.a[i];
    *reinterpret_cast<uint4*>(b_tile + at) = s.b[i];
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) tgmm_bf16_kernel(Args p) {
  __shared__ __align__(16) bf16 a_s[2][kDepth * kColStride];
  __shared__ __align__(16) bf16 b_s[2][kDepth * kColStride];
  const int n0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile, e = blockIdx.z;
  int lo, hi;
  group_rows(p, e, &lo, &hi);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;

  float acc[4][4][4] = {};
  if (hi > lo) {
    StageBf16 stage;
    load_bf16<kMode>(p, stage, lo, hi, k0, n0);
    store_bf16<kMode>(stage, a_s[0], b_s[0]);
    __syncthreads();
    for (int r0 = lo, buf = 0; r0 < hi; r0 += kDepth, buf ^= 1) {
      const bool more = r0 + kDepth < hi;
      if (more) load_bf16<kMode>(p, stage, r0 + kDepth, hi, k0, n0);
#pragma unroll
      for (int k16 = 0; k16 < kDepth / 16; ++k16) {
        warp_mma_k16<false>(acc, a_s[buf], b_s[buf], k16, wm, wn, lane);
      }
      if (more) store_bf16<kMode>(stage, a_s[buf ^ 1], b_s[buf ^ 1]);
      __syncthreads();
    }
  }

  bf16* out = static_cast<bf16*>(p.out) + static_cast<size_t>(e) * p.K * p.N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = k0 + wm * 64 + mi * 16 + lane / 4 + half * 8;
      if (k >= p.K) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * (lane % 4);
        if (n >= p.N) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(k) * p.N + n) =
            __floats2bfloat162_rn(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
  }
}

// --- bfloat16 kPlain: TMA + wgmma --------------------------------------------

constexpr int kWgRows = 128;                    // rows of K per output tile, 64 per warpgroup
constexpr int kWgDepth = 64;                    // rows of G per stage
constexpr int kWgChunk = 64;                    // columns per TMA box (128 bytes of bf16)
constexpr int kWgBox = kWgDepth * kWgChunk;     // elements of one box
constexpr uint32_t kWgBoxBytes = kWgBox * 2;    // the MN-major LBO: box to box
constexpr int kWgThreads = 288;
constexpr int kProducerWarp = 8;

template <int kBN, int kStages>
struct WgShape {
  static constexpr int kATile = (kWgRows / kWgChunk) * kWgBox;  // elements of A per stage
  static constexpr int kBTile = (kBN / kWgChunk) * kWgBox;      // elements of B per stage
  static constexpr uint32_t kStageBytes = 2 * (kATile + kBTile);
  // Each consumer warpgroup's 64 x kBN output tile, kBN / 64 boxes of 64 x 64.
  static constexpr int kOutTile = 64 * kBN;
  // Without the group table (3 E ints), which the launch adds.
  static constexpr size_t kSmemBytes = kStages * static_cast<size_t>(kStageBytes) +
                                       2 * kOutTile * sizeof(bf16) +
                                       2 * kStages * sizeof(uint64_t) + 1024;
};

// The item a persistent block takes in round r of its walk: the rounds deal
// gridDim.x items each, in block order, and with `snake` in reverse order
// on odd rounds, so that a block which took one of the largest tiles
// first takes one of the smallest next.
__device__ __forceinline__ long long walk_item(int r, int snake) {
  const unsigned k = snake && (r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return static_cast<long long>(r) * gridDim.x + k;
}

// kPlain in bf16: out[e] = A[rows of e]^T @ B[rows of e] (the file's note).
// Item i is output tile i % (n_k n_n) of the (i / (n_k n_n))-th group of
// `order`, K tile before N tile. With largest_first the groups are taken
// largest first and the rounds snake (walk_item), else in group order with
// every round in block order. The ring's stages and phases run on across
// items, so the producer loads the next tile's first stages while the
// consumers store the last one.
template <int kBN, int kStages>
__global__ void __launch_bounds__(kWgThreads, 1)
tgmm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map,
                  const __grid_constant__ CUtensorMap out_map, Args p, int largest_first) {
  using Shape = WgShape<kBN, kStages>;
  extern __shared__ unsigned char smem_raw[];
  // Swizzle atoms start 1024-byte aligned.
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = a_s + kStages * Shape::kATile;
  bf16* o_s = b_s + kStages * Shape::kBTile;  // the two warpgroups' output tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(o_s + 2 * Shape::kOutTile);
  uint64_t* empty = full + kStages;
  int* group_lo = reinterpret_cast<int*>(empty + kStages);  // group e's rows [lo, hi)
  int* group_hi = group_lo + p.E;
  int* order = group_hi + p.E;                              // the groups in walk order
  const int n_k = (p.K + kWgRows - 1) / kWgRows;
  const int n_n = (p.N + kBN - 1) / kBN;
  const int tiles = n_k * n_n;  // per group
  const int items = p.E * tiles;
  const int rounds = (items + gridDim.x - 1) / gridDim.x;
  const int warp = threadIdx.x / 32;

  for (int e = threadIdx.x; e < p.E; e += kWgThreads) {
    long long start = 0;
    for (int i = 0; i < e; ++i) start += max(__ldg(p.sizes + i), 0);
    const long long lo = min(start, static_cast<long long>(p.G));
    group_lo[e] = static_cast<int>(lo);
    group_hi[e] = static_cast<int>(min(lo + max(__ldg(p.sizes + e), 0),
                                       static_cast<long long>(p.G)));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < p.E; e += kWgThreads) {
    int rank = e;
    if (largest_first) {
      const int size = group_hi[e] - group_lo[e];
      rank = 0;
      for (int i = 0; i < p.E; ++i) {
        const int other = group_hi[i] - group_lo[i];
        rank += other > size || (other == size && i < e);
      }
    }
    order[rank] = e;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);   // the producer's arrival, then the TMA bytes
      mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  int it = 0;  // stages filled (producer) or consumed (consumers) so far
  if (warp == kProducerWarp) {
    if (threadIdx.x % 32 != 0) return;
    for (int round = 0; round < rounds; ++round) {
      const long long item = walk_item(round, largest_first);
      if (item >= items) continue;
      const int e = order[item / tiles];
      const int k0 = (item % tiles) / n_n * kWgRows, n0 = (item % n_n) * kBN;
      for (int r = group_lo[e]; r < group_hi[e]; r += kWgDepth, ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + s, (it / kStages - 1) & 1);
        mbar_arrive_expect_tx(full + s, Shape::kStageBytes);
#pragma unroll
        for (int c = 0; c < kWgRows / kWgChunk; ++c) {
          tma_load_2d(a_s + s * Shape::kATile + c * kWgBox, &a_map, full + s, k0 + c * kWgChunk,
                      r);
        }
#pragma unroll
        for (int c = 0; c < kBN / kWgChunk; ++c) {
          tma_load_2d(b_s + s * Shape::kBTile + c * kWgBox, &b_map, full + s, n0 + c * kWgChunk,
                      r);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows wg * 64 .. + 63 of K of each tile (its
  // own A box), and its first thread releases the stages.
  const int wg = warp / 4;
  const int wg_tid = threadIdx.x % 128;
  constexpr int kHalfBoxes = kBN / kWgChunk / 2;  // B boxes each warpgroup zeroes
  bf16* o_tile = o_s + wg * Shape::kOutTile;
  float acc[kBN / 2];
  for (int round = 0; round < rounds; ++round) {
    const long long item = walk_item(round, largest_first);
    if (item >= items) continue;
    const int e = order[item / tiles];
    const int k0 = (item % tiles) / n_n * kWgRows, n0 = (item % n_n) * kBN;
    const int hi = group_hi[e];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    int step = 0;
    for (int r = group_lo[e]; r < hi; r += kWgDepth, ++it, ++step) {
      const int s = it % kStages;
      mbar_wait(full + s, (it / kStages) & 1);
      bf16* a_tile = a_s + s * Shape::kATile + wg * kWgBox;
      bf16* b_tile = b_s + s * Shape::kBTile;
      const int rows = hi - r;  // of this group in the stage
      if (rows < kWgDepth) {
        // The box reaches past the group: zero rows rows .. 63 of this
        // warpgroup's A box and of its half of B's boxes, whole swizzle rows,
        // then wait for the other warpgroup's half.
        const int pieces = (kWgDepth - rows) * (kWgChunk / 8);
        const uint4 zero = make_uint4(0, 0, 0, 0);
        for (int i = wg_tid; i < pieces * (1 + kHalfBoxes); i += 128) {
          const int box = i / pieces, at = rows * kWgChunk + (i % pieces) * 8;
          bf16* tile = box == 0 ? a_tile : b_tile + (wg * kHalfBoxes + box - 1) * kWgBox;
          *reinterpret_cast<uint4*>(tile + at) = zero;
        }
        fence_proxy_async();
        named_sync(3, 256);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgDepth / 16; ++kk) {
        wgmma_tile<kBN, 1>(acc, smem_desc_sw128(a_tile + kk * 16 * kWgChunk, kWgBoxBytes, 1024),
                           smem_desc_sw128(b_tile + kk * 16 * kWgChunk, kWgBoxBytes, 1024));
      }
      wgmma_commit();
      fence_regs(acc);
      // The previous step's products are done: release its stage.
      wgmma_wait<1>();
      fence_regs(acc);
      if (step > 0 && wg_tid == 0) mbar_arrive(empty + (it - 1) % kStages);
    }
    if (step > 0) {
      wgmma_wait<0>();
      fence_regs(acc);
      if (wg_tid == 0) mbar_arrive(empty + (it - 1) % kStages);
    }

    // Epilogue, while the producer fills the next tile's stages: stage the
    // accumulators in bf16 once the last TMA store has read the tile, then
    // store its boxes; the 3-D map clips rows past K and columns past N.
    const int k_row = k0 + wg * 64;
    if (wg_tid == 0) tma_store_wait_read();
    named_sync(1 + wg, 128);
    stage_acc_sw128<kBN>(acc, o_tile);
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if (wg_tid == 0 && k_row < p.K) {
#pragma unroll
      for (int c = 0; c < kBN / kWgChunk; ++c) {
        tma_store_3d(&out_map, o_tile + c * kWgBox, n0 + c * kWgChunk, k_row, e);
      }
      tma_store_commit();
    }
  }
  if (wg_tid == 0) tma_store_wait();
}

// tgmm_wgmma_kernel at column tile kBN: its tensor maps, built at each call
// (the pointers change), and a persistent grid of one block an SM. With no
// rows (G = 0) no load is issued, and A's and B's maps are built over out.
template <int kBN, int kStages>
cudaError_t launch_wgmma(const Args& p, int largest_first, cudaStream_t stream) {
  using Shape = WgShape<kBN, kStages>;
  const cuuint64_t rows = p.G > 0 ? static_cast<cuuint64_t>(p.G) : 1;
  CUtensorMap a_map, b_map, out_map;
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(p.K), rows};
  const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(p.K) * 2};
  const cuuint64_t b_dims[2] = {static_cast<cuuint64_t>(p.N), rows};
  const cuuint64_t b_strides[1] = {static_cast<cuuint64_t>(p.N) * 2};
  const cuuint32_t box[2] = {kWgChunk, kWgDepth};
  const cuuint64_t out_dims[3] = {static_cast<cuuint64_t>(p.N), static_cast<cuuint64_t>(p.K),
                                  static_cast<cuuint64_t>(p.E)};
  const cuuint64_t out_strides[2] = {static_cast<cuuint64_t>(p.N) * 2,
                                     static_cast<cuuint64_t>(p.K) * p.N * 2};
  const cuuint32_t out_box[3] = {kWgChunk, 64, 1};
  cudaError_t err =
      make_tensor_map_bf16(&a_map, p.G > 0 ? p.a : p.out, 2, a_dims, a_strides, box);
  if (err != cudaSuccess) return err;
  err = make_tensor_map_bf16(&b_map, p.G > 0 ? p.b : p.out, 2, b_dims, b_strides, box);
  if (err != cudaSuccess) return err;
  err = make_tensor_map_bf16(&out_map, p.out, 3, out_dims, out_strides, out_box);
  if (err != cudaSuccess) return err;
  const size_t smem = Shape::kSmemBytes + 3 * static_cast<size_t>(p.E) * sizeof(int);
  int device = 0, sms = 0, optin = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  const auto kernel = tgmm_wgmma_kernel<kBN, kStages>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(p.E) * ((p.K + kWgRows - 1) / kWgRows) *
                          ((p.N + kBN - 1) / kBN);
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const long long blocks = items < sms ? items : sms;
  kernel<<<static_cast<unsigned>(blocks), kWgThreads, smem, stream>>>(a_map, b_map, out_map, p,
                                                                      largest_first);
  return cudaGetLastError();
}

// The two column tiles, one block an SM: 128 x 128 with four stages, and
// 128 x 256 with three.
cudaError_t launch_plain_bf16(const Args& p, int tile_n, int largest_first,
                              cudaStream_t stream) {
  switch (tile_n) {
    case 128: return launch_wgmma<128, 4>(p, largest_first, stream);
    case 256: return launch_wgmma<256, 3>(p, largest_first, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The column tile and walk kPlain takes (chip_smoke.py times each).
constexpr int kPlainTileN = 256;
constexpr int kPlainLargestFirst = 1;

// --- float32 ----------------------------------------------------------------

struct StageF32 {
  float4 a, up, b;
};

template <int kMode>
__device__ __forceinline__ void load_f32(const Args& p, StageF32& s, int r0, int hi, int k0,
                                         int n0) {
  const int lda = kMode == kSwigluIn ? 2 * p.K : p.K;
  const float* a = static_cast<const float*>(p.a);
  const int r = r0 + threadIdx.x / (kTileF / 4);
  const int c = (threadIdx.x % (kTileF / 4)) * 4;
  s.a = s.up = s.b = zero4();
  if (r < hi) {
    if (k0 + c < p.K) {
      s.a = ldg4(a + static_cast<size_t>(r) * lda + k0 + c);
      if (kMode == kSwigluIn) s.up = ldg4(a + static_cast<size_t>(r) * lda + p.K + k0 + c);
    }
    if (n0 + c < p.N) {
      s.b = ldg4(static_cast<const float*>(p.b) + static_cast<size_t>(r) * p.N + n0 + c);
    }
  }
}

template <int kMode>
__device__ __forceinline__ void store_f32(const StageF32& s, float* a_tile, float* b_tile) {
  const int at = (threadIdx.x / (kTileF / 4)) * kStrideF + (threadIdx.x % (kTileF / 4)) * 4;
  *reinterpret_cast<float4*>(a_tile + at) = kMode == kSwigluIn ? swiglu4(s.a, s.up) : s.a;
  *reinterpret_cast<float4*>(b_tile + at) = s.b;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) tgmm_f32_kernel(Args p) {
  __shared__ __align__(16) float a_s[2][kDepthF * kStrideF];
  __shared__ __align__(16) float b_s[2][kDepthF * kStrideF];
  const int n0 = blockIdx.x * kTileF, k0 = blockIdx.y * kTileF, e = blockIdx.z;
  int lo, hi;
  group_rows(p, e, &lo, &hi);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[4][4] = {};
  if (hi > lo) {
    StageF32 stage;
    load_f32<kMode>(p, stage, lo, hi, k0, n0);
    store_f32<kMode>(stage, a_s[0], b_s[0]);
    __syncthreads();
    for (int r0 = lo, buf = 0; r0 < hi; r0 += kDepthF, buf ^= 1) {
      const bool more = r0 + kDepthF < hi;
      if (more) load_f32<kMode>(p, stage, r0 + kDepthF, hi, k0, n0);
      fma_tile(acc, a_s[buf], b_s[buf], ty, tx);
      if (more) store_f32<kMode>(stage, a_s[buf ^ 1], b_s[buf ^ 1]);
      __syncthreads();
    }
  }

  const int n = n0 + tx * 4;
  if (n >= p.N) return;
  float* out = static_cast<float*>(p.out) + static_cast<size_t>(e) * p.K * p.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k < p.K) {
      *reinterpret_cast<float4*>(out + static_cast<size_t>(k) * p.N + n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

template <int kMode>
cudaError_t launch(const Args& p, int fp32, cudaStream_t stream) {
  if (kMode == kPlain && !fp32) {
    return launch_plain_bf16(p, kPlainTileN, kPlainLargestFirst, stream);
  }
  const int tile = fp32 ? kTileF : kTile;
  const dim3 grid((p.N + tile - 1) / tile, (p.K + tile - 1) / tile, p.E);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  if (fp32) {
    tgmm_f32_kernel<kMode><<<grid, kThreads, 0, stream>>>(p);
  } else if constexpr (kMode != kPlain) {
    tgmm_bf16_kernel<kMode><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int tgmm(const void* a, const void* b, const void* group_sizes, void* out, int G,
                    int K, int N, int E, int mode, int fp32, void* stream) {
  if (G < 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args p{a, b, static_cast<const int*>(group_sizes), out, G, K, N, E};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPlain: return static_cast<int>(launch<kPlain>(p, fp32, s));
    case kSwigluIn: return static_cast<int>(launch<kSwigluIn>(p, fp32, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// kPlain in bf16 at column tile tile_n (128 or 256), the tiles walked
// largest group first or (largest_first 0) in group order, whatever tgmm()
// takes: the same operands as tgmm(a, b, group_sizes, out, G, K, N, E,
// kPlain, 0, stream).
extern "C" int tgmm_plain_tile(const void* a, const void* b, const void* group_sizes, void* out,
                               int G, int K, int N, int E, int tile_n, int largest_first,
                               void* stream) {
  if (G < 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args p{a, b, static_cast<const int*>(group_sizes), out, G, K, N, E};
  return static_cast<int>(
      launch_plain_bf16(p, tile_n, largest_first, static_cast<cudaStream_t>(stream)));
}
