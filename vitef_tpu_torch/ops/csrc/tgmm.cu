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
// group writes zeros. y is rounded to the input dtype before its product, and
// rows outside the group are zero in both operands, as the TPU kernel does.
//
// What bounds it on this card: at the 8x124m step (G = 16384 rows, E = 8) a
// dw1 half is 51.5 GFLOP against 113 MB (0.052 ms at 989 TFLOP/s) and dw2 in
// kSwigluIn 51.5 GFLOP against 185 MB (0.055 ms, bytes), near the line.
//
// Both modes in bf16 are tgmm_wgmma_kernel<mode, tile, stages>, Hopper's
// asynchronous pipeline (wgmma_tma.cuh), gmm_wgmma_kernel's design with both
// operands MN-major: the depth of the product is the rows of G, the outer
// dimension of A and B alike. A persistent block on each SM walks the output
// tiles (group, 128 rows of K, kBN columns of N); one producer warp keeps a
// ring of stages 64 rows deep filled by TMA (A's two 64 x 64 boxes, or in
// kSwigluIn gate's and up's from h as a 3-D map (K, 2, G), and B's kBN / 64,
// in the 128-byte swizzle) and signals each through an mbarrier; two
// consumer warpgroups, each 64 rows of K, multiply each stage with wgmma
// m64nNk16 (A with imm-trans-a 1, B with imm-trans-b 1; a 16-deep step is 16
// rows, 2048 bytes) into float32 accumulators in registers. In kSwigluIn
// each warpgroup first writes y over its gate box in place (swiglu_box:
// whole 16-byte pieces, all loaded before any is stored; silu_fast as
// gmm_swiglu, so the same y bit for bit; rows past the group zero), then a
// proxy fence and the warpgroup's barrier, while the last stage's products
// run. A group starts at any row, and TMA takes any row coordinate, so the
// first box starts at the group's first row; the last box reaches into the
// next group's rows, which the consumers zero in B's tiles and (kPlain) A's
// before wgmma reads them (each is one whole 128-byte swizzle row; a proxy
// fence orders the generic stores before the asynchronous read); rows past G
// read as zeros. The epilogue stages the tile in bf16 (kSwigluIn at 256: 128
// columns at a time, so that three 64 KB stages fit) and writes it with TMA
// stores through a 3-D map (N, K, E), which clips at K and N inside expert
// e and overlaps the next tile's products. An empty group's tiles load
// nothing and store zeros. Each tile sums its group's rows in one fixed order
// (no split of the depth across blocks, no atomics), so two launches give
// the same bits. The group sizes are read on the card: every block turns
// them into each group's rows and, with largest_first, a walk that deals the
// largest group's tiles first (ties to the lower group) in rounds that snake
// over the blocks, since a tile's work is its group's rows: on the step's
// uneven groups a block that takes a large tile in one round takes a small
// one in the next. The column tile is 256 with three stages or 128 with
// four; the wrappers take 256, the faster in both modes (PERF.md).
//
// Every float32 mode keeps the first design (tgmm_f32_kernel): one block per
// (group, K tile of 64, N tile of 64), CUDA-core FMAs, the group's rows
// walked 16 at a time in a fixed order, the next slice loaded into registers
// while the current one multiplies; no atomics, the same bits every launch.
//
// C interface: tgmm(a, b, group_sizes, out, G, K, N, E, mode, fp32, stream)
// returns a cudaError_t as int: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape this kernel does not take. a is A
// (G, K), or h (G, 2K) in kSwigluIn; K and N are multiples of 8. bf16 also
// needs a, b and out 16-byte aligned (TMA); the wrapper passes them so.
// tgmm_tile(a, b, group_sizes, out, G, K, N, E, mode, tile_n, largest_first,
// stream) runs either mode in bf16 at column tile 128 or 256, the tiles
// walked largest group first or in group order, so chip_smoke.py can time
// each.

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

// --- bfloat16: TMA + wgmma -----------------------------------------------------

constexpr int kWgRows = 128;                    // rows of K per output tile, 64 per warpgroup
constexpr int kWgDepth = 64;                    // rows of G per stage
constexpr int kWgChunk = 64;                    // columns per TMA box (128 bytes of bf16)
constexpr int kWgBox = kWgDepth * kWgChunk;     // elements of one box
constexpr uint32_t kWgBoxBytes = kWgBox * 2;    // the MN-major LBO: box to box
constexpr int kWgThreads = 288;
constexpr int kProducerWarp = 8;

template <int kMode, int kBN, int kStages>
struct WgShape {
  // A's boxes per stage: each warpgroup's 64 columns of A, or of gate and of
  // up (kSwigluIn).
  static constexpr int kABoxes = (kMode == kSwigluIn ? 2 : 1) * kWgRows / kWgChunk;
  static constexpr int kATile = kABoxes * kWgBox;           // elements of A per stage
  static constexpr int kBTile = (kBN / kWgChunk) * kWgBox;  // elements of B per stage
  static constexpr uint32_t kStageBytes = 2 * (kATile + kBTile);
  // Each consumer warpgroup's output tile, 64 x kOutCols as kOutCols / 64
  // boxes of 64 x 64: the whole tile, or (kSwigluIn at 256, whose stages are
  // 64 KB) half of it at a time, so that three stages fit.
  static constexpr int kOutCols = kMode == kSwigluIn && kBN == 256 ? 128 : kBN;
  static constexpr int kOutTile = 64 * kOutCols;
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

// kSwigluIn: y = bf16(silu(gate) up) (swiglu2, as gmm_swiglu makes it) over
// a warpgroup's gate box in place (up kWgBox further on), zero in the rows
// of G at or past `rows`, which belong to the next group. y is elementwise,
// so each thread takes whole 16-byte pieces wherever the swizzle put them:
// piece i of the box lies in row i / 8. A thread's pieces are all loaded
// before any is stored, so that no load waits for a store it might alias.
__device__ __forceinline__ void swiglu_box(bf16* g_tile, int rows) {
  constexpr int kPieces = kWgBox / 8 / 128;  // per thread
  uint4* gate = reinterpret_cast<uint4*>(g_tile);
  const uint4* up = reinterpret_cast<const uint4*>(g_tile + kWgBox);
  uint4 g[kPieces], u[kPieces];
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    g[j] = gate[threadIdx.x % 128 + j * 128];
    u[j] = up[threadIdx.x % 128 + j * 128];
  }
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const int i = threadIdx.x % 128 + j * 128;
    uint4 y = make_uint4(swiglu2(g[j].x, u[j].x), swiglu2(g[j].y, u[j].y),
                         swiglu2(g[j].z, u[j].z), swiglu2(g[j].w, u[j].w));
    if (i / 8 >= rows) y = make_uint4(0, 0, 0, 0);
    gate[i] = y;
  }
}

// out[e] = A[rows of e]^T @ B[rows of e] (kPlain) or y[rows of e]^T @
// B[rows of e] (kSwigluIn), as the file's note says. Item i is output tile
// i % (n_k n_n) of the (i / (n_k n_n))-th group of `order`, K tile before N
// tile. With largest_first the groups are taken largest first and the
// rounds snake (walk_item), else in group order with every round in block
// order. The ring's stages and phases run on across items, so the producer
// loads the next tile's first stages while the consumers store the last one.
template <int kMode, int kBN, int kStages>
__global__ void __launch_bounds__(kWgThreads, 1)
tgmm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map,
                  const __grid_constant__ CUtensorMap out_map, Args p, int largest_first) {
  using Shape = WgShape<kMode, kBN, kStages>;
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
        bf16* a_dst = a_s + s * Shape::kATile;
#pragma unroll
        for (int c = 0; c < kWgRows / kWgChunk; ++c) {
          if constexpr (kMode == kSwigluIn) {  // warpgroup c's gate box, then its up box
            tma_load_3d(a_dst + 2 * c * kWgBox, &a_map, full + s, k0 + c * kWgChunk, 0, r);
            tma_load_3d(a_dst + (2 * c + 1) * kWgBox, &a_map, full + s, k0 + c * kWgChunk, 1,
                        r);
          } else {
            tma_load_2d(a_dst + c * kWgBox, &a_map, full + s, k0 + c * kWgChunk, r);
          }
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
  // own A box, or gate and up boxes), and its first thread releases the
  // stages.
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
      bf16* a_tile = a_s + s * Shape::kATile + wg * (Shape::kABoxes / 2) * kWgBox;
      bf16* b_tile = b_s + s * Shape::kBTile;
      const int rows = hi - r;  // of this group in the stage
      // kSwigluIn: y over this warpgroup's gate box, while the last stage
      // multiplies.
      if constexpr (kMode == kSwigluIn) swiglu_box(a_tile, rows);
      if (rows < kWgDepth) {
        // The boxes reach past the group: zero rows rows .. 63 of this
        // warpgroup's half of B's boxes and (kPlain) of its A box, whole
        // swizzle rows.
        constexpr int kABox = kMode == kSwigluIn ? 0 : 1;
        const int pieces = (kWgDepth - rows) * (kWgChunk / 8);
        const uint4 zero = make_uint4(0, 0, 0, 0);
        for (int i = wg_tid; i < pieces * (kABox + kHalfBoxes); i += 128) {
          const int box = i / pieces + 1 - kABox, at = rows * kWgChunk + (i % pieces) * 8;
          bf16* tile = box == 0 ? a_tile : b_tile + (wg * kHalfBoxes + box - 1) * kWgBox;
          *reinterpret_cast<uint4*>(tile + at) = zero;
        }
      }
      // Generic stores before wgmma reads them: the proxy fence, then the
      // warpgroup's barrier, or both warpgroups' when B was zeroed.
      if (kMode == kSwigluIn || rows < kWgDepth) {
        fence_proxy_async();
        if (rows < kWgDepth) {
          named_sync(3, 256);
        } else {
          named_sync(1 + wg, 128);
        }
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
    // Waited for on every path, an empty group's too: a wait under a branch
    // the compiler cannot prove uniform makes ptxas serialise the wgmmas.
    wgmma_wait<0>();
    fence_regs(acc);
    if (step > 0 && wg_tid == 0) mbar_arrive(empty + (it - 1) % kStages);

    // Epilogue, while the producer fills the next tile's stages: stage the
    // accumulators in bf16 once the last TMA store has read the tile, then
    // store its boxes; the 3-D map clips rows past K and columns past N.
    const int k_row = k0 + wg * 64;
#pragma unroll
    for (int part = 0; part < kBN / Shape::kOutCols; ++part) {
      if (wg_tid == 0) tma_store_wait_read();
      named_sync(1 + wg, 128);
      stage_acc_sw128<kBN, Shape::kOutCols>(acc, o_tile, part);
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (wg_tid == 0 && k_row < p.K) {
#pragma unroll
        for (int c = 0; c < Shape::kOutCols / kWgChunk; ++c) {
          tma_store_3d(&out_map, o_tile + c * kWgBox, n0 + part * Shape::kOutCols + c * kWgChunk,
                       k_row, e);
        }
        tma_store_commit();
      }
    }
  }
  if (wg_tid == 0) tma_store_wait();
}

// tgmm_wgmma_kernel at column tile kBN: its tensor maps, built at each call
// (the pointers change), and a persistent grid of one block an SM. With no
// rows (G = 0) no load is issued, and A's and B's maps are built over out.
template <int kMode, int kBN, int kStages>
cudaError_t launch_wgmma(const Args& p, int largest_first, cudaStream_t stream) {
  using Shape = WgShape<kMode, kBN, kStages>;
  const cuuint64_t rows = p.G > 0 ? static_cast<cuuint64_t>(p.G) : 1;
  const cuuint64_t K = p.K, N = p.N, E = p.E;
  CUtensorMap a_map, b_map, out_map;
  const cuuint32_t box[2] = {kWgChunk, kWgDepth};
  cudaError_t err;
  if constexpr (kMode == kSwigluIn) {
    // h (G, 2K) as (K, 2, G): gate at [k, 0, r], up at [k, 1, r].
    const cuuint64_t a_dims[3] = {K, 2, rows};
    const cuuint64_t a_strides[2] = {K * 2, K * 4};
    const cuuint32_t a_box[3] = {kWgChunk, 1, kWgDepth};
    err = make_tensor_map_bf16(&a_map, p.G > 0 ? p.a : p.out, 3, a_dims, a_strides, a_box);
  } else {
    const cuuint64_t a_dims[2] = {K, rows};
    const cuuint64_t a_strides[1] = {K * 2};
    err = make_tensor_map_bf16(&a_map, p.G > 0 ? p.a : p.out, 2, a_dims, a_strides, box);
  }
  if (err != cudaSuccess) return err;
  const cuuint64_t b_dims[2] = {N, rows};
  const cuuint64_t b_strides[1] = {N * 2};
  err = make_tensor_map_bf16(&b_map, p.G > 0 ? p.b : p.out, 2, b_dims, b_strides, box);
  if (err != cudaSuccess) return err;
  const cuuint64_t out_dims[3] = {N, K, E};
  const cuuint64_t out_strides[2] = {N * 2, K * N * 2};
  const cuuint32_t out_box[3] = {kWgChunk, 64, 1};
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
  const auto kernel = tgmm_wgmma_kernel<kMode, kBN, kStages>;
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
template <int kMode>
cudaError_t launch_wgmma_tile(const Args& p, int tile_n, int largest_first,
                              cudaStream_t stream) {
  switch (tile_n) {
    case 128: return launch_wgmma<kMode, 128, 4>(p, largest_first, stream);
    case 256: return launch_wgmma<kMode, 256, 3>(p, largest_first, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_tma_bf16(const Args& p, int mode, int tile_n, int largest_first,
                            cudaStream_t stream) {
  switch (mode) {
    case kPlain: return launch_wgmma_tile<kPlain>(p, tile_n, largest_first, stream);
    case kSwigluIn: return launch_wgmma_tile<kSwigluIn>(p, tile_n, largest_first, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The column tile and walk each mode takes in bf16 (chip_smoke.py times
// each).
constexpr int kTmaTileN = 256;
constexpr int kLargestFirst = 1;

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

// float32: tgmm_f32_kernel, one block per (column tile, K tile, group).
template <int kMode>
cudaError_t launch_f32(const Args& p, cudaStream_t stream) {
  const dim3 grid((p.N + kTileF - 1) / kTileF, (p.K + kTileF - 1) / kTileF, p.E);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  tgmm_f32_kernel<kMode><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

bool widths_ok(int G, int K, int N, int E) {
  return G >= 0 && K > 0 && N > 0 && E > 0 && K % 8 == 0 && N % 8 == 0;
}

}  // namespace

extern "C" int tgmm(const void* a, const void* b, const void* group_sizes, void* out, int G,
                    int K, int N, int E, int mode, int fp32, void* stream) {
  if (!widths_ok(G, K, N, E)) return static_cast<int>(cudaErrorInvalidValue);
  const Args p{a, b, static_cast<const int*>(group_sizes), out, G, K, N, E};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!fp32) return static_cast<int>(launch_tma_bf16(p, mode, kTmaTileN, kLargestFirst, s));
  switch (mode) {
    case kPlain: return static_cast<int>(launch_f32<kPlain>(p, s));
    case kSwigluIn: return static_cast<int>(launch_f32<kSwigluIn>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Either mode in bf16 at column tile tile_n (128 or 256), the tiles walked
// largest group first or (largest_first 0) in group order, whatever tgmm()
// takes: the same operands as tgmm(a, b, group_sizes, out, G, K, N, E, mode,
// 0, stream).
extern "C" int tgmm_tile(const void* a, const void* b, const void* group_sizes, void* out, int G,
                         int K, int N, int E, int mode, int tile_n, int largest_first,
                         void* stream) {
  if (!widths_ok(G, K, N, E)) return static_cast<int>(cudaErrorInvalidValue);
  const Args p{a, b, static_cast<const int*>(group_sizes), out, G, K, N, E};
  return static_cast<int>(
      launch_tma_bf16(p, mode, tile_n, largest_first, static_cast<cudaStream_t>(stream)));
}
