// Grouped matrix product for Hopper (sm_90a): kernel K8 (gmm) and three of
// the K7 passes.
//
// Replaces the TPU kernels megablox gmm (jax/experimental/pallas/ops/tpu/
// megablox/gmm.py:314, call :526), which vitef_tpu/parallel/moe.py:_gmm
// (:428) calls for the expert products, and three of vitef_tpu/ops/
// gmm_fused.py's: gmm_swiglu (:94, call :149), gmm_dy_swiglu (:177, call
// :240) and gmm_dual (:370, call :431). Over rows sorted by group it
// computes, for every row r of group e,
//     kPlain:        out[r] = A[r] @ W[e]                      A (G, K), W (E, K, N)
//     kSwigluIn:     out[r] = bf16(silu(h[r, :K]) h[r, K:]) @ W[e]   h (G, 2K)
//     kSwigluBwdOut: acc = g[r] @ W[e] (float32), then
//                    dhg[r] = acc hu silu'(hg), dhu[r] = acc silu(hg)   h (G, 2N)
//     kDual:         out[r] = a[r] @ W[e, :K/2] + b[r] @ W[e, K/2:]      a, b (G, K/2)
// in bfloat16 (tensor cores, float32 accumulators) or float32 (CUDA-core
// FMAs, no TF32); outputs in the input dtype. In kSwigluIn the gated
// activation is rounded to the input dtype before its product, and in
// kSwigluBwdOut the swiglu backward reads the unrounded float32
// accumulator, as the TPU kernels do.
//
// What bounds it on this card: at the 8x124m step (G = 16384 rows, E = 8,
// d = 768, f = 2048) fc1 is 103 GFLOP against 76 MB, so the products are
// bound by the tensor cores' rate (0.104 ms at 989 TFLOP/s); kSwigluIn and
// kSwigluBwdOut move about as many bytes as they multiply (h is 134 MB) and
// sit near the line.
//
// The work list is built on the card in every mode: a work slot walks
// group_sizes and takes the slot-th (group, row tile of 128) pair, a row tile
// that spans a group boundary being visited once per group with its stores
// masked to that group's rows (megablox's store mask); the slots are sized
// from the host-known bound ceil(G / 128) + E - 1 and surplus slots do
// nothing. So no launch reads the sizes on the host.
//
// kPlain in bfloat16 (gmm_wgmma_kernel, K8 gmm on the MoE path) is Hopper's
// asynchronous pipeline (wgmma_tma.cuh): a persistent block on each SM walks
// the (work slot, column tile) items; one producer warp keeps a ring of 64-deep
// stages filled by TMA (A's 128 x 64 box from a 2-D map, W's 64 x 64 boxes
// from a 3-D (N, K, E) map, so a depth past K reads zeros inside expert e;
// all in the 128-byte swizzle) and signals each through an mbarrier; two
// consumer warpgroups of 64 rows multiply each stage with wgmma m64nNk16
// (bf16 from shared memory, W N-major, float32 accumulators in registers)
// and release it. The column tile is 256 with three stages (211 KB of shared
// memory, 154 registers): against 128 with four it reuses each A tile over
// twice the columns, and it ran faster on the card (PERF.md). The epilogue
// overlaps the producer's next loads: the accumulators go in bf16 into a
// per-warpgroup output tile in the 128-byte swizzle, then, for a tile whose
// rows all lie in one group, out by asynchronous TMA stores that overlap the
// next item's products, else by 16-byte row stores masked to the group's
// rows (stores of four bytes a thread straight from the accumulators held
// the kernel back). No split of K and no atomics: two launches give the
// same bits.
//
// The other modes and every float32 mode take the mma.sync design: one block per
// (row tile of 128, column tile of 128) of one group, 8 warps of 16 x 8 x 16
// mma.sync products on tiles staged in shared memory (ldmatrix), the next
// depth slice loaded into registers while the current one multiplies (one
// barrier per slice). The swiglu prologue (kSwigluIn) is applied while the
// tile moves from registers to shared memory; the swiglu backward
// (kSwigluBwdOut) in the store epilogue.
//
// C interface: gmm(a, b, w, h, group_sizes, out, out2, G, K, N, E, mode, fp32,
// stream) returns a cudaError_t as int: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape this kernel does not take. K is the
// contracted width (kDual: the 2f rows of W), N the output width; K and N
// are multiples of 8 (kDual: K of 16). b is read in kDual only, h and out2
// in kSwigluBwdOut only. kPlain in bf16 also needs a, w and out 16-byte
// aligned (TMA); the wrapper passes them so. gmm_plain_tile(a, w,
// group_sizes, out, G, K, N, E, tile_n, stream) runs kPlain in bf16 at
// column tile 128 or 256, so chip_smoke.py can time both.

#include "gmm_common.cuh"
#include "wgmma_tma.cuh"

namespace {

struct Args {
  const void* a;
  const void* b;
  const void* w;
  const void* h;
  const int* sizes;
  void* out;
  void* out2;
  int G, K, N, E;
};

// The (group, row tile, rows [lo, hi)) of work slot `slot` over row tiles of
// `tile` rows, walking the group sizes; false for a surplus slot.
__device__ __forceinline__ bool find_work(const Args& p, int tile, int slot, int* group,
                                          int* row0, int* lo, int* hi) {
  int start = 0;
  for (int e = 0; e < p.E; ++e) {
    const int size = max(__ldg(p.sizes + e), 0);
    const int end = min(start + size, p.G);
    if (end > start) {
      const int first = start / tile;
      const int count = (end - 1) / tile - first + 1;
      if (slot < count) {
        *group = e;
        *row0 = (first + slot) * tile;
        *lo = max(start, *row0);
        *hi = min(end, *row0 + tile);
        return true;
      }
      slot -= count;
    }
    start = end;
  }
  return false;
}

// The row stride of A, in elements, for each mode.
template <int kMode>
__device__ __forceinline__ int a_stride(const Args& p) {
  return kMode == kSwigluIn ? 2 * p.K : (kMode == kDual ? p.K / 2 : p.K);
}

// --- bfloat16 ---------------------------------------------------------------

// One thread's share of a depth slice: two 16-byte pieces of A (with their
// up-halves in kSwigluIn) and two of W, held in registers.
struct StageBf16 {
  uint4 a[2], up[2], w[2];
};

template <int kMode>
__device__ __forceinline__ void load_bf16(const Args& p, StageBf16& s, int e, int row0, int lo,
                                          int hi, int n0, int k0) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int lda = a_stride<kMode>(p);
  const bf16* a = static_cast<const bf16*>(p.a);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int piece = threadIdx.x + i * kThreads;
    const int r = row0 + piece / (kDepth / 8);
    const int k = k0 + (piece % (kDepth / 8)) * 8;
    s.a[i] = s.up[i] = zero;
    if (r >= lo && r < hi && k < p.K) {
      if (kMode == kDual) {
        const int f = p.K / 2;
        const bf16* src = k < f ? a : static_cast<const bf16*>(p.b);
        s.a[i] = ldg16(src + static_cast<size_t>(r) * lda + (k < f ? k : k - f));
      } else {
        s.a[i] = ldg16(a + static_cast<size_t>(r) * lda + k);
        if (kMode == kSwigluIn) s.up[i] = ldg16(a + static_cast<size_t>(r) * lda + p.K + k);
      }
    }
    const int kw = k0 + piece / (kTile / 8);
    const int n = n0 + (piece % (kTile / 8)) * 8;
    s.w[i] = zero;
    if (kw < p.K && n < p.N) {
      s.w[i] = ldg16(static_cast<const bf16*>(p.w) +
                     (static_cast<size_t>(e) * p.K + kw) * p.N + n);
    }
  }
}

template <int kMode>
__device__ __forceinline__ void store_bf16(const StageBf16& s, bf16* a_tile, bf16* w_tile) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int piece = threadIdx.x + i * kThreads;
    const uint4 a = kMode == kSwigluIn ? swiglu8(s.a[i], s.up[i]) : s.a[i];
    *reinterpret_cast<uint4*>(a_tile + (piece / (kDepth / 8)) * kRowStride +
                              (piece % (kDepth / 8)) * 8) = a;
    *reinterpret_cast<uint4*>(w_tile + (piece / (kTile / 8)) * kColStride +
                              (piece % (kTile / 8)) * 8) = s.w[i];
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) gmm_bf16_kernel(Args p) {
  __shared__ __align__(16) bf16 a_s[2][kTile * kRowStride];
  __shared__ __align__(16) bf16 w_s[2][kDepth * kColStride];
  int e, row0, lo, hi;
  if (!find_work(p, kTile, blockIdx.y, &e, &row0, &lo, &hi)) return;
  const int n0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;

  float acc[4][4][4] = {};
  StageBf16 stage;
  const int steps = (p.K + kDepth - 1) / kDepth;
  load_bf16<kMode>(p, stage, e, row0, lo, hi, n0, 0);
  store_bf16<kMode>(stage, a_s[0], w_s[0]);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load_bf16<kMode>(p, stage, e, row0, lo, hi, n0, (step + 1) * kDepth);
#pragma unroll
    for (int k16 = 0; k16 < kDepth / 16; ++k16) {
      warp_mma_k16<true>(acc, a_s[buf], w_s[buf], k16, wm, wn, lane);
    }
    if (step + 1 < steps) store_bf16<kMode>(stage, a_s[buf ^ 1], w_s[buf ^ 1]);
    __syncthreads();
  }

  // Epilogue: accumulator (mi, ni, c) holds row wm*64 + mi*16 + lane/4 (+8
  // for c >= 2), columns wn*32 + ni*8 + 2*(lane%4) (+1 for odd c).
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + wm * 64 + mi * 16 + lane / 4 + half * 8;
      if (r < lo || r >= hi) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * (lane % 4);
        if (n >= p.N) continue;
        const float x = acc[mi][ni][2 * half], y = acc[mi][ni][2 * half + 1];
        const size_t at = static_cast<size_t>(r) * p.N + n;
        if (kMode == kSwigluBwdOut) {
          const bf16* h = static_cast<const bf16*>(p.h) + static_cast<size_t>(r) * 2 * p.N + n;
          const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h));
          const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h + p.N));
          float dg0, du0, dg1, du1;
          swiglu_bwd_f32(x, g.x, u.x, &dg0, &du0);
          swiglu_bwd_f32(y, g.y, u.y, &dg1, &du1);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + at) =
              __floats2bfloat162_rn(dg0, dg1);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out2) + at) =
              __floats2bfloat162_rn(du0, du1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + at) =
              __floats2bfloat162_rn(x, y);
        }
      }
    }
  }
}

// --- bfloat16 kPlain: TMA + wgmma --------------------------------------------

// A block computes a 128 x kBN output tile of one (group, row tile): two
// consumer warpgroups of 64 rows (warps 0-7) and one producer warp (warp 8)
// over a ring of kStages stages, each 64 deep: A's 128 x 64 box and W's
// kBN / 64 boxes of 64 x 64, all in the 128-byte swizzle.
constexpr int kWgRows = 128;
constexpr int kWgDepth = 64;                            // one 128-byte swizzle row of bf16
constexpr int kWgChunk = 64;                            // W columns per TMA box
constexpr int kWgThreads = 288;
constexpr int kProducerWarp = 8;
constexpr int kWgATile = kWgRows * kWgDepth;            // elements of A per stage
constexpr int kWgChunkBytes = kWgDepth * kWgChunk * 2;  // one W box: the N-major LBO

template <int kBN, int kStages>
struct WgShape {
  static constexpr int kWTile = kWgDepth * kBN;                      // elements of W per stage
  static constexpr uint32_t kStageBytes = 2 * (kWgATile + kWTile);  // each stage's TMA bytes
  // Each consumer warpgroup's 64 x kBN output tile, as kBN / 64 boxes of
  // 64 x 64 in the 128-byte swizzle (the TMA store's layout).
  static constexpr int kOutTile = 64 * kBN;
  static constexpr size_t kSmemBytes = kStages * static_cast<size_t>(kStageBytes) +
                                       2 * kOutTile * sizeof(bf16) +
                                       2 * kStages * sizeof(uint64_t) + 1024;
};

// The slots of a grid over row tiles of `tile` rows: every row tile once,
// plus one more for each group boundary inside a tile (at most E - 1).
__host__ __device__ inline long long work_slots(const Args& p, int tile) {
  return (static_cast<long long>(p.G) + tile - 1) / tile + p.E - 1;
}

// kPlain in bf16: out[r] = A[r] @ W[e]. A persistent block walks the work
// items blockIdx.x, + gridDim.x, ...: item i is column tile i % n_cols of
// work slot i / n_cols, whose (group, row tile, rows [lo, hi)) find_work
// reads from the sizes (surplus slots are skipped by both roles alike). The
// ring's stages and phases run on across items, so the producer loads the
// next item's first stages while the consumers store the last one. A is the
// 2-D map (K, G) and W the 3-D map (N, K, E): a depth past K reads zeros
// inside expert e (never expert e + 1), and rows past G read zeros. The rows
// of a tile outside [lo, hi) are multiplied too and masked at the store. No
// atomics and no split of K: each output element is one accumulator's fixed
// sequence of wgmmas, so two launches give the same bits.
template <int kBN, int kStages>
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap out_map, Args p) {
  using Shape = WgShape<kBN, kStages>;
  extern __shared__ unsigned char smem_raw[];
  // Swizzle atoms start 1024-byte aligned.
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* w_s = a_s + kStages * kWgATile;
  bf16* o_s = w_s + kStages * Shape::kWTile;  // the two warpgroups' output tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(o_s + 2 * Shape::kOutTile);
  uint64_t* empty = full + kStages;
  const int n_cols = (p.N + kBN - 1) / kBN;
  const int items = n_cols * static_cast<int>(work_slots(p, kWgRows));
  const int steps = (p.K + kWgDepth - 1) / kWgDepth;
  const int warp = threadIdx.x / 32;

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
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      int e, row0, lo, hi;
      if (!find_work(p, kWgRows, item / n_cols, &e, &row0, &lo, &hi)) continue;
      const int n0 = (item % n_cols) * kBN;
      for (int step = 0; step < steps; ++step, ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + s, (it / kStages - 1) & 1);
        mbar_arrive_expect_tx(full + s, Shape::kStageBytes);
        tma_load_2d(a_s + s * kWgATile, &a_map, full + s, step * kWgDepth, row0);
#pragma unroll
        for (int c = 0; c < kBN / kWgChunk; ++c) {
          tma_load_3d(w_s + s * Shape::kWTile + c * kWgDepth * kWgChunk, &w_map, full + s,
                      n0 + c * kWgChunk, step * kWgDepth, e);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows wg * 64 .. + 63 of each tile, and its
  // first thread releases the stages.
  const int wg = warp / 4;
  const int wg_tid = threadIdx.x % 128;
  bf16* o_tile = o_s + wg * Shape::kOutTile;
  bf16* out = static_cast<bf16*>(p.out);
  float acc[kBN / 2];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int e, row0, lo, hi;
    if (!find_work(p, kWgRows, item / n_cols, &e, &row0, &lo, &hi)) continue;
    const int n0 = (item % n_cols) * kBN;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    for (int step = 0; step < steps; ++step, ++it) {
      const int s = it % kStages;
      mbar_wait(full + s, (it / kStages) & 1);
      const bf16* a_tile = a_s + s * kWgATile + wg * 64 * kWgDepth;
      const bf16* w_tile = w_s + s * Shape::kWTile;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgDepth / 16; ++kk) {
        wgmma_tile<kBN>(acc, smem_desc_sw128(a_tile + kk * 16, 16, 1024),
                        smem_desc_sw128(w_tile + kk * 16 * kWgChunk, kWgChunkBytes, 1024));
      }
      wgmma_commit();
      fence_regs(acc);
      // The previous step's products are done: release its stage.
      wgmma_wait<1>();
      fence_regs(acc);
      if (step > 0 && wg_tid == 0) mbar_arrive(empty + (it - 1) % kStages);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (wg_tid == 0) mbar_arrive(empty + (it - 1) % kStages);

    // Epilogue, while the producer fills the next item's stages: the
    // accumulators go in bf16 into the warpgroup's output tile in the
    // 128-byte swizzle (stage_acc_sw128), once the tile's last TMA store has
    // read it. Named barrier 1 + wg syncs the warpgroup's 128 threads.
    const int r0 = row0 + wg * 64;
    if (wg_tid == 0) tma_store_wait_read();
    named_sync(1 + wg, 128);
    stage_acc_sw128<kBN>(acc, o_tile);
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if (lo <= r0 && hi >= min(r0 + 64, p.G) && n0 + kBN <= p.N) {
      // Every row of the warpgroup's tile below G is in the group: TMA
      // stores, asynchronous, overlap the next item's products.
      if (wg_tid == 0) {
#pragma unroll
        for (int c = 0; c < kBN / kWgChunk; ++c) {
          tma_store_2d(&out_map, o_tile + c * 64 * kWgChunk, n0 + c * kWgChunk, r0);
        }
        tma_store_commit();
      }
    } else {
      // A tile across a group boundary (or past N): whole rows in 16-byte
      // pieces, masked to the rows [lo, hi) of the group (megablox's store
      // mask) and the columns below N.
      for (int i = wg_tid; i < 64 * kBN / 8; i += 128) {
        const int r = i / (kBN / 8);
        const int c = (i % (kBN / 8)) * 8;
        if (r0 + r >= lo && r0 + r < hi && n0 + c < p.N) {
          const int piece = ((c % kWgChunk) / 8) ^ (r % 8);
          *reinterpret_cast<uint4*>(out + static_cast<size_t>(r0 + r) * p.N + n0 + c) =
              *reinterpret_cast<const uint4*>(o_tile + (c / kWgChunk) * 64 * kWgChunk +
                                              r * kWgChunk + piece * 8);
        }
      }
    }
  }
  if (wg_tid == 0) tma_store_wait();
}

// gmm_wgmma_kernel at column tile kBN: its tensor maps, built at each call
// (the pointers change), and a persistent grid of one block an SM.
template <int kBN, int kStages>
cudaError_t launch_wgmma(const Args& p, cudaStream_t stream) {
  using Shape = WgShape<kBN, kStages>;
  CUtensorMap a_map, w_map, out_map;
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(p.K), static_cast<cuuint64_t>(p.G)};
  const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(p.K) * 2};
  const cuuint32_t a_box[2] = {kWgDepth, kWgRows};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(p.N), static_cast<cuuint64_t>(p.K),
                                static_cast<cuuint64_t>(p.E)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(p.N) * 2,
                                   static_cast<cuuint64_t>(p.K) * p.N * 2};
  const cuuint32_t w_box[3] = {kWgChunk, kWgDepth, 1};
  const cuuint64_t out_dims[2] = {static_cast<cuuint64_t>(p.N), static_cast<cuuint64_t>(p.G)};
  const cuuint64_t out_strides[1] = {static_cast<cuuint64_t>(p.N) * 2};
  const cuuint32_t out_box[2] = {kWgChunk, 64};
  cudaError_t err = make_tensor_map_bf16(&a_map, p.a, 2, a_dims, a_strides, a_box);
  if (err != cudaSuccess) return err;
  err = make_tensor_map_bf16(&w_map, p.w, 3, w_dims, w_strides, w_box);
  if (err != cudaSuccess) return err;
  err = make_tensor_map_bf16(&out_map, p.out, 2, out_dims, out_strides, out_box);
  if (err != cudaSuccess) return err;
  const auto kernel = gmm_wgmma_kernel<kBN, kStages>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Shape::kSmemBytes));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>((p.N + kBN - 1) / kBN) * work_slots(p, kWgRows);
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const long long blocks = items < sms ? items : sms;
  kernel<<<static_cast<unsigned>(blocks), kWgThreads, Shape::kSmemBytes, stream>>>(
      a_map, w_map, out_map, p);
  return cudaGetLastError();
}

// The two column tiles, one block an SM: 128 x 128 with four stages
// (163 KB), and 128 x 256 with three (211 KB).
cudaError_t launch_plain_bf16(const Args& p, int tile_n, cudaStream_t stream) {
  switch (tile_n) {
    case 128: return launch_wgmma<128, 4>(p, stream);
    case 256: return launch_wgmma<256, 3>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The column tile kPlain takes (chip_smoke.py times both).
constexpr int kPlainTileN = 256;

// --- float32 ----------------------------------------------------------------

struct StageF32 {
  float4 a, up, w;
};

template <int kMode>
__device__ __forceinline__ void load_f32(const Args& p, StageF32& s, int e, int row0, int lo,
                                         int hi, int n0, int k0) {
  const int lda = a_stride<kMode>(p);
  const float* a = static_cast<const float*>(p.a);
  const int r = row0 + threadIdx.x / (kDepthF / 4);
  const int k = k0 + (threadIdx.x % (kDepthF / 4)) * 4;
  s.a = s.up = zero4();
  if (r >= lo && r < hi && k < p.K) {
    if (kMode == kDual) {
      const int f = p.K / 2;
      const float* src = k < f ? a : static_cast<const float*>(p.b);
      s.a = ldg4(src + static_cast<size_t>(r) * lda + (k < f ? k : k - f));
    } else {
      s.a = ldg4(a + static_cast<size_t>(r) * lda + k);
      if (kMode == kSwigluIn) s.up = ldg4(a + static_cast<size_t>(r) * lda + p.K + k);
    }
  }
  const int kw = k0 + threadIdx.x / (kTileF / 4);
  const int n = n0 + (threadIdx.x % (kTileF / 4)) * 4;
  s.w = zero4();
  if (kw < p.K && n < p.N) {
    s.w = ldg4(static_cast<const float*>(p.w) + (static_cast<size_t>(e) * p.K + kw) * p.N + n);
  }
}

template <int kMode>
__device__ __forceinline__ void store_f32(const StageF32& s, float* a_tile, float* w_tile) {
  const float4 a = kMode == kSwigluIn ? swiglu4(s.a, s.up) : s.a;
  const int r = threadIdx.x / (kDepthF / 4), k = (threadIdx.x % (kDepthF / 4)) * 4;
  a_tile[(k + 0) * kStrideF + r] = a.x;  // depth-major: A is stored transposed
  a_tile[(k + 1) * kStrideF + r] = a.y;
  a_tile[(k + 2) * kStrideF + r] = a.z;
  a_tile[(k + 3) * kStrideF + r] = a.w;
  *reinterpret_cast<float4*>(w_tile + (threadIdx.x / (kTileF / 4)) * kStrideF +
                             (threadIdx.x % (kTileF / 4)) * 4) = s.w;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) gmm_f32_kernel(Args p) {
  __shared__ __align__(16) float a_s[2][kDepthF * kStrideF];
  __shared__ __align__(16) float w_s[2][kDepthF * kStrideF];
  int e, row0, lo, hi;
  if (!find_work(p, kTileF, blockIdx.y, &e, &row0, &lo, &hi)) return;
  const int n0 = blockIdx.x * kTileF;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[4][4] = {};
  StageF32 stage;
  const int steps = (p.K + kDepthF - 1) / kDepthF;
  load_f32<kMode>(p, stage, e, row0, lo, hi, n0, 0);
  store_f32<kMode>(stage, a_s[0], w_s[0]);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load_f32<kMode>(p, stage, e, row0, lo, hi, n0, (step + 1) * kDepthF);
    fma_tile(acc, a_s[buf], w_s[buf], ty, tx);
    if (step + 1 < steps) store_f32<kMode>(stage, a_s[buf ^ 1], w_s[buf ^ 1]);
    __syncthreads();
  }

  const int n = n0 + tx * 4;
  if (n >= p.N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r < lo || r >= hi) continue;
    const size_t at = static_cast<size_t>(r) * p.N + n;
    if (kMode == kSwigluBwdOut) {
      const float* h = static_cast<const float*>(p.h) + static_cast<size_t>(r) * 2 * p.N + n;
      const float4 g = ldg4(h), u = ldg4(h + p.N);
      float4 dg, du;
      swiglu_bwd_f32(acc[i][0], g.x, u.x, &dg.x, &du.x);
      swiglu_bwd_f32(acc[i][1], g.y, u.y, &dg.y, &du.y);
      swiglu_bwd_f32(acc[i][2], g.z, u.z, &dg.z, &du.z);
      swiglu_bwd_f32(acc[i][3], g.w, u.w, &dg.w, &du.w);
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + at) = dg;
      *reinterpret_cast<float4*>(static_cast<float*>(p.out2) + at) = du;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + at) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

template <int kMode>
cudaError_t launch(const Args& p, int fp32, cudaStream_t stream) {
  if (kMode == kPlain && !fp32) return launch_plain_bf16(p, kPlainTileN, stream);
  const int tile = fp32 ? kTileF : kTile;
  const long long slots = work_slots(p, tile);
  if (slots > 65535) return cudaErrorInvalidValue;
  const dim3 grid((p.N + tile - 1) / tile, static_cast<unsigned>(slots));
  if (fp32) {
    gmm_f32_kernel<kMode><<<grid, kThreads, 0, stream>>>(p);
  } else if constexpr (kMode != kPlain) {
    gmm_bf16_kernel<kMode><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int gmm(const void* a, const void* b, const void* w, const void* h,
                   const void* group_sizes, void* out, void* out2, int G, int K, int N, int E,
                   int mode, int fp32, void* stream) {
  if (G < 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8 || (mode == kDual && K % 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (G == 0) return static_cast<int>(cudaSuccess);
  const Args p{a, b, w, h, static_cast<const int*>(group_sizes), out, out2, G, K, N, E};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPlain: return static_cast<int>(launch<kPlain>(p, fp32, s));
    case kSwigluIn: return static_cast<int>(launch<kSwigluIn>(p, fp32, s));
    case kSwigluBwdOut: return static_cast<int>(launch<kSwigluBwdOut>(p, fp32, s));
    case kDual: return static_cast<int>(launch<kDual>(p, fp32, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// kPlain in bf16 at column tile tile_n (128 or 256), whatever gmm() takes:
// the same operands as gmm(a, nullptr, w, nullptr, group_sizes, out, nullptr,
// G, K, N, E, kPlain, 0, stream).
extern "C" int gmm_plain_tile(const void* a, const void* w, const void* group_sizes, void* out,
                              int G, int K, int N, int E, int tile_n, void* stream) {
  if (G < 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (G == 0) return static_cast<int>(cudaSuccess);
  const Args p{a, nullptr, w, nullptr, static_cast<const int*>(group_sizes), out, nullptr,
               G, K, N, E};
  return static_cast<int>(launch_plain_bf16(p, tile_n, static_cast<cudaStream_t>(stream)));
}
