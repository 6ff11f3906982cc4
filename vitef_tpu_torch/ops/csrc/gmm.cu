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
// d = 768, f = 2048) fc1 is 103 GFLOP against 76 MB, so kPlain and kDual
// are bound by the tensor cores' rate (0.104 ms at 989 TFLOP/s); kSwigluIn
// and kSwigluBwdOut move about as many bytes as they multiply (h is 134 MB)
// and sit near the line.
//
// The work list is built on the card in every mode: a work slot walks
// group_sizes and takes the slot-th (group, row tile of 128) pair, a row tile
// that spans a group boundary being visited once per group with its stores
// masked to that group's rows (megablox's store mask); the slots are sized
// from the host-known bound ceil(G / 128) + E - 1 and surplus slots do
// nothing. So no launch reads the sizes on the host.
//
// kPlain, kDual and kSwigluIn in bfloat16 (gmm_wgmma_kernel<mode, ...>) are
// one Hopper pipeline (wgmma_tma.cuh): a persistent block on each SM walks
// the (work slot, column tile) items; one producer warp keeps a ring of
// 64-deep stages filled by TMA and signals each through an mbarrier; two
// consumer warpgroups of 64 rows multiply each stage with wgmma m64nNk16
// (float32 accumulators in registers) and release it. The modes differ only
// in how a stage is addressed and what A is:
//   kPlain: A's 128 x 64 box from a 2-D map (K, G), W's 64 x 64 boxes from a
//     3-D map (N, K, E), so a depth past K reads zeros inside expert e;
//   kDual: ceil(f / 64) stages from a's map with the first half of W, then
//     as many from b's with the second, W being a 4-D map (N, f, 2, E) of
//     the same memory, so each half reads zeros past f inside itself and no
//     stage straddles the a/b seam; the consumers do not know which source a
//     stage came from;
//   kSwigluIn: h as a 3-D map (f, 2, G), whose two 128 x 64 boxes at
//     [k, 0, r] and [k, 1, r] are gate and up (zeros past f in each half);
//     each consumer warpgroup reads its 64 rows of both by ldmatrix from the
//     swizzled boxes straight into the wgmma A-fragment layout, computes
//     y = bf16(silu(gate) up) in registers (silu_fast, gmm_common.cuh, as
//     tgmm_swiglu does: the same y bit for bit), and multiplies with the RS
//     form of wgmma (A from registers). The fragments are double-buffered
//     and wgmma_wait<1> leaves one product in flight, so y for a 16-deep
//     slice is computed while the previous slice multiplies; the prologue's
//     MUFU work, paid once per column tile, is the cost this hides.
// All tiles are in the 128-byte swizzle. The column tile is a template
// argument, 128 or 256; each mode holds as many stages as fit (three at
// 256; kSwigluIn's 64 KB stages fit three only because its epilogue stages
// the output 128 columns at a time). The wrappers take 256, which ran
// fastest on the card (PERF.md; in kSwigluIn a whole stage of fragments
// computed ahead, or three in flight under wgmma_wait<2>, needs more than
// the 168 registers a thread has here and ran slower). The epilogue overlaps the producer's next loads: the
// accumulators go in bf16 into a per-warpgroup output tile in the 128-byte
// swizzle, then, for a tile whose rows all lie in one group, out by
// asynchronous TMA stores that overlap the next item's products, else by
// 16-byte row stores masked to the group's rows. No split of K and no
// atomics: two launches give the same bits.
//
// kSwigluBwdOut in bfloat16 (gmm_swiglu_bwd_kernel) keeps the mma.sync
// design, as does every float32 mode (gmm_f32_kernel): one block per (row
// tile, column tile) of one group, 8 warps of 16 x 8 x 16 mma.sync products
// (bf16) or 4 x 4 FMA blocks (float32) on tiles staged in shared memory, the
// next depth slice loaded into registers while the current one multiplies
// (one barrier per slice). The swiglu backward (kSwigluBwdOut) runs in the
// store epilogue; the float32 swiglu prologue (kSwigluIn) while the tile
// moves from registers to shared memory.
//
// C interface: gmm(a, b, w, h, group_sizes, out, out2, G, K, N, E, mode, fp32,
// stream) returns a cudaError_t as int: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape this kernel does not take. K is the
// contracted width (kDual: the 2f rows of W), N the output width; K and N
// are multiples of 8 (kDual: K of 16). b is read in kDual only, h and out2
// in kSwigluBwdOut only. The TMA modes in bf16 also need a, b, w and out
// 16-byte aligned; the wrappers pass them so. gmm_tile(a, b, w, group_sizes,
// out, G, K, N, E, mode, tile_n, stream) runs kPlain, kDual or kSwigluIn
// in bf16 at column tile 128 or 256, so chip_smoke.py can time each.

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

// --- bfloat16 kSwigluBwdOut: mma.sync ---------------------------------------

// One thread's share of a depth slice: two 16-byte pieces of g and two of W,
// held in registers.
struct StageBf16 {
  uint4 a[2], w[2];
};

__device__ __forceinline__ void load_bf16(const Args& p, StageBf16& s, int e, int row0, int lo,
                                          int hi, int n0, int k0) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const bf16* a = static_cast<const bf16*>(p.a);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int piece = threadIdx.x + i * kThreads;
    const int r = row0 + piece / (kDepth / 8);
    const int k = k0 + (piece % (kDepth / 8)) * 8;
    s.a[i] = zero;
    if (r >= lo && r < hi && k < p.K) s.a[i] = ldg16(a + static_cast<size_t>(r) * p.K + k);
    const int kw = k0 + piece / (kTile / 8);
    const int n = n0 + (piece % (kTile / 8)) * 8;
    s.w[i] = zero;
    if (kw < p.K && n < p.N) {
      s.w[i] = ldg16(static_cast<const bf16*>(p.w) +
                     (static_cast<size_t>(e) * p.K + kw) * p.N + n);
    }
  }
}

__device__ __forceinline__ void store_bf16(const StageBf16& s, bf16* a_tile, bf16* w_tile) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int piece = threadIdx.x + i * kThreads;
    *reinterpret_cast<uint4*>(a_tile + (piece / (kDepth / 8)) * kRowStride +
                              (piece % (kDepth / 8)) * 8) = s.a[i];
    *reinterpret_cast<uint4*>(w_tile + (piece / (kTile / 8)) * kColStride +
                              (piece % (kTile / 8)) * 8) = s.w[i];
  }
}

// kSwigluBwdOut in bf16: dy = g @ W[e] in float32, then the swiglu backward
// against h in the store epilogue.
__global__ void __launch_bounds__(kThreads) gmm_swiglu_bwd_kernel(Args p) {
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
  load_bf16(p, stage, e, row0, lo, hi, n0, 0);
  store_bf16(stage, a_s[0], w_s[0]);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load_bf16(p, stage, e, row0, lo, hi, n0, (step + 1) * kDepth);
#pragma unroll
    for (int k16 = 0; k16 < kDepth / 16; ++k16) {
      warp_mma_k16<true>(acc, a_s[buf], w_s[buf], k16, wm, wn, lane);
    }
    if (step + 1 < steps) store_bf16(stage, a_s[buf ^ 1], w_s[buf ^ 1]);
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
        const size_t at = static_cast<size_t>(r) * p.N + n;
        const bf16* h = static_cast<const bf16*>(p.h) + static_cast<size_t>(r) * 2 * p.N + n;
        const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h));
        const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h + p.N));
        float dg0, du0, dg1, du1;
        swiglu_bwd_f32(acc[mi][ni][2 * half], g.x, u.x, &dg0, &du0);
        swiglu_bwd_f32(acc[mi][ni][2 * half + 1], g.y, u.y, &dg1, &du1);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + at) =
            __floats2bfloat162_rn(dg0, dg1);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out2) + at) =
            __floats2bfloat162_rn(du0, du1);
      }
    }
  }
}

// --- bfloat16 kPlain, kDual, kSwigluIn: TMA + wgmma ---------------------------

// A block computes a 128 x kBN output tile of one (group, row tile): two
// consumer warpgroups of 64 rows (warps 0-7) and one producer warp (warp 8)
// over a ring of stages, each 64 deep: A's 128 x 64 box (kSwigluIn: gate's
// and up's) and W's kBN / 64 boxes of 64 x 64, all in the 128-byte swizzle.
constexpr int kWgRows = 128;
constexpr int kWgDepth = 64;                            // one 128-byte swizzle row of bf16
constexpr int kWgChunk = 64;                            // W columns per TMA box
constexpr int kWgThreads = 288;
constexpr int kProducerWarp = 8;
constexpr int kWgATile = kWgRows * kWgDepth;            // elements of one A box
constexpr int kWgChunkBytes = kWgDepth * kWgChunk * 2;  // one W box: the N-major LBO

template <int kMode, int kBN>
struct WgShape {
  static constexpr int kABoxes = kMode == kSwigluIn ? 2 : 1;  // gate and up
  static constexpr int kATile = kABoxes * kWgATile;                  // elements of A per stage
  static constexpr int kWTile = kWgDepth * kBN;                      // elements of W per stage
  static constexpr uint32_t kStageBytes = 2 * (kATile + kWTile);    // each stage's TMA bytes
  // Each consumer warpgroup's output tile, 64 x kOutCols as kOutCols / 64
  // boxes of 64 x 64 in the 128-byte swizzle (the TMA store's layout): the
  // whole tile, or (kSwigluIn at 256, whose stages are 64 KB) half of it at
  // a time, so that three stages fit.
  static constexpr int kOutCols = kABoxes == 2 && kBN == 256 ? 128 : kBN;
  static constexpr int kOutTile = 64 * kOutCols;
  // As many stages as fit beside the output tiles in 227 KB of shared
  // memory, at most four.
  static constexpr int kStages =
      (232448 - 2 * kOutTile * 2 - 1024 - 64) / kStageBytes < 4
          ? static_cast<int>((232448 - 2 * kOutTile * 2 - 1024 - 64) / kStageBytes)
          : 4;
  static constexpr size_t kSmemBytes = kStages * static_cast<size_t>(kStageBytes) +
                                       2 * kOutTile * sizeof(bf16) +
                                       2 * kStages * sizeof(uint64_t) + 1024;
  static_assert(kStages >= 2 && kSmemBytes <= 232448, "more shared memory than a block may hold");
};

// The slots of a grid over row tiles of `tile` rows: every row tile once,
// plus one more for each group boundary inside a tile (at most E - 1).
__host__ __device__ inline long long work_slots(const Args& p, int tile) {
  return (static_cast<long long>(p.G) + tile - 1) / tile + p.E - 1;
}

// The 64-deep stages of one source of A: K (kDual: f = K / 2, taken once
// from a and once from b).
template <int kMode>
__host__ __device__ inline int source_steps(const Args& p) {
  return ((kMode == kDual ? p.K / 2 : p.K) + kWgDepth - 1) / kWgDepth;
}

// The producer's TMA loads of stage `step` of an item into a_dst and w_dst,
// reported to `bar`. kDual's steps past the first source's take b and the
// second half of W, from depth 0 of each.
template <int kMode, int kBN>
__device__ __forceinline__ void load_stage(const CUtensorMap* a_map, const CUtensorMap* b_map,
                                           const CUtensorMap* w_map, uint64_t* bar,
                                           bf16* a_dst, bf16* w_dst, int step, int per_source,
                                           int row0, int n0, int e) {
  const int half = kMode == kDual && step >= per_source;
  const int k0 = (step - half * per_source) * kWgDepth;
  if constexpr (kMode == kSwigluIn) {
    tma_load_3d(a_dst, a_map, bar, k0, 0, row0);             // gate
    tma_load_3d(a_dst + kWgATile, a_map, bar, k0, 1, row0);  // up
  } else {
    tma_load_2d(a_dst, half ? b_map : a_map, bar, k0, row0);
  }
#pragma unroll
  for (int c = 0; c < kBN / kWgChunk; ++c) {
    bf16* dst = w_dst + c * kWgDepth * kWgChunk;
    if constexpr (kMode == kDual) {
      tma_load_4d(dst, w_map, bar, n0 + c * kWgChunk, k0, half, e);
    } else {
      tma_load_3d(dst, w_map, bar, n0 + c * kWgChunk, k0, e);
    }
  }
}

// kSwigluIn's A fragment of 16-deep slice kk for this thread's warp: the
// warp's 16 rows of gate and of up by ldmatrix from the swizzled boxes
// (g_tile: the warpgroup's 64 rows of gate, up kWgATile further on; row r's
// 16-byte piece q lies at piece q ^ (r % 8)), then y = bf16(silu(gate) up)
// in the A-fragment layout.
__device__ __forceinline__ void swiglu_slice(uint32_t (&frag)[4], const bf16* g_tile, int kk) {
  const int lane = threadIdx.x % 32;
  const int row = (threadIdx.x / 32 % 4) * 16 + (lane & 15);
  const int piece = (2 * kk + (lane >> 4)) ^ (row & 7);
  uint32_t gate[4], up[4];
  ldmatrix_x4(gate, g_tile + row * kWgDepth + piece * 8);
  ldmatrix_x4(up, g_tile + kWgATile + row * kWgDepth + piece * 8);
#pragma unroll
  for (int i = 0; i < 4; ++i) frag[i] = swiglu2(gate[i], up[i]);
}

// out[r] = A[r] @ W[e] (kPlain), a[r] @ W[e, :f] + b[r] @ W[e, f:] (kDual)
// or bf16(silu(gate) up)[r] @ W[e] (kSwigluIn). A persistent
// block walks the work items blockIdx.x, + gridDim.x, ...: item i is column
// tile i % n_cols of work slot i / n_cols, whose (group, row tile, rows
// [lo, hi)) find_work reads from the sizes (surplus slots are skipped by
// both roles alike). The ring's stages and phases run on across items, so
// the producer loads the next item's first stages while the consumers store
// the last one. Rows past G and depths past each source's width read zeros
// (silu(0) 0 = 0 in kSwigluIn). The rows of a tile outside [lo, hi) are
// multiplied too and masked at the store. No atomics and no split of K: each
// output element is one accumulator's fixed sequence of wgmmas, so two
// launches give the same bits.
template <int kMode, int kBN>
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap out_map, Args p) {
  using Shape = WgShape<kMode, kBN>;
  constexpr int kStages = Shape::kStages;
  extern __shared__ unsigned char smem_raw[];
  // Swizzle atoms start 1024-byte aligned.
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* w_s = a_s + kStages * Shape::kATile;
  bf16* o_s = w_s + kStages * Shape::kWTile;  // the two warpgroups' output tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(o_s + 2 * Shape::kOutTile);
  uint64_t* empty = full + kStages;
  const int n_cols = (p.N + kBN - 1) / kBN;
  const int items = n_cols * static_cast<int>(work_slots(p, kWgRows));
  const int per_source = source_steps<kMode>(p);
  const int steps = kMode == kDual ? 2 * per_source : per_source;
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
        load_stage<kMode, kBN>(&a_map, &b_map, &w_map, full + s, a_s + s * Shape::kATile,
                               w_s + s * Shape::kWTile, step, per_source, row0, n0, e);
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
    if constexpr (kMode == kSwigluIn) {
      for (int step = 0; step < steps; ++step, ++it) {
        const int s = it % kStages;
        mbar_wait(full + s, (it / kStages) & 1);
        const bf16* g_tile = a_s + s * Shape::kATile + wg * 64 * kWgDepth;
        const bf16* w_tile = w_s + s * Shape::kWTile;
        // y for slice kk into fragment kk & 1, whose last reader (slice
        // kk - 2) wgmma_wait<1> has retired; slice kk - 1 multiplies
        // meanwhile. After slice 0's wait, the previous stage is read no
        // more: release it.
        uint32_t frag[2][4];
#pragma unroll
        for (int kk = 0; kk < kWgDepth / 16; ++kk) {
          uint32_t(&a)[4] = frag[kk & 1];
          swiglu_slice(a, g_tile, kk);
          fence_frag(a);
          fence_regs(acc);
          wgmma_fence();
          wgmma_tile_rs<kBN>(
              acc, a, smem_desc_sw128(w_tile + kk * 16 * kWgChunk, kWgChunkBytes, 1024));
          wgmma_commit();
          fence_regs(acc);
          fence_frag(a);
          wgmma_wait<1>();
          fence_regs(acc);
          if (kk == 0 && step > 0 && wg_tid == 0) mbar_arrive(empty + (it - 1) % kStages);
        }
      }
    } else {
      for (int step = 0; step < steps; ++step, ++it) {
        const int s = it % kStages;
        mbar_wait(full + s, (it / kStages) & 1);
        const bf16* a_tile = a_s + s * Shape::kATile + wg * 64 * kWgDepth;
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
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (wg_tid == 0) mbar_arrive(empty + (it - 1) % kStages);

    // Epilogue, while the producer fills the next item's stages: the
    // accumulators go in bf16 into the warpgroup's output tile in the
    // 128-byte swizzle (stage_acc_sw128), once the tile's last TMA store has
    // read it. Named barrier 1 + wg syncs the warpgroup's 128 threads.
    const int r0 = row0 + wg * 64;
    const bool whole_rows = lo <= r0 && hi >= min(r0 + 64, p.G);
#pragma unroll
    for (int part = 0; part < kBN / Shape::kOutCols; ++part) {
      const int c0 = n0 + part * Shape::kOutCols;
      if (wg_tid == 0) tma_store_wait_read();
      named_sync(1 + wg, 128);
      stage_acc_sw128<kBN, Shape::kOutCols>(acc, o_tile, part);
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (whole_rows && c0 + Shape::kOutCols <= p.N) {
        // Every row of the warpgroup's tile below G is in the group: TMA
        // stores, asynchronous, overlap the next item's products.
        if (wg_tid == 0) {
#pragma unroll
          for (int c = 0; c < Shape::kOutCols / kWgChunk; ++c) {
            tma_store_2d(&out_map, o_tile + c * 64 * kWgChunk, c0 + c * kWgChunk, r0);
          }
          tma_store_commit();
        }
      } else {
        // A tile across a group boundary (or past N): whole rows in 16-byte
        // pieces, masked to the rows [lo, hi) of the group (megablox's store
        // mask) and the columns below N.
        for (int i = wg_tid; i < 64 * Shape::kOutCols / 8; i += 128) {
          const int r = i / (Shape::kOutCols / 8);
          const int c = (i % (Shape::kOutCols / 8)) * 8;
          if (r0 + r >= lo && r0 + r < hi && c0 + c < p.N) {
            const int piece = ((c % kWgChunk) / 8) ^ (r % 8);
            *reinterpret_cast<uint4*>(out + static_cast<size_t>(r0 + r) * p.N + c0 + c) =
                *reinterpret_cast<const uint4*>(o_tile + (c / kWgChunk) * 64 * kWgChunk +
                                                r * kWgChunk + piece * 8);
          }
        }
      }
    }
  }
  if (wg_tid == 0) tma_store_wait();
}

// gmm_wgmma_kernel at column tile kBN: its tensor maps, built at each call
// (the pointers change), and a persistent grid of one block an SM.
template <int kMode, int kBN>
cudaError_t launch_wgmma(const Args& p, cudaStream_t stream) {
  using Shape = WgShape<kMode, kBN>;
  CUtensorMap a_map, b_map, w_map, out_map;
  const cuuint64_t G = p.G, K = p.K, N = p.N, E = p.E;
  const cuuint64_t f = kMode == kDual ? K / 2 : K;  // the depth of one source of A
  cudaError_t err;
  if constexpr (kMode == kSwigluIn) {
    // h (G, 2f) as (f, 2, G): gate at [k, 0, r], up at [k, 1, r].
    const cuuint64_t dims[3] = {f, 2, G};
    const cuuint64_t strides[2] = {f * 2, f * 4};
    const cuuint32_t box[3] = {kWgDepth, 1, kWgRows};
    err = make_tensor_map_bf16(&a_map, p.a, 3, dims, strides, box);
  } else {
    const cuuint64_t dims[2] = {f, G};
    const cuuint64_t strides[1] = {f * 2};
    const cuuint32_t box[2] = {kWgDepth, kWgRows};
    err = make_tensor_map_bf16(&a_map, p.a, 2, dims, strides, box);
    if (kMode == kDual && err == cudaSuccess) {
      err = make_tensor_map_bf16(&b_map, p.b, 2, dims, strides, box);
    }
  }
  if (err != cudaSuccess) return err;
  if (kMode != kDual) b_map = a_map;  // read in kDual only
  if constexpr (kMode == kDual) {
    // W (E, 2f, N) as (N, f, 2, E): each half reads zeros past f.
    const cuuint64_t dims[4] = {N, f, 2, E};
    const cuuint64_t strides[3] = {N * 2, f * N * 2, 2 * f * N * 2};
    const cuuint32_t box[4] = {kWgChunk, kWgDepth, 1, 1};
    err = make_tensor_map_bf16(&w_map, p.w, 4, dims, strides, box);
  } else {
    const cuuint64_t dims[3] = {N, K, E};
    const cuuint64_t strides[2] = {N * 2, K * N * 2};
    const cuuint32_t box[3] = {kWgChunk, kWgDepth, 1};
    err = make_tensor_map_bf16(&w_map, p.w, 3, dims, strides, box);
  }
  if (err != cudaSuccess) return err;
  const cuuint64_t out_dims[2] = {N, G};
  const cuuint64_t out_strides[1] = {N * 2};
  const cuuint32_t out_box[2] = {kWgChunk, 64};
  err = make_tensor_map_bf16(&out_map, p.out, 2, out_dims, out_strides, out_box);
  if (err != cudaSuccess) return err;
  const auto kernel = gmm_wgmma_kernel<kMode, kBN>;
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
      a_map, b_map, w_map, out_map, p);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_wgmma_tile(const Args& p, int tile_n, cudaStream_t stream) {
  switch (tile_n) {
    case 128: return launch_wgmma<kMode, 128>(p, stream);
    case 256: return launch_wgmma<kMode, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// A TMA mode in bf16 at column tile tile_n (128 or 256).
cudaError_t launch_tma_bf16(const Args& p, int mode, int tile_n, cudaStream_t stream) {
  switch (mode) {
    case kPlain: return launch_wgmma_tile<kPlain>(p, tile_n, stream);
    case kSwigluIn: return launch_wgmma_tile<kSwigluIn>(p, tile_n, stream);
    case kDual: return launch_wgmma_tile<kDual>(p, tile_n, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The column tile the TMA modes take, the fastest on the card in each
// (chip_smoke.py times both).
constexpr int kTmaTileN = 256;

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
  if (kMode != kSwigluBwdOut && !fp32) {
    return launch_tma_bf16(p, kMode, kTmaTileN, stream);
  }
  const int tile = fp32 ? kTileF : kTile;
  const long long slots = work_slots(p, tile);
  if (slots > 65535) return cudaErrorInvalidValue;
  const dim3 grid((p.N + tile - 1) / tile, static_cast<unsigned>(slots));
  if (fp32) {
    gmm_f32_kernel<kMode><<<grid, kThreads, 0, stream>>>(p);
  } else if constexpr (kMode == kSwigluBwdOut) {
    gmm_swiglu_bwd_kernel<<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

// The widths every mode takes: K and N multiples of 8, kDual's K of 16.
bool widths_ok(int G, int K, int N, int E, int mode) {
  return G >= 0 && K > 0 && N > 0 && E > 0 && K % 8 == 0 && N % 8 == 0 &&
         (mode != kDual || K % 16 == 0);
}

}  // namespace

extern "C" int gmm(const void* a, const void* b, const void* w, const void* h,
                   const void* group_sizes, void* out, void* out2, int G, int K, int N, int E,
                   int mode, int fp32, void* stream) {
  if (!widths_ok(G, K, N, E, mode)) return static_cast<int>(cudaErrorInvalidValue);
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

// kPlain, kDual or kSwigluIn in bf16 at column tile tile_n (128 or 256),
// whatever gmm() takes: the same operands as gmm(a, b, w, nullptr,
// group_sizes, out, nullptr, G, K, N, E, mode, 0, stream).
extern "C" int gmm_tile(const void* a, const void* b, const void* w, const void* group_sizes,
                        void* out, int G, int K, int N, int E, int mode, int tile_n,
                        void* stream) {
  if (!widths_ok(G, K, N, E, mode)) return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return static_cast<int>(cudaSuccess);
  const Args p{a, b, w, nullptr, static_cast<const int*>(group_sizes), out, nullptr,
               G, K, N, E};
  return static_cast<int>(
      launch_tma_bf16(p, mode, tile_n, static_cast<cudaStream_t>(stream)));
}
