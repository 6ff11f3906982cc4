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
// and kSwigluBwdOut move about as many bytes as they multiply (h is 134 MB;
// kSwigluBwdOut also writes 134 MB of dhg and dhu) and sit near the line.
//
// The work list is built on the card in every mode: a work slot walks
// group_sizes and takes the slot-th (group, row tile of 128) pair, a row tile
// that spans a group boundary being visited once per group with its stores
// masked to that group's rows (megablox's store mask); the slots are sized
// from the host-known bound ceil(G / 128) + E - 1 and surplus slots do
// nothing. So no launch reads the sizes on the host.
//
// Every mode in bfloat16 is gmm_wgmma_kernel<mode, tile>, one Hopper
// pipeline (wgmma_tma.cuh): a persistent block on each SM walks the (work
// slot, column tile) items; one producer warp keeps a ring of 64-deep stages
// filled by TMA and signals each through an mbarrier; two consumer
// warpgroups multiply the stages with wgmma m64nNk16 (float32 accumulators
// in registers) and release them. The modes differ in how a stage is
// addressed, what A is and what the epilogue does:
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
//     slice is computed while the previous slice multiplies;
//   kSwigluBwdOut: kPlain's stages, in a ping-pong: warpgroup w takes all
//     128 rows of column half w of a tile (two m64 products per slice), the
//     two warpgroups' mainloops take turns, and each one's epilogue runs
//     while the other multiplies. The epilogue needs h's gate and up at the
//     tile's rows and columns: the producer loads them by TMA from a 3-D map
//     (N, 2, G) into the warpgroup's output tile while the warpgroup
//     multiplies; the warpgroup reads each accumulator's gate and up at the
//     place its bf16 result would be staged (acc_pair_sw128), computes the
//     swiglu backward (the accurate expf and a correctly rounded 1 / (1 + e),
//     by recip_fast without the division's per-value branch), writes dg over
//     gate and du over up, and stores both by TMA.
// All tiles are in the 128-byte swizzle. The column tile is a template
// argument, 128 or 256; each mode holds as many stages as fit (three at
// 256; kSwigluIn's 64 KB stages fit three only because its epilogue stages
// the output 128 columns at a time; kSwigluBwdOut's 32 KB stages three
// beside its 128 KB of h). The wrappers take 256, which ran fastest on the
// card in every mode (PERF.md). The epilogue overlaps the producer's next
// loads: the accumulators go in bf16 into a per-warpgroup output tile in the
// 128-byte swizzle, then, for a tile whose rows all lie in one group, out by
// asynchronous TMA stores that overlap the next item's products, else by
// 16-byte row stores masked to the group's rows. No split of K and no
// atomics: two launches give the same bits.
//
// Every float32 mode keeps the first design (gmm_f32_kernel): one block per
// (row tile, column tile) of one group, 4 x 4 FMA blocks on tiles staged in
// shared memory, the next depth slice loaded into registers while the
// current one multiplies (one barrier per slice). The swiglu backward
// (kSwigluBwdOut) runs in the store epilogue; the swiglu prologue
// (kSwigluIn) while the tile moves from registers to shared memory.
//
// C interface: gmm(a, b, w, h, group_sizes, out, out2, G, K, N, E, mode, fp32,
// stream) returns a cudaError_t as int: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape this kernel does not take. K is the
// contracted width (kDual: the 2f rows of W), N the output width; K and N
// are multiples of 8 (kDual: K of 16). b is read in kDual only, h and out2
// in kSwigluBwdOut only. The bf16 modes also need a, b, w, h, out and out2
// 16-byte aligned (TMA); the wrappers pass them so. gmm_tile(a, b, w, h,
// group_sizes, out, out2, G, K, N, E, mode, tile_n, stream) runs any mode in
// bf16 at column tile 128 or 256, so chip_smoke.py can time each;
// gmm_recip_check(mismatches, stream) holds recip_fast against the division.

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

// --- bfloat16: TMA + wgmma -----------------------------------------------------

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
  // kSwigluBwdOut is a ping-pong: each warpgroup takes all 128 rows of one
  // half of the tile's columns, its stages after the other's.
  static constexpr bool kPingPong = kMode == kSwigluBwdOut;
  static constexpr int kWCols = kPingPong ? kBN / 2 : kBN;           // W columns per stage
  static constexpr int kABoxes = kMode == kSwigluIn ? 2 : 1;         // gate and up
  static constexpr int kATile = kABoxes * kWgATile;                  // elements of A per stage
  static constexpr int kWTile = kWgDepth * kWCols;                   // elements of W per stage
  static constexpr uint32_t kStageBytes = 2 * (kATile + kWTile);    // each stage's TMA bytes
  // Each consumer warpgroup's output tile in the 128-byte swizzle (the TMA
  // store's layout), boxes of 64 x 64: 64 x kOutCols, the whole tile or
  // (kSwigluIn at 256, whose stages are 64 KB) half of it at a time, so that
  // three stages fit; in kSwigluBwdOut h's gate and up for the warpgroup's
  // 128 x kWCols (row half 0's gate boxes, its up boxes, then row half 1's),
  // which the epilogue turns into dhg and dhu in place.
  static constexpr int kOutCols = kABoxes == 2 && kBN == 256 ? 128 : kBN;
  static constexpr int kOutTile = kPingPong ? 4 * 64 * kWCols : 64 * kOutCols;
  // As many stages as fit beside the output tiles and 2 kStages + 6
  // barriers in 227 KB of shared memory, at most four.
  static constexpr size_t kFixedBytes = 2 * kOutTile * sizeof(bf16) + 1024 + 14 * 8;
  static constexpr int kStages = (232448 - kFixedBytes) / kStageBytes < 4
                                     ? static_cast<int>((232448 - kFixedBytes) / kStageBytes)
                                     : 4;
  static constexpr size_t kSmemBytes = kStages * static_cast<size_t>(kStageBytes) +
                                       2 * kOutTile * sizeof(bf16) +
                                       (2 * kStages + 6) * sizeof(uint64_t) + 1024;
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
  for (int c = 0; c < WgShape<kMode, kBN>::kWCols / kWgChunk; ++c) {
    bf16* dst = w_dst + c * kWgDepth * kWgChunk;
    if constexpr (kMode == kDual) {
      tma_load_4d(dst, w_map, bar, n0 + c * kWgChunk, k0, half, e);
    } else {
      tma_load_3d(dst, w_map, bar, n0 + c * kWgChunk, k0, e);
    }
  }
}

// kSwigluBwdOut: h's gate and up at a warpgroup's 128 rows and kCols
// columns into its output tile, reported to `bar`: for each 64-row half,
// kCols / 64 boxes of gate, then as many of up, 64 x 64 each from the 3-D
// map (N, 2, G) of h, which reads zeros past N in each half and past G.
template <int kCols>
__device__ __forceinline__ void load_h(const CUtensorMap* h_map, uint64_t* bar, bf16* tile,
                                       int row0, int n0) {
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int c = 0; c < kCols / kWgChunk; ++c) {
        tma_load_3d(tile + (2 * rh + half) * 64 * kCols + c * 64 * kWgChunk, h_map, bar,
                    n0 + c * kWgChunk, half, row0 + rh * 64);
      }
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

// kSwigluBwdOut's epilogue over 64 rows: each accumulator dy with h's gate
// and up at its place in the tile (tile: kCols / 64 boxes of gate, then of
// up; acc_pair_sw128, the address stage_acc_sw128 writes), the swiglu
// backward on the unrounded float32 dy (swiglu_bwd_f32's bits, its sigmoid
// by sigmoid_n), and dg over gate, du over up, in bf16: the tile becomes
// dhg's boxes and dhu's. The pairs go in batches of kBatch, all loaded
// before any is stored: a store may alias a later load for all the compiler
// knows, and would otherwise make every pair's loads wait for the previous
// pair's stores. Two pairs a batch: more spill beside the 128 accumulators
// of a 128 x 256 ping-pong tile.
template <int kCols>
__device__ __forceinline__ void swiglu_bwd_sw128(const float (&acc)[kCols / 2], bf16* tile) {
  constexpr int kBatch = 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int j0 = 0; j0 < kCols / 8; j0 += kBatch) {
      float g[2 * kBatch], u[2 * kBatch], s[2 * kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const bf16* at = tile + acc_pair_sw128(j0 + b, half);
        const float2 gate = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
        const float2 up =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at + 64 * kCols));
        g[2 * b] = gate.x;
        g[2 * b + 1] = gate.y;
        u[2 * b] = up.x;
        u[2 * b + 1] = up.y;
      }
      sigmoid_n(g, s);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = 4 * (j0 + b) + 2 * half;
        float dg0, du0, dg1, du1;
        swiglu_bwd_s(acc[i], g[2 * b], u[2 * b], s[2 * b], &dg0, &du0);
        swiglu_bwd_s(acc[i + 1], g[2 * b + 1], u[2 * b + 1], s[2 * b + 1], &dg1, &du1);
        bf16* at = tile + acc_pair_sw128(j0 + b, half);
        *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(dg0, dg1);
        *reinterpret_cast<__nv_bfloat162*>(at + 64 * kCols) = __floats2bfloat162_rn(du0, du1);
      }
    }
  }
}

// A warpgroup's 64 x kCols tile of boxes of 64 x 64 (tile) into out (row
// stride n) at rows r0 .., columns c0 ..: 16-byte row pieces, masked to the
// rows [lo, hi) of the group (megablox's store mask) and the columns below n.
template <int kCols>
__device__ __forceinline__ void store_rows_sw128(const bf16* tile, bf16* out, int n, int r0,
                                                 int c0, int lo, int hi) {
  for (int i = threadIdx.x % 128; i < 64 * kCols / 8; i += 128) {
    const int r = i / (kCols / 8);
    const int c = (i % (kCols / 8)) * 8;
    if (r0 + r >= lo && r0 + r < hi && c0 + c < n) {
      const int piece = ((c % kWgChunk) / 8) ^ (r % 8);
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(r0 + r) * n + c0 + c) =
          *reinterpret_cast<const uint4*>(tile + (c / kWgChunk) * 64 * kWgChunk +
                                          r * kWgChunk + piece * 8);
    }
  }
}

// out[r] = A[r] @ W[e] (kPlain), a[r] @ W[e, :f] + b[r] @ W[e, f:] (kDual),
// bf16(silu(gate) up)[r] @ W[e] (kSwigluIn), or dy = g[r] @ W[e] followed by
// the swiglu backward against h[r] into out and out2 (kSwigluBwdOut; b_map
// is h's map then). A persistent block walks the work items blockIdx.x,
// + gridDim.x, ...: item i is column tile i % n_cols of work slot i / n_cols,
// whose (group, row tile, rows [lo, hi)) find_work reads from the sizes
// (surplus slots are skipped by both roles alike). The ring's stages and
// phases run on across items, so the producer loads the next item's first
// stages while the consumers store the last one. Rows past G and depths past
// each source's width read zeros (silu(0) 0 = 0 in kSwigluIn). The rows of a
// tile outside [lo, hi) are multiplied too and masked at the store. No
// atomics and no split of K: each output element is one accumulator's fixed
// sequence of wgmmas, so two launches give the same bits.
//
// The consumers split a tile by rows, 64 each, and multiply every stage
// together, except in kSwigluBwdOut, a ping-pong: warpgroup w takes all 128
// rows of column half w (two m64 products per 16-deep slice), the producer
// loads half 0's stages then half 1's, and so each warpgroup's epilogue (the
// swiglu backward, two MUFU operations and a division per element) runs
// while the other multiplies. Its h tile is the warpgroup's output tile,
// loaded by the producer once it has issued the half's first stages and the
// warpgroup's last stores have read the tile (h_empty + w, which the
// warpgroup's first thread arrives at after its next half's first stage);
// the warpgroup waits for it (h_full + w) once its products are done. The
// two warpgroups' mainloops take turns (order + w, which the other
// warpgroup arrives at once it has waited for its last stage): a warpgroup
// that skips the other's stages could otherwise wait on a full barrier two
// phases behind, whose parity test would pass on the older phase.
template <int kMode, int kBN>
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap out_map,
                 const __grid_constant__ CUtensorMap out2_map, Args p) {
  using Shape = WgShape<kMode, kBN>;
  constexpr int kStages = Shape::kStages;
  constexpr bool kPingPong = Shape::kPingPong;
  constexpr int kHalf = Shape::kWCols;  // kSwigluBwdOut: a warpgroup's columns
  extern __shared__ unsigned char smem_raw[];
  // Swizzle atoms start 1024-byte aligned.
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* w_s = a_s + kStages * Shape::kATile;
  bf16* o_s = w_s + kStages * Shape::kWTile;  // the two warpgroups' output tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(o_s + 2 * Shape::kOutTile);
  uint64_t* empty = full + kStages;
  uint64_t* h_full = empty + kStages;  // kSwigluBwdOut's h tiles, one per warpgroup
  uint64_t* h_empty = h_full + 2;
  uint64_t* order = h_empty + 2;       // kSwigluBwdOut: the warpgroups' turns
  const int n_cols = (p.N + kBN - 1) / kBN;
  const int items = n_cols * static_cast<int>(work_slots(p, kWgRows));
  const int per_source = source_steps<kMode>(p);
  const int steps = kMode == kDual ? 2 * per_source : per_source;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);                   // the producer's arrival, then the TMA bytes
      mbar_init(empty + s, kPingPong ? 1 : 2);  // each consuming warpgroup's arrival
    }
    if (kPingPong) {
      for (int w = 0; w < 2; ++w) {
        mbar_init(h_full + w, 1);
        mbar_init(h_empty + w, 1);
        mbar_init(order + w, 1);
      }
    }
    mbar_fence_init();
  }
  __syncthreads();

  int it = 0;  // stages filled (producer) or consumed (consumers) so far
  if (warp == kProducerWarp) {
    if (threadIdx.x % 32 != 0) return;
    const int h_step = min(kStages, steps) - 1;
    int n = 0;  // items taken
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      int e, row0, lo, hi;
      if (!find_work(p, kWgRows, item / n_cols, &e, &row0, &lo, &hi)) continue;
#pragma unroll 1
      for (int w = 0; w < (kPingPong ? 2 : 1); ++w) {
        const int n0 = (item % n_cols) * kBN + w * kHalf;
        for (int step = 0; step < steps; ++step, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(empty + s, (it / kStages - 1) & 1);
          mbar_arrive_expect_tx(full + s, Shape::kStageBytes);
          load_stage<kMode, kBN>(&a_map, &b_map, &w_map, full + s, a_s + s * Shape::kATile,
                                 w_s + s * Shape::kWTile, step, per_source, row0, n0, e);
          if constexpr (kPingPong) {
            if (step == h_step) {
              if (n > 0) mbar_wait(h_empty + w, (n - 1) & 1);
              mbar_arrive_expect_tx(h_full + w, Shape::kOutTile * sizeof(bf16));
              load_h<kHalf>(&b_map, h_full + w, o_s + w * Shape::kOutTile, row0, n0);
            }
          }
        }
      }
      ++n;
    }
    return;
  }

  const int wg = warp / 4;
  const int wg_tid = threadIdx.x % 128;
  bf16* o_tile = o_s + wg * Shape::kOutTile;
  bf16* out = static_cast<bf16*>(p.out);

  if constexpr (kPingPong) {
    // Warpgroup wg: column half wg of every item, both row halves; its first
    // thread releases the stages it read.
    float acc[2][kHalf / 2];
    int n = 0;  // items taken
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      int e, row0, lo, hi;
      if (!find_work(p, kWgRows, item / n_cols, &e, &row0, &lo, &hi)) continue;
      const int n0 = (item % n_cols) * kBN + wg * kHalf;
      it += wg * steps;  // the other half's stages come first (wg 1) or next (wg 0)
#pragma unroll
      for (int i = 0; i < kHalf / 2; ++i) acc[0][i] = acc[1][i] = 0.f;
      // This warpgroup's turn: the other has waited for its last stage.
      if (wg > 0 || n > 0) mbar_wait(order + wg, (n - 1 + wg) & 1);
      for (int step = 0; step < steps; ++step, ++it) {
        const int s = it % kStages;
        mbar_wait(full + s, (it / kStages) & 1);
        const bf16* a_tile = a_s + s * Shape::kATile;
        const bf16* w_tile = w_s + s * Shape::kWTile;
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgDepth / 16; ++kk) {
          const uint64_t desc_w =
              smem_desc_sw128(w_tile + kk * 16 * kWgChunk, kWgChunkBytes, 1024);
          wgmma_tile<kHalf>(acc[0], smem_desc_sw128(a_tile + kk * 16, 16, 1024), desc_w);
          wgmma_tile<kHalf>(acc[1], smem_desc_sw128(a_tile + 64 * kWgDepth + kk * 16, 16, 1024),
                            desc_w);
        }
        wgmma_commit();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        // The previous step's products are done: release its stage. Once
        // the last item's stores have read the h tile, the producer may load
        // this item's into it.
        wgmma_wait<1>();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        if (step > 0 && wg_tid == 0) mbar_arrive(empty + (it - 1) % kStages);
        if (step == 0 && n > 0 && wg_tid == 0) {
          tma_store_wait_read();
          mbar_arrive(h_empty + wg);
        }
      }
      if (wg_tid == 0) mbar_arrive(order + 1 - wg);
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (wg_tid == 0) mbar_arrive(empty + (it - 1) % kStages);
      it += (1 - wg) * steps;

      // Epilogue, while the other warpgroup multiplies: h's tile has
      // landed; dg and du go over gate and up in place, then out by TMA
      // stores (asynchronous: they overlap the next products), or, for rows
      // across a group boundary or columns past N, by masked row stores.
      mbar_wait(h_full + wg, n & 1);
      ++n;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) swiglu_bwd_sw128<kHalf>(acc[rh], o_tile + rh * 2 * 64 * kHalf);
      fence_proxy_async();
      named_sync(1 + wg, 128);
      bool masked = false;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int r0 = row0 + rh * 64;
        const bf16* dg = o_tile + rh * 2 * 64 * kHalf;
        const bf16* du = dg + 64 * kHalf;
        if (lo <= r0 && hi >= min(r0 + 64, p.G) && n0 + kHalf <= p.N) {
          if (wg_tid == 0) {
#pragma unroll
            for (int c = 0; c < kHalf / kWgChunk; ++c) {
              tma_store_2d(&out_map, dg + c * 64 * kWgChunk, n0 + c * kWgChunk, r0);
              tma_store_2d(&out2_map, du + c * 64 * kWgChunk, n0 + c * kWgChunk, r0);
            }
          }
        } else {
          store_rows_sw128<kHalf>(dg, out, p.N, r0, n0, lo, hi);
          store_rows_sw128<kHalf>(du, static_cast<bf16*>(p.out2), p.N, r0, n0, lo, hi);
          masked = true;
        }
      }
      if (wg_tid == 0) tma_store_commit();
      if (masked) named_sync(1 + wg, 128);  // every read done before the tile is released
    }
  } else {
    // Warpgroup wg owns rows wg * 64 .. + 63 of each tile, and its first
    // thread releases the stages.
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
      // 128-byte swizzle (stage_acc_sw128), once the tile's last TMA store
      // has read it. Named barrier 1 + wg syncs the warpgroup's 128 threads.
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
          // A tile across a group boundary (or past N).
          store_rows_sw128<Shape::kOutCols>(o_tile, out, p.N, r0, c0, lo, hi);
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
  CUtensorMap a_map, b_map, w_map, out_map, out2_map;
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
  if constexpr (kMode == kSwigluBwdOut) {
    // h (G, 2N) as (N, 2, G), in boxes of 64 rows: each warpgroup's gate
    // and up.
    const cuuint64_t dims[3] = {N, 2, G};
    const cuuint64_t strides[2] = {N * 2, N * 4};
    const cuuint32_t box[3] = {kWgChunk, 1, 64};
    err = make_tensor_map_bf16(&b_map, p.h, 3, dims, strides, box);
    if (err != cudaSuccess) return err;
  } else if constexpr (kMode != kDual) {
    b_map = a_map;  // read in kDual and kSwigluBwdOut only
  }
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
  out2_map = out_map;  // written in kSwigluBwdOut only
  if (kMode == kSwigluBwdOut) {
    err = make_tensor_map_bf16(&out2_map, p.out2, 2, out_dims, out_strides, out_box);
    if (err != cudaSuccess) return err;
  }
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
      a_map, b_map, w_map, out_map, out2_map, p);
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

// A mode in bf16 at column tile tile_n (128 or 256).
cudaError_t launch_tma_bf16(const Args& p, int mode, int tile_n, cudaStream_t stream) {
  switch (mode) {
    case kPlain: return launch_wgmma_tile<kPlain>(p, tile_n, stream);
    case kSwigluIn: return launch_wgmma_tile<kSwigluIn>(p, tile_n, stream);
    case kSwigluBwdOut: return launch_wgmma_tile<kSwigluBwdOut>(p, tile_n, stream);
    case kDual: return launch_wgmma_tile<kDual>(p, tile_n, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The column tile each mode takes in bf16, the fastest on the card
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

// recip_fast against 1.f / d at every float d in [1, 2^126): the count of
// differing bits into *mismatches (one atomic add per block).
__global__ void recip_check_kernel(unsigned long long* mismatches) {
  constexpr uint32_t kFirst = 0x3f800000u, kEnd = 0x7e800000u;  // 1 and 2^126
  unsigned long long found = 0;
  for (uint32_t bits = kFirst + blockIdx.x * blockDim.x + threadIdx.x; bits < kEnd;
       bits += gridDim.x * blockDim.x) {
    const float d = __uint_as_float(bits);
    found += __float_as_uint(recip_fast(d)) != __float_as_uint(1.f / d);
  }
  for (int off = 16; off > 0; off /= 2) found += __shfl_xor_sync(0xffffffffu, found, off);
  __shared__ unsigned long long block_found;
  if (threadIdx.x == 0) block_found = 0;
  __syncthreads();
  if (threadIdx.x % 32 == 0) atomicAdd(&block_found, found);
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(mismatches, block_found);
}

// float32: gmm_f32_kernel, one block per (work slot of 64 rows, column tile
// of 64).
template <int kMode>
cudaError_t launch_f32(const Args& p, cudaStream_t stream) {
  const long long slots = work_slots(p, kTileF);
  if (slots > 65535) return cudaErrorInvalidValue;
  const dim3 grid((p.N + kTileF - 1) / kTileF, static_cast<unsigned>(slots));
  gmm_f32_kernel<kMode><<<grid, kThreads, 0, stream>>>(p);
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
  if (!fp32) return static_cast<int>(launch_tma_bf16(p, mode, kTmaTileN, s));
  switch (mode) {
    case kPlain: return static_cast<int>(launch_f32<kPlain>(p, s));
    case kSwigluIn: return static_cast<int>(launch_f32<kSwigluIn>(p, s));
    case kSwigluBwdOut: return static_cast<int>(launch_f32<kSwigluBwdOut>(p, s));
    case kDual: return static_cast<int>(launch_f32<kDual>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Any mode in bf16 at column tile tile_n (128 or 256), whatever gmm()
// takes: the same operands as gmm(a, b, w, h, group_sizes, out, out2, G, K,
// N, E, mode, 0, stream).
extern "C" int gmm_tile(const void* a, const void* b, const void* w, const void* h,
                        const void* group_sizes, void* out, void* out2, int G, int K, int N,
                        int E, int mode, int tile_n, void* stream) {
  if (!widths_ok(G, K, N, E, mode)) return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return static_cast<int>(cudaSuccess);
  const Args p{a, b, w, h, static_cast<const int*>(group_sizes), out, out2, G, K, N, E};
  return static_cast<int>(
      launch_tma_bf16(p, mode, tile_n, static_cast<cudaStream_t>(stream)));
}

// The check of recip_fast (gmm_common.cuh) against the division it stands
// for: *mismatches (zeroed by the caller) gets the count of floats in
// [1, 2^126) where the two differ.
extern "C" int gmm_recip_check(void* mismatches, void* stream) {
  recip_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(mismatches));
  return static_cast<int>(cudaGetLastError());
}
