// Train augment for Hopper (sm_90a): RandomResizedCrop + horizontal flip +
// ToTensor + ImageNet normalize, uint8 NHWC in, NCHW out.
//
// Replaces the TPU kernel vitef_tpu/data/images/transforms.py:_augment_kernel
// (:187, launched by _augment_pallas :204). That kernel builds the bilinear
// weight matrices of the crop (_bilinear_weights :173-184) and applies them
// as two small matmuls per channel. Each row of those matrices has at most
// two non-zero taps, max(0, 1 - |u - x|) at x = floor(u) and floor(u) + 1,
// whatever the scale; taps outside [0, src) are dropped and the row is
// renormalised. So here every output value is a two-by-two bilinear gather
// with the same weights:
//     u = (o' + 0.5) * (length * (1 / size)) + start - 0.5,  o' = size - 1 - o if flipped
// (the flip mirrors the output column), then out = value / (255 std_c) -
// mean_c / std_c in float32, stored as bfloat16 or float32. The coordinate
// and weights are rounded as XLA computes the JAX kernel: the reciprocal
// of size rounded to float32, and (o' + 0.5) * inv_s + start in one fused
// multiply-add. The plain version rounds them alike, so both find the same
// taps and weights.
//
// What bounds it on this card: the output write. At N = 512, 32 x 32 sources
// and size 224 it writes 3 * 224^2 * 2 bytes * 512 = 154.1 MB and reads
// 1.6 MB, 0.0465 ms at 3.35 TB/s. The arithmetic of a two-tap map is a few
// operations per value; the first design spent far more (an index decode
// with four divisions, both axes' taps with three divisions each, four
// one-byte reads and a 2-byte store, for every value), so it was limited by
// its instructions. What this design does:
//   - one block per (image, band of R output rows), all three channels;
//   - taps once: the block builds the x taps of every output column (the
//     flip folded in) and the y taps of its R rows in shared memory; nothing
//     per value divides or rounds down;
//   - separable: the source rows the band reads (at most
//     floor((R-1) H / size) + 3, as y is monotone in the output row) are
//     first resized along x into shared memory as float4 (r, g, b, -); each
//     output value is then two loads, for all three channels at once, and a
//     lerp between two of those rows;
//   - a thread takes 8 consecutive columns of a row for all three channels,
//     fixed by its (threadIdx.x, threadIdx.y); each channel's 8 values leave
//     in one 16-byte streaming store (two for float32), and a ragged or
//     unaligned run of a row in scalar stores;
//   - the resized rows keep 9 float4 slots per 8 columns, so the 8 threads
//     of a 16-byte load phase read 8 different bank groups.
// The source's width costs no shared memory, and a band of one row holds
// four source rows whatever their count, so every source size is taken; the
// output width is the limit: size up to 2640, where one row's band fills
// the 227 KB a block may opt in to. R is the largest up to 64 whose shared
// memory stays within 64 KB (several blocks an SM), else 1, then evened out
// over its bands (224 rows: 4 bands of 56, 48,832 bytes, 2,048 blocks at
// N = 512); the wrapper (data/images/transforms.py augment_band_rows)
// computes the same plan to refuse a size, and chip_smoke.py holds the two
// equal through train_augment_plan.
//
// C interface:
//   train_augment(images, boxes, flips, out, N, H, W, size, out_bf16, stream)
// images (N, H, W, 3) uint8, boxes (N, 4) int32 as (top, left, h, w), flips
// (N,) uint8, out (N, 3, size, size) bfloat16 if out_bf16 else float32.
// Each box lies within its image (0 <= top, 1 <= h, top + h <= H, likewise
// across), as sample_crop_batch draws them; past that the kernel reads and
// writes only its own memory, but its values are undefined. Returns a
// cudaError_t as int: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape this kernel does not take.
//   train_augment_plan(H, size, plan)
// writes the plan of that shape to plan[0..2]: output rows a block, its
// dynamic shared memory in bytes, the resized source rows it holds (rows 0
// if the shape is refused).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRun = 8;                 // output columns a thread takes
constexpr int kSlots = kRun + 1;        // float4 slots per run in a resized row
constexpr int kBandRows = 64;           // output rows a block takes at most
constexpr int kStageBytes = 64 * 1024;  // a block's shared-memory aim
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr int kMaxThreadsX = 32, kMaxThreadsY = 8;

// ImageNet statistics as float32 (transforms.IMAGENET_MEAN / IMAGENET_STD);
// the normalize constants are computed from them in double on the host.
constexpr float kMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kStd[3] = {0.229f, 0.224f, 0.225f};

struct Normalize {
  float scale[3];  // 1 / (255 std_c)
  float shift[3];  // -mean_c / std_c
};

// The taps of one output coordinate: two source indices (x taps: their byte
// offsets in a row, 3 x) and their renormalised weights; a tap outside
// [0, src) has weight 0 and its index clamped.
struct alignas(16) Taps {
  int lo, hi;
  float wlo, whi;
};

struct Plan {
  int rows;     // output rows a block takes; 0 if the shape is refused
  int smem;     // its dynamic shared memory in bytes
  int src_rows; // resized source rows it holds at most
};

__host__ __device__ inline int groups_of(int size) { return (size + kRun - 1) / kRun; }

// data/images/transforms.py augment_smem_bytes and augment_band_rows.
__host__ inline Plan plan_of(int H, int size) {
  const long long groups = groups_of(size);
  auto bytes = [&](int rows, int src_rows) {
    return 16LL * (kRun * groups + rows + kSlots * groups * src_rows);
  };
  auto src_rows_of = [&](int rows) {
    return static_cast<int>(static_cast<long long>(rows - 1) * H / size + 4);
  };
  if (bytes(1, src_rows_of(1)) > kMaxSmemBytes) return {0, 0, 0};
  int rows = size < kBandRows ? size : kBandRows;
  while (rows > 1 && bytes(rows, src_rows_of(rows)) > kStageBytes) --rows;
  const int bands = (size + rows - 1) / rows;
  rows = (size + bands - 1) / bands;
  return {rows, static_cast<int>(bytes(rows, src_rows_of(rows))), src_rows_of(rows)};
}

// The plain version's float32 steps (transforms._bilinear_weights), each
// rounded as it is there: length times the rounded reciprocal of size, and
// (o' + 0.5) * inv_s + start in one fused multiply-add, as XLA computes the
// JAX kernel.
__device__ Taps taps(int o, int start, int length, int size, int src, bool flip) {
  const float of = flip ? __fsub_rn(size - 1.f, static_cast<float>(o)) : static_cast<float>(o);
  const float inv_s = __fmul_rn(static_cast<float>(length), __frcp_rn(static_cast<float>(size)));
  const float u = __fsub_rn(
      __fmaf_rn(__fadd_rn(of, 0.5f), inv_s, static_cast<float>(start)), 0.5f);
  const float f0 = floorf(u);
  const int x0 = static_cast<int>(f0);
  float w0 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(u, f0))));
  float w1 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(u, __fadd_rn(f0, 1.f)))));
  if (x0 < 0 || x0 >= src) w0 = 0.f;
  if (x0 + 1 < 0 || x0 + 1 >= src) w1 = 0.f;
  const float total = __fadd_rn(w0, w1);
  return {max(x0, 0), min(x0 + 1, src - 1), __fdiv_rn(w0, total), __fdiv_rn(w1, total)};
}

__device__ __forceinline__ float4 lerp_pixel(const uint8_t* row, const Taps& t) {
  const uint8_t* a = row + t.lo;
  const uint8_t* b = row + t.hi;
  return make_float4(t.wlo * static_cast<float>(__ldg(a)) + t.whi * static_cast<float>(__ldg(b)),
                     t.wlo * static_cast<float>(__ldg(a + 1)) +
                         t.whi * static_cast<float>(__ldg(b + 1)),
                     t.wlo * static_cast<float>(__ldg(a + 2)) +
                         t.whi * static_cast<float>(__ldg(b + 2)),
                     0.f);
}

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}

// One channel's run of kRun values of an output row: one 16-byte store (two
// for float32) where the run is whole and aligned, else one value at a time.
__device__ __forceinline__ void store_run(__nv_bfloat16* dst, const float (&v)[kRun], int count) {
  if (count == kRun && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    __stcs(reinterpret_cast<uint4*>(dst), make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7])));
  } else {
    for (int j = 0; j < count; ++j) dst[j] = __float2bfloat16_rn(v[j]);
  }
}

__device__ __forceinline__ void store_run(float* dst, const float (&v)[kRun], int count) {
  if (count == kRun && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
    __stcs(reinterpret_cast<float4*>(dst) + 1, make_float4(v[4], v[5], v[6], v[7]));
  } else {
    for (int j = 0; j < count; ++j) dst[j] = v[j];
  }
}

// Block (image n = blockIdx.x, band blockIdx.y of `band_rows` output rows);
// threads (x, y): x walks the runs of 8 columns, y the rows.
template <typename Out>
__global__ void __launch_bounds__(kMaxThreadsX * kMaxThreadsY)
train_augment_band_kernel(const uint8_t* __restrict__ images, const int* __restrict__ boxes,
                          const uint8_t* __restrict__ flips, Out* __restrict__ out, int H,
                          int W, int size, int band_rows, int max_src_rows, Normalize norm) {
  extern __shared__ float4 smem[];
  const int groups = groups_of(size);
  Taps* xt = reinterpret_cast<Taps*>(smem);          // kRun * groups
  Taps* yt = xt + kRun * groups;                     // band_rows
  float4* resized = reinterpret_cast<float4*>(yt + band_rows);  // max_src_rows rows

  const int n = blockIdx.x;
  const int r0 = blockIdx.y * band_rows;
  const int rows = min(band_rows, size - r0);
  const int top = boxes[4 * n], left = boxes[4 * n + 1];
  const int box_h = boxes[4 * n + 2], box_w = boxes[4 * n + 3];
  const bool flip = flips[n] != 0;

  // 1. The taps: x of every column (past `size` a copy of the last), y of the band's rows.
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
  for (int i = tid; i < kRun * groups + rows; i += threads) {
    if (i < kRun * groups) {
      Taps t = taps(min(i, size - 1), left, box_w, size, W, flip);
      t.lo *= 3;
      t.hi *= 3;
      xt[i] = t;
    } else {
      yt[i - kRun * groups] = taps(r0 + i - kRun * groups, top, box_h, size, H, false);
    }
  }
  __syncthreads();

  // 2. The source rows the band reads, resized along x (rows are monotone in
  //    the output row: no vertical flip). A box within its image cannot pass
  //    the plan's bound; for one that does not, this min and phase 3's clamp
  //    keep every access inside shared memory.
  const int y_first = yt[0].lo;
  const int src_rows = min(yt[rows - 1].hi - y_first + 1, max_src_rows);
  const int row_slots = kSlots * groups;
  const uint8_t* image = images + static_cast<size_t>(n) * H * W * 3;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    Taps t[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) t[j] = xt[kRun * g + j];
    for (int s = threadIdx.y; s < src_rows; s += blockDim.y) {
      const uint8_t* src = image + static_cast<size_t>(y_first + s) * W * 3;
      float4* dst = resized + s * row_slots + kSlots * g;
#pragma unroll
      for (int j = 0; j < kRun; ++j) dst[j] = lerp_pixel(src, t[j]);
    }
  }
  __syncthreads();

  // 3. Each output value: a lerp between two resized rows, normalised, stored.
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int ox = kRun * g;
    const int count = min(kRun, size - ox);
    for (int r = threadIdx.y; r < rows; r += blockDim.y) {
      const Taps ty = yt[r];
      const int lo = max(min(ty.lo - y_first, src_rows - 1), 0);
      const int hi = max(min(ty.hi - y_first, src_rows - 1), 0);
      const float4* a = resized + lo * row_slots + kSlots * g;
      const float4* b = resized + hi * row_slots + kSlots * g;
      float v[3][kRun];
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const float4 p = a[j], q = b[j];
        v[0][j] = (ty.wlo * p.x + ty.whi * q.x) * norm.scale[0] + norm.shift[0];
        v[1][j] = (ty.wlo * p.y + ty.whi * q.y) * norm.scale[1] + norm.shift[1];
        v[2][j] = (ty.wlo * p.z + ty.whi * q.z) * norm.scale[2] + norm.shift[2];
      }
      const size_t oy = r0 + r;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        store_run(out + ((static_cast<size_t>(n) * 3 + c) * size + oy) * size + ox, v[c], count);
      }
    }
  }
}

template <typename Out>
int launch(const uint8_t* images, const int* boxes, const uint8_t* flips, Out* out, int n,
           int H, int W, int size, const Plan& plan, const Normalize& norm, cudaStream_t s) {
  const auto kernel = train_augment_band_kernel<Out>;
  if (plan.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int groups = groups_of(size);
  const dim3 block(groups < kMaxThreadsX ? groups : kMaxThreadsX,
                   plan.rows < kMaxThreadsY ? plan.rows : kMaxThreadsY);
  const dim3 grid(n, (size + plan.rows - 1) / plan.rows);
  kernel<<<grid, block, plan.smem, s>>>(images, boxes, flips, out, H, W, size, plan.rows,
                                        plan.src_rows, norm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int train_augment(const void* images, const void* boxes, const void* flips,
                             void* out, int n, int H, int W, int size, int out_bf16,
                             void* stream) {
  if (n <= 0 || H <= 0 || W <= 0 || size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = plan_of(H, size);
  if (plan.rows == 0 || (size + plan.rows - 1) / plan.rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Normalize norm;
  for (int c = 0; c < 3; ++c) {
    norm.scale[c] = static_cast<float>(1.0 / (255.0 * static_cast<double>(kStd[c])));
    norm.shift[c] = static_cast<float>(-static_cast<double>(kMean[c]) /
                                       static_cast<double>(kStd[c]));
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* img = static_cast<const uint8_t*>(images);
  const int* box = static_cast<const int*>(boxes);
  const uint8_t* flip = static_cast<const uint8_t*>(flips);
  if (out_bf16) {
    return launch(img, box, flip, static_cast<__nv_bfloat16*>(out), n, H, W, size, plan, norm, s);
  }
  return launch(img, box, flip, static_cast<float*>(out), n, H, W, size, plan, norm, s);
}

extern "C" int train_augment_plan(int H, int size, int* plan) {
  const Plan p = H > 0 && size > 0 ? plan_of(H, size) : Plan{0, 0, 0};
  plan[0] = p.rows;
  plan[1] = p.smem;
  plan[2] = p.src_rows;
  return 0;
}
