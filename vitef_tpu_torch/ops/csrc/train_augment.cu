// Train augment for Hopper (sm_90a): RandomResizedCrop + horizontal flip +
// ToTensor + ImageNet normalize, uint8 NHWC in, NCHW out.
//
// Replaces the TPU kernel vitef_tpu/data/images/transforms.py:_augment_kernel
// (:187, launched by _augment_pallas :204). That kernel builds the bilinear
// weight matrices of the crop (_bilinear_weights :173-184) and applies them
// as two small matmuls per channel. Each row of those matrices has at most
// two non-zero taps, max(0, 1 - |u - x|) at x = floor(u) and floor(u) + 1,
// whatever the scale; taps outside [0, src) are dropped and the row is
// renormalised. So here every output pixel is a direct two-by-two bilinear
// gather with the same weights:
//     u = (o' + 0.5) * (length / size) + start - 0.5,  o' = size - 1 - o if flipped
// (the flip mirrors the output column), then out = value / (255 std_c) -
// mean_c / std_c in float32, stored as bfloat16 or float32.
//
// What bounds it on this card: the output write. At N = 512, 32 x 32 source
// images and size 224 it writes 3 * 224 * 224 * 2 bytes * 512 = 154 MB and
// reads 1.6 MB; the arithmetic (a few dozen operations per pixel) is far
// below the card's rate. What the design does about it:
//   - one block per (image, band of 32 output rows), all three channels;
//   - the image (H * W * 3 uint8, 3 KB at 32 x 32) is staged in shared memory
//     once per block, so the gathers never touch device memory;
//   - neighbouring threads write neighbouring pixels of one channel row, so
//     every warp's stores are coalesced;
//   - the block reads its own box and flip flag; the taps are recomputed per
//     pixel (cheaper than staging them).
//
// C interface:
//   train_augment(images, boxes, flips, out, N, H, W, size, out_bf16, stream)
// images (N, H, W, 3) uint8, boxes (N, 4) int32 as (top, left, h, w), flips
// (N,) uint8, out (N, 3, size, size) bfloat16 if out_bf16 else float32.
// Returns a cudaError_t as int: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape this kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 32;
constexpr int kMaxImageBytes = 48 * 1024;  // static shared-memory budget, no opt-in

// ImageNet statistics as float32 (transforms.IMAGENET_MEAN / IMAGENET_STD);
// the normalize constants are computed from them in double on the host.
constexpr float kMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kStd[3] = {0.229f, 0.224f, 0.225f};

struct Normalize {
  float scale[3];  // 1 / (255 std_c)
  float shift[3];  // -mean_c / std_c
};

struct Taps {
  int lo, hi;      // source indices, clamped into [0, src)
  float wlo, whi;  // their weights; a tap outside [0, src) has weight 0
};

// The bilinear taps of output coordinate o for a crop [start, start + length)
// of a source axis of `src` pixels resized to `size`.
__device__ __forceinline__ Taps taps(int o, int start, int length, int size, int src,
                                     bool flip) {
  const float of = flip ? (size - 1.f) - static_cast<float>(o) : static_cast<float>(o);
  const float inv_s = static_cast<float>(length) / static_cast<float>(size);
  const float u = (of + 0.5f) * inv_s + static_cast<float>(start) - 0.5f;
  const int x0 = static_cast<int>(floorf(u));
  float w0 = fmaxf(0.f, 1.f - fabsf(u - static_cast<float>(x0)));
  float w1 = fmaxf(0.f, 1.f - fabsf(u - static_cast<float>(x0 + 1)));
  if (x0 < 0 || x0 >= src) w0 = 0.f;
  if (x0 + 1 < 0 || x0 + 1 >= src) w1 = 0.f;
  const float total = w0 + w1;
  return {max(x0, 0), min(x0 + 1, src - 1), w0 / total, w1 / total};
}

__device__ __forceinline__ void store(float* out, size_t i, float v) { out[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* out, size_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
train_augment_kernel(const uint8_t* __restrict__ images, const int* __restrict__ boxes,
                     const uint8_t* __restrict__ flips, Out* __restrict__ out, int H, int W,
                     int size, Normalize norm) {
  extern __shared__ uint8_t img[];
  const int n = blockIdx.x;
  const int pixels = H * W * 3;
  const uint8_t* src = images + static_cast<size_t>(n) * pixels;
  for (int i = threadIdx.x; i < pixels; i += kThreads) img[i] = src[i];
  const int top = boxes[4 * n], left = boxes[4 * n + 1];
  const int box_h = boxes[4 * n + 2], box_w = boxes[4 * n + 3];
  const bool flip = flips[n] != 0;
  __syncthreads();

  const int r0 = blockIdx.y * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, size - r0);
  const int total = 3 * rows * size;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int ox = idx % size;
    const int t = idx / size;
    const int oy = r0 + t % rows;
    const int c = t / rows;
    const Taps ty = taps(oy, top, box_h, size, H, false);
    const Taps tx = taps(ox, left, box_w, size, W, flip);
    const uint8_t* lo = img + static_cast<size_t>(ty.lo) * W * 3 + c;
    const uint8_t* hi = img + static_cast<size_t>(ty.hi) * W * 3 + c;
    const float top_row = tx.wlo * lo[tx.lo * 3] + tx.whi * lo[tx.hi * 3];
    const float bottom_row = tx.wlo * hi[tx.lo * 3] + tx.whi * hi[tx.hi * 3];
    const float v = ty.wlo * top_row + ty.whi * bottom_row;
    store(out, ((static_cast<size_t>(n) * 3 + c) * size + oy) * size + ox,
          v * norm.scale[c] + norm.shift[c]);
  }
}

}  // namespace

extern "C" int train_augment(const void* images, const void* boxes, const void* flips,
                             void* out, int n, int H, int W, int size, int out_bf16,
                             void* stream) {
  const long long image_bytes = static_cast<long long>(H) * W * 3;
  if (n <= 0 || H <= 0 || W <= 0 || size <= 0 || image_bytes > kMaxImageBytes ||
      (size + kRowsPerBlock - 1) / kRowsPerBlock > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Normalize norm;
  for (int c = 0; c < 3; ++c) {
    norm.scale[c] = static_cast<float>(1.0 / (255.0 * static_cast<double>(kStd[c])));
    norm.shift[c] = static_cast<float>(-static_cast<double>(kMean[c]) /
                                       static_cast<double>(kStd[c]));
  }
  const dim3 grid(n, (size + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t smem = static_cast<size_t>(image_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* img = static_cast<const uint8_t*>(images);
  const int* box = static_cast<const int*>(boxes);
  const uint8_t* flip = static_cast<const uint8_t*>(flips);
  if (out_bf16) {
    train_augment_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        img, box, flip, static_cast<__nv_bfloat16*>(out), H, W, size, norm);
  } else {
    train_augment_kernel<float><<<grid, kThreads, smem, s>>>(
        img, box, flip, static_cast<float*>(out), H, W, size, norm);
  }
  return static_cast<int>(cudaGetLastError());
}
