// Helpers shared by the conv kernels: element conversion and SiLU, and the
// spatial tiling of dwblock_bn_silu.cu (one thread block per 8x8 tile of
// output pixels, with a one-pixel halo on every side for the 3x3 taps).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace needle {

constexpr int kTileH = 8;
constexpr int kTileW = 8;
constexpr int kTileP = kTileH * kTileW;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloP = kHaloH * kHaloW;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// Loads channels [c0, c0 + cw) of the (kHaloH x kHaloW) halo around the
// tile at (ty0, tx0) of one NHWC image into dst[halo pixel][cs] as float32.
// Pixels outside the image (the SAME border) and channels past cw are 0.
template <typename T>
__device__ __forceinline__ void load_halo(const T* __restrict__ img, float* dst,
                                          int H, int W, int C, int ty0, int tx0,
                                          int c0, int cw, int cs) {
  for (int i = threadIdx.x; i < kHaloP * cs; i += kThreads) {
    const int c = i % cs;
    const int hp = i / cs;
    const int gy = ty0 + hp / kHaloW - 1;
    const int gx = tx0 + hp % kHaloW - 1;
    float v = 0.0f;
    if (c < cw && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = to_f32(img[((size_t)gy * W + gx) * C + c0 + c]);
    }
    dst[i] = v;
  }
}

}  // namespace needle
