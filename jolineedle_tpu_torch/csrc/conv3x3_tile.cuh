// Dense 3x3 stride-1 SAME conv for Hopper (sm_90a) as an implicit GEMM:
// M = output pixels, N = K, depth = 9C. Shared by two kernel libraries,
// which differ only in the epilogue (a compile-time parameter):
//
//   - conv3x3_bn_silu.cu: folded eval BN + SiLU, replacing the Pallas
//     kernel jolineedle_tpu/ops/conv.py:50-93 (conv3x3_bn_silu);
//   - conv3x3.cu: no epilogue, replacing scripts/smoke_pallas_conv.py:49-90
//     (pallas_conv3x3).
//
// Both Pallas kernels built the im2col [HW, 9C] of a whole image in VMEM.
// Here:
//
//   - one thread block computes an 8x8 tile of output pixels for a slice of
//     up to kConvKT output channels (grid: tiles x K slices x images);
//   - it walks the input channels kConvCC at a time: the halo tile of those
//     channels and the matching [9][kConvCC][kConvKT] filter slice are
//     staged in shared memory (zero outside the image: the SAME border is
//     masked here, no padded copy and no im2col in HBM);
//   - each thread keeps 4 neighbouring pixels x up to 4 output channels of
//     float32 sums in registers, reusing every filter value 4 times.
//
// Float32 math on the CUDA cores; at the nano stem's C = 12, K = 16 the f32
// form is bound by operations, the bf16 form by bytes.
#pragma once

#include "common.cuh"

namespace needle {

constexpr int kConvCC = 16;  // input channels per shared-memory stage
constexpr int kConvKT = 64;  // output channels per thread block
constexpr int kConvQuads = kTileP / 4;                     // 4-pixel groups per tile
constexpr int kConvPerThread = kConvQuads * kConvKT / kThreads;  // = 4

// out = conv(x, wf) [* scale + bias -> SiLU when kBnSilu]. scale and bias
// are read only when kBnSilu.
template <typename T, bool kBnSilu>
__global__ void __launch_bounds__(kThreads)
conv3x3_tile_kernel(const T* __restrict__ x, const float* __restrict__ wf,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    T* __restrict__ out, int H, int W, int C, int K, int tiles_w) {
  __shared__ float halo[kHaloP * kConvCC];        // [halo pixel][kConvCC]
  __shared__ float wsm[9 * kConvCC * kConvKT];    // [tap][kConvCC][kConvKT]

  const int b = blockIdx.z;
  const int k0 = blockIdx.y * kConvKT;
  const int kt = min(kConvKT, K - k0);
  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  const T* img = x + (size_t)b * H * W * C;

  float acc[kConvPerThread][4];
#pragma unroll
  for (int q = 0; q < kConvPerThread; ++q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[q][j] = 0.0f;
  }

  for (int c0 = 0; c0 < C; c0 += kConvCC) {
    const int cw = min(kConvCC, C - c0);
    __syncthreads();  // the previous stage's reads are done
    load_halo(img, halo, H, W, C, ty0, tx0, c0, cw, kConvCC);
    for (int i = threadIdx.x; i < 9 * kConvCC * kConvKT; i += kThreads) {
      const int kk = i % kConvKT;
      const int c = (i / kConvKT) % kConvCC;
      const int tap = i / (kConvKT * kConvCC);
      float v = 0.0f;
      if (c < cw && kk < kt) v = __ldg(&wf[((size_t)tap * C + c0 + c) * K + k0 + kk]);
      wsm[i] = v;
    }
    __syncthreads();

#pragma unroll
    for (int q = 0; q < kConvPerThread; ++q) {
      const int i = threadIdx.x + q * kThreads;
      if (i < kConvQuads * kt) {
        const int kk = i % kt;
        const int p0 = (i / kt) * 4;  // 4 pixels of one tile row
        const int py = p0 / kTileW, px = p0 % kTileW;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float* h = halo + ((py + tap / 3) * kHaloW + px + tap % 3) * kConvCC;
          const float* w = wsm + tap * kConvCC * kConvKT + kk;
#pragma unroll
          for (int c = 0; c < kConvCC; ++c) {
            const float wv = w[c * kConvKT];
            acc[q][0] += h[c] * wv;
            acc[q][1] += h[kConvCC + c] * wv;
            acc[q][2] += h[2 * kConvCC + c] * wv;
            acc[q][3] += h[3 * kConvCC + c] * wv;
          }
        }
      }
    }
  }

  T* outb = out + (size_t)b * H * W * K;
#pragma unroll
  for (int q = 0; q < kConvPerThread; ++q) {
    const int i = threadIdx.x + q * kThreads;
    if (i < kConvQuads * kt) {
      const int k = k0 + i % kt;
      const int p0 = (i / kt) * 4;
      const int gy = ty0 + p0 / kTileW;
      float sc = 1.0f, bi = 0.0f;
      if constexpr (kBnSilu) {
        sc = __ldg(&scale[k]);
        bi = __ldg(&bias[k]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gx = tx0 + p0 % kTileW + j;
        if (gy < H && gx < W) {
          float y = acc[q][j];
          if constexpr (kBnSilu) y = silu(y * sc + bi);
          outb[((size_t)gy * W + gx) * K + k] = from_f32<T>(y);
        }
      }
    }
  }
}

template <bool kBnSilu>
cudaError_t launch_conv3x3(const void* x, const void* wf, const void* scale,
                           const void* bias, void* out, int B, int H, int W, int C,
                           int K, int is_bf16, cudaStream_t stream) {
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  dim3 grid(tiles_h * tiles_w, (K + kConvKT - 1) / kConvKT, B);
  const float* w = static_cast<const float*>(wf);
  const float* s = static_cast<const float*>(scale);
  const float* bb = static_cast<const float*>(bias);
  if (is_bf16) {
    conv3x3_tile_kernel<__nv_bfloat16, kBnSilu><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), w, s, bb,
        static_cast<__nv_bfloat16*>(out), H, W, C, K, tiles_w);
  } else {
    conv3x3_tile_kernel<float, kBnSilu><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), w, s, bb, static_cast<float*>(out), H, W, C, K,
        tiles_w);
  }
  return cudaGetLastError();
}

}  // namespace needle
