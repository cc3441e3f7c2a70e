// Dense 3x3 stride-1 SAME conv -> folded eval BN -> SiLU for Hopper
// (sm_90a). Replaces the Pallas TPU kernel jolineedle_tpu/ops/conv.py:68
// (conv3x3_bn_silu). The tensor-core implicit GEMM and its design notes are
// in conv3x3_tile.cuh; this library instantiates it with the BN + SiLU
// epilogue.

#include "conv3x3_tile.cuh"

// w: [9C, K] in x's dtype; scale, bias: [K] float32.
extern "C" int conv3x3_bn_silu(const void* x, const void* w, const void* scale,
                               const void* bias, void* out, int B, int H, int W,
                               int C, int K, int is_bf16, void* stream) {
  return static_cast<int>(needle::launch_conv3x3<true>(
      x, w, scale, bias, out, B, H, W, C, K, is_bf16,
      static_cast<cudaStream_t>(stream)));
}
