// Dense 3x3 stride-1 SAME conv, no epilogue, for Hopper (sm_90a).
// Replaces the Pallas TPU kernel scripts/smoke_pallas_conv.py:67
// (pallas_conv3x3: one image per program, im2col of the padded image in
// VMEM, one dot against the [9C, K] filter). The tensor-core implicit GEMM
// and its design notes are in conv3x3_tile.cuh, shared with
// conv3x3_bn_silu.cu; this library instantiates it with the identity
// epilogue. At the smoke script's default (C = 16, K = 32) it does 9.2
// kflop per pixel against 96 bytes moved in bf16, 1.2 MB in all: the call is
// bound by its launch, and one K slice of 32 covers the filter, which each
// persistent block stages once.

#include "conv3x3_tile.cuh"

// w: [9C, K] in x's dtype.
extern "C" int conv3x3(const void* x, const void* w, void* out, int B, int H, int W,
                       int C, int K, int is_bf16, void* stream) {
  return static_cast<int>(needle::launch_conv3x3<false>(
      x, w, nullptr, nullptr, out, B, H, W, C, K, is_bf16,
      static_cast<cudaStream_t>(stream)));
}
