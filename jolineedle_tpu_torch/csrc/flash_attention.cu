// Causal flash attention forward for Hopper (sm_90a): softmax(QK^T/sqrt(D)) V
// over [B*H, T, D], with the per-row log-sum-exp for the backward pass.
//
// Replaces the Pallas TPU kernel jolineedle_tpu/ops/attention.py:51-135
// (_flash_kernel / flash_attention): one program per (batch*head, q block)
// with K and V whole in VMEM, an online softmax over k blocks in float32,
// k blocks above the diagonal skipped, -1e30 on masked scores, and the
// output rounded once to q's dtype. The TPU kernel asserts T % block == 0;
// this one takes any T and masks the ragged last tile, and takes D in
// {16, 32, 64} (the head dims of gpt-pico ... gpt2).
//
// Design (simple first):
//
//   - one thread block per (batch*head, 64-row q tile), one thread per q
//     row; the row's scaled q, its float32 accumulator [D], running max and
//     running sum live in registers;
//   - the block walks the 64-key K/V tiles up to the diagonal (the loop
//     stops at the tile holding the q tile's last row), staging each tile in
//     shared memory as float32 (keys past T are zero-filled; the causal mask
//     hides them from every row < T);
//   - each row updates its softmax state 16 keys at a time: every thread of
//     the block reads the same K/V row at once, a shared-memory broadcast.
//
// At the needle decoder's shapes (T = 21, D = 16) the work is tiny and the
// kernel is bound by its launch; at long T it is bound by operations on the
// CUDA cores (2 * 2 * T^2 / 2 * D flops per head against 4 T D values
// moved). The tensor-core (mma/wgmma) form is later work.

#include "common.cuh"

namespace {

using namespace needle;

constexpr int kBlockQ = 64;  // q rows per thread block (one thread each)
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kChunk = 16;   // keys per online-softmax update
constexpr float kNegInf = -1e30f;

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int T_len, float scale) {
  __shared__ float ks[kBlockK][D];
  __shared__ float vs[kBlockK][D];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int row = q0 + threadIdx.x;
  const bool live = row < T_len;
  const size_t base = (size_t)bh * T_len * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? to_f32(q[base + (size_t)row * D + d]) * scale : 0.0f;
    acc[d] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  // Tiles up to the one holding the last (valid) row of this q tile.
  const int n_tiles = (min(q0 + kBlockQ, T_len) - 1) / kBlockK + 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's reads are done
    for (int i = threadIdx.x; i < kBlockK * D; i += kBlockQ) {
      const int j = i / D, d = i % D;
      const int key = k0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (key < T_len) {
        kv = to_f32(k[base + (size_t)key * D + d]);
        vv = to_f32(v[base + (size_t)key * D + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
    if (!live) continue;

    // Keys k0 .. row are visible to this row; row >= q0 >= k0, so >= 1.
    const int visible = min(kBlockK, row - k0 + 1);
    for (int c0 = 0; c0 < visible; c0 += kChunk) {  // c0 + j <= 63
      float s[kChunk];
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot += qr[d] * ks[c0 + j][d];
        s[j] = (c0 + j < visible) ? dot : kNegInf;
        mc = fmaxf(mc, s[j]);
      }
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = (c0 + j < visible) ? expf(s[j] - m_new) : 0.0f;
        psum += s[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float a = acc[d] * alpha;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) a += s[j] * vs[c0 + j][d];
        acc[d] = a;
      }
      m = m_new;
    }
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) o[base + (size_t)row * D + d] = from_f32<T>(acc[d] / denom);
    lse[(size_t)bh * T_len + row] = m + logf(denom);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int BH, int T_len, int D, float scale, cudaStream_t stream) {
  const dim3 grid(BH, (T_len + kBlockQ - 1) / kBlockQ);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  float* lp = static_cast<float*>(lse);
  switch (D) {
    case 16:
      flash_fwd_kernel<T, 16><<<grid, kBlockQ, 0, stream>>>(qp, kp, vp, op, lp, T_len, scale);
      break;
    case 32:
      flash_fwd_kernel<T, 32><<<grid, kBlockQ, 0, stream>>>(qp, kp, vp, op, lp, T_len, scale);
      break;
    case 64:
      flash_fwd_kernel<T, 64><<<grid, kBlockQ, 0, stream>>>(qp, kp, vp, op, lp, T_len, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               void* lse, int BH, int T_len, int D, int is_bf16,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? launch<__nv_bfloat16>(q, k, v, o, lse, BH, T_len, D, scale, s)
      : launch<float>(q, k, v, o, lse, BH, T_len, D, scale, s);
  return static_cast<int>(err);
}
