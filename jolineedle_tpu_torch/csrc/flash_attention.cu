// Causal flash attention forward for Hopper (sm_90a): softmax(QK^T/sqrt(D)) V
// over q, k, v [B, H, T, D] read through their (b, h, t) strides, with the
// per-row natural-log log-sum-exp [B, H, T] for the backward pass.
//
// Replaces the Pallas TPU kernel jolineedle_tpu/ops/attention.py:51-135
// (_flash_kernel / flash_attention): one program per (batch*head, q block)
// with K and V whole in VMEM, an online softmax over k blocks in float32,
// k blocks above the diagonal skipped, -1e30 on masked scores, and the
// output rounded once to q's dtype. The TPU kernel asserts T % block == 0;
// this one takes any T and D in {16, 32, 64, 128} (the head dims of gpt-pico
// ... gpt2, and the D = 128 of the JAX package's attention sweep,
// scripts/bench_attention.py).
//
// What bounds it, and what the design does about it:
//
//   - Short T (T <= 64, the needle decoder: T = 21, at most max-seq-len + 1)
//     is bound by the launch: [16, 3, 21, 16] in bf16 moves 43 KB (0.013 us
//     at 3.35 TB/s). So a call is one device operation: the kernel reads the
//     model's q/k/v views (the c_attn split) through their strides and
//     writes o into [B, T, H, D] storage, so no copy runs before or after
//     it. A block of 4 warps packs 4 / ceil(T / 16) heads; each head's q
//     and whole K/V (T rounded up to 16 rows) are copied once by cp.async,
//     one barrier, then every warp runs its 16 rows to the store with no
//     further barrier.
//   - Long T is bound by bytes until T ~ 1,200 in bf16 ([128, 4, 128, 64]
//     moves 33.8 MB: 10.1 us), then by the tensor cores. A block takes 64
//     q rows (4 warps of 16) and walks 64-key K/V tiles up to the diagonal,
//     double-buffered by cp.async; blocks are handed out longest q tile
//     first, so the causal imbalance leaves no tail of idle SMs. Copies in
//     and out are 16-byte vectors where the views' addresses and strides
//     allow (else 8, 4 or 2 bytes): q arrives by cp.async beside K/V, and
//     each warp stages its output rows in its own q rows of shared memory.
//
//   - Both products run on the tensor cores, FA2-style: each warp keeps its
//     16 query rows' A fragments in registers for the whole loop; S = QK^T
//     is scaled in float32 after the product. In bf16 both products are
//     mma.sync m16n8k16 (K's B fragments by ldmatrix, V's by ldmatrix.trans),
//     and P is rounded to bf16 (as the JAX oracle rounds its probabilities
//     to q's dtype) and repacked in registers: two n8 tiles of S's C
//     fragment are one k16 A fragment. P never touches shared memory.
//   - float32 is 3xTF32 (m16n8k8, split_tf32: big*big + big*small +
//     small*big), each key tile's PV summed into a fresh accumulator and
//     added in IEEE float32. The TF32 A fragment (a0 = (g, t), a2 = (g, t+4))
//     does not match S's C layout (g, 2t / 2t+1), so P stays in registers
//     by permuting the k order of each 8-key step: A's k index t holds key
//     2t and t+4 holds key 2t+1, and V's B fragment reads rows 2t and 2t+1
//     to match.
//   - The online softmax lives in registers: a row's max and sum are held
//     by the 4 lanes that share it (reduced by __shfl_xor 1, 2); each
//     probability is one FFMA and one ex2.approx, 2^(s * c - m * c) with
//     c = log2(e) / sqrt(D) folded into one scale, and the stored lse goes
//     back to natural units: (m * c + log2 l) * ln 2.
//   - Causality: key tiles wholly above a warp's rows are skipped, only the
//     diagonal tile is masked (key > row -> -1e30), keys at or past T are
//     zero-filled (cp.async src-size 0), so V's pad rows are 0, never NaN.
//     No row at or past T is stored.
//   - float32 at D = 128: the split q fragments alone would take 128
//     registers a thread beside the 64 of the output accumulator, the 64
//     of the fresh PV accumulator and the 32 of S, past the 255 a thread
//     may hold. So that instantiation keeps no q fragment: each key tile
//     rereads the warp's q rows from shared memory (where they stay until
//     the output is staged over them), one 8-dim step at a time, and
//     splits them again. bf16 at D = 128 holds its 32 registers of q.
//   - Shared memory rows are skewed by 16 bytes, so ldmatrix's 8 rows (and
//     the float32 path's scalar reads) hit distinct banks. The tiles are
//     dynamic shared memory (float32 D = 64 at long T is 87 KB; float32
//     D = 128 is 169 KB at long T, one block per SM, and 101 KB at short T).
//
// wgmma (a 64-row warpgroup tile) is not used: at T = 21 it would leave two
// thirds of its rows idle.

#include "common.cuh"
#include "ptx.cuh"

namespace {

using namespace needle;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;   // keys per K/V tile; q rows per block at long T
constexpr int kShortT = 64;  // T up to this: whole K/V per head, heads packed
constexpr int kStages = 2;  // K/V tile buffers at long T
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, T]
  int B, H, T;
  long long qs[3], ks[3], vs[3], os[3];  // element strides over (b, h, t)
  int vec;                               // bytes per q/k/v copy: 16, 8, 4 or 2
  int heads_per_block;                   // short T; 0 at long T
  float scale_log2;                      // log2(e) / sqrt(D)
};

// Shared memory: the block's q rows (the warps' output rows at the end),
// then `bufs` buffers of a K and a V tile, 64 rows each (1 at short T).
template <typename T, int D>
struct Layout {
  static constexpr int kPitch = D + 16 / (int)sizeof(T);  // elements per smem row
  static constexpr int kTileElems = kTile * kPitch;
  static constexpr int bytes(int bufs) { return (1 + 2 * bufs) * kTileElems * (int)sizeof(T); }
};

// One warp's query rows: their A fragments, the output accumulator and the
// softmax state of the two rows (g and g + 8) each lane holds: m the running
// max of the unscaled scores, l the lane's share of the running sum.
template <typename T, int D>
struct Rows {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  // float32 at D = 128 rereads q from shared memory instead of holding it.
  static constexpr bool kQInSmem = !kBf16 && D > 64;
  // bf16: D/16 k16 fragments; float32: D/8 k8 fragments, big then small.
  uint32_t qa[kQInSmem ? 1 : (kBf16 ? D / 16 : D / 8)][kBf16 ? 4 : 8];
  const T* qs;  // the warp's 16 q rows in shared memory
  float acc[D / 8][4];
  float m[2], l[2];
};

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x, about 2 ulp; 0 for x << 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The warp's 16 q rows, staged at qs, as A fragments; the state reset.
template <typename T, int D>
__device__ __forceinline__ void load_q(Rows<T, D>& r, const T* qs, int lane) {
  constexpr int kPitch = Layout<T, D>::kPitch;
  r.qs = qs;
  if constexpr (Rows<T, D>::kBf16) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // matrices (rows +0 / +8) x (dims +0 / +8)
      ldmatrix_x4(r.qa[kk], smem_u32(qs + (lane & 15) * kPitch + kk * 16 + (lane >> 4) * 8));
  } else if constexpr (!Rows<T, D>::kQInSmem) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = qs[(g + (i & 1) * 8) * kPitch + kk * 8 + t + (i >> 1) * 4];
        split_tf32(v, r.qa[kk][i], r.qa[kk][4 + i]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) r.acc[n][i] = 0.0f;
  r.m[0] = r.m[1] = kNegInf;
  r.l[0] = r.l[1] = 0.0f;
}

// Rows t0 .. t0 + nrows - 1 of up to three [T, D] tensors of head (b, h)
// (src[i] at element strides st[0..2] over (b, h, t)) into rows row0.. of
// dst[i], by the whole block in copies of p.vec bytes; rows at or past T are
// zeros. One cp.async group.
template <typename T, int D, int N>
__device__ __forceinline__ void stage_rows(T* const (&dst)[N], const void* const (&src)[N],
                                           const long long* const (&st)[N], const Params& p,
                                           int b, int h, int t0, int nrows, int row0) {
  constexpr int kPitch = Layout<T, D>::kPitch;
  with_width(p.vec, [&](auto bytes) {
    constexpr int kVe = decltype(bytes)::value / (int)sizeof(T) > 0
                            ? decltype(bytes)::value / (int)sizeof(T) : 1;
    constexpr int kNv = D / kVe;  // copies per row
#pragma unroll
    for (int x = 0; x < N; ++x) {
      const T* base = static_cast<const T*>(src[x]) + b * st[x][0] + h * st[x][1];
      const long long rs = st[x][2];
#pragma unroll 1
      for (int e = threadIdx.x; e < nrows * kNv; e += kThreads) {
        const int j = e / kNv, d = (e % kNv) * kVe;
        const int row = t0 + j;
        const bool valid = row < p.T;
        copy_vec<decltype(bytes)::value>(dst[x] + (row0 + j) * kPitch + d,
                                         base + (valid ? row * rs + d : 0), valid);
      }
    }
  });
  cp_async_commit();
}

// S = Q K^T for the tile's first 16 * n16 keys, unscaled.
template <typename T, int D>
__device__ __forceinline__ void scores(float (&s)[kTile / 8][4], const Rows<T, D>& r,
                                       const T* ks, int n16, int lane) {
  constexpr int kPitch = Layout<T, D>::kPitch;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
  if constexpr (Rows<T, D>::kBf16) {
#pragma unroll
    for (int jj = 0; jj < kTile / 16; ++jj) {
      if (jj >= n16) break;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // matrices (keys +0 / +8) x (dims +0 / +8): b0, b1 of n tiles 2jj, 2jj+1
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(ks + (jj * 16 + (lane >> 4) * 8 + (lane & 7)) * kPitch +
                                kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * jj], r.qa[kk], b[0], b[1]);
        mma_bf16(s[2 * jj + 1], r.qa[kk], b[2], b[3]);
      }
    }
  } else if constexpr (Rows<T, D>::kQInSmem) {
    // Each 8-dim step's q fragment read and split once per key tile, then
    // used for every key group: S's sums run in the same order as below.
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t big[4], small[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(r.qs[(g + (i & 1) * 8) * kPitch + kk * 8 + t + (i >> 1) * 4], big[i],
                   small[i]);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        if (j >= 2 * n16) break;
        const float* row = ks + (j * 8 + g) * kPitch + kk * 8 + t;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(row[0], bb0, bs0);
        split_tf32(row[4], bb1, bs1);
        mma_tf32(s[j], small, bb0, bb1);
        mma_tf32(s[j], big, bs0, bs1);
        mma_tf32(s[j], big, bb0, bb1);
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      if (j >= 2 * n16) break;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const float* row = ks + (j * 8 + g) * kPitch + kk * 8 + t;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(row[0], bb0, bs0);
        split_tf32(row[4], bb1, bs1);
        const uint32_t(&big)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&r.qa[kk][0]);
        const uint32_t(&small)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&r.qa[kk][4]);
        mma_tf32(s[j], small, bb0, bb1);
        mma_tf32(s[j], big, bs0, bs1);
        mma_tf32(s[j], big, bb0, bb1);
      }
    }
  }
}

// Mask S on the diagonal, update the rows' max (of the unscaled scores;
// the scale is positive) and sum, and leave P = 2^(S * scale - m * scale),
// one FFMA and one ex2 an element, in s; scales the accumulator by the max's
// change.
template <typename T, int D>
__device__ __forceinline__ void softmax_step(float (&s)[kTile / 8][4], Rows<T, D>& r, int n16,
                                             int key0, int q0, bool diagonal, float scale_log2,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    if (j >= 2 * n16) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (diagonal && key0 + j * 8 + 2 * t + (i & 1) > q0 + g + (i >> 1) * 8) s[j][i] = kNegInf;
      mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
    }
  }
  float alpha[2], ms[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(r.m[h], mx[h]);
    alpha[h] = fast_exp2((r.m[h] - m_new) * scale_log2);
    r.m[h] = m_new;
    r.l[h] *= alpha[h];
    ms[h] = m_new * scale_log2;
  }
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    if (j >= 2 * n16) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = fast_exp2(fmaf(s[j][i], scale_log2, -ms[i >> 1]));
      r.l[i >> 1] += s[j][i];
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) r.acc[n][i] *= alpha[i >> 1];
}

// Every element of S into the accumulator: keeps the product alive when an
// ablation build drops the softmax and PV.
template <typename T, int D>
__device__ __forceinline__ void fold_scores(const float (&s)[kTile / 8][4], Rows<T, D>& r) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) r.acc[j % (D / 8)][i] += s[j][i];
}

// acc += P V over the tile's first 16 * n16 keys.
template <typename T, int D>
__device__ __forceinline__ void pv(Rows<T, D>& r, const float (&s)[kTile / 8][4], const T* vs,
                                   int n16, int lane) {
  constexpr int kPitch = Layout<T, D>::kPitch;
  if constexpr (Rows<T, D>::kBf16) {
#pragma unroll
    for (int jj = 0; jj < kTile / 16; ++jj) {
      if (jj >= n16) break;
      // S's C fragments of n tiles 2jj and 2jj+1 are P's k16 A fragment.
      const uint32_t a[4] = {pack_bf16(s[2 * jj][0], s[2 * jj][1]),
                             pack_bf16(s[2 * jj][2], s[2 * jj][3]),
                             pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]),
                             pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3])};
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        // matrices (keys +0 / +8) x (dims +0 / +8), transposed: b0, b1 of
        // dim tiles 2dd, 2dd+1
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_u32(vs + (jj * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                               kPitch +
                                      dd * 16 + (lane >> 4) * 8));
        mma_bf16(r.acc[2 * dd], a, b[0], b[1]);
        mma_bf16(r.acc[2 * dd + 1], a, b[2], b[3]);
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    float fresh[D / 8][4] = {};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      if (j >= 2 * n16) break;
      // k order permuted: A's k = t is key 2t, k = t + 4 is key 2t + 1.
      uint32_t big[4], small[4];
      split_tf32(s[j][0], big[0], small[0]);
      split_tf32(s[j][2], big[1], small[1]);
      split_tf32(s[j][1], big[2], small[2]);
      split_tf32(s[j][3], big[3], small[3]);
      const float* rows = vs + (j * 8 + 2 * t) * kPitch + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(rows[n * 8], bb0, bs0);
        split_tf32(rows[kPitch + n * 8], bb1, bs1);
        mma_tf32(fresh[n], small, bb0, bb1);
        mma_tf32(fresh[n], big, bs0, bs1);
        mma_tf32(fresh[n], big, bb0, bb1);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) r.acc[n][i] += fresh[n][i];
  }
}

// The warp's rows q0.. against the keys key0 .. key0 + 16 * n16 - 1 held in
// rows 0.. of ks / vs.
template <typename T, int D>
__device__ __forceinline__ void attend(Rows<T, D>& r, const T* ks, const T* vs, int n16,
                                       int key0, int q0, float scale_log2, int lane) {
  float s[kTile / 8][4];
  scores<T, D>(s, r, ks, n16, lane);
  softmax_step<T, D>(s, r, n16, key0, q0, key0 + 16 * n16 - 1 > q0, scale_log2, lane);
  pv<T, D>(r, s, vs, n16, lane);
}

// o = acc / l in o's dtype, staged in the warp's own 16 rows at os_ (its
// q rows, read already) and stored in 16-byte vectors; the natural-log lse.
// Rows at or past T are not stored.
template <typename T, int D>
__device__ __forceinline__ void store_rows(Rows<T, D>& r, T* os_, const Params& p, int b, int h,
                                           int q0, int lane) {
  constexpr int kPitch = Layout<T, D>::kPitch;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = r.l[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / l;
    T* srow = os_ + (g + hf * 8) * kPitch + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float v0 = r.acc[n][2 * hf] * inv, v1 = r.acc[n][2 * hf + 1] * inv;
      if constexpr (Rows<T, D>::kBf16) {
        *reinterpret_cast<__nv_bfloat162*>(srow + n * 8) = __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<float2*>(srow + n * 8) = make_float2(v0, v1);
      }
    }
    const int row = q0 + g + hf * 8;
    if (t == 0 && row < p.T)
      p.lse[((size_t)b * p.H + h) * p.T + row] = (r.m[hf] * p.scale_log2 + log2f(l)) * kLn2;
  }
  __syncwarp();
  constexpr int kVe = 16 / (int)sizeof(T), kNv = D / kVe;  // 16-byte vectors per row
  T* o = static_cast<T*>(p.o) + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int i = lane; i < 16 * kNv; i += 32) {
    const int j = i / kNv, d = (i % kNv) * kVe;
    if (q0 + j < p.T)
      *reinterpret_cast<uint4*>(o + (q0 + j) * p.os[2] + d) =
          *reinterpret_cast<const uint4*>(os_ + j * kPitch + d);
  }
}

template <typename T, int D, bool kShort>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kTileElems = Layout<T, D>::kTileElems;
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int BH = p.B * p.H;
  Rows<T, D> r;

  T* qs = smem;  // q rows, then the output rows
  // How blockIdx and the warp index map onto (head, first q row) below is
  // mirrored by tests/test_torch_attention.py::plan_tiles; keep the two alike.
  if constexpr (kShort) {
    // Heads packed per block, each head's whole q/K/V loaded once.
    const int wph = (p.T + 15) / 16;  // warps (16-row q tiles) per head
    const int tpad = wph * 16;
    T* const dst[3] = {qs, smem + kTileElems, smem + 2 * kTileElems};
    const void* const src[3] = {p.q, p.k, p.v};
    const long long* const st[3] = {p.qs, p.ks, p.vs};
#pragma unroll 1
    for (int s = 0; s < p.heads_per_block; ++s) {
      const int bh = blockIdx.x * p.heads_per_block + s;
      if (bh < BH) stage_rows<T, D, 3>(dst, src, st, p, bh / p.H, bh % p.H, 0, tpad, s * tpad);
    }
    const int slot = warp / wph;
    const int bh = blockIdx.x * p.heads_per_block + slot;
    const bool live = slot < p.heads_per_block && bh < BH;
    const int b = bh / p.H, h = bh % p.H, q0 = (warp % wph) * 16;
    cp_async_wait<0>();
    __syncthreads();
    if (!live) return;
    const int off = slot * tpad * Layout<T, D>::kPitch;  // this head's rows
    T* mine = qs + off + q0 * Layout<T, D>::kPitch;      // this warp's q rows
    load_q<T, D>(r, mine, lane);
    const int last = min(q0 + 15, p.T - 1);
    attend<T, D>(r, dst[1] + off, dst[2] + off, last / 16 + 1, 0, q0, p.scale_log2, lane);
    store_rows<T, D>(r, mine, p, b, h, q0, lane);
  } else {
    // One 64-row q tile per block, longest first; 64-key tiles up to the
    // diagonal, double-buffered: tile kt + 1 loads while tile kt computes.
    const int nqt = (p.T + kTile - 1) / kTile;
    const int qt = nqt - 1 - (int)blockIdx.x / BH;
    const int bh = blockIdx.x % BH;
    const int b = bh / p.H, h = bh % p.H;
    const int q0 = qt * kTile + warp * 16;
    const bool live = q0 < p.T;
    const int last = min(q0 + 15, p.T - 1);
    T* mine = qs + warp * 16 * Layout<T, D>::kPitch;
    const void* const kvsrc[2] = {p.k, p.v};
    const long long* const kvst[2] = {p.ks, p.vs};
    // Tile kt (when it exists; else an empty cp.async group) into its buffer.
    auto load_tile = [&](int kt) {
      if (kt > qt) {
        cp_async_commit();
        return;
      }
      T* const kv[2] = {smem + (1 + 2 * (kt % kStages)) * kTileElems,
                        smem + (2 + 2 * (kt % kStages)) * kTileElems};
      stage_rows<T, D, 2>(kv, kvsrc, kvst, p, b, h, kt * kTile, kTile, 0);
    };
    {
      T* const qdst[1] = {qs};
      const void* const qsrc[1] = {p.q};
      const long long* const qst[1] = {p.qs};
      stage_rows<T, D, 1>(qdst, qsrc, qst, p, b, h, qt * kTile, kTile, 0);
    }
#pragma unroll 1
    for (int kt = 0; kt < kStages - 1; ++kt) load_tile(kt);
#pragma unroll 1
    for (int kt = 0; kt <= qt; ++kt) {
      load_tile(kt + kStages - 1);  // into the buffer that tile kt - 1 released
      cp_async_wait<kStages - 1>();  // every group but the newest: q and tile kt
      __syncthreads();
      const int key0 = kt * kTile;
      if (kt == 0 && live) load_q<T, D>(r, mine, lane);
      if (live && last >= key0) {
        const T* ks = smem + (1 + 2 * (kt % kStages)) * kTileElems;
        attend<T, D>(r, ks, ks + kTileElems, min(kTile, last - key0 + 1 + 15) / 16, key0, q0,
                     p.scale_log2, lane);
      }
      __syncthreads();  // this buffer is refilled next
    }
    if (live) store_rows<T, D>(r, mine, p, b, h, q0, lane);
  }
}

// Per instantiation, once: the dynamic shared memory allowed up to what a
// launch takes (above the 48 KB default for float32 at D = 64 and for both
// types at D = 128), and the carveout.
template <typename T, int D, bool kShort>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    auto kernel = flash_fwd_kernel<T, D, kShort>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<T, D>::bytes(kShort ? 1 : kStages));
    // All of L1 as shared memory, so that registers, not the carveout,
    // bound the blocks resident on an SM.
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <typename T, int D>
cudaError_t launch(const Params& p, int grid, cudaStream_t stream) {
  if (p.heads_per_block > 0) {
    if (const cudaError_t err = prepare<T, D, true>(); err != cudaSuccess) return err;
    flash_fwd_kernel<T, D, true><<<grid, kThreads, Layout<T, D>::bytes(1), stream>>>(p);
  } else {
    if (const cudaError_t err = prepare<T, D, false>(); err != cudaSuccess) return err;
    flash_fwd_kernel<T, D, false><<<grid, kThreads, Layout<T, D>::bytes(kStages), stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int D, int grid, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, grid, stream);
    case 32: return launch<T, 32>(p, grid, stream);
    case 64: return launch<T, 64>(p, grid, stream);
    case 128: return launch<T, 128>(p, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [B, H, T, D] with D contiguous and element strides (b, h, t) in
// qs/ks/vs; o: the same through os (the wrapper's [B, T, H, D] storage, its
// strides multiples of 16 bytes); lse [B, H, T] float32. vec: the bytes of
// one q/k/v copy (16, 8 or 4 for cp.async, 2 for bf16 scalars), dividing
// their pointers and every stride in bytes. heads_per_block > 0 selects the
// short-T regime (T <= 64) with that many heads per block; grid as the
// host's plan gives it.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int H, int T, int D, long long qsb, long long qsh,
                               long long qst, long long ksb, long long ksh, long long kst,
                               long long vsb, long long vsh, long long vst, long long osb,
                               long long osh, long long ost, int vec, int heads_per_block,
                               int grid, int is_bf16, float scale, void* stream) {
  if (grid <= 0 ||
      (heads_per_block > 0 ? T > kShortT || heads_per_block * ((T + 15) / 16) > kWarps
                           : T <= kShortT))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, static_cast<float*>(lse), B, H, T,
           {qsb, qsh, qst}, {ksb, ksh, kst}, {vsb, vsh, vst}, {osb, osh, ost},
           vec, heads_per_block, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_d<__nv_bfloat16>(p, D, grid, s)
                                  : launch_d<float>(p, D, grid, s);
  return static_cast<int>(err);
}
