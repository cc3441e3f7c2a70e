// Fused nano DWConv block for Hopper (sm_90a): depthwise 3x3 stride-1 SAME
// conv -> eval BN -> SiLU -> pointwise 1x1 -> eval BN -> SiLU, one kernel
// launch per call (BN folded in the prologue, the weights read through
// their strides).
//
// Replaces the Pallas TPU kernel jolineedle_tpu/ops/conv.py:96-159
// (dwblock_bn_silu), which held one whole padded image in VMEM per program.
//
// What bounds it on the H100: bytes. At the yolox-nano widths (C = K = 16
// .. 128) the block does 2 (9 + K) flops per input value, far below the
// card's ~295 flops per byte in bf16; reading x once and writing the output
// once is the bound (0.0749 ms over one detector call at N = 32, bf16).
//
// The design, and what each part does about that:
//   - Persistent blocks over items. An item is (image, tile of rows x 16
//     output pixels, slice of kNT output channels). The host picks kNT and
//     the tile's rows (up to 16, rows = ceil(H / n): 56 rows take tiles of
//     7, not 8 and a ragged one) per shape, for the most warps busy per SM
//     (choose_plan). A block keeps one K slice and walks its tiles, so the
//     pointwise weights are staged once.
//   - The halo by TMA: one 4-D tensor map over x [B, H, W, C] and one box
//     [1, rows + 2, 18, C] at (b, ty0 - 1, tx0 - 1, 0) per item; TMA fills
//     coordinates outside the tensor (the negative ones too) with zeros, so
//     the SAME border costs nothing. Two buffers with an mbarrier each: the
//     last warp to finish reading item j's halo issues item j + 2's, which
//     lands while items j and j + 1 compute. An x that TMA cannot take (not
//     16-byte aligned, or C * esize not a multiple of 16) loads by cp.async
//     in the widest vector its pitch and address allow.
//   - Each warp owns whole tile rows, from halo to store, so no barrier
//     spans the block inside the loop and one warp's product overlaps
//     another's depthwise.
//   - The depthwise in registers, in float32: a lane owns two adjacent
//     channels and slides the 3x3 window along a tile row (one halo column
//     of 3 pixels loaded per output), applies BN1 and SiLU, and writes mid
//     in x's dtype to shared memory in the rows the MMA fragments want (16
//     bytes of skew: ldmatrix is conflict-free).
//   - The pointwise 1x1 on the tensor cores: a warp multiplies each of its
//     tile rows (16 pixels, one m16 fragment) by the block's K slice. bf16:
//     mma.sync m16n8k16, both fragments by ldmatrix, float32 sums. float32:
//     3xTF32 m16n8k8 (big and small TF32 halves of both operands), each
//     chunk of 32 channels summed into a fresh accumulator and the chunks
//     added in IEEE float32, which keeps float32 accuracy.
//   - The epilogue: BN2 and SiLU on the float32 sums in registers, the row's
//     16 output pixels staged in shared memory (in the row's own mid rows
//     where the slice is no wider than C) and stored with 16-byte vectors
//     (narrower only where K * esize or the output's address demands).
//   - BN folded in the prologue, scale = gamma / sqrt(var + eps) and bias =
//     beta - mean * scale in IEEE float32 (no contraction), as the
//     wrapper's fold_bn does; dw and pw read through strides, so the model's
//     permuted OIHW weight views pass with no copy.
//
// What holds it above the bound (H100, the ablation in
// scripts/conv_ablation.py): a launch costs about 2 us back to back, and
// the depthwise and the product add up rather than overlap, each slower
// than its instruction count suggests; more resident blocks (a register
// cap) ran slower.
//
// A bf16 block multiplies mid and pw rounded to bf16 with float32 sums; the
// JAX model runs the whole DWConv in bf16 (flax nn.Conv(dtype=bf16)), so the
// kernel computes no less precisely than the model it ports.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ptx.cuh"

namespace needle {
namespace dwblock {

constexpr int kTW = 16;       // tile columns: one m16 fragment per tile row
constexpr int kHW = kTW + 2;  // halo row length
constexpr int kMaxRows = 16;  // tile rows; warp w owns rows [w rpw, w rpw + rpw)
constexpr int kWarps = 8;
constexpr int kBlock = 32 * kWarps;
constexpr int kMaxC = 256;
constexpr int kMaxK = 256;
constexpr int kMaxSmem = 227 * 1024;  // a block's dynamic shared memory
constexpr int kSmSmem = 228 * 1024;   // an SM's, with 1 KB reserved per block
constexpr int kChunk = 32;            // float32: channels per fresh accumulator

struct Params {
  const void* x;
  const float* dw;  // dw[dy][dx][0][c] at dy * dw_sy + dx * dw_sx + c * dw_sc
  const float *g1, *be1, *m1, *v1;
  const float* pw;  // pw[0][0][c][k] at c * pw_sc + k * pw_sk
  const float *g2, *be2, *m2, *v2;
  void* out;
  float eps;
  int dw_sy, dw_sx, dw_sc, pw_sc, pw_sk;
  int B, H, W, C, K;
  int rows;        // tile rows
  int rpw;         // tile rows per warp: 1 or 2
  int tiles_w, tiles_h, tiles;  // tiles per image row and column; B * both
  int nslices;     // K slices
  int cs;          // halo pixel pitch (channels): C rounded up to 2
  int cpad;        // MMA depth: C rounded up to 16 (bf16) or 8 (float32)
  int halo_bytes;  // one halo buffer, a multiple of 128 bytes
  int tma;         // the halo by TMA, else by cp.async
  int xvec;        // cp.async: bytes per copy (16, 8, 4, or 2: a scalar)
  int ovec;        // bytes per output store (16, 8, 4 or 2)
  int ovshift;     // log2(kNT * esize / ovec): vectors per pixel of a slice
};

__host__ __device__ constexpr int up16(int v) { return (v + 15) / 16 * 16; }

// Byte offsets of the shared-memory regions, past the two halo buffers:
// mid [rows * 16][cpad + skew] and pw [kNT][cpad + skew] in T, the output
// staging (16 rows of kNT + skew per warp, only where kNT > cpad) in T,
// then float32 dw [9][cs], BN1 scale and bias [cs], BN2 scale and bias
// [kNT], the two mbarriers and the two release counts of the halo buffers.
struct Smem {
  int mid, pw, out, dw, s1, b1, s2, b2, bar, bytes;
};

template <typename T, int kNT>
__host__ __device__ inline Smem layout(int rows, int cs, int cpad, int halo_bytes) {
  constexpr int e = (int)sizeof(T), skew = 16 / e;
  Smem s;
  s.mid = 2 * halo_bytes;
  s.pw = s.mid + rows * kTW * (cpad + skew) * e;
  s.out = s.pw + kNT * (cpad + skew) * e;
  // At kNT <= cpad a warp stages its outputs in its own rows of mid.
  s.dw = s.out + (kNT > cpad ? (rows < kWarps ? rows : kWarps) * kTW * (kNT + skew) * e : 0);
  s.s1 = s.dw + up16(9 * cs * 4);
  s.b1 = s.s1 + up16(cs * 4);
  s.s2 = s.b1 + up16(cs * 4);
  s.b2 = s.s2 + kNT * 4;
  s.bar = s.b2 + kNT * 4;
  s.bytes = s.bar + 24;  // 2 mbarriers, 2 release counts
  return s;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// BN scale and bias are kept multiplied by kHalf<T> (exactly): in bf16 the
// epilogues then take SiLU(v) = u (1 + tanh u) at u = v / 2 from the
// scaled fma in one tanh.approx and one fma (2^-11 relative, far below the
// bf16 rounding that follows); float32 keeps fast_silu's exponential.
template <typename T>
constexpr float kHalf = std::is_same<T, __nv_bfloat16>::value ? 0.5f : 1.0f;

template <typename T>
__device__ __forceinline__ float silu_of_scaled(float u) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    float t;
    asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(u));
    return fmaf(u, t, u);
  } else {
    return fast_silu<T>(u);
  }
}

// One vector of kBytes from shared src to global dst.
template <int kBytes>
__device__ __forceinline__ void store_vec(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else if constexpr (kBytes == 4) {
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
  } else {
    *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(src);
  }
}

// The cp.async route, by one warp: the (rows + 2) x 18 halo of the tile at
// (ty0, tx0) of image b into dst[halo pixel][cs], zeros outside the image
// (the channels past C stay zero from the kernel's start). Each lane then
// arrives on `full` once its copies have landed.
template <typename T>
__device__ __forceinline__ void stage_halo(T* dst, uint64_t* full, const Params& p, int b,
                                           int ty0, int tx0, int lane) {
  const T* img = static_cast<const T*>(p.x) + (size_t)b * p.H * p.W * p.C;
  const int ve = p.xvec / (int)sizeof(T);
  const int nv = p.C / ve;  // xvec divides C * esize
  const int total = (p.rows + 2) * kHW * nv;
  with_width(p.xvec, [&](auto bytes) {
#pragma unroll 1
    for (int i = lane; i < total; i += 32) {
      const int hp = i / nv;
      const int j = (i - hp * nv) * ve;
      const int hy = hp / kHW;
      const int gy = ty0 + hy - 1;
      const int gx = tx0 + (hp - hy * kHW) - 1;
      const bool valid = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      const T* src = valid ? img + ((size_t)gy * p.W + gx) * p.C + j : img;
      copy_vec<decltype(bytes)::value>(dst + hp * p.cs + j, src, valid);
    }
  });
  if (p.xvec >= 4) {  // when this thread's cp.asyncs complete
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(full))
                 : "memory");
  } else {  // scalar copies: already stored
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(full)) : "memory");
  }
}

// The depthwise 3x3 + BN1 + SiLU of tile rows [r0, r0 + nr) into their rows
// of mid, by one warp. A unit of work is (channel pair, tile row, run of
// columns): the lane slides a 3 x 3 window along the run, loading one halo
// column of 3 pixels per output (with the columns unrolled, the window
// never moves in registers; a loop of three-column steps, which keeps the
// code small, ran slower on the card). Lanes take consecutive channel pairs of one
// pixel, so a load is one contiguous row of banks; at fewer than 32 pairs
// the other lanes take the warp's other row or further runs.
template <typename T>
__device__ __forceinline__ void depthwise(const T* __restrict__ halo, T* __restrict__ mid,
                                          int mid_pitch, const float* dws, const float* s1,
                                          const float* b1, const Params& p, int r0, int nr,
                                          int lane) {
  const int ncg = p.cs >> 1;
  const int lanes = min(32, ncg);  // lanes per pixel
  const int groups = 32 / lanes, group = lane / lanes;
  if (group >= groups) return;
  const int runs = max(1, groups / nr);      // runs per tile row
  const int len = (kTW + runs - 1) / runs;   // columns per run
#pragma unroll 1
  for (int cg = lane - group * lanes; cg < ncg; cg += lanes) {
    const int c = 2 * cg;
    float2 w[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) w[tap] = load2(dws + tap * p.cs + c);
    const float2 sc = load2(s1 + c), bi = load2(b1 + c);
#pragma unroll 1
    for (int u = group; u < nr * runs; u += groups) {
      const int row = r0 + u / runs;
      const int x0 = (u % runs) * len;
      const int n = min(len, kTW - x0);  // outputs of this run
      const T* h = halo + (row * kHW + x0) * p.cs + c;  // halo rows row .. row + 2
      T* const m = mid + (row * kTW + x0) * mid_pitch + c;
      float2 col[3][3];  // [column % 3][dy]
#pragma unroll
      for (int i = 0; i < kTW + 2; ++i) {
        if (i >= n + 2) break;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) col[i % 3][dy] = load2(h + (dy * kHW + i) * p.cs);
        if (i >= 2) {  // output column x0 + i - 2: halo columns i - 2 .. i
          float2 a = make_float2(0.0f, 0.0f);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float2 v = col[(i - 2 + dx) % 3][dy];
              a.x = fmaf(v.x, w[dy * 3 + dx].x, a.x);
              a.y = fmaf(v.y, w[dy * 3 + dx].y, a.y);
            }
          store2(m + (i - 2) * mid_pitch, silu_of_scaled<T>(fmaf(a.x, sc.x, bi.x)),
                 silu_of_scaled<T>(fmaf(a.y, sc.y, bi.y)));
        }
      }
    }
  }
}

// Tile row mi (16 pixels of mid) times the K slice pws[kNT][cpad]:
// acc[nt] holds rows g and g + 8, channels nt * 8 + 2t and the next one.
template <int kNT>
__device__ __forceinline__ void pointwise(float (&acc)[kNT / 8][4], const __nv_bfloat16* mid,
                                          int mid_pitch, const __nv_bfloat16* pws, int pw_pitch,
                                          int cpad, int mi, int lane) {
  // A: the 16 pixels (lane & 15), k halves by lane >> 4. B: ldmatrix matrix
  // m = lane >> 3 holds channels (m >> 1) * 8 + (lane & 7), k half m & 1.
  const uint32_t a_addr =
      smem_u32(mid + (mi * kTW + (lane & 15)) * mid_pitch + (lane >> 4) * 8);
  const uint32_t b_addr =
      smem_u32(pws + ((lane >> 4) * 8 + (lane & 7)) * pw_pitch + ((lane >> 3) & 1) * 8);
#pragma unroll 2
  for (int ks = 0; ks < cpad / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, a_addr + ks * 32);
#pragma unroll
    for (int nj = 0; nj < kNT / 16; ++nj) {
      uint32_t b[4];
      ldmatrix_x4(b, b_addr + (nj * 16 * pw_pitch) * 2 + ks * 32);
      mma_bf16(acc[2 * nj], a, b[0], b[1]);
      mma_bf16(acc[2 * nj + 1], a, b[2], b[3]);
    }
  }
}

template <int kNT>
__device__ __forceinline__ void pointwise(float (&acc)[kNT / 8][4], const float* mid,
                                          int mid_pitch, const float* pws, int pw_pitch, int cpad,
                                          int mi, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* arow = mid + (mi * kTW + g) * mid_pitch + t;
  const float* brow = pws + g * pw_pitch + t;
#pragma unroll 1
  for (int c0 = 0; c0 < cpad; c0 += kChunk) {
    float part[kNT / 8][4] = {};
    const int kend = min(cpad, c0 + kChunk);
#pragma unroll 1
    for (int k0 = c0; k0 < kend; k0 += 8) {
      uint32_t ab[4], as[4];
      split_tf32(arow[k0], ab[0], as[0]);
      split_tf32(arow[8 * mid_pitch + k0], ab[1], as[1]);
      split_tf32(arow[k0 + 4], ab[2], as[2]);
      split_tf32(arow[8 * mid_pitch + k0 + 4], ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < kNT / 8; ++nt) {
        const float* bp = brow + nt * 8 * pw_pitch + k0;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(bp[0], bb0, bs0);
        split_tf32(bp[4], bb1, bs1);
        mma_tf32(part[nt], as, bb0, bb1);
        mma_tf32(part[nt], ab, bs0, bs1);
        mma_tf32(part[nt], ab, bb0, bb1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] += part[nt][j];
  }
}

// This block's K slice of pw, [n][c] at pws + n * pw_pitch + c in T, in
// batches of kPwBatch loads a thread (the first batch is loaded by
// load_pw_batch before the taps and BN vectors, so that all of a thread's
// first global loads are in flight together); pw read with c contiguous
// (the model's OIHW views) goes by float4.
constexpr int kPwBatch = 8;

struct PwBatch {
  float4 v[kPwBatch];
  int at[kPwBatch];  // shared offset of each value, -1 past the slice
};

__device__ __forceinline__ bool pw_by4(const Params& p) {
  return p.pw_sc == 1 && p.C % 4 == 0 && p.pw_sk % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p.pw) % 16 == 0;
}

__device__ __forceinline__ void load_pw_batch(PwBatch& bt, int i0, const Params& p, int n0,
                                              int kw, int pw_pitch) {
  const bool by4 = pw_by4(p);
  const int per_row = by4 ? p.C / 4 : p.C;  // loads per output channel
  const int total = kw * per_row;
#pragma unroll
  for (int u = 0; u < kPwBatch; ++u) {
    const int i = i0 + u * kBlock;
    const int n = i / per_row, q = i - n * per_row;
    bt.at[u] = i < total ? n * pw_pitch + (by4 ? 4 * q : q) : -1;
    const float* src = p.pw + (size_t)(n0 + n) * p.pw_sk;
    if (bt.at[u] < 0) {
      bt.v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else if (by4) {
      bt.v[u] = __ldg(reinterpret_cast<const float4*>(src) + q);
    } else {
      bt.v[u].x = __ldg(src + (size_t)q * p.pw_sc);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_pw_batch(const PwBatch& bt, T* pws, const Params& p) {
  const bool by4 = pw_by4(p);
#pragma unroll
  for (int u = 0; u < kPwBatch; ++u) {
    if (bt.at[u] < 0) continue;
    if (by4) {
      store2(pws + bt.at[u], bt.v[u].x, bt.v[u].y);
      store2(pws + bt.at[u] + 2, bt.v[u].z, bt.v[u].w);
    } else {
      pws[bt.at[u]] = from_f32<T>(bt.v[u].x);
    }
  }
}

// --- the kernel ------------------------------------------------------------
// A persistent block walks its items through two halo buffers. Warp w owns
// tile rows [w * rpw, w * rpw + rpw) from halo to store: it waits on the
// buffer's `full` barrier, computes its rows' depthwise into its own rows of
// mid, releases the buffer (a count in shared memory), and multiplies,
// applies BN2 + SiLU and stores its rows. No barrier spans the block inside
// the loop, so one warp's product overlaps another's depthwise; the last
// warp to release item j's buffer refills it with item j + 2 and waits for
// no one (the cp.async route: that warp copies the whole halo).
template <typename T, int kNT>
__global__ void __launch_bounds__(kBlock)
    dwblock_kernel(const Params p, const __grid_constant__ CUtensorMap tmap) {
  constexpr int kSkew = 16 / (int)sizeof(T);
  constexpr int kOutPitch = kNT + kSkew;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = layout<T, kNT>(p.rows, p.cs, p.cpad, p.halo_bytes);
  const int mid_pitch = p.cpad + kSkew, pw_pitch = p.cpad + kSkew;
  T* const mid = reinterpret_cast<T*>(smem + L.mid);
  T* const pws = reinterpret_cast<T*>(smem + L.pw);
  float* const dws = reinterpret_cast<float*>(smem + L.dw);
  float* const s1 = reinterpret_cast<float*>(smem + L.s1);
  float* const b1 = reinterpret_cast<float*>(smem + L.b1);
  float* const s2 = reinterpret_cast<float*>(smem + L.s2);
  float* const b2 = reinterpret_cast<float*>(smem + L.b2);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L.bar);  // [2]
  int* const released = reinterpret_cast<int*>(full + 2);            // [2]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // This block's K slice, and its tiles: first, first + stride, ...
  const int n0 = (blockIdx.x % p.nslices) * kNT;
  const int stride = gridDim.x / p.nslices;
  const int first = blockIdx.x / p.nslices;
  const int n_items = first < p.tiles ? (p.tiles - first + stride - 1) / stride : 0;

  // Zeros where padding is read and nothing writes it: channels [C, cs) of
  // a cp.async halo, mid's channels [cs, cpad), pw's rows past K and
  // channels past C, the float32 vectors past C and K.
  const int kw = min(kNT, p.K - n0);
  auto clear = [&](int from, int to) {
    for (int i = from / 16 + tid; i < to / 16; i += kBlock)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  };
  if (!p.tma && p.cs != p.C) clear(0, L.mid);
  if (p.cpad != p.cs) clear(L.mid, L.pw);
  if (p.cpad != p.C || kw != kNT) clear(L.pw, L.out);
  clear(L.dw, L.bar);
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(full + i, p.tma ? 1 : 32);
      released[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto coords = [&](int j, int& b, int& ty0, int& tx0) {
    const int t = first + j * stride;
    const int per_image = p.tiles_h * p.tiles_w;
    b = t / per_image;
    const int r = t - b * per_image;
    const int ty = r / p.tiles_w;
    ty0 = ty * p.rows;
    tx0 = (r - ty * p.tiles_w) * kTW;
  };
  // Item j's halo into buffer j & 1, by one warp (by TMA, its lane 0).
  auto issue = [&](int j) {
    if (j >= n_items) return;
    int b, ty0, tx0;
    coords(j, b, ty0, tx0);
    T* const dst = reinterpret_cast<T*>(smem + (j & 1) * p.halo_bytes);
    if (p.tma) {
      if (lane == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        tma_load_4d(full + (j & 1), dst, tmap, 0, tx0 - 1, ty0 - 1, b,
                    (p.rows + 2) * kHW * p.C * (int)sizeof(T));
      }
    } else {
      stage_halo<T>(dst, full + (j & 1), p, b, ty0, tx0, lane);
    }
  };
  if (warp == 0) {
    issue(0);
    issue(1);
  }

  // While the first halos land: BN folded in IEEE float32, the taps, and
  // this block's K slice of pw as pws[n][c] in T. A thread's global loads
  // (its first pw batch, its taps and BN vectors) are issued before its
  // first shared store, so that they are in flight together.
  auto fold = [&](float g, float be, float m, float v, float& scale, float& bias) {
    const float sc = __fdiv_rn(g, __fsqrt_rn(__fadd_rn(v, p.eps)));
    scale = sc * kHalf<T>;
    bias = __fsub_rn(be, __fmul_rn(m, sc)) * kHalf<T>;
  };
  const int pw_total = kw * (pw_by4(p) ? p.C / 4 : p.C);
  PwBatch batch;
  load_pw_batch(batch, tid, p, n0, kw, pw_pitch);
  for (int c = tid; c < p.C; c += kBlock) {
    float d[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      d[tap] = __ldg(p.dw + (tap / 3) * p.dw_sy + (tap % 3) * p.dw_sx + c * p.dw_sc);
    fold(__ldg(p.g1 + c), __ldg(p.be1 + c), __ldg(p.m1 + c), __ldg(p.v1 + c), s1[c], b1[c]);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) dws[tap * p.cs + c] = d[tap];
  }
  for (int n = tid; n < kw; n += kBlock) {
    const int k = n0 + n;
    fold(__ldg(p.g2 + k), __ldg(p.be2 + k), __ldg(p.m2 + k), __ldg(p.v2 + k), s2[n], b2[n]);
  }
  store_pw_batch(batch, pws, p);
#pragma unroll 1
  for (int i0 = tid + kPwBatch * kBlock; i0 < pw_total; i0 += kPwBatch * kBlock) {
    load_pw_batch(batch, i0, p, n0, kw, pw_pitch);
    store_pw_batch(batch, pws, p);
  }
  __syncthreads();  // the weights, for every warp

  const int r0 = warp * p.rpw;
  const int nr = min(p.rpw, p.rows - r0);  // this warp's tile rows (may be <= 0)
  const int ve = p.ovec / (int)sizeof(T);
  const bool own_rows = kNT <= p.cpad;  // stage outputs in the row's own mid rows
  const int op = own_rows ? mid_pitch : kOutPitch;
#pragma unroll 1
  for (int j = 0; j < n_items; ++j) {
    mbar_wait(full + (j & 1), (j >> 1) & 1);
    int b, ty0, tx0;
    coords(j, b, ty0, tx0);
    if (nr > 0)
      depthwise<T>(reinterpret_cast<const T*>(smem + (j & 1) * p.halo_bytes), mid, mid_pitch,
                   dws, s1, b1, p, r0, nr, lane);
    // The warp's reads of the buffer (and its rows of mid) are done; the
    // last warp to release the buffer refills it with item j + 2.
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(released + (j & 1), 1) == kWarps - 1;
      if (last) released[j & 1] = 0;
      __threadfence_block();
    }
    if (__shfl_sync(0xffffffffu, last, 0)) issue(j + 2);
    __syncwarp();

#pragma unroll 1
    for (int mi = r0; mi < r0 + nr; ++mi) {
      const int gy = ty0 + mi;
      if (gy >= p.H) break;
      float acc[kNT / 8][4] = {};
      pointwise<kNT>(acc, mid, mid_pitch, pws, pw_pitch, p.cpad, mi, lane);
      T* const ost = own_rows ? mid + mi * kTW * mid_pitch
                              : reinterpret_cast<T*>(smem + L.out) + warp * kTW * kOutPitch;
      __syncwarp();  // every lane's reads of row mi are done
      // BN2 + SiLU into the staging rows (pixels g and g + 8).
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int nt = 0; nt < kNT / 8; ++nt) {
        const int n = nt * 8 + 2 * t;
        const float2 sc = load2(s2 + n), bi = load2(b2 + n);
        store2(ost + g * op + n, silu_of_scaled<T>(fmaf(acc[nt][0], sc.x, bi.x)),
               silu_of_scaled<T>(fmaf(acc[nt][1], sc.y, bi.y)));
        store2(ost + (g + 8) * op + n, silu_of_scaled<T>(fmaf(acc[nt][2], sc.x, bi.x)),
               silu_of_scaled<T>(fmaf(acc[nt][3], sc.y, bi.y)));
      }
      __syncwarp();
      // The 16 pixels' kw channels, in vectors of ovec bytes.
      T* const orow = static_cast<T*>(p.out) + ((size_t)b * p.H + gy) * p.W * p.K + n0;
      with_width(p.ovec, [&](auto bytes) {
#pragma unroll 1
        for (int i = lane; i < kTW << p.ovshift; i += 32) {
          const int px = i >> p.ovshift;
          const int e0 = (i - (px << p.ovshift)) * ve;
          if (tx0 + px < p.W && e0 < kw)
            store_vec<decltype(bytes)::value>(orow + (size_t)(tx0 + px) * p.K + e0,
                                              ost + px * op + e0);
        }
      });
      __syncwarp();
    }
  }
}

// --- launch --------------------------------------------------------------
// The widest copy (16, 8 or 4 bytes) that a row pitch of `pitch` bytes and
// `ptr`'s alignment allow; else one element.
inline int vector_bytes(const void* ptr, int pitch, int esize) {
  for (int v = 16; v >= 4; v /= 2) {
    if (pitch % v == 0 && reinterpret_cast<uintptr_t>(ptr) % v == 0) return v;
  }
  return esize;
}

inline int log2_of(int v) {  // v a power of two
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}

// Per instantiation (internal linkage: each library keeps its own), found
// once: the attributes set, the SM count and the registers per thread. The
// process's first device stands for all.
namespace {
struct KernelInfo {
  cudaError_t err;
  int sms;
  int regs;
};

template <typename T, int kNT>
const KernelInfo& kernel_info() {
  static const KernelInfo info = [] {
    KernelInfo o{cudaSuccess, 0, 0};
    auto kernel = dwblock_kernel<T, kNT>;
    cudaFuncAttributes attr;
    int dev = 0;
    // All of L1 as shared memory, so that the persistent grid (sized from
    // the shared memory a launch takes) is resident at once.
    if ((o.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kMaxSmem)) != cudaSuccess ||
        (o.err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                      cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
        (o.err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess ||
        (o.err = cudaGetDevice(&dev)) != cudaSuccess ||
        (o.err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
      return o;
    o.regs = attr.numRegs;
    return o;
  }();
  return info;
}
}  // namespace

// Blocks of kBlock threads resident on one SM: 2048 threads, 64K registers
// (allocated per warp in units of 256), 228 KB of shared memory with 1 KB
// reserved per block.
inline int blocks_per_sm(int regs, int smem) {
  const int per_warp = (regs * 32 + 255) / 256 * 256;
  const int by_regs = 65536 / per_warp / kWarps;
  return std::min({2048 / kBlock, by_regs, kSmSmem / (smem + 1024)});
}

struct Shape {
  int B, H, W, C, K;
};

// A launch's plan for slice width kNT: the tile's rows, its shared memory
// and the items; rows == 0 when none fits.
struct Plan {
  int nt, rows, smem, per_sm, tiles_h, tiles_w;
  long items;
};

template <typename T, int kNT>
Plan plan_for(const Shape& s, int rows) {
  constexpr int e = (int)sizeof(T);
  const int cs = (s.C + 1) / 2 * 2;
  const int depth = e == 2 ? 16 : 8;  // the MMA's k: bf16 16, TF32 8
  const int cpad = (s.C + depth - 1) / depth * depth;
  const int halo = ((rows + 2) * kHW * cs * e + 127) / 128 * 128;
  Plan p{kNT, rows, layout<T, kNT>(rows, cs, cpad, halo).bytes, 0, 0, 0, 0};
  const KernelInfo& info = kernel_info<T, kNT>();
  if (info.err != cudaSuccess || p.smem > kMaxSmem) return Plan{kNT, 0, 0, 0, 0, 0, 0};
  p.per_sm = blocks_per_sm(info.regs, p.smem);
  p.tiles_h = (s.H + rows - 1) / rows;
  p.tiles_w = (s.W + kTW - 1) / kTW;
  p.items = (long)((s.K + kNT - 1) / kNT) * s.B * p.tiles_h * p.tiles_w;
  return p;
}

template <typename T, int kNT>
cudaError_t launch_plan(const Plan& plan, const Params& base, cudaStream_t stream) {
  constexpr int e = (int)sizeof(T);
  const KernelInfo& info = kernel_info<T, kNT>();
  if (info.err != cudaSuccess) return info.err;
  Params p = base;
  p.rows = plan.rows;
  p.tiles_h = plan.tiles_h;
  p.tiles_w = plan.tiles_w;
  p.tiles = p.B * p.tiles_h * p.tiles_w;
  p.nslices = (p.K + kNT - 1) / kNT;
  p.cs = (p.C + 1) / 2 * 2;
  const int depth = e == 2 ? 16 : 8;
  p.cpad = (p.C + depth - 1) / depth * depth;
  p.halo_bytes = ((p.rows + 2) * kHW * p.cs * e + 127) / 128 * 128;
  p.tma = reinterpret_cast<uintptr_t>(p.x) % 16 == 0 && p.C * e % 16 == 0;
  p.xvec = vector_bytes(p.x, p.C * e, e);
  p.ovec = vector_bytes(p.out, p.K * e, e);
  p.ovshift = log2_of(kNT * e / p.ovec);
  p.rpw = (p.rows + kWarps - 1) / kWarps;

  CUtensorMap tmap{};
  if (p.tma) {
    const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[4] = {(cuuint64_t)p.C, (cuuint64_t)p.W, (cuuint64_t)p.H,
                                (cuuint64_t)p.B};
    const cuuint64_t strides[3] = {(cuuint64_t)p.C * e, (cuuint64_t)p.W * p.C * e,
                                   (cuuint64_t)p.H * p.W * p.C * e};
    const cuuint32_t box[4] = {(cuuint32_t)p.C, kHW, (cuuint32_t)p.rows + 2, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    if (encode(&tmap, e == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               4, const_cast<void*>(p.x), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  const int per_slice = (int)std::min<long>(p.tiles, std::max(1, info.sms * plan.per_sm / p.nslices));
  dwblock_kernel<T, kNT><<<per_slice * p.nslices, kBlock, plan.smem, stream>>>(p, tmap);
  return cudaGetLastError();
}

// The slice widths an instantiation offers, widest first: bf16 128 .. 16,
// float32 (whose 3xTF32 sums need twice the registers) 64 .. 16.
template <typename T>
struct Widths;
template <>
struct Widths<__nv_bfloat16> {
  template <typename F>
  static void each(F&& f) {
    f(std::integral_constant<int, 128>{});
    f(std::integral_constant<int, 64>{});
    f(std::integral_constant<int, 32>{});
    f(std::integral_constant<int, 16>{});
  }
};
template <>
struct Widths<float> {
  template <typename F>
  static void each(F&& f) {
    f(std::integral_constant<int, 64>{});
    f(std::integral_constant<int, 32>{});
    f(std::integral_constant<int, 16>{});
  }
};

// The plan: among the slice widths no wider than K needs and the tile
// heights rows = ceil(H / n), n = ceil(H / 16) .. ceil(H / 16) + 8, that fit
// in shared memory, the one that keeps the most warps busy per SM: blocks
// resident per SM (no more than the items give, items / SMs) times the
// warps that hold tile rows, over the K slices (each repeats the
// depthwise). Ties go to the wider slice, then to the taller tile.
template <typename T>
Plan choose_plan(const Shape& s, cudaError_t& err) {
  Plan best{0, 0, 0, 0, 0, 0, 0};
  double best_score = -1.0;
  const int k16 = (s.K + 15) / 16 * 16;
  int widest = 0;  // the narrowest width that holds K in one slice, else the widest
  Widths<T>::each([&](auto nt) {
    if (widest == 0 || nt.value >= k16) widest = nt.value;
  });
  Widths<T>::each([&](auto nt) {
    constexpr int kNT = decltype(nt)::value;
    if (kNT > widest || err != cudaSuccess) return;
    const KernelInfo& info = kernel_info<T, kNT>();
    if ((err = info.err) != cudaSuccess) return;
    const int n_first = (s.H + kMaxRows - 1) / kMaxRows;
    int last = 0;
    for (int n = n_first; n <= std::min(s.H, n_first + 8); ++n) {
      const int rows = (s.H + n - 1) / n;
      if (rows == last) continue;
      last = rows;
      const Plan p = plan_for<T, kNT>(s, rows);
      if (p.rows == 0 || p.per_sm < 1) continue;
      const int rpw = (rows + kWarps - 1) / kWarps;
      const double blocks = std::min((double)p.per_sm, (double)p.items / info.sms);
      const double score = blocks * ((rows + rpw - 1) / rpw) / ((s.K + kNT - 1) / kNT);
      if (score > best_score) best_score = score, best = p;
    }
  });
  return best;
}

template <typename T>
cudaError_t launch_typed(const Params& base, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const Plan plan = choose_plan<T>(Shape{base.B, base.H, base.W, base.C, base.K}, err);
  if (err != cudaSuccess) return err;
  if (plan.rows == 0) return cudaErrorInvalidConfiguration;
  switch (plan.nt) {
    case 128:
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        return launch_plan<T, 128>(plan, base, stream);
      return cudaErrorInvalidConfiguration;
    case 64: return launch_plan<T, 64>(plan, base, stream);
    case 32: return launch_plan<T, 32>(plan, base, stream);
    default: return launch_plan<T, 16>(plan, base, stream);
  }
}

}  // namespace dwblock
}  // namespace needle

// x, out: [B, H, W, C] and [B, H, W, K] contiguous, bf16 or float32; the
// weights and BN vectors float32 (dw and pw through their element strides,
// the BN vectors contiguous). Returns cudaGetLastError() of the launch.
extern "C" int dwblock_bn_silu(const void* x, const void* dw, const void* g1, const void* be1,
                               const void* m1, const void* v1, const void* pw, const void* g2,
                               const void* be2, const void* m2, const void* v2, void* out, int B,
                               int H, int W, int C, int K, int dw_sy, int dw_sx, int dw_sc,
                               int pw_sc, int pw_sk, int is_bf16, float eps, void* stream) {
  using namespace needle::dwblock;
  if (C < 1 || C > kMaxC || K < 1 || K > kMaxK || B < 0 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  Params p{};
  p.x = x;
  p.dw = static_cast<const float*>(dw);
  p.g1 = static_cast<const float*>(g1);
  p.be1 = static_cast<const float*>(be1);
  p.m1 = static_cast<const float*>(m1);
  p.v1 = static_cast<const float*>(v1);
  p.pw = static_cast<const float*>(pw);
  p.g2 = static_cast<const float*>(g2);
  p.be2 = static_cast<const float*>(be2);
  p.m2 = static_cast<const float*>(m2);
  p.v2 = static_cast<const float*>(v2);
  p.out = out;
  p.eps = eps;
  p.dw_sy = dw_sy, p.dw_sx = dw_sx, p.dw_sc = dw_sc, p.pw_sc = pw_sc, p.pw_sk = pw_sk;
  p.B = B, p.H = H, p.W = W, p.C = C, p.K = K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_typed<__nv_bfloat16>(p, s) : launch_typed<float>(p, s);
  return static_cast<int>(err);
}
