// Dense 3x3 stride-1 SAME conv for Hopper (sm_90a) as an implicit GEMM on
// the tensor cores: M = output pixels, N = K, depth = 9 taps x C. Shared by
// two kernel libraries, which differ only in the epilogue (a compile-time
// flag):
//
//   - conv3x3_bn_silu.cu: folded eval BN + SiLU, replacing the Pallas
//     kernel jolineedle_tpu/ops/conv.py:68 (conv3x3_bn_silu);
//   - conv3x3.cu: no epilogue, replacing scripts/smoke_pallas_conv.py:67
//     (pallas_conv3x3).
//
// Both Pallas kernels built the im2col [HW, 9C] of a whole padded image in
// VMEM and made one dot against the [9C, K] filter.
//
// What bounds it on the H100:
//   - the yolox-nano Focus stem at 448 px ([32, 224, 224, 12 -> 16]) does
//     61 flop per byte in bf16, far below the card's ~295: bound by bytes
//     (0.027 ms to read x once and write the output once);
//   - the smoke default ([8, 56, 56, 16 -> 32]) moves 1.2 MB: bound by its
//     launch and one wave of tiles;
//   - the yolox-s widths (C = K = 64..256) are bound by operations.
//
// The design, and what each part does about that:
//   - Tensor cores. bf16: mma.sync m16n8k16 (bf16 in, float32 sums), A and
//     B fragments read with ldmatrix; the A fragment of one halo row serves
//     the three taps that need it (dy), so a k-step loads 3 (rows + 2) A
//     fragments, not 9 rows. float32: 3xTF32, mma.sync m16n8k8 on the big
//     and small TF32 halves of both operands (a*b ~ ab*bb + ab*bs + as*bb),
//     summed per tap and then added in IEEE float32, which keeps float32
//     accuracy at TF32 tensor-core rates.
//   - Tiles 16 pixels wide (one m16 fragment per tile row). At K <= 16 (the
//     stem) 32 rows: the 34 x 18 halo is 1.19x the tile (an 8 x 8 tile
//     reads 1.56x); else 8 rows. The N slice follows K: 16, 32 or 64 wide,
//     so the stem's K = 16 fills its slice.
//   - Persistent blocks: (SMs x blocks per SM) blocks walk the (K slice,
//     image, tile) items, stepping by additions with carries. When one chunk
//     of channels and one K slice cover the filter (the stem, the smoke
//     default), each block stages its filter once; otherwise the filter
//     chunk travels with the halo chunk.
//   - C and K are padded to the MMA's multiples with zeros in shared memory
//     only; the SAME border is masked by the copies' zero fill. No padded
//     copy and no im2col reach HBM.
//   - An asynchronous ring: the next tiles' halo (three buffers when the
//     filter is resident, else two, with the filter) loads while this
//     tile's MMAs and epilogue run.
//   - Packed rows by TMA (bf16 at C = 4 or 12, the stem): a 24-byte pixel
//     is no whole number of 16-byte vectors, but a halo row of 18 pixels
//     is contiguous in x. One thread issues one TMA box per tile, [rows + 2,
//     18 C (+ 4 channels ahead, so the box starts 16-byte aligned)] of x
//     seen as [B, H, W C], zeros outside the image, completing on an
//     mbarrier; no other thread spends an instruction on the load.
//     The A fragments are then read from the packed rows with 8-byte
//     shared loads (the filter's depth is staged permuted so that a
//     thread's four k values are four adjacent channels), channels past C
//     masked to zero in registers. TMA needs x 16-byte aligned and W C 2 a
//     multiple of 16 bytes.
//   - Every other shape copies pixel by pixel with cp.async, in 16, 8 or 4
//     byte vectors, the widest that the row pitch (C bytes) and x's
//     address allow; a bf16 x that is only 2-byte aligned (odd C, or a
//     storage offset) takes a scalar path. One compact copy loop per width
//     keeps the loop body in the instruction cache.
//   - Shared-memory rows carry 16 bytes of skew, so ldmatrix and the
//     float32 fragment loads are free of bank conflicts.
//   - The epilogue runs on the float32 accumulators in registers: BN scale
//     and bias (folded in float32 by the wrapper, loaded while the MMAs
//     run), SiLU, and stores of channel pairs (4 bytes in bf16, 8 in
//     float32), unmasked when the tile lies inside the image.
//
// The filter comes in x's dtype, HWIO [9C, K] as the wrapper hands it over:
// a bf16 conv multiplies a bf16-rounded filter, as flax's
// nn.Conv(dtype=bfloat16) does on the JAX model's own path.
//
// ptxas (-O3, sm_90a, as chip_smoke.py's build phase prints it): registers
// per thread for K slices of 16 / 32 / 64, conv3x3_bn_silu.cu bf16 128 / 80
// / 168 (98 for the packed-row stem) and float32 143 / 95 / 242, conv3x3.cu
// bf16 97 / 56 / 128 (105 packed) and float32 127 / 79 / 213; no spills.
// Shared memory is dynamic: 95,256 B at the stem (2 blocks of 256 threads
// per SM), 37,656 B at the smoke default, 111,888 B for a bf16 K slice of
// 64 with C > 32.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ptx.cuh"

namespace needle {
namespace conv3x3 {

constexpr int kTW = 16;           // output columns per tile: one m16 fragment
constexpr int kHW = kTW + 2;      // halo row length
constexpr int kChunkBytes = 64;   // channels per stage: 32 bf16 or 16 float32
// A TMA box must start at a 16-byte aligned inner coordinate: a packed halo
// row (C % 8 == 4) starts 4 channels early, since (tx0 - 1) C - 4 is then a
// multiple of 8 channels.
constexpr int kTmaLead = 4;

struct Params {
  const void* x;
  const void* w;  // [9C, K] in x's dtype
  const float* scale;
  const float* bias;
  void* out;
  int B, H, W, C, K;
  int cc;        // channels per chunk: the MMA depth or kChunkBytes' worth
  int cc_shift;  // log2(cc)
  int nchunks;   // ceil(C / cc)
  int tiles_w;   // tiles per image row
  int tiles_h;   // tile rows per image
  int items;     // K slices x B x tiles_h x tiles_w
  int step_x, step_y, step_b, step_s;  // gridDim.x as digits of the item index
  int ps;        // halo pixel pitch in shared memory (elements): cc + 16 B skew
  int halo_elems;  // one halo buffer (elements), a multiple of 128 bytes
  int pix_bytes;   // packed rows: C * 2
  int row_bytes;   // packed rows: kTmaLead + kHW * C channels, in 16-byte multiples
  int tma_bytes;   // packed rows: one halo box
  int xvec;      // bytes per halo copy: 16, 8, 4 (cp.async) or 2 (bf16, scalar)
  int wvec;      // bytes per filter copy, likewise
  int wrow_shift;  // log2(filter copies per staged row)
  int nstages;   // halo buffers in the cp.async ring
  int resident;  // one chunk and one K slice: the filter is staged once
  int pairs;     // outputs stored two channels at a time (K even)
};

template <typename T>
struct MmaDepth;
template <>
struct MmaDepth<__nv_bfloat16> {
  static constexpr int value = 16;  // m16n8k16
};
template <>
struct MmaDepth<float> {
  static constexpr int value = 8;  // m16n8k8 (tf32)
};

// --- staging -------------------------------------------------------------
// Channels [c0, c0 + cc) of the halo around the tile at (ty0, tx0) into
// dst[halo pixel][ps]: zeros outside the image. With one chunk the channels
// past C stay zero from the kernel's start and are not copied; with more,
// every vector of the chunk is written (zeros past C).
template <typename T, int kBlock, int kHP>
__device__ __forceinline__ void stage_halo(T* dst, const Params& p, const T* img, int ty0,
                                           int tx0, int c0) {
  const int ve = p.xvec / (int)sizeof(T);
  const int cw = min(p.cc, p.C - c0);
  const int nv = p.nchunks == 1 ? cw / ve : p.cc / ve;  // ve divides C
  const float inv_nv = 1.0f / (float)nv;
  with_width(p.xvec, [&](auto bytes) {
#pragma unroll 1
    for (int i = threadIdx.x; i < kHP * nv; i += kBlock) {
      const int hp = __float2int_rz(((float)i + 0.5f) * inv_nv);  // i / nv (i < 2^16)
      const int j = (i - hp * nv) * ve;
      const int hy = hp / kHW;
      const int gy = ty0 + hy - 1;
      const int gx = tx0 + (hp - hy * kHW) - 1;
      const bool valid = j < cw && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      const T* src = valid ? img + ((size_t)gy * p.W + gx) * p.C + c0 + j : img;
      copy_vec<decltype(bytes)::value>(dst + hp * p.ps + j, src, valid);
    }
  });
}

// Rows [c0, c0 + cc) of every tap and columns [n0, n0 + kNT) of the [9C, K]
// filter into dst[tap * cc + k][kNT + 8]: zeros past C and past K. k = c,
// but for packed rows the MMA depth k = 2t + j (j < 2) or 2t + 8 + j - 2
// holds channel 4t + j, so that thread t's A fragment (k = 2t, 2t + 1,
// 2t + 8, 2t + 9) is channels 4t .. 4t + 3 of a pixel: one 8-byte load.
template <typename T, int kNT, int kBlock, bool kPacked>
__device__ __forceinline__ void stage_filter(T* dst, const Params& p, int c0, int n0) {
  constexpr int kNS = kNT + 8;
  const T* w = static_cast<const T*>(p.w);
  const int ve = p.wvec / (int)sizeof(T);
  const int cw = min(p.cc, p.C - c0);
  with_width(p.wvec, [&](auto bytes) {
#pragma unroll 1
    for (int i = threadIdx.x; i < (9 * p.cc) << p.wrow_shift; i += kBlock) {
      const int row = i >> p.wrow_shift;  // tap * cc + c
      const int col = (i - (row << p.wrow_shift)) * ve;
      const int tap = row >> p.cc_shift;
      const int c = row & (p.cc - 1);
      const bool valid = c < cw && n0 + col < p.K;
      const T* src = valid ? w + (size_t)(tap * p.C + c0 + c) * p.K + n0 + col : w;
      const int k = kPacked ? ((c >> 2) << 1) + (c & 1) + ((c & 2) << 2) : c;
      copy_vec<decltype(bytes)::value>(dst + (row - c + k) * kNS + col, src, valid);
    }
  });
}

// A position in the block's walk: the item (tile column and row, image,
// first output channel) and the chunk of channels, with its ring buffer.
struct Cursor {
  int tx, ty, b, n0, chunk, buf;
};

// The next stage: the next chunk, or the first chunk of the item gridDim.x
// further, added digit by digit with carries (no division in the loop).
template <int kNT>
__device__ __forceinline__ void advance(Cursor& c, const Params& p) {
  if (++c.buf == p.nstages) c.buf = 0;
  if (++c.chunk < p.nchunks) return;
  c.chunk = 0;
  c.tx += p.step_x;
  int carry = c.tx >= p.tiles_w;
  if (carry) c.tx -= p.tiles_w;
  c.ty += p.step_y + carry;
  carry = c.ty >= p.tiles_h;
  if (carry) c.ty -= p.tiles_h;
  c.b += p.step_b + carry;
  carry = c.b >= p.B;
  if (carry) c.b -= p.B;
  c.n0 += (p.step_s + carry) * kNT;
}

// --- the kernel ------------------------------------------------------------
// kNT: output channels per item (16, 32 or 64); kWarps warps of kWM tile
// rows (m16 fragments) each. out = conv(x, w) [* scale + bias -> SiLU].
//
// A persistent block walks items (K slice, image, tile of kRows x 16
// output pixels) through a ring of halo buffers; the filter is staged once
// (resident) or chunk by chunk with the halo.
template <typename T, bool kBnSilu, int kNT, int kWM, int kWarps, bool kPacked>
__global__ void __launch_bounds__(32 * kWarps)
    conv3x3_tile_kernel(const Params p, const __grid_constant__ CUtensorMap tmap) {
  constexpr int kBlock = 32 * kWarps;
  constexpr int kRows = kWarps * kWM;  // tile rows
  constexpr int kHP = (kRows + 2) * kHW;
  constexpr int kNS = kNT + 8;
  constexpr int kNTiles = kNT / 8;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int halo_elems = p.halo_elems;
  const int w_elems = 9 * p.cc * kNS;
  T* const wsm = reinterpret_cast<T*>(smem_raw);
  T* const halo = wsm + (p.resident ? 1 : p.nstages) * w_elems;
  // One mbarrier per ring buffer, past the buffers (packed rows only).
  uint64_t* const bar = reinterpret_cast<uint64_t*>(halo + p.nstages * halo_elems);
  const T* x = static_cast<const T*>(p.x);
  const int row0 = warp * kWM;  // this warp's first tile row

  // The padding (channels past C, the skew) reads as zeros: clear the
  // buffers once (not the mbarriers, which thread 0 initializes meanwhile);
  // then the resident filter.
  const int clear = (int)(reinterpret_cast<unsigned char*>(bar) - smem_raw) / 16;
  for (int i = threadIdx.x; i < clear; i += kBlock)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kPacked) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < p.nstages; ++i) mbar_init(bar + i);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros, for TMA
  }
  __syncthreads();
  if (p.resident) {
    stage_filter<T, kNT, kBlock, kPacked>(wsm, p, 0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const int n_stages =
      (p.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * p.nchunks;

  // Two cursors walk the block's stages: `ld` the next one to load, `cu`
  // the one to compute.
  Cursor ld;
  {
    const int tile = blockIdx.x % (p.tiles_h * p.tiles_w);
    const int rest = blockIdx.x / (p.tiles_h * p.tiles_w);
    ld = Cursor{tile % p.tiles_w, tile / p.tiles_w, rest % p.B, (rest / p.B) * kNT, 0, 0};
  }
  Cursor cu = ld;
  int issued = 0;
  // Each call commits one cp.async group, empty past the last stage.
  auto issue = [&]() {
    if (issued < n_stages) {
      const int c0 = ld.chunk * p.cc;
      if constexpr (kPacked) {  // one box: the halo rows, each kHW * C contiguous channels
        if (threadIdx.x == 0)
          tma_halo(bar + ld.buf, halo + ld.buf * halo_elems, tmap,
                   (ld.tx * kTW - 1) * p.C - kTmaLead, ld.ty * kRows - 1, ld.b, p.tma_bytes);
      } else {
        stage_halo<T, kBlock, kHP>(halo + ld.buf * halo_elems, p,
                                   x + (size_t)ld.b * p.H * p.W * p.C, ld.ty * kRows,
                                   ld.tx * kTW, c0);
      }
      if (!p.resident) stage_filter<T, kNT, kBlock, kPacked>(wsm + ld.buf * w_elems, p, c0, ld.n0);
      advance<kNT>(ld, p);
      ++issued;
    }
    cp_async_commit();
  };
  for (int s = 0; s < p.nstages - 1; ++s) issue();

  float acc[kWM][kNTiles][4];
  float sb[kBnSilu ? kNTiles : 1][4];  // BN scale and bias of this thread's channels
  uint32_t parity = 0;  // bit i: the phase of ring buffer i's mbarrier
  for (int s = 0; s < n_stages; ++s) {
    issue();
    if (p.nstages == 3) {
      cp_async_wait<2>();
    } else {
      cp_async_wait<1>();
    }
    if constexpr (kPacked) {
      mbar_wait(bar + cu.buf, (parity >> cu.buf) & 1u);
      parity ^= 1u << cu.buf;
    }
    __syncthreads();  // stage s has landed for every thread

    if (cu.chunk == 0) {
      if constexpr (kBnSilu) {  // loaded here, so the MMAs hide the latency
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const int n = cu.n0 + nt * 8 + 2 * t;
          sb[nt][0] = n < p.K ? __ldg(&p.scale[n]) : 0.0f;
          sb[nt][1] = n < p.K ? __ldg(&p.bias[n]) : 0.0f;
          sb[nt][2] = n + 1 < p.K ? __ldg(&p.scale[n + 1]) : 0.0f;
          sb[nt][3] = n + 1 < p.K ? __ldg(&p.bias[n + 1]) : 0.0f;
        }
      }
#pragma unroll
      for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][nt][j] = 0.0f;
    }
    const T* hb = halo + cu.buf * halo_elems;
    const T* wb = p.resident ? wsm : wsm + cu.buf * w_elems;
    const int ksteps = p.cc / MmaDepth<T>::value;

    if constexpr (kBf16) {
#pragma unroll 1
      for (int ks = 0; ks < ksteps; ++ks) {
        // The A fragment of halo row r at column shift dx serves every
        // (mi, dy) with mi + dy = r: 3 (kWM + 2) ldmatrix a k-step, not 9 kWM.
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          // B of taps (dy, dx): k rows (lane & 15) of two n8 tiles (lane >> 4).
          uint32_t b[3][kNT / 16][4];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int nj = 0; nj < kNT / 16; ++nj)
              ldmatrix_x4_trans(b[dy][nj],
                                smem_u32(wb + ((dy * 3 + dx) * p.cc + ks * 16 + (lane & 15)) * kNS +
                                         nj * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int r = 0; r < kWM + 2; ++r) {
            uint32_t a[4];
            if constexpr (kPacked) {
              // Packed rows (C = 4 or 12, one k-step; the filter's depth
              // permuted by stage_filter): channels 4t .. 4t + 3 of pixel g
              // (and g + 8) at dx. Past C they belong to the next pixel and
              // are masked to zero.
              const uint32_t h = smem_u32(hb) + (row0 + r) * p.row_bytes + 2 * kTmaLead +
                                 (g + dx) * p.pix_bytes + 8 * t;
              a[0] = a[1] = a[2] = a[3] = 0u;
              if (4 * t < p.C) {
                lds64(a[0], a[2], h);
                lds64(a[1], a[3], h + 8 * p.pix_bytes);
              }
            } else {
              // The 16 pixels of halo row r (lane & 15), k halves by lane >> 4.
              ldmatrix_x4(a, smem_u32(hb + ((row0 + r) * kHW + (lane & 15) + dx) * p.ps +
                                      ks * 16 + (lane >> 4) * 8));
            }
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              const int mi = r - dy;
              if (mi < 0 || mi >= kWM) continue;
#pragma unroll
              for (int nj = 0; nj < kNT / 16; ++nj) {
                mma_bf16(acc[mi][2 * nj], a, b[dy][nj][0], b[dy][nj][1]);
                mma_bf16(acc[mi][2 * nj + 1], a, b[dy][nj][2], b[dy][nj][3]);
              }
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        // This tap's 3xTF32 sums, added to acc in IEEE float32 after the
        // tap, so that no long chain of tensor-core accumulations (which do
        // not round to nearest) builds up over 9C terms.
        float part[kWM][kNTiles][4] = {};
#pragma unroll 1
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t ab[kWM][4], as[kWM][4];
#pragma unroll
          for (int mi = 0; mi < kWM; ++mi) {
            const float* h = hb + ((row0 + mi + dy) * kHW + g + dx) * p.ps + ks * 8 + t;
            split_tf32(h[0], ab[mi][0], as[mi][0]);
            split_tf32(h[8 * p.ps], ab[mi][1], as[mi][1]);
            split_tf32(h[4], ab[mi][2], as[mi][2]);
            split_tf32(h[8 * p.ps + 4], ab[mi][3], as[mi][3]);
          }
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt) {
            const float* w = wb + (tap * p.cc + ks * 8 + t) * kNS + nt * 8 + g;
            uint32_t bb0, bs0, bb1, bs1;
            split_tf32(w[0], bb0, bs0);
            split_tf32(w[4 * kNS], bb1, bs1);
#pragma unroll
            for (int mi = 0; mi < kWM; ++mi) {
              mma_tf32(part[mi][nt], as[mi], bb0, bb1);
              mma_tf32(part[mi][nt], ab[mi], bs0, bs1);
              mma_tf32(part[mi][nt], ab[mi], bb0, bb1);
            }
          }
        }
#pragma unroll
        for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[mi][nt][j] += part[mi][nt][j];
      }
    }

    if (cu.chunk == p.nchunks - 1) {  // the epilogue, from the accumulators
      // Each thread's outputs: rows row0 + mi, columns g and g + 8, channels
      // n0 + nt * 8 + 2t and the next one.
      auto value = [&](int mi, int nt, int j) {
        const float v = acc[mi][nt][j];
        if constexpr (kBnSilu) {
          return fast_silu<T>(fmaf(v, sb[nt][j & 1 ? 2 : 0], sb[nt][j & 1 ? 3 : 1]));
        }
        return v;
      };
      auto store_pair = [](T* o, float v0, float v1) {
        if constexpr (kBf16) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        }
      };
      const int gy0 = cu.ty * kRows + row0, gx0 = cu.tx * kTW + g;
      T* const out = static_cast<T*>(p.out) + (size_t)cu.b * p.H * p.W * p.K;
      if (p.pairs && cu.ty * kRows + kRows <= p.H && cu.tx * kTW + kTW <= p.W &&
          cu.n0 + kNT <= p.K) {  // the whole tile and slice lie inside: no masks
        T* const o = out + ((size_t)gy0 * p.W + gx0) * p.K + cu.n0 + 2 * t;
#pragma unroll
        for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int nt = 0; nt < kNTiles; ++nt)
              store_pair(o + ((size_t)mi * p.W + 8 * half) * p.K + nt * 8,
                         value(mi, nt, 2 * half), value(mi, nt, 2 * half + 1));
      } else {
#pragma unroll
        for (int mi = 0; mi < kWM; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int gy = gy0 + mi, gx = gx0 + 8 * half;
            if (gy >= p.H || gx >= p.W) continue;
#pragma unroll
            for (int nt = 0; nt < kNTiles; ++nt) {
              const int n = cu.n0 + nt * 8 + 2 * t;
              if (n >= p.K) continue;
              T* const o = out + ((size_t)gy * p.W + gx) * p.K + n;
              const float v0 = value(mi, nt, 2 * half), v1 = value(mi, nt, 2 * half + 1);
              if (p.pairs) {  // K even, so n + 1 < K too
                store_pair(o, v0, v1);
              } else {
                o[0] = from_f32<T>(v0);
                if (n + 1 < p.K) o[1] = from_f32<T>(v1);
              }
            }
          }
      }
    }
    __syncthreads();  // every read of stage s's buffers is done
    advance<kNT>(cu, p);
  }
  cp_async_wait<0>();
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

// Dynamic shared memory of a launch: the filter (once when resident, else
// one per ring buffer), the halo ring (buffers of 128-byte multiples, so a
// TMA box lands aligned) and one mbarrier per buffer.
template <typename T, int kNT, int kRows>
struct Layout {
  static int halo_elems(int cc) {
    constexpr int kPer = 128 / (int)sizeof(T);
    const int elems = (kRows + 2) * kHW * (cc + 16 / (int)sizeof(T));
    return (elems + kPer - 1) / kPer * kPer;
  }
  static int smem_bytes(int cc, bool resident) {
    const int nstages = resident ? 3 : 2;
    return (nstages * halo_elems(cc) + (resident ? 1 : nstages) * 9 * cc * (kNT + 8)) *
               (int)sizeof(T) +
           8 * nstages;
  }
};

// Per instantiation and per library (internal linkage: each library that
// includes this header keeps its own), found once: its attributes set for the largest shared
// memory any of its launches takes, the SM count, and the blocks per SM at
// each of its shared-memory sizes (cc the MMA depth [0] or kChunkBytes'
// worth [1]; resident or not). The process's first device stands for all.
namespace {
struct Occupancy {
  cudaError_t err;
  int sms;
  int per_sm[2][2];
};

template <typename T, bool kBnSilu, int kNT, int kWM, int kWarps, bool kPacked>
const Occupancy& occupancy() {
  using L = Layout<T, kNT, kWarps * kWM>;
  static const Occupancy occ = [] {
    Occupancy o{cudaSuccess, 0, {{0, 0}, {0, 0}}};
    const int ccs[2] = {MmaDepth<T>::value, kChunkBytes / (int)sizeof(T)};
    int most = 0;
    for (int c : ccs) most = std::max({most, L::smem_bytes(c, false), L::smem_bytes(c, true)});
    auto kernel = conv3x3_tile_kernel<T, kBnSilu, kNT, kWM, kWarps, kPacked>;
    int dev = 0;
    if ((o.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      most)) != cudaSuccess)
      return o;
    // All of L1 as shared memory, so that every block of the persistent
    // grid is resident at once (the grid is sized by the occupancy).
    if ((o.err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                      cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
        (o.err = cudaGetDevice(&dev)) != cudaSuccess ||
        (o.err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
      return o;
    for (int i = 0; i < 2; ++i)
      for (int r = 0; r < 2; ++r)
        if ((o.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &o.per_sm[i][r], kernel, 32 * kWarps, L::smem_bytes(ccs[i], r))) != cudaSuccess)
          return o;
    return o;
  }();
  return occ;
}

}  // namespace

// A bf16 pixel of 4 or 12 channels is no whole number of 16-byte vectors,
// but a halo row (kHW pixels) is: TMA copies the halo as one box of packed
// rows, given x 16-byte aligned and a row pitch (W * C * 2) of 16-byte
// multiples.
inline bool packed_rows(const void* x, int W, int C) {
  return C % 8 == 4 && C < 16 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && W * C * 2 % 16 == 0;
}

template <typename T, bool kBnSilu, int kNT, int kWM, int kWarps, bool kPacked>
cudaError_t launch_tiles(const void* x, const void* w, const void* scale, const void* bias,
                         void* out, int B, int H, int W, int C, int K, cudaStream_t stream) {
  constexpr int kBlock = 32 * kWarps;
  constexpr int kRows = kWarps * kWM;
  constexpr int kDepth = MmaDepth<T>::value;
  using L = Layout<T, kNT, kRows>;
  const int esize = (int)sizeof(T);
  Params p;
  p.x = x;
  p.w = w;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.B = B, p.H = H, p.W = W, p.C = C, p.K = K;
  // A power of two: the MMA depth, or kChunkBytes' worth (= 2 depths in bf16).
  p.cc = std::min(kChunkBytes / esize, (C + kDepth - 1) / kDepth * kDepth);
  p.cc_shift = log2_of(p.cc);
  p.nchunks = (C + p.cc - 1) / p.cc;
  const int nslices = (K + kNT - 1) / kNT;
  p.tiles_w = (W + kTW - 1) / kTW;
  p.tiles_h = (H + kRows - 1) / kRows;
  p.items = nslices * B * p.tiles_h * p.tiles_w;
  p.ps = p.cc + 16 / esize;
  p.halo_elems = L::halo_elems(p.cc);
  p.xvec = vector_bytes(x, C * esize, esize);
  p.wvec = vector_bytes(w, K * esize, esize);
  p.wrow_shift = log2_of(kNT * esize / p.wvec);
  p.resident = p.nchunks == 1 && nslices == 1;
  p.nstages = p.resident ? 3 : 2;
  p.pairs = K % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * esize) == 0;
  if (p.items == 0) return cudaSuccess;

  CUtensorMap tmap{};  // packed rows only
  const int box_w = (kTmaLead + kHW * C + 7) / 8 * 8;  // channels
  p.pix_bytes = C * esize;
  p.row_bytes = box_w * esize;
  p.tma_bytes = (kRows + 2) * p.row_bytes;
  if constexpr (kPacked) {
    const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)W * C, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)W * C * esize, (cuuint64_t)H * W * C * esize};
    const cuuint32_t box[3] = {(cuuint32_t)box_w, kRows + 2, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }

  const Occupancy& occ = occupancy<T, kBnSilu, kNT, kWM, kWarps, kPacked>();
  if (occ.err != cudaSuccess) return occ.err;
  const int per_sm = occ.per_sm[p.cc == kDepth ? 0 : 1][p.resident];
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = std::min(p.items, occ.sms * per_sm);
  p.step_x = grid % p.tiles_w;
  p.step_y = grid / p.tiles_w % p.tiles_h;
  p.step_b = grid / (p.tiles_w * p.tiles_h) % B;
  p.step_s = grid / (p.tiles_w * p.tiles_h * B);
  conv3x3_tile_kernel<T, kBnSilu, kNT, kWM, kWarps, kPacked>
      <<<grid, kBlock, L::smem_bytes(p.cc, p.resident), stream>>>(p, tmap);
  return cudaGetLastError();
}

// The K slice follows K. At K <= 16 (the stem) a warp takes four tile
// rows: tiles of 32 x 16 pixels, a 34 x 18 halo (1.19x the tile). Packed
// rows (the stem's TMA halo) are a separate instantiation, so that each
// main loop holds one way of reading A fragments (one alone fits the
// instruction cache).
template <typename T, bool kBnSilu>
cudaError_t launch_typed(const void* x, const void* w, const void* scale, const void* bias,
                         void* out, int B, int H, int W, int C, int K, cudaStream_t stream) {
  if (K <= 16) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (packed_rows(x, W, C))
        return launch_tiles<T, kBnSilu, 16, 4, 8, true>(x, w, scale, bias, out, B, H, W, C, K,
                                                        stream);
    }
    return launch_tiles<T, kBnSilu, 16, 4, 8, false>(x, w, scale, bias, out, B, H, W, C, K,
                                                     stream);
  }
  if (K <= 32)
    return launch_tiles<T, kBnSilu, 32, 1, 8, false>(x, w, scale, bias, out, B, H, W, C, K,
                                                     stream);
  return launch_tiles<T, kBnSilu, 64, 2, 4, false>(x, w, scale, bias, out, B, H, W, C, K, stream);
}

}  // namespace conv3x3

// w: [9C, K] in x's dtype (bf16 or float32); scale and bias (float32) are
// read only with kBnSilu.
template <bool kBnSilu>
cudaError_t launch_conv3x3(const void* x, const void* w, const void* scale, const void* bias,
                           void* out, int B, int H, int W, int C, int K, int is_bf16,
                           cudaStream_t stream) {
  if (is_bf16)
    return conv3x3::launch_typed<__nv_bfloat16, kBnSilu>(x, w, scale, bias, out, B, H, W, C,
                                                         K, stream);
  return conv3x3::launch_typed<float, kBnSilu>(x, w, scale, bias, out, B, H, W, C, K, stream);
}

}  // namespace needle
