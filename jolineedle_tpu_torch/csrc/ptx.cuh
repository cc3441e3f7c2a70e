// PTX helpers shared by the kernels of csrc/: shared-memory addresses,
// cp.async copies, ldmatrix, mma.sync (bf16 and TF32), mbarriers and TMA
// loads, the SiLU of the epilogues, and the host's tensor-map encoder.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace needle {
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes (4, 8 or 16) from src to shared dst; zeros when !valid (src-size 0
// reads nothing).
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes,
                                         bool valid) {
  const int n = valid ? bytes : 0;
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(n)
                 : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One vector of kBytes into shared memory, or zeros; 2 bytes (bf16 that is
// not 4-byte aligned) is a plain load and store.
template <int kBytes, typename T>
__device__ __forceinline__ void copy_vec(T* dst, const T* src, bool valid) {
  if constexpr (kBytes >= 4) {
    cp_async(smem_u32(dst), src, kBytes, valid);
  } else {
    *reinterpret_cast<unsigned short*>(dst) =
        valid ? __ldg(reinterpret_cast<const unsigned short*>(src)) : (unsigned short)0;
  }
}

// f(std::integral_constant<int, bytes>) for bytes = 16, 8, 4 or 2: one
// compact copy loop per width, chosen once per stage, keeps the main loop
// small enough for the instruction cache.
template <typename F>
__device__ __forceinline__ void with_width(int bytes, F&& f) {
  switch (bytes) {
    case 16: f(std::integral_constant<int, 16>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    default: f(std::integral_constant<int, 2>{}); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mbarriers and TMA.
// An mbarrier whose phase completes after `count` arrivals (and the bytes
// any expect_tx announced).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The box at (c0, y0, b) of the [B, H, W * C] tensor map into dst; the
// barrier completes when its bytes have landed. Coordinates outside the
// tensor read as zeros: the SAME border.
__device__ __forceinline__ void tma_halo(uint64_t* bar, void* dst, const CUtensorMap& map,
                                         int c0, int y0, int b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(y0), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// The box at (c0, x0, y0, b) of a [B, H, W, C] tensor map into dst, as
// tma_halo: coordinates outside the tensor (negative ones too) read as zeros.
__device__ __forceinline__ void tma_load_4d(uint64_t* bar, void* dst, const CUtensorMap& map,
                                            int c0, int x0, int y0, int b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(x0), "r"(y0), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void lds64(uint32_t& lo, uint32_t& hi, uint32_t addr) {
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(lo), "=r"(hi) : "r"(addr) : "memory");
}

// v = big + small, both TF32 (3xTF32).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(v - __uint_as_float(big)));
}

// SiLU on the float32 sum, before the store rounds it to T. float32: the
// fast exponential and reciprocal (about 2 ulp). bf16: v * (0.5 + 0.5 *
// tanh(v / 2)) on one tanh.approx (2^-11 relative), far below the bf16
// rounding that follows (2^-9).
template <typename T>
__device__ __forceinline__ float fast_silu(float v) {
  float r;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm("tanh.approx.f32 %0, %1;\n" : "=f"(r) : "f"(0.5f * v));
    return v * fmaf(0.5f, r, 0.5f);
  } else {
    asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.0f + __expf(-v)));
    return v * r;
  }
}

// cuTensorMapEncodeTiled, found once through the runtime's entry-point query
// (no link to libcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f)
               : nullptr;
  }();
  return fn;
}

}  // namespace needle
