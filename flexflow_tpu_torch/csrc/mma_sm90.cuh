// Warp-level building blocks of the port's tensor-core kernels for Hopper
// (sm_90a): cp.async copies into shared memory, the 3xTF32 split,
// mma.sync products (m16n8k8 TF32, m16n8k16 bf16), ldmatrix, a split TF32
// A fragment and the bf16 pair packing.  Included by fused_ce_mma.cuh
// (kernels 4-6) and flash_attention_fwd.cu / flash_attention_bwd.cu
// (kernels 1-3).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// big = cvt.rna.tf32.f32(a), small = cvt.rna.tf32.f32(a - big), written
// as the integer ops that give cvt.rna's bits (keep 10 mantissa bits,
// round to nearest, ties away from zero: add half of the 13 dropped bits'
// range to the magnitude, then cut them); on sm_90 cvt.rna.tf32 lowers to
// a longer sequence, and these ops share the instruction slots with the
// mma
__device__ __forceinline__ uint32_t rna_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_tf32(float a, uint32_t& big,
                                           uint32_t& small) {
  big = rna_tf32(a);
  small = rna_tf32(a - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 matrices of 16-bit elements (8 rows of 16 bytes each, row
// addresses from lanes 8q..8q+7 for matrix q) into r[q]: lane l gets row
// l / 4, 32-bit word l % 4 of each, or with TRANS the 16-bit elements
// (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4).  For float32 tiles a
// 32-bit word is one element, so the plain form loads TF32 fragments of
// tiles that are contiguous along k.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix4(uint32_t r[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  if (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  }
}

// A fragment (16 rows x 8 deep) of a float32 [m][k] tile, split
__device__ __forceinline__ void a_frag_tf32(const float* s, int ld,
                                            uint32_t big[4],
                                            uint32_t small[4]) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int q = lane / 8;
  uint32_t raw[4];
  ldmatrix4<false>(raw, s + (lane % 8 + 8 * (q % 2)) * ld + 4 * (q / 2));
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(raw[e]), big[e], small[e]);
}

// (bf16(a) in the low half, bf16(b) in the high half), rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(b), "f"(a));
  return r;
}

}  // namespace
