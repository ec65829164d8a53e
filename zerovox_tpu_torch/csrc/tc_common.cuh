// The tensor-core products shared by the kernels: 3xTF32's operand split and
// the mma.sync.m16n8k8 TF32 product (mrf_tc.cuh for K1-K3, se_conv.cu for
// K4), and the bf16 mma.sync.m16n8k16 product with ldmatrix (mrf_bf16.cuh for
// the bf16 K1/K2, se_conv.cu's bf16 K4).
//
// 3xTF32. Each operand is split as hi = rna_tf32(x), lo = rna_tf32(x - hi)
// (cvt.rna.tf32's rounding); three MMAs (lo.hi, hi.lo, hi.hi) accumulate
// in float32, which keeps the products to within float32 rounding of the
// float32 ones (single-pass TF32 is ~1.5e-3 off at K1's widths, 3x over the
// kernels' 5e-4 bound).
#pragma once

#include <cstdint>

namespace zv {
namespace tc {

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero, 10 mantissa
// bits) on the integer pipe: add half a TF32 ulp to the bit pattern and
// clear the 13 low bits. Bitwise the same as the conversion instruction for
// finite values, and faster on every K1/K2 shape measured.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a (16x8, row) . b (8x8, col), TF32 in, float32 accumulate. Fragments,
// with g = lane / 4 and t = lane % 4: a = {A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, float32 accumulate. With g =
// lane / 4 and t = lane % 4: a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]}, two bf16 a register, the
// lower index in the low half; d as in mma.
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 matrices of 16-bit values from shared memory: lanes 8q..8q+7 give
// the addresses of matrix q's rows (16 bytes each, 16-byte aligned); r[q] is
// its fragment, lane l holding row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

}  // namespace tc
}  // namespace zv
