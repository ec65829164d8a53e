// 3xTF32 on the tensor cores: the operand split and the mma.sync.m16n8k8
// TF32 product shared by the tensor-core kernels (mrf_tc.cuh for K1/K2,
// se_conv.cu for K4).
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

}  // namespace tc
}  // namespace zv
