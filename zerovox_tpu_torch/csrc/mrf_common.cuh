// Shared parts of the fused HiFi-GAN kernels (mrf.cu, upsample_stage.cu,
// resblock.cu, all on the tensor-core tile of mrf_tc.cuh): the tower
// parameters, their halos, and the loads and stores of one element type.
//
// Layout: activations are rows of C elements (NLC, channels contiguous). A
// tile covers TT output rows plus a halo of HW rows on each side ("window
// coordinates": window row r is sequence row tbase + r).
//
// Element types: float, or bf16 (bf16 inference). A bf16 value widens to
// float exactly (its bits shifted up by 16); inside a kernel every value is
// float32, and a bf16 output is rounded once, to nearest even, when stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace zv {

using bf16 = __nv_bfloat16;

constexpr int MAX_TOWERS = 3;
constexpr int MAX_PAIRS = 3;

// E: the element type of the weights and biases (float or bf16).
template <class E>
struct MrfParamsT {
  int n_towers;
  int ks[MAX_TOWERS];     // kernel size of each tower
  int n_pairs;
  int dils[MAX_PAIRS];    // dilation of each pair's first conv (shared by towers)
  const E* w;             // tower j: w1 [P][k] then w2 [P][k] taps, in mma fragment order
  const E* b;             // tower j: b1 [P][C] then b2 [P][C]
};
using MrfParams = MrfParamsT<float>;

template <class E>
__host__ __device__ inline int tower_halo(int k, const MrfParamsT<E>& p) {
  const int half = (k - 1) / 2;
  int h = 0;
  for (int q = 0; q < p.n_pairs; ++q) h += half * p.dils[q] + half;
  return h;
}

template <class E>
__host__ __device__ inline int mrf_halo(const MrfParamsT<E>& p) {
  int h = 0;
  for (int j = 0; j < p.n_towers; ++j) {
    const int t = tower_halo(p.ks[j], p);
    h = t > h ? t : h;
  }
  return h;
}

__device__ __forceinline__ float leaky(float v, float slope) { return v >= 0.f ? v : v * slope; }

__device__ __forceinline__ float4 leaky4(float4 v, float slope) {
  return make_float4(leaky(v.x, slope), leaky(v.y, slope), leaky(v.z, slope), leaky(v.w, slope));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4& at4(float* p) { return *reinterpret_cast<float4*>(p); }

// bf16 bits -> float, exactly.
__device__ __forceinline__ float widen_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float widen_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

// Four bf16 (8 bytes) widened to float32.
__device__ __forceinline__ float4 ldg4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(widen_lo(u.x), widen_hi(u.x), widen_lo(u.y), widen_hi(u.y));
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ float2 ldg2(const bf16* p) {
  const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(widen_lo(u), widen_hi(u));
}

__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ldg1(const bf16* p) {
  return widen_lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// Stores of finished float32 values in the output's type (bf16: rounded to
// nearest even).
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void store2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }

__device__ __forceinline__ void store2(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

// Shared memory one block may take on an H100: the SM's 228 KB less the
// 1 KB the hardware keeps for each resident block.
constexpr int SMEM_BUDGET = 227 * 1024;

}  // namespace zv
