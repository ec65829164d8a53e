// Shared parts of the fused HiFi-GAN kernels (mrf.cu, upsample_stage.cu,
// resblock.cu, all on the tensor-core tile of mrf_tc.cuh): the tower
// parameters, their halos, and float4 helpers of the stage loads.
//
// Layout: activations are rows of C floats (NLC, channels contiguous). A
// tile covers TT output rows plus a halo of HW rows on each side ("window
// coordinates": window row r is sequence row tbase + r).
#pragma once

#include <cuda_runtime.h>

namespace zv {

constexpr int MAX_TOWERS = 3;
constexpr int MAX_PAIRS = 3;

struct MrfParams {
  int n_towers;
  int ks[MAX_TOWERS];     // kernel size of each tower
  int n_pairs;
  int dils[MAX_PAIRS];    // dilation of each pair's first conv (shared by towers)
  const float* w;         // tower j: w1 [P][k] then w2 [P][k] taps, in mma fragment order
  const float* b;         // tower j: b1 [P][C] then b2 [P][C]
};

__host__ __device__ inline int tower_halo(int k, const MrfParams& p) {
  const int half = (k - 1) / 2;
  int h = 0;
  for (int q = 0; q < p.n_pairs; ++q) h += half * p.dils[q] + half;
  return h;
}

__host__ __device__ inline int mrf_halo(const MrfParams& p) {
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

// Shared memory one block may take on an H100: the SM's 228 KB less the
// 1 KB the hardware keeps for each resident block.
constexpr int SMEM_BUDGET = 227 * 1024;

}  // namespace zv
