// Fused HiFi-GAN upsample stage for Hopper (sm_90a): leaky(0.1) ->
// ConvTranspose1d (stride s, padding p) -> mean of ResBlock1 towers, and on
// the last stage leaky(0.01) -> conv_post (C_out -> 1) -> tanh, float32.
// x [B, T_in, C_in] -> [B, T_out, C_out], or the waveform [B, T_out].
//
// Replaces the TPU kernel zerovox_tpu/ops/pallas/packed.py::
// fused_packed_stage (_packed_stage_kernel). The TPU kernel's lane packing
// and banded shift matrices only fill the TPU's 128-wide matrix unit; here
// the stage is computed directly in its own channel width.
//
// What bounds it on an H100: arithmetic. At the main path's shapes the
// 128 -> 64 stage does ~94 GFLOP and the 64 -> 32 stage with conv_post ~47
// GFLOP against 45-68 MB of activations: several hundred FLOP per byte,
// above the card's ~20 FLOP/byte float32 ridge.
//
// Design: as mrf.cu (one 256-thread block per time tile, the window in two
// shared buffers plus a small tower-sum buffer, float32 FMA with a 4 x 4
// register tile), with the tower input produced in place: for each tower
// the tile's input rows (from L2 after the first tower) are staged into
// buffer B with the leaky relu applied, and the transposed conv writes the
// upsampled window into A. Recomputing the upsampler per tower costs ~3% of
// the stage's arithmetic and saves a fourth window buffer. With conv_post
// the towers' mean is kept in shared memory over the tile plus conv_post's
// halo, and one warp per output sample reduces conv_post over taps and
// channels.
#include "mrf_common.cuh"

namespace {

__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

template <int CI, int CO>
__global__ void __launch_bounds__(zv::NT, 1)
stage_kernel(const float* __restrict__ x, float* __restrict__ out, const float* __restrict__ up_w,
             const float* __restrict__ up_b, zv::MrfParams p, const float* __restrict__ post_w,
             const float* __restrict__ post_b, int T_in, int T_out, int up_k, int stride,
             int up_pad, int post_k, int TT, int HW, int bf_floats) {
  constexpr int LD = CO + 4;
  constexpr int LDI = CI + 4;
  extern __shared__ __align__(16) float smem[];
  const int W = TT + 2 * HW;
  const int P = post_k > 0 ? (post_k - 1) / 2 : 0;
  float* A = smem;
  float* Bf = A + W * LD;
  float* acc = Bf + bf_floats;
  const int b = blockIdx.y;
  const int tbase = blockIdx.x * TT - HW;
  const float* xb = x + (size_t)b * T_in * CI;

  auto load = [&](int lo, int hi) {
    // stage leaky(x) rows [i_min, i_max] into B
    const int i_min = floor_div(tbase + lo + up_pad - (up_k - 1), stride);
    const int i_max = floor_div(tbase + hi - 1 + up_pad, stride);
    constexpr int C4 = CI / 4;
    for (int idx = threadIdx.x; idx < (i_max - i_min + 1) * C4; idx += zv::NT) {
      const int i = i_min + idx / C4, c = (idx % C4) * 4;
      zv::at4(Bf + (i - i_min) * LDI + c) =
          (unsigned)i < (unsigned)T_in ? zv::leaky4(zv::ldg4(xb + (size_t)i * CI + c), 0.1f)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    // transposed conv, torch semantics: out[t] += x[i] * w[tap] where
    // t = i * stride - up_pad + tap; rows outside [0, T_out) stay zero
    constexpr int NCG = CO / 4;
    constexpr int NRG = zv::NT / NCG;
    const int co = (threadIdx.x % NCG) * 4;
    for (int r = lo + threadIdx.x / NCG; r < hi; r += NRG) {
      const int t = tbase + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if ((unsigned)t < (unsigned)T_out) {
        v = zv::ldg4(up_b + co);
        for (int tap = 0; tap < up_k; ++tap) {
          const int m = t + up_pad - tap;
          if (m < 0 || m % stride) continue;
          const int i = m / stride;
          if (i >= T_in) continue;
          const float* a = Bf + (i - i_min) * LDI;
          const float* wt = up_w + (size_t)tap * CI * CO + co;
#pragma unroll 4
          for (int ci = 0; ci < CI; ci += 4) {
            const float4 av = *reinterpret_cast<const float4*>(a + ci);
            const float xs[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float4 wv = zv::ldg4(wt + (ci + c) * CO);
              v.x = fmaf(xs[c], wv.x, v.x);
              v.y = fmaf(xs[c], wv.y, v.y);
              v.z = fmaf(xs[c], wv.z, v.z);
              v.w = fmaf(xs[c], wv.w, v.w);
            }
          }
        }
      }
      zv::at4(A + r * LD + co) = v;
    }
  };

  zv::mrf_tile<CO, LD>(A, Bf, p, HW, TT, P, tbase, T_out, (size_t)b * T_out,
                       zv::MrfOut{acc, post_k > 0 ? nullptr : out, 0.01f}, load);
  if (post_k == 0) return;

  // acc holds leaky(mean, 0.01) for window rows [HW - P, HW + TT + P)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float pb = __ldg(post_b);
  for (int r = HW + warp; r < HW + TT; r += zv::NT / 32) {
    const int t = tbase + r;
    if ((unsigned)t >= (unsigned)T_out) continue;
    float y = 0.f;
    for (int tap = 0; tap < post_k; ++tap) {
      const float* a = acc + (r - HW + tap) * LD;
      const float* wt = post_w + tap * CO;
      for (int ci = lane; ci < CO; ci += 32) y = fmaf(a[ci], __ldg(wt + ci), y);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) y += __shfl_xor_sync(0xffffffffu, y, s);
    if (lane == 0) out[(size_t)b * T_out + t] = tanhf(y + pb);
  }
}

template <int CI, int CO>
int launch(const float* x, float* out, const float* up_w, const float* up_b,
           const zv::MrfParams& p, const float* post_w, const float* post_b, int B, int T_in,
           int up_k, int stride, int up_pad, int post_k, cudaStream_t s) {
  constexpr int LD = CO + 4;
  constexpr int LDI = CI + 4;
  const int P = post_k > 0 ? (post_k - 1) / 2 : 0;
  const int HW = zv::mrf_halo(p) + P;
  const int T_out = (T_in - 1) * stride + up_k - 2 * up_pad;
  int smem = 0;
  const int TT = zv::pick_tile(LD, HW, P, zv::SMEM_BUDGET, up_k, stride, LDI, &smem);
  if (TT == 0 || T_out <= 0) return (int)cudaErrorInvalidConfiguration;
  const int W = TT + 2 * HW;
  const int staged = zv::up_rows_in(W, up_k, stride) * LDI;
  const int bf_floats = W * LD > staged ? W * LD : staged;
  cudaError_t e = cudaFuncSetAttribute(stage_kernel<CI, CO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T_out + TT - 1) / TT, B);
  stage_kernel<CI, CO><<<grid, zv::NT, smem, s>>>(x, out, up_w, up_b, p, post_w, post_b, T_in,
                                                  T_out, up_k, stride, up_pad, post_k, TT, HW,
                                                  bf_floats);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, T_in, C_in]; up_w [up_k][C_in][C_out] (torch taps, not flipped);
// up_b [C_out]; w, b: flat tower weights (see zv::MrfParams); post_w
// [post_k][C_out] and post_b [1] when post_k > 0 (else ignored). out is
// [B, T_out, C_out], or [B, T_out] with post. Returns a cudaError_t;
// (C_in, C_out) must be (128, 64), (64, 32) or (32, 16).
extern "C" int zv_upsample_stage_f32(const float* x, float* out, const float* up_w,
                                     const float* up_b, const float* w, const float* b,
                                     const float* post_w, const float* post_b, int B, int T_in,
                                     int C_in, int C_out, int up_k, int stride, int up_pad,
                                     int post_k, int n_towers, int k0, int k1, int k2,
                                     int n_pairs, int d0, int d1, int d2, void* stream) {
  if (n_towers < 1 || n_towers > zv::MAX_TOWERS || n_pairs < 1 || n_pairs > zv::MAX_PAIRS ||
      stride < 1 || up_k < 1 || post_k < 0 || (post_k > 0 && post_k % 2 == 0))
    return (int)cudaErrorInvalidValue;
  zv::MrfParams p{n_towers, {k0, k1, k2}, n_pairs, {d0, d1, d2}, w, b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C_in == 128 && C_out == 64)
    return launch<128, 64>(x, out, up_w, up_b, p, post_w, post_b, B, T_in, up_k, stride, up_pad,
                           post_k, s);
  if (C_in == 64 && C_out == 32)
    return launch<64, 32>(x, out, up_w, up_b, p, post_w, post_b, B, T_in, up_k, stride, up_pad,
                          post_k, s);
  if (C_in == 32 && C_out == 16)
    return launch<32, 16>(x, out, up_w, up_b, p, post_w, post_b, B, T_in, up_k, stride, up_pad,
                          post_k, s);
  return (int)cudaErrorInvalidValue;
}
