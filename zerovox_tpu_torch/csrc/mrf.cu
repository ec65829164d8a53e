// Fused HiFi-GAN MRF stage for Hopper (sm_90a): the mean of ResBlock1
// towers over one input, x [B, T, C] -> [B, T, C], float32.
//
// Replaces the TPU kernel zerovox_tpu/ops/pallas/mrf.py::fused_mrf
// (_mrf_kernel). Each tower is P pairs of leaky(0.1) -> dilated conv(k, d)
// -> leaky -> conv(k, 1) -> + residual; the stage output is the mean of
// the towers.
//
// What bounds it on an H100: arithmetic. At the main path's shape (C=128,
// T=44096, towers 3/7/11 x dilations 1,3,5) the stage does 252 C^2 FLOP per
// row, 182 GFLOP, against ~53 MB of input, output and weights: ~3400 FLOP
// per byte, far above the card's ~20 FLOP/byte float32 ridge.
//
// Design: one block of 256 threads per (time tile, batch row). The tile's
// window (TT rows + a halo of the towers' receptive field on each side)
// lives in shared memory in two buffers: conv1 reads A (the tower state)
// and writes B, conv2 reads B and adds into A; the tower sum of the TT
// output rows is a third, small buffer. Each conv computes only the rows
// later convs still need, so the halo recompute shrinks conv by conv. The
// input is re-read for each tower (from L2 after the first); the output is
// written once. Convs are float32 FMA with a 4 x 4 register tile per thread;
// weights (8.3 MB at C=128) stream through L2 and L1.
#include "mrf_common.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(zv::NT, 1)
mrf_kernel(const float* __restrict__ x, float* __restrict__ out, zv::MrfParams p, int T,
           int TT, int HW) {
  constexpr int LD = C + 4;
  extern __shared__ __align__(16) float smem[];
  const int W = TT + 2 * HW;
  float* A = smem;
  float* Bf = A + W * LD;
  float* acc = Bf + W * LD;
  const int b = blockIdx.y;
  const int tbase = blockIdx.x * TT - HW;
  const float* xb = x + (size_t)b * T * C;
  auto load = [&](int lo, int hi) {
    constexpr int C4 = C / 4;
    for (int idx = threadIdx.x; idx < (hi - lo) * C4; idx += zv::NT) {
      const int r = lo + idx / C4, c = (idx % C4) * 4;
      const int t = tbase + r;
      zv::at4(A + r * LD + c) = (unsigned)t < (unsigned)T
                                    ? zv::ldg4(xb + (size_t)t * C + c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  zv::mrf_tile<C, LD>(A, Bf, p, HW, TT, 0, tbase, T, (size_t)b * T, zv::MrfOut{acc, out, 0.f},
                      load);
}

template <int C>
int launch(const float* x, float* out, const zv::MrfParams& p, int B, int T,
           cudaStream_t stream) {
  constexpr int LD = C + 4;
  const int HW = zv::mrf_halo(p);
  int smem = 0;
  const int TT = zv::pick_tile(LD, HW, 0, zv::SMEM_BUDGET, 0, 1, 0, &smem);
  if (TT == 0) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(mrf_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + TT - 1) / TT, B);
  mrf_kernel<C><<<grid, zv::NT, smem, stream>>>(x, out, p, T, TT, HW);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out [B, T, C]; w, b: flat tower weights (see zv::MrfParams).
// Returns a cudaError_t; C must be 32, 64 or 128.
extern "C" int zv_mrf_f32(const float* x, float* out, const float* w, const float* b, int B,
                          int T, int C, int n_towers, int k0, int k1, int k2, int n_pairs,
                          int d0, int d1, int d2, void* stream) {
  if (n_towers < 1 || n_towers > zv::MAX_TOWERS || n_pairs < 1 || n_pairs > zv::MAX_PAIRS)
    return (int)cudaErrorInvalidValue;
  zv::MrfParams p{n_towers, {k0, k1, k2}, n_pairs, {d0, d1, d2}, w, b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return launch<32>(x, out, p, B, T, s);
    case 64: return launch<64>(x, out, p, B, T, s);
    case 128: return launch<128>(x, out, p, B, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
