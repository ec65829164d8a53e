// Fused HiFi-GAN ResBlock1 for Hopper (sm_90a): one tower of P pairs of
// leaky(0.1) -> dilated conv(k, d_p) -> leaky -> conv(k, 1) -> + residual,
// x [B, T, C] -> [B, T, C], float32.
//
// Replaces the TPU kernel zerovox_tpu/ops/pallas/resblock.py::fused_resblock1
// (_resblock_kernel). The vocoder runs it per tower when the towers cannot
// share one MRF kernel (a single tower, or towers whose dilations differ).
//
// What bounds it on an H100: arithmetic. A k=3, P=3 tower does 36 C^2 FLOP
// per row: 26 GFLOP at [1, 44096, 128] against 45 MB of input and output,
// ~580 FLOP per byte, far above the card's ~20 FLOP/byte float32 ridge.
//
// Design: the one-tower case of the MRF kernel's tile (mrf_common.cuh). One
// block of 256 threads per (time tile, batch row); the tile's window (TT
// rows + the tower's own halo, 12 rows a side at k=3, dilations 1,3,5) sits
// in shared memory in two buffers, conv1 reading the tower state A and
// writing B, conv2 reading B and adding into A; every conv computes only the
// rows later convs still need, and rows outside [0, T) are zeroed after each
// conv. The finished rows go straight to the output: with one tower there is
// no tower sum to keep. The tile is the largest that fits shared memory,
// then shrunk so the blocks fill whole waves of the card's SMs.
#include "mrf_common.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(zv::NT, 1)
resblock_kernel(const float* __restrict__ x, float* __restrict__ out, zv::MrfParams p, int T,
                int TT, int HW) {
  constexpr int LD = C + 4;
  extern __shared__ __align__(16) float smem[];
  const int W = TT + 2 * HW;
  float* A = smem;
  float* Bf = A + W * LD;
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
  // one tower: mrf_tile writes each finished row to `out` and never reads or
  // writes the tower-sum buffer, so it is given Bf's address and no space
  zv::mrf_tile<C, LD>(A, Bf, p, HW, TT, 0, tbase, T, (size_t)b * T, zv::MrfOut{Bf, out, 0.f},
                      load);
}

template <int C>
int launch(const float* x, float* out, const zv::MrfParams& p, int B, int T,
           cudaStream_t stream) {
  constexpr int LD = C + 4;
  constexpr int ROW_BYTES = 2 * LD * 4;  // A and B
  const int HW = zv::mrf_halo(p);
  int tt_max = (zv::SMEM_BUDGET / ROW_BYTES - 2 * HW) / 16 * 16;
  if (tt_max > 1024) tt_max = 1024;
  if (tt_max < 16) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // one block per SM at a time (shared memory, registers): spread the rows
  // over whole waves instead of leaving a ragged last wave
  const long slots = (long)sms * ((B * (long)((T + tt_max - 1) / tt_max) + sms - 1) / sms);
  const long per_row = (slots + B - 1) / B;
  int TT = (int)(((T + per_row - 1) / per_row + 15) / 16 * 16);
  if (TT > tt_max) TT = tt_max;
  if (TT < 16) TT = 16;
  const int smem = (TT + 2 * HW) * ROW_BYTES;
  e = cudaFuncSetAttribute(resblock_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + TT - 1) / TT, B);
  resblock_kernel<C><<<grid, zv::NT, smem, stream>>>(x, out, p, T, TT, HW);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out [B, T, C]; w: w1 [P][k][C][C] then w2 [P][k][C][C] (taps (k, in,
// out)); b: b1 [P][C] then b2 [P][C]; d0..d2: the P first-conv dilations.
// Returns a cudaError_t; C must be 32, 64 or 128, P 1-3, k odd.
extern "C" int zv_resblock1_f32(const float* x, float* out, const float* w, const float* b,
                                int B, int T, int C, int k, int n_pairs, int d0, int d1, int d2,
                                void* stream) {
  if (n_pairs < 1 || n_pairs > zv::MAX_PAIRS || k < 1 || k % 2 == 0 || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  zv::MrfParams p{1, {k, 0, 0}, n_pairs, {d0, d1, d2}, w, b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return launch<32>(x, out, p, B, T, s);
    case 64: return launch<64>(x, out, p, B, T, s);
    case 128: return launch<128>(x, out, p, B, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
