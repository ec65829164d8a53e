// Fused HiFi-GAN MRF stage for Hopper (sm_90a): the mean of ResBlock1
// towers over one input, x [B, T, C] -> [B, T, C], float32 in and out, or
// bf16 in and out with float32 inside (zv_mrf_bf16, bf16 inference).
//
// Replaces the TPU kernel zerovox_tpu/ops/pallas/mrf.py::fused_mrf
// (_mrf_kernel). Each tower is P pairs of leaky(0.1) -> dilated conv(k, d)
// -> leaky -> conv(k, 1) -> + residual; the stage output is the mean of
// the towers.
//
// What bounds it on an H100: tensor-core operations. At the main path's
// shape (C=128, T=44096, towers 3/7/11 x dilations 1,3,5) the stage does
// 252 C^2 FLOP per row, 182 GFLOP, which 3xTF32 runs as 546 GFLOP of TF32
// MMAs, against ~53 MB of input, output and weights.
//
// Design: the tensor-core tile of mrf_tc.cuh, one block of 512 threads per
// (time tile, batch row). The tile's window (TT rows + the towers' halo on
// each side) lives in shared memory in two buffers: conv1 reads A (the tower
// state) and writes B, conv2 reads B and adds into A; each conv computes
// only the rows later convs still need. The tower sum is kept in the output
// rows the block owns, so the two buffers take all of shared memory: at
// C=128 the window is at most 220 rows (TT <= 100 with the 60-row halo).
// Halo recompute and wave fill are traded off by one cost model
// (zv::tc::choose_tile): the tile is the one that minimises whole waves
// of blocks (one per SM) x each block's MMA work, halo rows and ragged
// 32-row items included. The input is re-read per tower (from L2 after the
// first); the output is written once per tower.
//
// bf16 (zv_mrf_bf16): the same tile on bf16 x and weights in the bf16x2
// arithmetic of mrf_bf16.cuh: bf16 mma.sync.m16n8k16, each activation as two
// bf16 terms, two MMAs a product, conv2's operand split once into shared
// memory; x widened at the load, the tower sum kept in a float32 scratch of
// the output's shape (the caller's), and only the mean rounded to bf16. The
// bound is two bf16 products a product, 364 GFLOP at 989 TFLOP/s, against
// ~27 MB.
#include <type_traits>

#include "mrf_bf16.cuh"

namespace {

using zv::tc::NT;

// The float32 kernel; the tower sums are kept in out.
template <int C>
__global__ void __launch_bounds__(NT, 1)
mrf_kernel(const float* __restrict__ x, float* out, zv::MrfParams p, int T, int TT, int HW) {
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
    for (int idx = threadIdx.x; idx < (hi - lo) * C4; idx += NT) {
      const int r = lo + idx / C4, c = (idx % C4) * 4;
      const int t = tbase + r;
      zv::at4(A + r * LD + c) = (unsigned)t < (unsigned)T
                                    ? zv::ldg4(xb + (size_t)t * C + c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  zv::tc::mrf_tile<C>(A, Bf, p, HW, TT, 0, tbase, T, (size_t)b * T,
                      zv::tc::TileOut<float>{out, nullptr, 0.f, out}, load);
}

// The bf16 kernel (mrf_bf16.cuh): A of lda(C) floats a row, B of ldb(C)
// bf16; sum: the float32 tower sums.
template <int C>
__global__ void __launch_bounds__(NT, 1)
mrf_kernel_bf16(const zv::bf16* __restrict__ x, zv::bf16* out, float* sum,
                zv::MrfParamsT<zv::bf16> p, int T, int TT, int HW) {
  constexpr int LA = zv::bf16x2::lda(C);
  extern __shared__ __align__(16) float smem[];
  const int W = TT + 2 * HW;
  float* A = smem;
  zv::bf16* Bs = reinterpret_cast<zv::bf16*>(A + W * LA);
  const int b = blockIdx.y;
  const int tbase = blockIdx.x * TT - HW;
  const zv::bf16* xb = x + (size_t)b * T * C;
  auto load = [&](int lo, int hi) {
    constexpr int C4 = C / 4;
    for (int idx = threadIdx.x; idx < (hi - lo) * C4; idx += NT) {
      const int r = lo + idx / C4, c = (idx % C4) * 4;
      const int t = tbase + r;
      zv::at4(A + r * LA + c) = (unsigned)t < (unsigned)T
                                    ? zv::ldg4(xb + (size_t)t * C + c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  zv::bf16x2::mrf_tile<C>(A, Bs, p, HW, TT, 0, tbase, T, (size_t)b * T,
                          zv::tc::TileOut<zv::bf16>{out, nullptr, 0.f, sum}, load);
}

// The tile of a launch (zv::tc::choose_tile) and its shared memory bytes:
// float32, two windows of C + 4 floats a row and the cost in k-steps of 8;
// bf16, rows of lda(C) floats and ldb(C) bf16 and k-steps of 16.
template <int C, class E>
int plan(const zv::MrfParamsT<E>& p, int B, int T, int* TT, int* smem) {
  constexpr bool bf = std::is_same_v<E, zv::bf16>;
  constexpr long row_bytes = bf ? 4L * (zv::bf16x2::lda(C) + C + 4) : 8L * (C + 4);
  const int HW = zv::mrf_halo(p);
  int sms = 0;
  const int e = zv::tc::sm_count(&sms);
  if (e != 0) return e;
  *TT = zv::tc::choose_tile(
      T, B, sms, [&](int tt) { return row_bytes * (tt + 2 * HW); },
      [&](int tt) { return zv::tc::towers_cost(p, C, tt, 0, zv::tc::NWARP, bf ? 16 : 8); }, smem);
  return *TT == 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

template <int C, class E>
int launch(const E* x, E* out, float* sum, const zv::MrfParamsT<E>& p, int B, int T,
           cudaStream_t stream) {
  int TT = 0, smem = 0;
  int e = plan<C>(p, B, T, &TT, &smem);
  if (e != 0) return e;
  dim3 grid((T + TT - 1) / TT, B);
  const int HW = zv::mrf_halo(p);
  if constexpr (std::is_same_v<E, zv::bf16>) {
    e = (int)cudaFuncSetAttribute(mrf_kernel_bf16<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
    if (e != 0) return e;
    mrf_kernel_bf16<C><<<grid, NT, smem, stream>>>(x, out, sum, p, T, TT, HW);
  } else {
    e = (int)cudaFuncSetAttribute(mrf_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
    if (e != 0) return e;
    mrf_kernel<C><<<grid, NT, smem, stream>>>(x, out, p, T, TT, HW);
  }
  return (int)cudaGetLastError();
}

template <class E>
int launch_c(const E* x, E* out, float* sum, const zv::MrfParamsT<E>& p, int B, int T, int C,
             cudaStream_t s) {
  switch (C) {
    case 8: return launch<8>(x, out, sum, p, B, T, s);
    case 16: return launch<16>(x, out, sum, p, B, T, s);
    case 32: return launch<32>(x, out, sum, p, B, T, s);
    case 64: return launch<64>(x, out, sum, p, B, T, s);
    case 128: return launch<128>(x, out, sum, p, B, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class E>
int tile_c(const zv::MrfParamsT<E>& p, int B, int T, int C) {
  int TT = 0, smem = 0, e = (int)cudaErrorInvalidValue;
  switch (C) {
    case 8: e = plan<8>(p, B, T, &TT, &smem); break;
    case 16: e = plan<16>(p, B, T, &TT, &smem); break;
    case 32: e = plan<32>(p, B, T, &TT, &smem); break;
    case 64: e = plan<64>(p, B, T, &TT, &smem); break;
    case 128: e = plan<128>(p, B, T, &TT, &smem); break;
  }
  return e != 0 ? -e : TT;
}

}  // namespace

static int check_args(int n_towers, int n_pairs, int B, int T) {
  return n_towers < 1 || n_towers > zv::MAX_TOWERS || n_pairs < 1 || n_pairs > zv::MAX_PAIRS ||
                 B < 1 || T < 1
             ? (int)cudaErrorInvalidValue
             : 0;
}

// x, out [B, T, C]; w: every tower's conv taps in mma fragment order (see
// mrf_tc.cuh and zv::MrfParams for the order of convs); b: the biases.
// Returns a cudaError_t; C must be 8, 16, 32, 64 or 128.
extern "C" int zv_mrf_f32(const float* x, float* out, const float* w, const float* b, int B,
                          int T, int C, int n_towers, int k0, int k1, int k2, int n_pairs,
                          int d0, int d1, int d2, void* stream) {
  if (int e = check_args(n_towers, n_pairs, B, T)) return e;
  zv::MrfParams p{n_towers, {k0, k1, k2}, n_pairs, {d0, d1, d2}, w, b};
  return launch_c(x, out, out, p, B, T, C, static_cast<cudaStream_t>(stream));
}

// zv_mrf_f32 on bf16 x, out, w and b, w in m16n8k16 fragment order
// (mrf_bf16.cuh, the same order of convs); sum: float32 scratch [B, T, C]
// for the tower sums (may be null with one tower).
extern "C" int zv_mrf_bf16(const zv::bf16* x, zv::bf16* out, float* sum, const zv::bf16* w,
                           const zv::bf16* b, int B, int T, int C, int n_towers, int k0, int k1,
                           int k2, int n_pairs, int d0, int d1, int d2, void* stream) {
  if (int e = check_args(n_towers, n_pairs, B, T)) return e;
  if (n_towers > 1 && sum == nullptr) return (int)cudaErrorInvalidValue;
  zv::MrfParamsT<zv::bf16> p{n_towers, {k0, k1, k2}, n_pairs, {d0, d1, d2}, w, b};
  return launch_c(x, out, sum, p, B, T, C, static_cast<cudaStream_t>(stream));
}

// The time tile zv_mrf_f32 takes for these arguments (rows), or minus a
// cudaError_t.
extern "C" int zv_mrf_tile(int B, int T, int C, int n_towers, int k0, int k1, int k2,
                           int n_pairs, int d0, int d1, int d2) {
  if (int e = check_args(n_towers, n_pairs, B, T)) return -e;
  return tile_c(zv::MrfParams{n_towers, {k0, k1, k2}, n_pairs, {d0, d1, d2}, nullptr, nullptr},
                B, T, C);
}

// The time tile zv_mrf_bf16 takes, likewise.
extern "C" int zv_mrf_bf16_tile(int B, int T, int C, int n_towers, int k0, int k1, int k2,
                                int n_pairs, int d0, int d1, int d2) {
  if (int e = check_args(n_towers, n_pairs, B, T)) return -e;
  return tile_c(zv::MrfParamsT<zv::bf16>{n_towers, {k0, k1, k2}, n_pairs, {d0, d1, d2}, nullptr,
                                         nullptr},
                B, T, C);
}
