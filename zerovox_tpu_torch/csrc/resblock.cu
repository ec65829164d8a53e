// Fused HiFi-GAN ResBlock1 for Hopper (sm_90a): one tower of P pairs of
// leaky(0.1) -> dilated conv(k, d_p) -> leaky -> conv(k, 1) -> + residual,
// x [B, T, C] -> [B, T, C], float32 in and out, or bf16 in and out with
// float32 inside (zv_resblock1_bf16, bf16 inference).
//
// Replaces the TPU kernel zerovox_tpu/ops/pallas/resblock.py::fused_resblock1
// (_resblock_kernel). The vocoder runs it per tower when the towers cannot
// share one MRF kernel (a single tower, or towers whose dilations differ).
//
// What bounds it on an H100: tensor-core operations. A k=3, P=3 tower does
// 36 C^2 FLOP per row: 26 GFLOP at [1, 44096, 128], which 3xTF32 runs as
// 78 GFLOP of TF32 MMAs, against 45 MB of input and output.
//
// Design: the one-tower case of the tensor-core tile of mrf_tc.cuh (K1's and
// K2's), one block per (time tile, batch row). The window (TT rows + the
// tower's halo, 12 rows a side at k=3, dilations 1,3,5) sits in shared
// memory in two buffers: conv1 reads the tower state A and writes B, conv2
// reads B and adds into A; every conv is a sum over taps of mma.sync GEMMs
// in 3xTF32 and computes only the rows later convs still need. The finished
// rows go straight to the output. The halo is a fifth of K1's, so the tile
// recomputes ~1.1x (K1 1.5x).
//
// What one tower changes against K1, decided on an H100 by
// scripts/bench_k3_variants.py (times in PERF.md):
//   * at C <= STAGE_MAX_C each conv's weights (12 KB at C=32 for 3 taps)
//     are copied into shared memory before the conv and split there once
//     into hi/lo TF32 halves, instead of every warp reading its B fragments
//     from L2 and splitting them at each k-step: 3 % faster at C=32. At
//     C=64 the staged 98 KB cut the tile from 224 to 168 rows and it was
//     4 % slower; C=128's 196 KB a conv do not fit beside a tile. Those
//     widths read B from L2 as K1 does;
//   * at C=32 a block has WARPS_C32 = 8 warps, 2 blocks an SM (16 warps
//     an SM either way): a 32-row item has only 12 k-steps at k=3, and
//     smaller blocks leave fewer warps idle in a conv's last round (4 %
//     faster than 16; 4 warps, 4 blocks an SM, was 27 % slower).
//   * C = 16 and 8 (a 256-channel single-tower vocoder's last stage, and
//     narrower) stage their weights too (3 KB and 0.8 KB a conv at k=3). At
//     C=16 blocks of WARPS_C16 = 16 warps were 11 % faster than 8; at C=8
//     blocks of WARPS_C8 = 4 warps, 4 an SM, 20 % faster than 8 (its 224-
//     row tile has 7 items a conv: 4-warp blocks leave fewer warps idle).
//     Measured at bucket 689's [1, 88192, 16] and [1, 176384, 8] by
//     bench_k3_variants.py (PERF.md).
// Every instantiated width names its layout in `Layout` below; a width
// without one does not compile. The tile is zv::tc::choose_tile's, with
// towers_cost over one tower.
//
// bf16 (zv_resblock1_bf16): the one-tower case of the bf16 tile of
// mrf_bf16.cuh (K1's and K2's): bf16 mma.sync.m16n8k16, each float32
// activation as two bf16 terms (hi = rn(a), lo = rn(a - hi)), two MMAs a
// product accumulated in float32; conv1's A from the float32 tower state (rows
// of lda(C) floats, split at the load), conv2's from B (rows of ldb(C) bf16,
// split once by conv1's epilogue, read by ldmatrix); the weights in m16n8k16
// fragment order (ops.mrf.mma_fragments_bf16, exact). The residual stream
// stays float32 and the tower's output is rounded to bf16 once. The bound is
// two bf16 products a product, 52 GFLOP at [1, 44096, 128] at 989 TFLOP/s,
// against 23 MB. Its result is within one bf16 step of the plain version
// with a fraction of a percent of the outputs rounded the other way; it is
// not bitwise the float32 kernel (tests/test_torch_bf16_mma.py emulates it).
//
// The bf16 layout, `Layout<C>::warps_bf16` and `stage_bf16`, timed on an
// H100 (700 W) by scripts/bench_k3_variants.py's bf16 variants, in turns at
// bucket 689's shapes (PERF.md):
//   * a bf16 conv's fragments are exact and need no split, so staging is a
//     copy: k * k16(C) * C bf16 a conv (24 KB at C = 64, 6 KB at 32, 1.5 KB
//     at 16, 0.75 KB at 8 with its input channels padded to 16), copied by
//     cp.async one conv ahead into the second of two buffers after B, so
//     that the copy runs under the current conv's MMAs and waits only at the
//     barrier between convs (mrf_bf16.cuh's StagedWeights). Staged at C >=
//     BF16_STAGE_MIN_C where the two buffers fit in half a block's share:
//     C = 64 only, 0.1246 ms against 0.1267 from L2 at [1, 88192, 64]. The
//     narrower widths read B from L2, where L1 holds their few KB: staged,
//     C = 32 took 0.0767 ms against 0.0747 and C = 16 0.0255 against
//     0.0245 (C = 8 within 1 %, 0.0225 against 0.0226). At C = 128 the two
//     buffers (192 KB) do not fit beside a tile: B from L2, as in K1;
//   * warps a block, BF16_WARPS_C64, _C32, _C16, _C8 (16 at C = 128): the
//     float32 kernel's 16 / 8 / 16 / 4 held on bf16 too. 8-warp blocks at
//     C = 64 took 0.1564 ms against 0.1246; at C = 32 16 warps took 0.0808
//     and 4 warps 0.0969 against 0.0769 with 8; at C = 16 8 warps 0.0265
//     against 0.0252 with 16; at C = 8 8 warps 0.0279 against 0.0222 with 4.
#include <cstdint>
#include <type_traits>

#include "mrf_bf16.cuh"

namespace {

constexpr int STAGE_MAX_C = 32;  // widths whose conv weights are staged in shared memory (float32)
constexpr int WARPS_C32 = 8;     // warps of a block at C = 32
constexpr int WARPS_C16 = 16;    // at C = 16
constexpr int WARPS_C8 = 4;      // at C = 8 (16 at C = 64, 128)
// bf16
constexpr int BF16_STAGE_MIN_C = 64;  // widths whose bf16 conv weights are staged (two buffers)
constexpr int BF16_WARPS_C64 = 16;    // warps of a bf16 block at C = 64
constexpr int BF16_WARPS_C32 = 8;     // at C = 32
constexpr int BF16_WARPS_C16 = 16;    // at C = 16
constexpr int BF16_WARPS_C8 = 4;      // at C = 8 (16 at C = 128)

// K3's layout at each instantiated width: warps a block, and whether the
// weights are staged (where they fit in half of a block's share), for the
// float32 kernel and for the bf16 one.
template <int C>
struct Layout {
  static_assert(C == 8 || C == 16 || C == 32 || C == 64 || C == 128,
                "K3 has no layout for this width");
  static constexpr int warps = C == 8 ? WARPS_C8 : C == 16 ? WARPS_C16 : C == 32 ? WARPS_C32 : 16;
  static constexpr bool stage = C <= STAGE_MAX_C;
  static constexpr int warps_bf16 = C == 8    ? BF16_WARPS_C8
                                    : C == 16 ? BF16_WARPS_C16
                                    : C == 32 ? BF16_WARPS_C32
                                    : C == 64 ? BF16_WARPS_C64
                                              : 16;
  static constexpr bool stage_bf16 = C >= BF16_STAGE_MIN_C;
};

template <class E>
using KernelFn = void (*)(const E*, E*, zv::MrfParamsT<E>, int, int, int);

// A conv's k taps of B fragments copied into shared memory, split once into
// {hi.x, hi.y, lo.x, lo.y} a lane-fragment; the barrier makes them visible.
template <int C, int NW>
struct Staged {
  uint4* ws;
  __device__ zv::tc::BShared operator()(const float* w, int k) const {
    const float2* src = reinterpret_cast<const float2*>(w);
    const int n = k * C * C / 2;
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += NW * 32) {
      const float2 v = __ldg(src + i);
      uint4 f;
      zv::tc::split(v.x, f.x, f.z);
      zv::tc::split(v.y, f.y, f.w);
      ws[i] = f;
    }
    __syncthreads();
    return zv::tc::BShared{ws};
  }
};

template <int C, int NW, bool STAGE, class E>
__global__ void __launch_bounds__(NW * 32, 16 / NW)
resblock_kernel(const E* __restrict__ x, E* __restrict__ out, zv::MrfParamsT<E> p, int T,
                int TT, int HW) {
  constexpr int LD = C + 4;
  extern __shared__ __align__(16) float smem[];
  const int W = TT + 2 * HW;
  float* A = smem;
  float* Bf = A + W * LD;
  const int b = blockIdx.y;
  const int tbase = blockIdx.x * TT - HW;
  const E* xb = x + (size_t)b * T * C;
  auto load = [&](int lo, int hi) {
    constexpr int C4 = C / 4;
    for (int idx = threadIdx.x; idx < (hi - lo) * C4; idx += NW * 32) {
      const int r = lo + idx / C4, c = (idx % C4) * 4;
      const int t = tbase + r;
      zv::at4(A + r * LD + c) = (unsigned)t < (unsigned)T
                                    ? zv::ldg4(xb + (size_t)t * C + c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // one tower: the output is the tower, no sums are kept
  const zv::tc::TileOut<E> o{out, nullptr, 0.f, nullptr};
  if constexpr (STAGE) {
    static_assert(std::is_same_v<E, float>, "only float32 weights are staged");
    zv::tc::mrf_tile<C, NW>(A, Bf, p, HW, TT, 0, tbase, T, (size_t)b * T, o, load,
                            Staged<C, NW>{reinterpret_cast<uint4*>(Bf + W * LD)});
  } else {
    zv::tc::mrf_tile<C, NW>(A, Bf, p, HW, TT, 0, tbase, T, (size_t)b * T, o, load);
  }
}

// The bf16 kernel (mrf_bf16.cuh): A of lda(C) floats a row, B of ldb(C)
// bf16, and, when STAGE, two buffers of one conv's fragments after B.
template <int C, int NW, bool STAGE>
__global__ void __launch_bounds__(NW * 32, 16 / NW)
resblock_kernel_bf16(const zv::bf16* __restrict__ x, zv::bf16* __restrict__ out,
                     zv::MrfParamsT<zv::bf16> p, int T, int TT, int HW) {
  constexpr int LA = zv::bf16x2::lda(C), LB = zv::bf16x2::ldb(C);
  extern __shared__ __align__(16) float smem[];
  const int W = TT + 2 * HW;
  float* A = smem;
  zv::bf16* Bs = reinterpret_cast<zv::bf16*>(A + W * LA);
  const int b = blockIdx.y;
  const int tbase = blockIdx.x * TT - HW;
  const zv::bf16* xb = x + (size_t)b * T * C;
  auto load = [&](int lo, int hi) {
    constexpr int C4 = C / 4;
    for (int idx = threadIdx.x; idx < (hi - lo) * C4; idx += NW * 32) {
      const int r = lo + idx / C4, c = (idx % C4) * 4;
      const int t = tbase + r;
      zv::at4(A + r * LA + c) = (unsigned)t < (unsigned)T
                                    ? zv::ldg4(xb + (size_t)t * C + c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  const zv::tc::TileOut<zv::bf16> o{out, nullptr, 0.f, nullptr};
  if constexpr (STAGE) {
    const int n = p.ks[0] * zv::bf16x2::k16(C) * C / 4;  // lane-fragments of a conv
    zv::bf16x2::mrf_tile<C, NW>(
        A, Bs, p, HW, TT, 0, tbase, T, (size_t)b * T, o, load,
        zv::bf16x2::StagedWeights<NW>{reinterpret_cast<uint2*>(Bs + W * LB), n});
  } else {
    zv::bf16x2::mrf_tile<C, NW>(A, Bs, p, HW, TT, 0, tbase, T, (size_t)b * T, o, load);
  }
}

template <class E>
struct Plan {
  KernelFn<E> kernel;
  int threads, TT, smem;
};

// The tile of one layout: blocks of NW warps, 16 / NW of them an SM, each
// with A and B over the window and, when STAGE, the staged weights: float32,
// two windows of C + 4 floats a row, one conv's split weights, the cost in
// k-steps of 8; bf16, rows of lda(C) floats and ldb(C) bf16, two buffers of
// one conv's fragments, the cost in k-steps of 16.
template <int C, int NW, bool STAGE, class E>
int plan_as(const zv::MrfParamsT<E>& p, int B, int T, Plan<E>* pl) {
  constexpr bool bf = std::is_same_v<E, zv::bf16>;
  constexpr int BPS = 16 / NW;
  constexpr long row_bytes =
      bf ? 4L * zv::bf16x2::lda(C) + 2L * zv::bf16x2::ldb(C) : 8L * (C + 4);
  const int HW = zv::mrf_halo(p);
  const long wbytes = !STAGE ? 0 : bf ? 2 * 2L * p.ks[0] * zv::bf16x2::k16(C) * C
                                      : 8L * p.ks[0] * C * C;
  int sms = 0;
  const int e = zv::tc::sm_count(&sms);
  if (e != 0) return e;
  if constexpr (bf)
    pl->kernel = resblock_kernel_bf16<C, NW, STAGE>;
  else
    pl->kernel = resblock_kernel<C, NW, STAGE, E>;
  pl->threads = NW * 32;
  pl->TT = zv::tc::choose_tile(
      T, B, sms * BPS, [&](int tt) { return row_bytes * (tt + 2 * HW) + wbytes; },
      [&](int tt) { return zv::tc::towers_cost(p, C, tt, 0, NW, bf ? 16 : 8); }, &pl->smem,
      (zv::SMEM_BUDGET + 1024L) / BPS - 1024);
  return pl->TT == 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

// The layout K3 takes at C (Layout<C>): weights staged where the layout says
// and they fit in half of a block's shared memory (float32: one conv split
// into hi and lo, 8 bytes a weight; bf16: two convs, 2 bytes a weight), else
// B from L2.
template <int C, class E>
int plan(const zv::MrfParamsT<E>& p, int B, int T, Plan<E>* pl) {
  constexpr bool bf = std::is_same_v<E, zv::bf16>;
  constexpr int NW = bf ? Layout<C>::warps_bf16 : Layout<C>::warps;
  if constexpr (bf ? Layout<C>::stage_bf16 : Layout<C>::stage) {
    const long budget = (zv::SMEM_BUDGET + 1024L) / (16 / NW) - 1024;
    const long staged = bf ? 2 * 2L * p.ks[0] * zv::bf16x2::k16(C) * C : 8L * p.ks[0] * C * C;
    if (2 * staged <= budget) return plan_as<C, NW, true>(p, B, T, pl);
  }
  return plan_as<C, NW, false>(p, B, T, pl);
}

template <class E>
int plan_for(int C, const zv::MrfParamsT<E>& p, int B, int T, Plan<E>* pl) {
  switch (C) {
    case 8: return plan<8>(p, B, T, pl);
    case 16: return plan<16>(p, B, T, pl);
    case 32: return plan<32>(p, B, T, pl);
    case 64: return plan<64>(p, B, T, pl);
    case 128: return plan<128>(p, B, T, pl);
    default: return (int)cudaErrorInvalidValue;
  }
}

int check_args(int B, int T, int k, int n_pairs) {
  return n_pairs < 1 || n_pairs > zv::MAX_PAIRS || k < 1 || k % 2 == 0 || B < 1 || T < 1
             ? (int)cudaErrorInvalidValue
             : 0;
}

template <class E>
int launch(const E* x, E* out, const E* w, const E* b, int B, int T, int C, int k, int n_pairs,
           int d0, int d1, int d2, void* stream) {
  if (int e = check_args(B, T, k, n_pairs)) return e;
  const zv::MrfParamsT<E> p{1, {k, 0, 0}, n_pairs, {d0, d1, d2}, w, b};
  Plan<E> pl{};
  int e = plan_for(C, p, B, T, &pl);
  if (e != 0) return e;
  e = (int)cudaFuncSetAttribute(pl.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (e != 0) return e;
  dim3 grid((T + pl.TT - 1) / pl.TT, B);
  pl.kernel<<<grid, pl.threads, pl.smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, p, T, pl.TT, zv::mrf_halo(p));
  return (int)cudaGetLastError();
}

template <class E>
int tile(int B, int T, int C, int k, int n_pairs, int d0, int d1, int d2) {
  if (int e = check_args(B, T, k, n_pairs)) return -e;
  const zv::MrfParamsT<E> p{1, {k, 0, 0}, n_pairs, {d0, d1, d2}, nullptr, nullptr};
  Plan<E> pl{};
  const int e = plan_for(C, p, B, T, &pl);
  return e != 0 ? -e : pl.TT;
}

}  // namespace

// x, out [B, T, C]; w: w1 [P][k] then w2 [P][k] conv taps in mma fragment
// order (mrf_tc.cuh); b: b1 [P][C] then b2 [P][C]; d0..d2: the P first-conv
// dilations. Returns a cudaError_t; C must be 8, 16, 32, 64 or 128, P 1-3, k odd.
extern "C" int zv_resblock1_f32(const float* x, float* out, const float* w, const float* b,
                                int B, int T, int C, int k, int n_pairs, int d0, int d1, int d2,
                                void* stream) {
  return launch(x, out, w, b, B, T, C, k, n_pairs, d0, d1, d2, stream);
}

// zv_resblock1_f32 on bf16 x, out, w and b, w in m16n8k16 fragment order
// (mrf_bf16.cuh, the same order of convs; 16-byte aligned).
extern "C" int zv_resblock1_bf16(const zv::bf16* x, zv::bf16* out, const zv::bf16* w,
                                 const zv::bf16* b, int B, int T, int C, int k, int n_pairs,
                                 int d0, int d1, int d2, void* stream) {
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  return launch(x, out, w, b, B, T, C, k, n_pairs, d0, d1, d2, stream);
}

// The time tile zv_resblock1_f32 takes for these arguments (rows), or minus
// a cudaError_t.
extern "C" int zv_resblock1_tile(int B, int T, int C, int k, int n_pairs, int d0, int d1, int d2) {
  return tile<float>(B, T, C, k, n_pairs, d0, d1, d2);
}

// The time tile zv_resblock1_bf16 takes, likewise.
extern "C" int zv_resblock1_bf16_tile(int B, int T, int C, int k, int n_pairs, int d0, int d1,
                                      int d2) {
  return tile<zv::bf16>(B, T, C, k, n_pairs, d0, d1, d2);
}
