// Fused speaker-encoder stage-1 conv pass for Hopper (sm_90a), forward and
// backward, float32 in and out, canonical NCHW layout with C = 32 channels,
// every product of the 3x3 conv on the tensor cores in 3xTF32; and the same
// pass on bfloat16 tensors (namespace bf, at the end) for bf16-mixed
// training, on bf16 tensor-core MMAs.
//
// Replaces the TPU kernels of zerovox_tpu/ops/pallas/se_fused.py::se_conv:
// _fwd_kernel (pallas_call in _fwd_call) and _bwd_kernel (pallas_call in
// _bwd_call). One pass of ResNetSE34V2 stage 1:
//
//   forward   u = x*s + t inside the image, 0 outside (padding in u-space:
//             the affine is applied first, then the SAME conv pads u with
//             zeros, so a t != 0 never leaks into the border)
//             y = relu?(conv3x3(u)); sum[c] = S y, sq[c] = S y^2 over
//             (b, h, w); m[b, c] = S y over (h, w)
//   backward  g  = (dy + dsum[c] + 2 y dsq[c] + dm[b, c]) * relu'(y)
//             du = conv3x3 of g with the flipped, transposed taps (dgrad)
//             dx = du*s; ds = S du*x; dt = S du; dW = S g (x) u_shifted
//
// What bounds it on an H100: operations. At the training shape
// [24, 32, 80, 500] the forward does 17.7 GFLOP against 246 MB (72 FLOP a
// byte, above the ~49 FLOP a byte where 3xTF32 at 495 TFLOP/s meets 3.35
// TB/s): 3 x 17.7 GFLOP / 495 TFLOP/s = 0.107 ms. The backward does twice
// the FLOPs against twice the bytes: 0.214 ms.
//
// Every conv is an implicit GEMM on mma.sync.m16n8k8 (tc_common.cuh):
//   forward, dgrad  M = a tile row's 32 positions, N = 32 output channels,
//                   K = 9 taps x 32 input channels (36 k-steps of 8);
//   wgrad           M = 32 output channels, N = 9 taps x 32 input channels,
//                   K = the tile's positions, the u window read at each
//                   tap's shift (+-1 along h and w). mma.sync is kept for
//                   that: a fragment load may start at any shared-memory
//                   position, which wgmma's swizzled layouts do not allow.
//
// Windows. A tile of TH x 32 output positions reads a (TH + 2) x 34 window
// of u (and, backward, of g) with a 1-pixel halo. The affine (and g's
// cotangent sum and relu mask) is applied on load and the value split once
// into TF32 hi and lo planes, so that the 9 taps that read each element do
// not split it again. The taps (w changes at every optimizer step, so
// nothing is packed on the host) are staged by each block's prologue into
// shared memory in fragment order, float32, and split at each k-step.
//
// Banks. The forward and dgrad A loads take 8 positions x 4 channels a
// fragment register, wgrad's loads 8 channels x 4 positions. Channel planes
// at a pitch of 8 mod 32 floats, with the planes of channels 4-7 (mod 8)
// shifted by 4 more, put both patterns on 32 distinct banks; no single
// pitch does (an odd pitch conflicts in both, 4 mod 8 in the first, 8 mod 32
// alone in the second).
//
// Sums. Forward: y written once; per-channel S y and S y^2 reduced from the
// accumulator fragments in a fixed order into one row per tile; a second
// pass sums each sample's rows (m), one block a sample, and a third the
// samples. Backward: one persistent block per SM walks its tiles; wgrad's
// MMA chains span one tile's positions and are then added into float32
// registers, ds and dt are float32 sums in the dgrad epilogue, and each
// block writes one partial row that a second pass sums in a fixed order.
// No float atomics: every run gives the same bits.
//
// Tiles: 8 x 32 positions, one warp a row, one block of 8 warps an SM. A
// window arrives by cp.async straight into shared memory (4 bytes a copy,
// zero-filled outside the image), all of a tile's copies in flight at once,
// and is converted and split in place. Forward (173 KB): the next tile's x
// arrives in a third plane while this tile's MMAs run, and y leaves through
// shared memory as rows of 32 positions. Backward (219 KB: the taps and the
// g and u windows in hi and lo) has no room to fetch ahead. Each choice was
// timed on an H100 at [24, 32, 80, 500] against its alternative: windows
// loaded through registers (latency-bound), 4-row tiles at
// 2 blocks an SM, y stored from the fragments, and a warp-per-window-row
// walk were all slower. scripts/bench_k4_breakdown.py times the MMA phases
// against the window loads and epilogues (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_common.cuh"

namespace {

using zv::tc::mma;
using zv::tc::split;

constexpr int C = 32;
constexpr int TW = 32;                   // tile columns: one warp row
constexpr int NTAP = C * C * 9;          // 9216 weights
constexpr int NPART = NTAP + 2 * C;      // per-block backward partial: dW, ds, dt
constexpr int TH = 8;                    // tile rows: one warp each

// A tile's window: (TH + 2) x (TW + 2) positions, one plane per channel at
// pitch PL (8 mod 32, room for the 4-float shift of channels 4-7 mod 8).
struct Win {
  static constexpr int HR = TH + 2, WR = TW + 2, NPOS = HR * WR;
  static constexpr int PL = (NPOS + 4 - 8 + 31) / 32 * 32 + 8;
  static constexpr int FLOATS = C * PL;
  static_assert(PL % 32 == 8 && PL >= NPOS + 4, "plane pitch");
};

__device__ __forceinline__ int chan(int c) {
  return c * Win::PL + 4 * ((c >> 2) & 1);
}

struct Shape {
  int B, H, W, nth, ntw, ntiles;
};

Shape make_shape(int B, int H, int W) {
  Shape sh;
  sh.B = B;
  sh.H = H;
  sh.W = W;
  sh.nth = (H + TH - 1) / TH;
  sh.ntw = (W + TW - 1) / TW;
  sh.ntiles = B * sh.nth * sh.ntw;
  return sh;
}

__device__ inline void tile_origin(const Shape& sh, int i, int* b, int* h0, int* w0) {
  *w0 = (i % sh.ntw) * TW;
  i /= sh.ntw;
  *h0 = (i % sh.nth) * TH;
  *b = i / sh.nth;
}

// f(c, s, in, o) for every position of a tile's window: channel c, offset s
// in the planes, whether it lies in the image, and then its global offset
// o. Thread k of the block's TH warps takes positions k, k + 32 TH, ..., so
// it always visits the same positions of a window.
template <class F>
__device__ __forceinline__ void for_window(const Shape& sh, int b, int h0, int w0, F f) {
  for (int i = threadIdx.x; i < C * Win::NPOS; i += TH * 32) {
    const int c = i / Win::NPOS, p = i - c * Win::NPOS;
    const int r = p / Win::WR, col = p - r * Win::WR;
    const int h = h0 + r - 1, w = w0 + col - 1;
    const bool in = (unsigned)h < (unsigned)sh.H && (unsigned)w < (unsigned)sh.W;
    f(c, chan(c) + p, in, in ? (((size_t)b * C + c) * sh.H + h) * sh.W + w : 0);
  }
}

// One float from global into shared memory without a register round trip
// (cp.async); zero-filled, and src not read, when !valid.
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void store_split(float* hi, float* lo, int s, float v) {
  uint32_t h, l;
  split(v, h, l);
  hi[s] = __uint_as_float(h);
  lo[s] = __uint_as_float(l);
}

// The taps in fragment order: for tap t, k-step ks (8 k channels) and n
// block nf (8 n channels), 64 floats in which lane l holds B[8 ks + l%4]
// [8 nf + l/4] and B[8 ks + l%4 + 4][8 nf + l/4] side by side. Forward:
// B[t][k = ci][n = co] = w[co][ci][t]. dgrad (flip): B[t][k = co][n = ci] =
// w[co][ci][8 - t].
__device__ void stage_taps(float* Bs, const float* __restrict__ w, bool dgrad) {
  for (int i = threadIdx.x; i < NTAP; i += blockDim.x) {  // w[co][ci][kh][kw]
    const int co = i / (C * 9), ci = (i / 9) % C, t = i % 9;
    const int k = dgrad ? co : ci, n = dgrad ? ci : co, tap = dgrad ? 8 - t : t;
    const int lane = (n % 8) * 4 + k % 4;
    Bs[((tap * 4 + k / 8) * 4 + n / 8) * 64 + 2 * lane + (k % 8) / 4] = __ldg(w + i);
  }
}

// acc[mf][nf][e] (fragment layout of mma) = the 3x3 conv at tile row r,
// positions 0-31, output channels 0-31: the sum over taps (kh, kw) and
// input channels ci of A[ci][(r + kh) WR + pos + kw] B[tap][ci][co], A split
// in the planes Ah, Al, B float32 in fragment order (Bs). The tensor cores
// truncate as they add into an accumulator, so the hi.hi chain spans one
// tap (4 MMAs) and is then added into acc in float32; the lo products,
// 2^-11 of the sum, keep their own chain over all taps. One chain over all
// 108 MMAs left y 1.76e-5 from plain at the training shape, this 5.2e-6.
__device__ __forceinline__ void conv_row(const float* Ah, const float* Al, const float* Bs, int r,
                                         float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float lo[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = lo[i][j][e] = 0.f;
  const float2* bf = reinterpret_cast<const float2*>(Bs) + lane;
  const int c0 = chan(t4), c1 = chan(t4 + 4);  // k channels t4, t4 + 4 of a k-step
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int kh = tap / 3, kw = tap - 3 * kh;
    const int p = (r + kh) * Win::WR + kw + g;
    float hi[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hi[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const float2 v = bf[((tap * 4 + ks) * 4 + nf) * 32];
        split(v.x, bh[nf][0], bl[nf][0]);
        split(v.y, bh[nf][1], bl[nf][1]);
      }
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        const int q = ks * 8 * Win::PL + p + 16 * mf;
        const uint32_t ah[4] = {__float_as_uint(Ah[q + c0]), __float_as_uint(Ah[q + c0 + 8]),
                                __float_as_uint(Ah[q + c1]), __float_as_uint(Ah[q + c1 + 8])};
        const uint32_t al[4] = {__float_as_uint(Al[q + c0]), __float_as_uint(Al[q + c0 + 8]),
                                __float_as_uint(Al[q + c1]), __float_as_uint(Al[q + c1 + 8])};
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {
          mma(lo[mf][nf], al, bh[nf]);
          mma(lo[mf][nf], ah, bl[nf]);
          mma(hi[mf][nf], ah, bh[nf]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += hi[i][j][e];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += lo[i][j][e];
}

// Sum over the 8 lanes that share lane % 4 (the fragment rows g).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------------ forward

__global__ void __launch_bounds__(TH * 32, 1)
se_conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ s, const float* __restrict__ t,
                   float* __restrict__ y, float* __restrict__ part, Shape sh, int relu) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;               // taps in fragment order
  float* Uh = Bs + NTAP;          // u window, hi and lo planes
  float* Ul = Uh + Win::FLOATS;
  float* Xs = Ul + Win::FLOATS;   // the next tile's x window, arriving
  float* red = Xs + Win::FLOATS;  // [warp][sum, sq][C]
  float* prm = red + 2 * TH * C;  // s, t
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  auto fetch = [&](int tile) {  // x into Xs, 0 outside the image
    int b, h0, w0;
    tile_origin(sh, tile, &b, &h0, &w0);
    for_window(sh, b, h0, w0, [&](int, int q, bool in, size_t o) {
      copy_async(Xs + q, x + o, in);
    });
  };
  if (blockIdx.x < sh.ntiles) fetch(blockIdx.x);
  stage_taps(Bs, w, false);
  if (threadIdx.x < 2 * C)
    prm[threadIdx.x] = __ldg(threadIdx.x < C ? s + threadIdx.x : t + threadIdx.x - C);

  for (int tile = blockIdx.x; tile < sh.ntiles; tile += gridDim.x) {
    int b, h0, w0;
    tile_origin(sh, tile, &b, &h0, &w0);
    copy_wait();
    __syncthreads();  // Xs has arrived; the previous tile is done with U and red
    // u = x s + t inside the image, split into the planes; then the next
    // tile's x is fetched during this tile's MMAs
    for_window(sh, b, h0, w0, [&](int c, int q, bool in, size_t) {
      store_split(Uh, Ul, q, in ? Xs[q] * prm[c] + prm[C + c] : 0.f);
    });
    __syncthreads();
    if (tile + gridDim.x < sh.ntiles) fetch(tile + gridDim.x);

    float acc[2][4][4];
    conv_row(Uh, Ul, Bs, warp, acc);

    // per-channel S y, S y^2 of this row from the fragments, co = 8 nf +
    // 2 t4 + e; y through shared memory ([co][pos], pitch 36: conflict-free
    // both ways), then out as 32 rows of 32 positions
    __syncthreads();  // every warp is done with the planes
    float* Ys = Uh + warp * 32 * 36;
    const int h = h0 + warp;
    float s1[4][2], s2[4][2];
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 2; ++e) s1[nf][e] = s2[nf][e] = 0.f;
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pos = 16 * mf + g + 8 * hh;
        const bool ok = h < sh.H && w0 + pos < sh.W;
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = 8 * nf + 2 * t4 + e;
            float v = acc[mf][nf][2 * hh + e];
            if (relu) v = fmaxf(v, 0.f);
            Ys[co * 36 + pos] = v;
            if (ok) {
              s1[nf][e] += v;
              s2[nf][e] = fmaf(v, v, s2[nf][e]);
            }
          }
      }
    __syncwarp();
    if (h < sh.H && w0 + lane < sh.W) {
      float* yo = y + ((size_t)b * C * sh.H + h) * sh.W + w0 + lane;
#pragma unroll 8
      for (int co = 0; co < C; ++co) yo[(size_t)co * sh.H * sh.W] = Ys[co * 36 + lane];
    }
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s1[nf][e] = row_sum(s1[nf][e]);
        s2[nf][e] = row_sum(s2[nf][e]);
        if (g == 0) {
          red[(warp * 2 + 0) * C + 8 * nf + 2 * t4 + e] = s1[nf][e];
          red[(warp * 2 + 1) * C + 8 * nf + 2 * t4 + e] = s2[nf][e];
        }
      }
    __syncthreads();
    if (threadIdx.x < 2 * C) {  // row [tile]: C sums, then C sums of squares
      float a = 0.f;
      for (int k = 0; k < TH; ++k) a += red[k * 2 * C + threadIdx.x];
      part[(size_t)tile * 2 * C + threadIdx.x] = a;
    }
  }
}

// One block per sample b, of 32 channels x 32 slices: m[b, c] = the sum of
// sample b's tile rows, and their S y^2 likewise, each in a fixed order;
// both also go to the sample's first row for se_conv_fwd_total.
__global__ void se_conv_fwd_sample(float* __restrict__ part, float* __restrict__ m,
                                   int tiles_per_sample) {
  __shared__ float r1[32][C], r2[32][C];
  const int c = threadIdx.x, sl = threadIdx.y;
  float* rows = part + (size_t)blockIdx.x * tiles_per_sample * 2 * C;
  float a1 = 0.f, a2 = 0.f;
  for (int j = sl; j < tiles_per_sample; j += 32) {
    a1 += rows[(size_t)j * 2 * C + c];
    a2 += rows[(size_t)j * 2 * C + C + c];
  }
  r1[sl][c] = a1;
  r2[sl][c] = a2;
  __syncthreads();  // every read of the rows is done
  if (sl == 0) {
    float m1 = 0.f, m2 = 0.f;
    for (int k = 0; k < 32; ++k) {
      m1 += r1[k][c];
      m2 += r2[k][c];
    }
    m[(size_t)blockIdx.x * C + c] = m1;
    rows[c] = m1;
    rows[C + c] = m2;
  }
}

// sum[c] = S_b m[b, c] and sq[c] likewise, in sample order (2C threads).
__global__ void se_conv_fwd_total(const float* __restrict__ part, float* __restrict__ ssum,
                                  float* __restrict__ ssq, int B, int tiles_per_sample) {
  const int i = threadIdx.x;
  float a = 0.f;
  for (int b = 0; b < B; ++b) a += part[(size_t)b * tiles_per_sample * 2 * C + i];
  if (i < C)
    ssum[i] = a;
  else
    ssq[i - C] = a;
}

// ----------------------------------------------------------------- backward

__global__ void __launch_bounds__(TH * 32, 1)
se_conv_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ dy, const float* __restrict__ w,
                   const float* __restrict__ s, const float* __restrict__ t,
                   const float* __restrict__ dsum, const float* __restrict__ dsq,
                   const float* __restrict__ dm, float* __restrict__ dx,
                   float* __restrict__ part, Shape sh, int relu) {
  static_assert(TH == 8, "wgrad gives each of 8 warps one tap and an eighth of tap 8");
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;              // dgrad taps in fragment order
  float* Gh = Bs + NTAP;         // g window, hi and lo planes
  float* Gl = Gh + Win::FLOATS;
  float* Uh = Gl + Win::FLOATS;   // u window, hi and lo planes
  float* Ul = Uh + Win::FLOATS;
  float* red = Ul + Win::FLOATS;  // [warp][ds, dt][C]
  float* prm = red + 2 * TH * C;  // s, t, dsum, dsq
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  stage_taps(Bs, w, true);
  if (threadIdx.x < 4 * C) {
    const int k = threadIdx.x / C, c = threadIdx.x % C;
    prm[threadIdx.x] = __ldg((k == 0 ? s : k == 1 ? t : k == 2 ? dsum : dsq) + c);
  }

  // wgrad: this warp owns dW[co][ci] of tap `warp` (fragments f < 8: m
  // block f / 4, n block f % 4) and of tap 8 (f = 8: m block warp / 4, n
  // block warp % 4); co = 16 mb + g (+8), ci = 8 nb + 2 t4 (+1)
  float dw[9][4];
#pragma unroll
  for (int f = 0; f < 9; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) dw[f][e] = 0.f;
  // ds, dt of input channels 8 nf + 2 t4 + e over this thread's positions
  float dsa[4][2], dta[4][2];
#pragma unroll
  for (int nf = 0; nf < 4; ++nf)
#pragma unroll
    for (int e = 0; e < 2; ++e) dsa[nf][e] = dta[nf][e] = 0.f;
  const int kh = warp / 3, kw = warp % 3;
  const int mb8 = warp >> 2, nb8 = warp & 3;

  for (int tile = blockIdx.x; tile < sh.ntiles; tile += gridDim.x) {
    int b, h0, w0;
    tile_origin(sh, tile, &b, &h0, &w0);
    __syncthreads();
    // y, dy and x into the Gh, Gl and Ul planes (0 outside the image), every
    // copy in flight at once; then each thread turns the positions it copied
    // into g and u, split in place
    for_window(sh, b, h0, w0, [&](int, int q, bool in, size_t o) {
      copy_async(Gh + q, y + o, in);
      copy_async(Gl + q, dy + o, in);
      copy_async(Ul + q, x + o, in);
    });
    copy_wait();
    const float* dmb = dm + (size_t)b * C;
    for_window(sh, b, h0, w0, [&](int c, int q, bool in, size_t) {
      float gv = 0.f, u = 0.f;
      if (in) {
        const float yv = Gh[q];
        gv = Gl[q] + prm[2 * C + c] + 2.f * yv * prm[3 * C + c] + __ldg(dmb + c);
        if (relu && !(yv > 0.f)) gv = 0.f;
        u = Ul[q] * prm[c] + prm[C + c];
      }
      store_split(Gh, Gl, q, gv);
      store_split(Uh, Ul, q, u);
    });
    __syncthreads();

    // dgrad: du at tile row `warp` for input channels 8 nf + 2 t4 + e
    {
      float acc[2][4][4];
      conv_row(Gh, Gl, Bs, warp, acc);
      const int h = h0 + warp;
      if (h < sh.H) {
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int col = w0 + 16 * mf + g + 8 * hh;
            if (col >= sh.W) continue;
#pragma unroll
            for (int nf = 0; nf < 4; ++nf)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int ci = 8 * nf + 2 * t4 + e;
                const size_t o = (((size_t)b * C + ci) * sh.H + h) * sh.W + col;
                const float du = acc[mf][nf][2 * hh + e];
                dx[o] = du * prm[ci];
                dsa[nf][e] = fmaf(du, __ldg(x + o), dsa[nf][e]);
                dta[nf][e] += du;
              }
          }
      }
    }

    // wgrad over the tile's positions, 8 a k-step (row r, columns 8 cb..):
    // A[co][pos] = g at the position, B[pos][ci] = u at the position + the
    // tap's shift. g is 0 outside the image, so those positions add 0.
    {
      float acc[9][4];
#pragma unroll
      for (int f = 0; f < 9; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
      const int ga = chan(g), gb = chan(g + 8);  // co = g, g + 8 of an m block
      const int ub = chan(g);                          // ci = g of an n block
#pragma unroll 1
      for (int kstep = 0; kstep < TH * 4; ++kstep) {
        const int r = kstep >> 2, c8 = (kstep & 3) * 8 + t4;
        const int pg = (r + 1) * Win::WR + c8 + 1;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          const int q = 16 * mf * Win::PL + pg;
          const int o[4] = {q + ga, q + gb, q + ga + 4, q + gb + 4};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[mf][e] = __float_as_uint(Gh[o[e]]);
            al[mf][e] = __float_as_uint(Gl[o[e]]);
          }
        }
        const int pu = (r + kh) * Win::WR + c8 + kw;
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {
          const int q = 8 * nf * Win::PL + pu + ub;
          const uint32_t bh[2] = {__float_as_uint(Uh[q]), __float_as_uint(Uh[q + 4])};
          const uint32_t bl[2] = {__float_as_uint(Ul[q]), __float_as_uint(Ul[q + 4])};
#pragma unroll
          for (int mf = 0; mf < 2; ++mf) {
            mma(acc[4 * mf + nf], al[mf], bh);
            mma(acc[4 * mf + nf], ah[mf], bl);
            mma(acc[4 * mf + nf], ah[mf], bh);
          }
        }
        {  // tap 8 (kh = kw = 2), this warp's fragment
          const int q = 8 * nb8 * Win::PL + (r + 2) * Win::WR + c8 + 2 + ub;
          const uint32_t bh[2] = {__float_as_uint(Uh[q]), __float_as_uint(Uh[q + 4])};
          const uint32_t bl[2] = {__float_as_uint(Ul[q]), __float_as_uint(Ul[q + 4])};
          uint32_t a8h[4], a8l[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a8h[e] = mb8 ? ah[1][e] : ah[0][e];
            a8l[e] = mb8 ? al[1][e] : al[0][e];
          }
          mma(acc[8], a8l, bh);
          mma(acc[8], a8h, bl);
          mma(acc[8], a8h, bh);
        }
      }
#pragma unroll
      for (int f = 0; f < 9; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) dw[f][e] += acc[f][e];
    }
  }

  // this block's partial row: dW in w's layout [co][ci][kh][kw], then ds, dt
  float* row = part + (size_t)blockIdx.x * NPART;
#pragma unroll
  for (int f = 0; f < 9; ++f) {
    const int tap = f < 8 ? warp : 8;
    const int mb = f < 8 ? f >> 2 : mb8, nb = f < 8 ? f & 3 : nb8;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int co = 16 * mb + g + 8 * (e >> 1), ci = 8 * nb + 2 * t4 + (e & 1);
      row[(co * C + ci) * 9 + tap] = dw[f][e];
    }
  }
#pragma unroll
  for (int nf = 0; nf < 4; ++nf)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dsa[nf][e] = row_sum(dsa[nf][e]);
      dta[nf][e] = row_sum(dta[nf][e]);
      if (g == 0) {
        red[(warp * 2 + 0) * C + 8 * nf + 2 * t4 + e] = dsa[nf][e];
        red[(warp * 2 + 1) * C + 8 * nf + 2 * t4 + e] = dta[nf][e];
      }
    }
  __syncthreads();
  if (threadIdx.x < 2 * C) {
    float a = 0.f;
    for (int k = 0; k < TH; ++k) a += red[k * 2 * C + threadIdx.x];
    row[NTAP + threadIdx.x] = a;
  }
}

// out[i] = S over blocks of part[blk][i]: 8 slices of the blocks, each
// summed in block order, then the slices in order; 32 outputs a block.
__global__ void se_conv_bwd_finish(const float* __restrict__ part, float* __restrict__ out,
                                   int nblocks) {
  __shared__ float r[8][32];
  const int i = blockIdx.x * 32 + threadIdx.x, sl = threadIdx.y;
  float a = 0.f;
  if (i < NPART)
    for (int k = sl; k < nblocks; k += 8) a += part[(size_t)k * NPART + i];
  r[sl][threadIdx.x] = a;
  __syncthreads();
  if (sl == 0 && i < NPART) {
    float tot = 0.f;
    for (int k = 0; k < 8; ++k) tot += r[k][threadIdx.x];
    out[i] = tot;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

constexpr size_t FWD_SMEM =
    (size_t)(NTAP + 3 * Win::FLOATS + 2 * TH * C + 2 * C) * sizeof(float);
constexpr size_t BWD_SMEM =
    (size_t)(NTAP + 4 * Win::FLOATS + 2 * TH * C + 4 * C) * sizeof(float);
static_assert(FWD_SMEM <= 227 * 1024, "forward shared memory");
static_assert(TH * 32 * 36 <= Win::FLOATS, "y staging fits the hi planes");
static_assert(BWD_SMEM <= 227 * 1024, "backward shared memory");

// ------------------------------------------------------------ bfloat16 pass
//
// The same pass on bf16 x, w, y, dy and dx (the bf16-mixed train step), with
// the JAX kernel's rounding points: u = bf16(x s + t) from float32 s and t;
// y accumulated in float32 and stored as bf16, its sums taken from the
// float32 y before rounding; backward g = bf16((dy + dsum + 2 y dsq + dm)
// relu'(y)) from the bf16 y, du and dW accumulated in float32, dx =
// bf16(du s), ds = S du x and dt = S du in float32.
//
// What bounds it on an H100: bytes from device memory, then shared memory.
// Products run on mma.sync.m16n8k16 with bf16 operands and float32
// accumulators. At [24, 32, 80, 500] the forward's 17.7 GFLOP take 0.018 ms
// at 989 TFLOP/s against 0.037 ms for its 123 MB (x in, y out) at 3.35 TB/s;
// the backward 0.036 against 0.073 ms (x, y, dy in, dx out). But a tile
// moves ~400 KB through shared memory forward (its raw window in, the
// conversion's reads and writes, 256 bytes of fragments an MMA, y staged)
// and ~830 KB backward, at 128 bytes a clock an SM: ~0.05 and ~0.11 ms.
//
// Windows loaded one 2-byte element a thread, with nothing in flight during
// the MMAs, kept 88 % (forward) and 63 % (backward) of a kernel's time
// without its MMAs (the 0.221 and 0.555 ms below). So:
//
// Fetch ahead. Each block walks tiles of TH x TW = 8 x 32 outputs. A tile's
// raw window (each channel's 10 rows x 34 columns: a 1-pixel halo) arrives
// by 16-byte cp.async.cg in a staging buffer, each row as the 16-byte chunks
// from the one holding its first column, aligned down (at most six: W and
// the tensor's base give a row any 2-byte alignment, so TMA's tensor maps,
// which need 16-byte strides, cannot describe it). A chunk is copied when it
// holds a byte of the row's image columns, so it lies in the tensor; the
// others are never read unmasked. The forward fetches tile i + 1 while tile
// i's MMAs run, two blocks an SM; the backward fetches the next tile's x, y
// and dy the same way, x into a second slot, since the ds epilogue reads
// this tile's x from its staging.
//
// Convert in shared memory. One pass turns the raw staging into the
// position-major windows (a position's 32 channels at a pitch of PB = 40
// bf16: eight consecutive positions on eight distinct 16-byte bank groups,
// so every fragment is one ldmatrix). Lane 2 c' + hs of a warp takes
// channels 2 c', 2 c' + 1 and four columns from 8 q + 4 hs of a window row.
// It reads each channel's four as two aligned 8-byte words, picked and
// shifted by the row's offset in its chunk without branches: 32 distinct
// banks across a half-warp (a channel pair's rows RAW_PAIR = 484 words
// apart, 4 mod 32; hs 2 banks on). It writes them as four 4-byte channel
// pairs: 32 distinct banks across the warp (pair c' at bank c', four columns
// on at c' + 16; 20 words a position). A lane takes a channel pair because a
// position's channels are what the window holds contiguously: one channel
// a lane would write 2 bytes a store. Each warp has two cells in flight.
//
// The MMAs keep one order whatever the tiling: conv_row's tap and k order
// for the forward and dgrad, wgrad's k-loop with one tap a warp (its
// fragments loaded a k-step ahead; tap 8's A picked a register at a time, as
// an array picked whole would live in local memory). So y, the forward's
// sums and m (one partial row a tile) and dx do not depend on the grid; dW,
// ds and dt sum per-block partials, which do.
//
// Stores. y and dx leave through shared memory, a row of [C][PY] a warp,
// each channel's positions placed at their global address's offset in a
// 16-byte chunk, in aligned 8-byte pieces, eight lanes a channel row (2-byte
// stores at an end a row covers in part). y leaves during the next tile's
// MMAs, dx during wgrad's.
//
// Timed on an H100 at [24, 32, 80, 500] (scripts/bench_k4_breakdown.py, in
// turns, PERF.md): forward 0.134 ms, backward 0.308 (windows loaded an
// element a thread: 0.221 and 0.555). Against them: two raw windows staged
// a block, so one block an SM, 0.167 forward; one window, one block an SM,
// 0.170; y and dx in 2-, 4- and 16-byte pieces (32, 16 and 4 lanes a
// channel row), 0.167, 0.150 and 0.160 forward, 0.336, 0.333 and 0.348
// backward. Taken out one at a time:
// the forward's MMAs 0.047 ms, its conversion 0.028, its stores 0.019, its
// fetch 0.016; the backward's conversion 0.080, its fetch 0.054, dgrad's MMAs
// 0.047, wgrad's 0.040, its stores 0.025.

namespace bf {

constexpr int PB = 40;                    // window pitch, bf16 a position
constexpr int WIN = Win::NPOS * PB;       // bf16 of one window
constexpr int TAPS = NTAP;                // bf16 of the staged taps
constexpr int PY = 40;                    // output staging pitch, bf16 a channel row
constexpr int NQ = (Win::WR + 7) / 8;     // 8-column groups of a window row
constexpr int RAW_ROW = 96;               // bytes of a raw window row: six 16-byte chunks
constexpr int RAW_PAIR = Win::HR * 2 * RAW_ROW + 16;  // a channel pair's rows, 484 words
constexpr int RAW = C / 2 * RAW_PAIR;     // bytes of one raw window
constexpr int FWD_STAGES = 1;             // raw windows in a forward block's ring
constexpr int FWD_BLOCKS = 2;             // forward blocks an SM, at most
constexpr int STORE_P = 4;                // y and dx leave in pieces of STORE_P bf16
constexpr int OUT = TH * C * PY;          // bf16 of a tile's output staging
static_assert(PY >= 7 + TW && PY % 8 == 0, "a staged row holds 32 positions at any chunk offset");
static_assert((7 + Win::WR - 1) / 4 * 4 + 8 <= RAW_ROW / 2, "raw reads stay in the row");
static_assert(RAW_PAIR / 4 % 32 == 4 && RAW % 16 == 0, "raw staging banks and alignment");
static_assert((TAPS * 2) % 16 == 0 && (WIN * 2) % 16 == 0 && (PB * 2) % 16 == 0,
              "ldmatrix rows are 16-byte aligned");

using zv::tc::ldsm_x4;
using zv::tc::mma16;
using zv::tc::smem_u32;

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// 16 bytes from global into shared memory, not through registers.
__device__ __forceinline__ void cp16(void* dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of raw window row (c, r) in a staging buffer: a channel pair's
// rows interleaved, RAW_PAIR bytes a pair.
__device__ __forceinline__ int raw_row(int c, int r) {
  return (c >> 1) * RAW_PAIR + (2 * r + (c & 1)) * RAW_ROW;
}

// Element index of row (b, c = 0, h), column w; the low bits of every
// address, which is all the chunk offsets need, survive 32-bit wrap.
__device__ __forceinline__ unsigned elem_at(const Shape& sh, int b, int h, int w) {
  return ((unsigned)b * C * sh.H + h) * sh.W + w;
}

// The raw window of tile (b, h0, w0) of an NCHW bf16 tensor at base into a
// staging buffer (raw_row's layout). Thread 8 c + k takes chunk k of
// channel c's rows, stepping a row by the row's bytes: byte 0 is window
// column 0 (image column w0 - 1) of the row, the chunk starts 16 k - lead
// from it (lead: that byte's offset in its 16-byte chunk), and it is copied
// when it overlaps the window's image columns, bytes [blo, bhi).
__device__ __forceinline__ void fetch(unsigned char* raw, uintptr_t base, const Shape& sh, int b,
                                      int h0, int w0) {
  static_assert(TH * 32 == C * 8, "a thread a channel and chunk");
  const int c = threadIdx.x >> 3, k = threadIdx.x & 7;
  uintptr_t first =
      base + 2 * ((((long long)b * C + c) * sh.H + h0 - 1) * (long long)sh.W + w0 - 1);
  const int blo = max(0, 2 - 2 * w0), bhi = min(2 * Win::WR, 2 * (sh.W - w0 + 1));
  unsigned char* dst = raw + raw_row(c, 0) + 16 * k;
#pragma unroll 2
  for (int r = 0; r < Win::HR; ++r, first += 2 * (uintptr_t)sh.W, dst += 2 * RAW_ROW) {
    const int d = 16 * k - (int)(first & 15);
    if ((unsigned)(h0 + r - 1) < (unsigned)sh.H && d < bhi && d + 16 > blo)
      cp16(dst, (first & ~(uintptr_t)15) + 16 * k);
  }
}

// Four bf16 of a raw row from element o on, as two bf16 pairs (element j in
// half j % 2 of word j / 2): two aligned 8-byte reads, the words picked by
// o's offset and a byte permute, without branches.
__device__ __forceinline__ uint2 raw4(const unsigned char* row, int o) {
  const int a = o & ~3, sft = o & 3;
  const uint2 p = *reinterpret_cast<const uint2*>(row + 2 * a);
  const uint2 q = *reinterpret_cast<const uint2*>(row + 2 * a + 8);
  const uint32_t w0 = sft & 2 ? p.y : p.x, w1 = sft & 2 ? q.x : p.y, w2 = sft & 2 ? q.y : q.x;
  const uint32_t sel = sft & 1 ? 0x5432u : 0x3210u;
  return make_uint2(__byte_perm(w0, w1, sel), __byte_perm(w1, w2, sel));
}

// Element j of raw4's four, as float (exact).
__device__ __forceinline__ float elem(const uint2& v, int j) {
  const uint32_t w = j < 2 ? v.x : v.y;
  return __uint_as_float(j & 1 ? w & 0xffff0000u : w << 16);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A conversion cell's raw values, channels 2 c' and 2 c' + 1: x (forward),
// or x, y and dy (backward).
struct Raw2 {
  uint2 c[2];
};
struct Raw6 {
  uint2 x[2], y[2], d[2];
};

// The conversion of this warp's share of the window: cells (r, col0) of
// window row r, columns col0..col0 + 3 of this lane (2 c' + hs: col0 = 8 q +
// 4 hs), every row and q once a block; load(r, col0) reads a cell's raw
// values, store(r, col0, v) writes its converted ones. Two cells at a time,
// both loads first, so that the second's reads overlap the first's math.
template <class L, class S>
__device__ __forceinline__ void for_cells(L load, S store) {
  constexpr int N = Win::HR * NQ;
  const int warp = threadIdx.x >> 5, hs = threadIdx.x & 1;
  for (int it = warp; it < N; it += 2 * TH) {
    const int it1 = it + TH < N ? it + TH : it;  // the second cell, or the first again
    const int r0 = it / NQ, c0 = (it - NQ * r0) * 8 + 4 * hs;
    const int r1 = it1 / NQ, c1 = (it1 - NQ * r1) * 8 + 4 * hs;
    const auto v0 = load(r0, c0);  // a column group past the window reads inside the row
    const auto v1 = load(r1, c1);
    if (c0 < Win::WR) store(r0, c0, v0);
    if (it1 != it && c1 < Win::WR) store(r1, c1, v1);
  }
}

// Whether all four columns of a cell (image row h, columns w..w + 3; window
// columns col0..) lie in the image and in the window.
__device__ __forceinline__ bool cell_inside(int h, int w, int col0, const Shape& sh) {
  return (unsigned)h < (unsigned)sh.H && w >= 0 && w + 3 < sh.W && col0 + 3 < Win::WR;
}

// u = bf16(x s + t), rounded after the multiply and after the add as the
// plain version computes it.
__device__ __forceinline__ float affine(float x, float s, float t) {
  return __fadd_rn(__fmul_rn(x, s), t);
}

// g before its rounding: (dy + dsum + 2 y dsq + dm) relu'(y), in the plain
// version's order of adds.
__device__ __forceinline__ float cotangent(float dy, float y, float dsum, float dsq, float dm,
                                          int relu) {
  const float g = __fadd_rn(__fadd_rn(__fadd_rn(dy, dsum), __fmul_rn(__fmul_rn(2.f, y), dsq)), dm);
  return relu && !(y > 0.f) ? 0.f : g;
}

// P bf16 from shared memory (aligned to 2P bytes) to global memory in one
// store.
template <int P>
__device__ __forceinline__ void store_piece(__nv_bfloat16* d, const __nv_bfloat16* s) {
  if constexpr (P == 8)
    *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
  else if constexpr (P == 4)
    *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
  else if constexpr (P == 2)
    *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
  else
    *d = *s;
}

// A warp's staged output row out: channel co's n positions, staged in S from
// (e0 + co hw) & 7 on (the offset of dst + co stride in its 16-byte chunk),
// to dst + co stride. The row leaves in pieces of P aligned bf16, TW / P
// lanes a channel, one store a piece that the row covers whole and 2-byte
// stores at a partly covered end.
template <int P>
__device__ __forceinline__ void store_rows(const __nv_bfloat16* S, __nv_bfloat16* dst,
                                           unsigned e0, unsigned hw, size_t stride, int n) {
  constexpr int L = TW / P;  // lanes a channel row
  const int lane = threadIdx.x & 31, q = lane % L;
  for (int co = lane / L; co < C; co += 32 / L) {
    const int off = (int)((e0 + co * hw) & 7u);
    const __nv_bfloat16* src = S + co * PY;
    __nv_bfloat16* d = dst + co * stride - off;
    if (n == TW && (off & (P - 1)) == 0) {  // L whole pieces, one a lane
      store_piece<P>(d + off + P * q, src + off + P * q);
      continue;
    }
    for (int i = (off & ~(P - 1)) + P * q; i < off + n; i += P * L) {
      const int lo = max(i, off), hi = min(i + P, off + n);
      if (lo == i && hi == i + P) {
        store_piece<P>(d + i, src + i);
      } else {
        for (int k = lo; k < hi; ++k) d[k] = src[k];
      }
    }
  }
}

// One bf16 into a staged output row: channel co's position pos at its chunk
// offset (e0 + co hw) & 7.
__device__ __forceinline__ void stage_out(__nv_bfloat16* S, int co, int pos, unsigned e0,
                                          unsigned hw, unsigned short v) {
  reinterpret_cast<unsigned short*>(S)[co * PY + ((e0 + co * hw) & 7u) + pos] = v;
}

// The taps in fragment order: for tap t, k-step ks (16 k channels) and n
// block nf (8 n channels), lane l = 4 g + q holds B[16 ks + 2q + {0, 1}]
// [8 nf + g], then B[16 ks + 2q + 8 + {0, 1}][8 nf + g]. Forward: B[t][k =
// ci][n = co] = w[co][ci][t]; dgrad: B[t][k = co][n = ci] = w[co][ci][8 - t].
// The loop unrolled, so that its loads are in flight together: a persistent
// block stages once, before its first tile.
__device__ void stage_taps(__nv_bfloat16* Bs, const __nv_bfloat16* __restrict__ w, bool dgrad) {
  static_assert(NTAP % (TH * 32) == 0, "whole rounds of the block");
#pragma unroll
  for (int j = 0; j < NTAP / (TH * 32); ++j) {  // w[co][ci][kh][kw]
    const int i = threadIdx.x + j * TH * 32;
    const int co = i / (C * 9), ci = (i / 9) % C, t = i % 9;
    const int k = dgrad ? co : ci, n = dgrad ? ci : co, tap = dgrad ? 8 - t : t;
    const int kk = k % 16, lane = (n % 8) * 4 + (kk % 8) / 2;
    Bs[(((tap * 2 + k / 16) * 4 + n / 8) * 32 + lane) * 4 + (kk / 8) * 2 + kk % 2] = w[i];
  }
}

// acc[mf][nf][e] (fragment layout of mma16) = the 3x3 conv at tile row r,
// positions 16 mf + g (+8), channels 8 nf + 2t (+1), from the window A
// (position-major, pitch PB) and the staged taps Bs. One float32 chain over
// the 18 k-steps: the bf16 products are exact in float32.
__device__ __forceinline__ void conv_row(const __nv_bfloat16* A, const __nv_bfloat16* Bs, int r,
                                         float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, ri = lane & 7;
  const int prow = (mi & 1) * 8 + ri, pch = (mi >> 1) * 8;  // this lane's ldmatrix row
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const uint2* bf = reinterpret_cast<const uint2*>(Bs) + lane;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int kh = tap / 3, kw = tap - 3 * kh;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t b[4][2];
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const uint2 v = bf[((tap * 2 + ks) * 4 + nf) * 32];
        b[nf][0] = v.x;
        b[nf][1] = v.y;
      }
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        uint32_t a[4];
        ldsm_x4(a, A + ((r + kh) * Win::WR + kw + 16 * mf + prow) * PB + 16 * ks + pch);
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) mma16(acc[mf][nf], a, b[nf]);
      }
    }
  }
}

// wgrad's fragments of one k-step (16 positions: tile row r, columns c16..):
// A[co][pos] = g at the positions, B[pos][ci] = u at the positions + the
// warp's tap's shift, and tap 8's B for this warp's fragment of it.
struct WgradFrags {
  uint32_t a[2][4], b[2][4], b8[2];
};

__device__ __forceinline__ void load_wgrad(WgradFrags& f, const __nv_bfloat16* G,
                                           const __nv_bfloat16* U, int kstep, int apos, int ach,
                                           int bpos, int bch, int kh, int kw, int nb8) {
  const int r = kstep >> 1, c16 = (kstep & 1) * 16;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
    ldsm_x4_t(f.a[mf], G + ((r + 1) * Win::WR + 1 + c16 + apos) * PB + 16 * mf + ach);
  const __nv_bfloat16* ub = U + ((r + kh) * Win::WR + kw + c16 + bpos) * PB + bch;
#pragma unroll
  for (int np = 0; np < 2; ++np) ldsm_x4_t(f.b[np], ub + 16 * np);  // n blocks 2 np, 2 np + 1
  // tap 8 (kh = kw = 2); lanes 0-15 give the rows
  ldsm_x2_t(f.b8, U + ((r + 2) * Win::WR + 2 + c16 + bpos) * PB + 8 * nb8);
}

// The MMAs of a k-step, in wgrad's fixed order.
__device__ __forceinline__ void mma_wgrad(float (&acc)[9][4], const WgradFrags& f, int mb8) {
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    const uint32_t b0[2] = {f.b[np][0], f.b[np][1]}, b1[2] = {f.b[np][2], f.b[np][3]};
#pragma unroll
    for (int mf = 0; mf < 2; ++mf) {
      mma16(acc[4 * mf + 2 * np], f.a[mf], b0);
      mma16(acc[4 * mf + 2 * np + 1], f.a[mf], b1);
    }
  }
  uint32_t a8[4];  // picked a register at a time: an array picked whole would live in memory
#pragma unroll
  for (int e = 0; e < 4; ++e) a8[e] = mb8 ? f.a[1][e] : f.a[0][e];
  mma16(acc[8], a8, f.b8);
}

__global__ void __launch_bounds__(TH * 32, FWD_BLOCKS)
fwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
           const float* __restrict__ s, const float* __restrict__ t,
           __nv_bfloat16* __restrict__ y, float* __restrict__ part, Shape sh, int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* U = Bs + TAPS;
  unsigned char* Xr = reinterpret_cast<unsigned char*>(U + WIN);  // ring of raw x windows
  __nv_bfloat16* Ys = reinterpret_cast<__nv_bfloat16*>(Xr + FWD_STAGES * RAW);  // y staging
  float* red = reinterpret_cast<float*>(Ys + OUT);  // [warp][sum, sq][C]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, cp = lane >> 1;
  Ys += warp * C * PY;  // this warp's row
  const uintptr_t xb = reinterpret_cast<uintptr_t>(x);
  const unsigned xe = (unsigned)(xb >> 1), ye = (unsigned)(reinterpret_cast<uintptr_t>(y) >> 1);
  const unsigned hw = (unsigned)sh.H * sh.W;
  // the first FWD_STAGES tiles' windows in flight, one copy group each
#pragma unroll
  for (int k = 0; k < FWD_STAGES; ++k) {
    const int tile = blockIdx.x + k * gridDim.x;
    if (tile < sh.ntiles) {
      int b, h0, w0;
      tile_origin(sh, tile, &b, &h0, &w0);
      fetch(Xr + k * RAW, xb, sh, b, h0, w0);
    }
    cp_commit();
  }
  stage_taps(Bs, w, false);
  const float s0 = s[2 * cp], s1 = s[2 * cp + 1], t0 = t[2 * cp], t1 = t[2 * cp + 1];

  // the last tile's y row, staged in Ys: stored during this tile's MMAs
  __nv_bfloat16* ydst = nullptr;
  unsigned ye0 = 0;
  int yn = 0;
  int slot = 0;
  for (int tile = blockIdx.x; tile < sh.ntiles; tile += gridDim.x) {
    int b, h0, w0;
    tile_origin(sh, tile, &b, &h0, &w0);
    unsigned char* raw = Xr + slot * RAW;
    cp_wait<FWD_STAGES - 1>();
    __syncthreads();  // this tile's window has arrived; the last tile is done with U and red
    // channel 2 c' at window row 0: its elements' offset in their chunks
    const unsigned e0r = xe + elem_at(sh, b, h0 - 1, w0 - 1) + 2 * cp * hw;
    for_cells(
        [&](int r, int col0) {  // rows out of the image are read, then masked
          const unsigned e = e0r + r * sh.W;
          return Raw2{{raw4(raw + raw_row(2 * cp, r), (int)(e & 7u) + col0),
                       raw4(raw + raw_row(2 * cp + 1, r), (int)((e + hw) & 7u) + col0)}};
        },
        [&](int r, int col0, const Raw2& v) {
          uint32_t* out = reinterpret_cast<uint32_t*>(U + (r * Win::WR + col0) * PB + 2 * cp);
          const int h = h0 + r - 1, w = w0 - 1 + col0;
          if (cell_inside(h, w, col0, sh)) {  // no mask
#pragma unroll
            for (int j = 0; j < 4; ++j)
              out[j * PB / 2] =
                  pack2(affine(elem(v.c[0], j), s0, t0), affine(elem(v.c[1], j), s1, t1));
            return;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool in = (unsigned)h < (unsigned)sh.H && (unsigned)(w + j) < (unsigned)sh.W;
            if (col0 + j < Win::WR)
              out[j * PB / 2] = pack2(in ? affine(elem(v.c[0], j), s0, t0) : 0.f,
                                      in ? affine(elem(v.c[1], j), s1, t1) : 0.f);
          }
        });
    __syncthreads();  // U is whole; the raw slot is free
    {
      const int next = tile + FWD_STAGES * gridDim.x;
      if (next < sh.ntiles) {
        int nb, nh0, nw0;
        tile_origin(sh, next, &nb, &nh0, &nw0);
        fetch(raw, xb, sh, nb, nh0, nw0);
      }
      cp_commit();
    }
    slot = slot + 1 == FWD_STAGES ? 0 : slot + 1;

    if (ydst) store_rows<STORE_P>(Ys, ydst, ye0, hw, (size_t)hw, yn);
    float acc[2][4][4];
    conv_row(U, Bs, warp, acc);
    __syncwarp();  // the last row's stores have read Ys
    // per-channel S y, S y^2 from the float32 y; y as bf16 into this warp's
    // staging, out in aligned 16-byte chunks during the next tile's MMAs
    const int h = h0 + warp;
    const unsigned e0 = ye + elem_at(sh, b, h, w0);
    float s1r[4][2], s2r[4][2];
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 2; ++e) s1r[nf][e] = s2r[nf][e] = 0.f;
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pos = 16 * mf + g + 8 * hh;
        const bool ok = h < sh.H && w0 + pos < sh.W;
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = 8 * nf + 2 * t4 + e;
            float v = acc[mf][nf][2 * hh + e];
            if (relu) v = fmaxf(v, 0.f);
            stage_out(Ys, co, pos, e0, hw, __bfloat16_as_ushort(__float2bfloat16_rn(v)));
            if (ok) {
              s1r[nf][e] += v;
              s2r[nf][e] = fmaf(v, v, s2r[nf][e]);
            }
          }
      }
    ydst = h < sh.H ? y + ((size_t)b * C * sh.H + h) * sh.W + w0 : nullptr;
    ye0 = e0;
    yn = min(TW, sh.W - w0);
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s1r[nf][e] = row_sum(s1r[nf][e]);
        s2r[nf][e] = row_sum(s2r[nf][e]);
        if (g == 0) {
          red[(warp * 2 + 0) * C + 8 * nf + 2 * t4 + e] = s1r[nf][e];
          red[(warp * 2 + 1) * C + 8 * nf + 2 * t4 + e] = s2r[nf][e];
        }
      }
    __syncthreads();
    if (threadIdx.x < 2 * C) {  // row [tile]: C sums, then C sums of squares
      float a = 0.f;
      for (int k = 0; k < TH; ++k) a += red[k * 2 * C + threadIdx.x];
      part[(size_t)tile * 2 * C + threadIdx.x] = a;
    }
  }
  __syncwarp();
  if (ydst) store_rows<STORE_P>(Ys, ydst, ye0, hw, (size_t)hw, yn);
  cp_wait<0>();  // no copy outlives the block
}

__global__ void __launch_bounds__(TH * 32, 1)
bwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
           const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ w,
           const float* __restrict__ s, const float* __restrict__ t,
           const float* __restrict__ dsum, const float* __restrict__ dsq,
           const float* __restrict__ dm, __nv_bfloat16* __restrict__ dx,
           float* __restrict__ part, Shape sh, int relu) {
  static_assert(TH == 8, "wgrad gives each of 8 warps one tap and an eighth of tap 8");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // dgrad taps
  __nv_bfloat16* G = Bs + TAPS;                                      // g window
  __nv_bfloat16* U = G + WIN;                                        // u window
  unsigned char* Xr = reinterpret_cast<unsigned char*>(U + WIN);     // raw x, two slots
  unsigned char* Yr = Xr + 2 * RAW;                                  // raw y
  unsigned char* Dr = Yr + RAW;                                      // raw dy
  __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(Dr + RAW);   // dx staging
  float* red = reinterpret_cast<float*>(Ds + OUT);  // [warp][ds, dt][C]
  float* prm = red + 2 * TH * C;                    // s
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3, ri = lane & 7, cp = lane >> 1;
  Ds += warp * C * PY;  // this warp's row
  const uintptr_t xb = reinterpret_cast<uintptr_t>(x), yb = reinterpret_cast<uintptr_t>(y),
                  db = reinterpret_cast<uintptr_t>(dy);
  const unsigned xe = (unsigned)(xb >> 1), ye = (unsigned)(yb >> 1), de = (unsigned)(db >> 1);
  const unsigned dxe = (unsigned)(reinterpret_cast<uintptr_t>(dx) >> 1);
  const unsigned hw = (unsigned)sh.H * sh.W;
  auto fetch_tile = [&](int tile, unsigned char* xr) {
    int b, h0, w0;
    tile_origin(sh, tile, &b, &h0, &w0);
    fetch(xr, xb, sh, b, h0, w0);
    fetch(Yr, yb, sh, b, h0, w0);
    fetch(Dr, db, sh, b, h0, w0);
  };
  if (blockIdx.x < sh.ntiles) fetch_tile(blockIdx.x, Xr);
  cp_commit();
  stage_taps(Bs, w, true);
  if (threadIdx.x < C) prm[threadIdx.x] = s[threadIdx.x];
  // this lane's channel pair in the conversion
  const float s0 = s[2 * cp], s1 = s[2 * cp + 1], t0 = t[2 * cp], t1 = t[2 * cp + 1];
  const float dsum0 = dsum[2 * cp], dsum1 = dsum[2 * cp + 1];
  const float dsq0 = dsq[2 * cp], dsq1 = dsq[2 * cp + 1];

  // wgrad: this warp owns dW of tap `warp` (fragments f < 8: m block f / 4,
  // n block f % 4) and of tap 8 (f = 8: m block warp / 4, n block warp % 4);
  // co = 16 mb + g (+8), ci = 8 nb + 2 t4 (+1)
  float dw[9][4];
#pragma unroll
  for (int f = 0; f < 9; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) dw[f][e] = 0.f;
  float dsa[4][2], dta[4][2];
#pragma unroll
  for (int nf = 0; nf < 4; ++nf)
#pragma unroll
    for (int e = 0; e < 2; ++e) dsa[nf][e] = dta[nf][e] = 0.f;
  const int kh = warp / 3, kw = warp % 3;
  const int mb8 = warp >> 2, nb8 = warp & 3;
  // ldmatrix rows of wgrad's fragments: A's matrices step co by 8, then
  // positions by 8; B's step positions by 8, then ci by 8
  const int apos = (mi >> 1) * 8 + ri, ach = (mi & 1) * 8;
  const int bpos = (mi & 1) * 8 + ri, bch = (mi >> 1) * 8;

  int slot = 0;
  for (int tile = blockIdx.x; tile < sh.ntiles; tile += gridDim.x) {
    int b, h0, w0;
    tile_origin(sh, tile, &b, &h0, &w0);
    const unsigned char* xr = Xr + slot * RAW;
    const float dm0 = dm[(size_t)b * C + 2 * cp], dm1 = dm[(size_t)b * C + 2 * cp + 1];
    cp_wait<0>();
    __syncthreads();  // this tile's windows have arrived; the last tile is done with G and U
    // channel 2 c' at window row 0: its elements' offset in their chunks
    const unsigned e0r = elem_at(sh, b, h0 - 1, w0 - 1) + 2 * cp * hw;
    for_cells(
        [&](int r, int col0) {  // rows out of the image are read, then masked
          const unsigned e = e0r + r * sh.W;
          Raw6 v;
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int row = raw_row(2 * cp + k, r);
            v.x[k] = raw4(xr + row, (int)((xe + e + k * hw) & 7u) + col0);
            v.y[k] = raw4(Yr + row, (int)((ye + e + k * hw) & 7u) + col0);
            v.d[k] = raw4(Dr + row, (int)((de + e + k * hw) & 7u) + col0);
          }
          return v;
        },
        [&](int r, int col0, const Raw6& v) {
          const int q = (r * Win::WR + col0) * PB + 2 * cp;
          const int h = h0 + r - 1, w = w0 - 1 + col0;
          auto put = [&](bool masked) {  // a copy without masks for cells inside
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (masked && col0 + j >= Win::WR) continue;
              const bool in =
                  !masked || ((unsigned)h < (unsigned)sh.H && (unsigned)(w + j) < (unsigned)sh.W);
              const float g0 = cotangent(elem(v.d[0], j), elem(v.y[0], j), dsum0, dsq0, dm0, relu);
              const float g1 = cotangent(elem(v.d[1], j), elem(v.y[1], j), dsum1, dsq1, dm1, relu);
              const float u0 = affine(elem(v.x[0], j), s0, t0);
              const float u1 = affine(elem(v.x[1], j), s1, t1);
              *reinterpret_cast<uint32_t*>(G + q + j * PB) = pack2(in ? g0 : 0.f, in ? g1 : 0.f);
              *reinterpret_cast<uint32_t*>(U + q + j * PB) = pack2(in ? u0 : 0.f, in ? u1 : 0.f);
            }
          };
          if (cell_inside(h, w, col0, sh))
            put(false);
          else
            put(true);
        });
    __syncthreads();  // G and U are whole; the raw y and dy are free
    if (tile + gridDim.x < sh.ntiles) fetch_tile(tile + gridDim.x, Xr + (slot ^ 1) * RAW);
    cp_commit();

    // dgrad: du at tile row `warp` for input channels 8 nf + 2 t4 + e; dx =
    // bf16(du s) through this warp's staging, out during wgrad's MMAs; ds =
    // S du x with x from the staged raw window
    {
      const int h = h0 + warp;
      float acc[2][4][4];
      conv_row(G, Bs, warp, acc);
      __syncwarp();  // the last row's stores have read Ds
      const unsigned ex = xe + elem_at(sh, b, h, w0 - 1);  // x's window column 0, channel 0
      const unsigned e0 = dxe + elem_at(sh, b, h, w0);
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int pos = 16 * mf + g + 8 * hh;
          const bool ok = h < sh.H && w0 + pos < sh.W;
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) {
            const int ci = 8 * nf + 2 * t4;
            const float du0 = acc[mf][nf][2 * hh], du1 = acc[mf][nf][2 * hh + 1];
            stage_out(Ds, ci, pos, e0, hw,
                      __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(du0, prm[ci]))));
            stage_out(Ds, ci + 1, pos, e0, hw,
                      __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(du1, prm[ci + 1]))));
            if (ok) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int o = (int)((ex + (ci + e) * hw) & 7u) + pos + 1;
                const unsigned short* xrow =
                    reinterpret_cast<const unsigned short*>(xr + raw_row(ci + e, warp + 1));
                const float xv = __uint_as_float((unsigned)xrow[o] << 16);
                const float du = e ? du1 : du0;
                dsa[nf][e] = fmaf(du, xv, dsa[nf][e]);
                dta[nf][e] += du;
              }
            }
          }
        }
      __syncwarp();
      if (h < sh.H)
        store_rows<STORE_P>(Ds, dx + ((size_t)b * C * sh.H + h) * sh.W + w0, e0, hw, (size_t)hw,
                   min(TW, sh.W - w0));
    }

    // wgrad over the tile's positions, 16 a k-step (row r, columns c16..):
    // A[co][pos] = g at the position, B[pos][ci] = u at the position + the
    // tap's shift. g is 0 outside the image, so those positions add 0.
    // The fragments of k-step ks are loaded a k-step ahead of their MMAs
    // (two register sets), so that the loads' latency hides behind them.
    {
      float acc[9][4];
#pragma unroll
      for (int f = 0; f < 9; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
      WgradFrags f0, f1;
      load_wgrad(f0, G, U, 0, apos, ach, bpos, bch, kh, kw, nb8);
#pragma unroll 1
      for (int kstep = 0; kstep < TH * 2; kstep += 2) {
        load_wgrad(f1, G, U, kstep + 1, apos, ach, bpos, bch, kh, kw, nb8);
        mma_wgrad(acc, f0, mb8);
        if (kstep + 2 < TH * 2) load_wgrad(f0, G, U, kstep + 2, apos, ach, bpos, bch, kh, kw, nb8);
        mma_wgrad(acc, f1, mb8);
      }
#pragma unroll
      for (int f = 0; f < 9; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) dw[f][e] += acc[f][e];
    }
    slot ^= 1;  // the next tile's first barrier: every warp is done with G, U and this x
  }
  __syncwarp();
  cp_wait<0>();

  // this block's partial row: dW in w's layout [co][ci][kh][kw], then ds, dt
  float* row = part + (size_t)blockIdx.x * NPART;
#pragma unroll
  for (int f = 0; f < 9; ++f) {
    const int tap = f < 8 ? warp : 8;
    const int mb = f < 8 ? f >> 2 : mb8, nb = f < 8 ? f & 3 : nb8;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int co = 16 * mb + g + 8 * (e >> 1), ci = 8 * nb + 2 * t4 + (e & 1);
      row[(co * C + ci) * 9 + tap] = dw[f][e];
    }
  }
#pragma unroll
  for (int nf = 0; nf < 4; ++nf)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dsa[nf][e] = row_sum(dsa[nf][e]);
      dta[nf][e] = row_sum(dta[nf][e]);
      if (g == 0) {
        red[(warp * 2 + 0) * C + 8 * nf + 2 * t4 + e] = dsa[nf][e];
        red[(warp * 2 + 1) * C + 8 * nf + 2 * t4 + e] = dta[nf][e];
      }
    }
  __syncthreads();
  if (threadIdx.x < 2 * C) {
    float a = 0.f;
    for (int k = 0; k < TH; ++k) a += red[k * 2 * C + threadIdx.x];
    row[NTAP + threadIdx.x] = a;
  }
}

constexpr size_t FWD_SMEM =
    (size_t)(TAPS + WIN + OUT) * 2 + (size_t)FWD_STAGES * RAW + 2 * TH * C * sizeof(float);
constexpr size_t BWD_SMEM = (size_t)(TAPS + 2 * WIN + OUT) * 2 + 4 * (size_t)RAW +
                            (2 * TH * C + C) * sizeof(float);
static_assert(BWD_SMEM <= 227 * 1024, "backward shared memory");
static_assert(FWD_SMEM <= 227 * 1024, "forward shared memory");

cudaError_t set_smem() {
  cudaError_t e = cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       FWD_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

// Blocks of a pass an SM (after set_smem): as many as fit, the forward at
// most FWD_BLOCKS.
int per_sm(bool bwd) {
  int n = 0;
  const cudaError_t e =
      bwd ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bwd_kernel, TH * 32, BWD_SMEM)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fwd_kernel, TH * 32, FWD_SMEM);
  if (e != cudaSuccess || n < 1) n = 1;
  return !bwd && n > FWD_BLOCKS ? FWD_BLOCKS : n;
}

// Blocks of a pass: per_sm an SM, at most one a tile.
int blocks(const Shape& sh, bool bwd) {
  const int n = sm_count() * per_sm(bwd);
  return sh.ntiles < n ? sh.ntiles : n;
}

}  // namespace bf

}  // namespace

extern "C" {

// Rows of scratch the forward needs: one per tile, 2*C floats each.
int zv_se_conv_fwd_tiles(int B, int H, int W) { return make_shape(B, H, W).ntiles; }

// Blocks of either pass (one an SM, at most one a tile); the backward's
// scratch holds NPART floats per block.
int zv_se_conv_bwd_blocks(int B, int H, int W) {
  const int n = make_shape(B, H, W).ntiles, g = sm_count();
  return n < g ? n : g;
}

// x, y [B, 32, H, W]; w [32, 32, 3, 3]; s, t [32]; ssum, ssq [32]; m [B, 32];
// part: zv_se_conv_fwd_tiles(B, H, W) * 64 floats of scratch.
int zv_se_conv_fwd_f32(const float* x, const float* w, const float* s, const float* t,
                       float* y, float* ssum, float* ssq, float* m, float* part, int B, int H,
                       int W, int relu, void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(B, H, W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(se_conv_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = zv_se_conv_bwd_blocks(B, H, W);
  se_conv_fwd_kernel<<<grid, TH * 32, FWD_SMEM, st>>>(x, w, s, t, y, part, sh, relu);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  se_conv_fwd_sample<<<B, dim3(C, 32), 0, st>>>(part, m, sh.nth * sh.ntw);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  se_conv_fwd_total<<<1, 2 * C, 0, st>>>(part, ssum, ssq, B, sh.nth * sh.ntw);
  return (int)cudaGetLastError();
}

// x, y, dy, dx [B, 32, H, W]; w [32, 32, 3, 3]; s, t, dsum, dsq [32];
// dm [B, 32]; out: dW (9216) then ds (32) then dt (32);
// part: zv_se_conv_bwd_blocks(B, H, W) * 9280 floats of scratch.
int zv_se_conv_bwd_f32(const float* x, const float* y, const float* dy, const float* w,
                       const float* s, const float* t, const float* dsum, const float* dsq,
                       const float* dm, float* dx, float* out, float* part, int B, int H,
                       int W, int relu, void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(B, H, W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(se_conv_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = zv_se_conv_bwd_blocks(B, H, W);
  se_conv_bwd_kernel<<<grid, TH * 32, BWD_SMEM, st>>>(x, y, dy, w, s, t, dsum, dsq, dm, dx,
                                                          part, sh, relu);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  se_conv_bwd_finish<<<(NPART + 31) / 32, dim3(32, 8), 0, st>>>(part, out, grid);
  return (int)cudaGetLastError();
}

}  // extern "C"

// The bfloat16 pass. x, y, dy, dx and w are bf16; s, t, the sums, m, dsum,
// dsq, dm and out float32. Scratch as for the float32 pass, with the
// backward's blocks from zv_se_conv_bf16_blocks(B, H, W, 1).
extern "C" {

int zv_se_conv_bf16_blocks(int B, int H, int W, int bwd) {
  if (bf::set_smem() != cudaSuccess) return 1;
  return bf::blocks(make_shape(B, H, W), bwd != 0);
}

// The bf16 pass's design, forward (bwd = 0) or backward: what = 0 tile rows,
// 1 tile columns, 2 raw windows staged ahead (the backward also keeps this
// tile's x), 3 blocks an SM, 4 shared-memory bytes a block; -1 on an error.
int zv_se_conv_bf16_design(int bwd, int what) {
  if (bf::set_smem() != cudaSuccess) return -1;
  switch (what) {
    case 0: return TH;
    case 1: return TW;
    case 2: return bwd ? 1 : bf::FWD_STAGES;
    case 3: return bf::per_sm(bwd != 0);
    case 4: return (int)(bwd ? bf::BWD_SMEM : bf::FWD_SMEM);
    default: return -1;
  }
}

int zv_se_conv_fwd_bf16(const void* x, const void* w, const float* s, const float* t, void* y,
                        float* ssum, float* ssq, float* m, float* part, int B, int H, int W,
                        int relu, void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(B, H, W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = bf::set_smem();
  if (e != cudaSuccess) return (int)e;
  bf::fwd_kernel<<<bf::blocks(sh, false), TH * 32, bf::FWD_SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), s, t,
      static_cast<__nv_bfloat16*>(y), part, sh, relu);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  se_conv_fwd_sample<<<B, dim3(C, 32), 0, st>>>(part, m, sh.nth * sh.ntw);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  se_conv_fwd_total<<<1, 2 * C, 0, st>>>(part, ssum, ssq, B, sh.nth * sh.ntw);
  return (int)cudaGetLastError();
}

int zv_se_conv_bwd_bf16(const void* x, const void* y, const void* dy, const void* w,
                        const float* s, const float* t, const float* dsum, const float* dsq,
                        const float* dm, void* dx, float* out, float* part, int B, int H, int W,
                        int relu, void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(B, H, W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = bf::set_smem();
  if (e != cudaSuccess) return (int)e;
  const int grid = bf::blocks(sh, true);
  bf::bwd_kernel<<<grid, TH * 32, bf::BWD_SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(w), s, t, dsum,
      dsq, dm, static_cast<__nv_bfloat16*>(dx), part, sh, relu);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  se_conv_bwd_finish<<<(NPART + 31) / 32, dim3(32, 8), 0, st>>>(part, out, grid);
  return (int)cudaGetLastError();
}

}  // extern "C"
