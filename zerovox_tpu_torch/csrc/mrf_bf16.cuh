// The bf16 tile of the fused HiFi-GAN kernels K1, K2 and K3 (mrf.cu's
// zv_mrf_bf16, upsample_stage.cu's zv_upsample_stage_bf16, resblock.cu's
// zv_resblock1_bf16): mrf_tc.cuh's tile (one time tile of an MRF stage,
// every tower, the activations in shared memory, each conv a sum over taps
// of warp GEMMs, the same items, halos and tower sums) on Hopper's bf16
// tensor cores, mma.sync.m16n8k16: twice TF32's rate, 16 input channels a
// k-step.
//
// Arithmetic: the TPU kernels' bf16 contract, bf16 in, float32 inside, one
// rounding at the output. The weights are bf16, so exact. Each float32
// activation a that feeds a GEMM goes in as two bf16 terms, hi = rn(a) and
// lo = rn(a - hi), which keep 16 of its 24 significant bits, and each
// product is two MMAs (lo.w, then hi.w) accumulated in float32: half the
// tensor-core time of the two TF32 m16n8k8 MMAs the TF32 tile spends. The
// residual stream, the conv outputs, the tower sums and conv_post stay
// float32. The result is within one bf16 step of the plain version (float32
// on the widened inputs, rounded once) with ~0.2 % of the outputs rounded
// the other way; one bf16 term (8 bits) moves a third of them
// (tests/test_torch_bf16_mma.py emulates both).
//
// A operands. Conv1 reads leaky(A), A the float32 tower state in rows of
// lda(C) = C + 8 floats (8 at C = 8), where a fragment's float2 loads (rows
// g and g + 8, channels 2t and 2t + 8) fall on distinct banks; each pair is
// split by two cvt.rn.bf16x2.f32. Conv2's operand leaky(conv1) is split once,
// by conv1's epilogue, into B: rows of C hi and C lo bf16 and 8 bf16 of
// padding (ldb(C) = 2C + 8, a float32 row's bytes, an odd multiple of 16
// bytes so that ldmatrix's 8 rows fall on distinct banks), and every warp
// reads its two terms with two ldmatrix.x4 a 16 x 16 fragment (one at
// C = 8, where a row's 8 hi and 8 lo are one 16-byte piece). K2 stages its
// input leaky(x) into B the same way for the transposed conv.
//
// B operands: the weights in m16n8k16 B-fragment order (ops/mrf.py's
// mma_fragments_bf16): for each tap, k-step ks of 16 input channels
// (zero-padded to 16 at C = 8, whose upper A terms are constant zeros: the
// same tensor-core time as two TF32 m16n8k8 MMAs) and block nf of 8 output
// channels, lane l holds w[16 ks + 2 (l % 4) + {0, 1}][8 nf + l / 4] and the
// same at input channel + 8, 8 bytes, so that a warp's fragment is one
// coalesced 256-byte load, one k-step ahead of its MMAs: from L2 through L1
// (BL2; K1, K2), or from a copy in shared memory (BSmem, StagedWeights: K3
// at the widths where a conv's fragments fit beside the tile, copied by
// cp.async one conv ahead of the conv that reads them).
#pragma once

#include <cstdint>

#include "mrf_tc.cuh"

namespace zv {
namespace bf16x2 {

using tc::MF;
using tc::NWARP;
using tc::Rows;

// Design choices, timed against their alternatives at the main path's shapes
// by scripts/bench_mrf_breakdown.py (PERF.md):
constexpr int KK_UNROLL = 2;   // k-steps of a GEMM's loop unrolled together
constexpr int B_AHEAD = 1;     // k-steps of B fragments in flight ahead of the MMAs
constexpr int ITEM_COLS = 32;  // output channels of a warp's item (C_out when narrower)

__host__ __device__ constexpr int item_cols(int co) { return co < ITEM_COLS ? co : ITEM_COLS; }

// floats a row of A (the float32 tower state) at C channels
__host__ __device__ constexpr int lda(int c) { return c == 8 ? 8 : c + 8; }
// bf16 a row of B: C hi, C lo, 8 of padding
__host__ __device__ constexpr int ldb(int c) { return 2 * c + 8; }
// input channels of a conv's fragments: C rounded up to whole k-steps of 16
__host__ __device__ constexpr int k16(int c) { return (c + 15) / 16 * 16; }

// bf16x2 {rn(lo), rn(hi)}, lo in the low half.
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The two bf16 terms of a pair: h = rn(v), l = rn(v - h).
__device__ __forceinline__ void split2(float2 v, uint32_t& h, uint32_t& l) {
  h = pack_rn(v.x, v.y);
  l = pack_rn(v.x - __uint_as_float(h << 16), v.y - __uint_as_float(h & 0xFFFF0000u));
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// A conv's B source: fetch(i) gives lane-fragment i of its fragment buffer.
// BL2: the buffer in global memory, through L1 from L2.
struct BL2 {
  const uint2* __restrict__ w;
  __device__ __forceinline__ uint2 fetch(size_t i) const { return __ldg(w + i); }
};

// BSmem: a copy of the buffer in shared memory.
struct BSmem {
  const uint2* s;
  __device__ __forceinline__ uint2 fetch(size_t i) const { return s[i]; }
};

// Where mrf_tile's convs read their weights. Every thread calls start(w)
// once before the first conv, use(w, next) before each conv (after the
// block's barrier), which gives the B source of the conv whose fragments
// start at w (`next`: the following conv's, or null), and wait() before
// each barrier that precedes a conv. L2Weights: BL2, nothing to wait for.
struct L2Weights {
  __device__ __forceinline__ void start(const uint2*) {}
  __device__ __forceinline__ BL2 use(const uint2* w, const uint2*) { return BL2{w}; }
  __device__ __forceinline__ void wait() {}
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(tc::smem_u32(dst)), "l"(src)
               : "memory");
}

// StagedWeights: each conv's n lane-fragments (8 bytes each, n even) copied
// into shared memory, two buffers of n at buf: the copy of the next conv
// goes out by cp.async, 16 bytes a thread at a time, when the current conv
// starts, and wait() (cp.async.wait_all) before the barrier between the two
// makes it complete, so the copy runs under the current conv's MMAs. Every
// conv of the tile has n lane-fragments (one tower: K3).
template <int NW>
struct StagedWeights {
  uint2* buf;
  int n;
  int cur = 0;
  __device__ __forceinline__ void copy(const uint2* w, uint2* dst) const {
    for (int i = threadIdx.x; i < n / 2; i += NW * 32) cp_async16(dst + 2 * i, w + 2 * i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  __device__ __forceinline__ void start(const uint2* w) { copy(w, buf); }
  __device__ __forceinline__ BSmem use(const uint2* w, const uint2* next) {
    const uint2* here = buf + cur * n;
    cur ^= 1;
    if (next != nullptr) copy(next, buf + cur * n);
    return BSmem{here};
  }
  __device__ __forceinline__ void wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
};

// Conv1's A: leaky(0.1) of float32 rows of lda(C) floats, split at the load.
// Off: this lane's offsets (floats) of its fragment rows g and g + 8.
template <int C>
struct AFloat {
  static constexpr int LD = lda(C);
  struct Off {
    int r0, r1;
  };
  const float* src;
  // rows m0 + g and m0 + g + 8 of the GEMM (past M: row M - 1, not stored)
  __device__ __forceinline__ Off offset(int a0, int m0, int M, int lane) const {
    const int g = lane >> 2, c = 2 * (lane & 3);
    return {(a0 + min(m0 + g, M - 1)) * LD + c, (a0 + min(m0 + g + 8, M - 1)) * LD + c};
  }
  __device__ __forceinline__ void frag(Off o, int shift, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) const {
    const float* p = src + shift;
    constexpr int NE = C == 8 ? 2 : 4;  // C = 8: channels 8-15 are the zero padding
    float2 v[NE];
    v[0] = lds2(p + o.r0);
    v[1] = lds2(p + o.r1);
    if constexpr (NE == 4) {
      v[2] = lds2(p + o.r0 + 8);
      v[3] = lds2(p + o.r1 + 8);
    }
#pragma unroll
    for (int e = 0; e < NE; ++e) split2(tc::leaky2(v[e], 0.1f), ah[e], al[e]);
#pragma unroll
    for (int e = NE; e < 4; ++e) ah[e] = al[e] = 0u;
  }
};

// Conv2's (and the transposed conv's) A: B rows of ldb(C) bf16, already
// split, by ldmatrix. Off: this lane's row address (bf16): lanes 0-15 rows
// m0..m0+15 at channel 0, lanes 16-31 the same rows at channel 8.
template <int C>
struct ASplit {
  static constexpr int LD = ldb(C);
  using Off = int;
  const bf16* src;
  __device__ __forceinline__ Off offset(int a0, int m0, int M, int lane) const {
    return (a0 + min(m0 + (lane & 15), M - 1)) * LD + (lane >> 4) * 8;
  }
  __device__ __forceinline__ void frag(Off o, int shift, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) const {
    const bf16* p = src + o + shift;
    if constexpr (C == 8) {  // one piece: rows' hi (lanes 0-15) and lo (16-31)
      uint32_t r[4];
      tc::ldsm_x4(r, p);
      ah[0] = r[0];
      ah[1] = r[1];
      al[0] = r[2];
      al[1] = r[3];
      ah[2] = ah[3] = al[2] = al[3] = 0u;
    } else {
      tc::ldsm_x4(ah, p);
      tc::ldsm_x4(al, p + C);
    }
  }
};

// out[m][co] = bias[co] + sum_t sum_ci A(m, t, ci) w[t][ci][co] over `ntaps`
// taps, A the source's two terms of row a0 + m + (t - half) dil; w (a B
// source: BL2, BSmem) in m16n8k16 fragment order; epi(row, co, value) takes
// two finished neighbouring channels. NW warps take the items (32 rows x
// item_cols(CO) channels) in turn, as tc::conv_tc.
template <int CI, int CO, int NW = NWARP, class ASrc, class BSrc, class TB, class Epi>
__device__ void conv(ASrc a, BSrc w, const TB* __restrict__ bias, int ntaps, Rows rw, Epi epi) {
  constexpr int KS = k16(CI) / 16, NF = CO / 8;
  constexpr int NFW = item_cols(CO) / 8;  // n fragments of a warp's item
  constexpr int NSL = NF / NFW;               // items across the channels
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int nk = ntaps * KS;
  const int n_items = (rw.M + 16 * MF - 1) / (16 * MF) * NSL;
  for (int item = warp; item < n_items; item += NW) {
    const int m0 = item / NSL * 16 * MF;
    const int nf0 = item % NSL * NFW;
    float acc[MF][NFW][4];
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NFW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    typename ASrc::Off ra[MF];
#pragma unroll
    for (int i = 0; i < MF; ++i) ra[i] = a.offset(rw.a0, m0 + 16 * i, rw.M, lane);
    const size_t wl = (size_t)nf0 * 32 + lane;
    uint2 bq[B_AHEAD][NFW];  // B of the next B_AHEAD k-steps
#pragma unroll
    for (int s = 0; s < B_AHEAD; ++s)
#pragma unroll
      for (int j = 0; j < NFW; ++j)
        bq[s][j] = s < nk ? w.fetch(wl + ((size_t)s * NF + j) * 32) : make_uint2(0u, 0u);
#pragma unroll KK_UNROLL
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t b[NFW][2];
#pragma unroll
      for (int j = 0; j < NFW; ++j) {
        b[j][0] = bq[0][j].x;
        b[j][1] = bq[0][j].y;
      }
#pragma unroll
      for (int s = 0; s + 1 < B_AHEAD; ++s)
#pragma unroll
        for (int j = 0; j < NFW; ++j) bq[s][j] = bq[s + 1][j];
      if (kk + B_AHEAD < nk) {
#pragma unroll
        for (int j = 0; j < NFW; ++j)
          bq[B_AHEAD - 1][j] = w.fetch(wl + ((size_t)(kk + B_AHEAD) * NF + j) * 32);
      }
      const int tap = kk / KS, ks = kk - tap * KS;
      const int shift = (tap - rw.half) * rw.dil * ASrc::LD + ks * 16;
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        uint32_t ah[4], al[4];
        a.frag(ra[i], shift, ah, al);
#pragma unroll
        for (int j = 0; j < NFW; ++j) {
          tc::mma16(acc[i][j], al, b[j]);
          tc::mma16(acc[i][j], ah, b[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NFW; ++j) {
      const int co = (nf0 + j) * 8 + 2 * t4;
      const float2 bv = ldg2(bias + co);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + i * 16 + g + 8 * h;
          if (m < rw.M)
            epi(rw.o0 + rw.os * m, co,
                make_float2(acc[i][j][2 * h] + bv.x, acc[i][j][2 * h + 1] + bv.y));
        }
    }
  }
}

// leaky(0.1) of two finished channels, split into row r of B at channel co.
template <int C>
__device__ __forceinline__ void store_split(bf16* Bs, int r, int co, float2 v) {
  uint32_t h, l;
  split2(tc::leaky2(v, 0.1f), h, l);
  uint32_t* row = reinterpret_cast<uint32_t*>(Bs + r * ldb(C));
  row[co / 2] = h;
  row[(C + co) / 2] = l;
}

// tc::mrf_tile on the bf16 arithmetic: all towers of one MRF stage over one
// tile, NW warps a block. A holds W = TT + 2 HW rows of lda(C) floats, Bs W
// rows of ldb(C) bf16; `load(lo, hi)` fills window rows [lo, hi) of A with
// the stage input (zero outside [0, T)) and must leave Bs free; the mean
// over towers of rows [HW - P, HW + TT + P) goes to `o` (o.acc: rows of C + 4
// floats). Weights: tower by tower, w1 [P][k] then w2 [P][k] taps in
// m16n8k16 fragment order (k16(C) x C a tap), read as `weights` says
// (L2Weights, StagedWeights); biases b1 [P][C] then b2 [P][C].
template <int C, int NW = NWARP, class Load, class Weights = L2Weights>
__device__ void mrf_tile(float* A, bf16* Bs, const MrfParamsT<bf16>& p, int HW, int TT, int P,
                         int tbase, int T, size_t gout_row0, const tc::TileOut<bf16>& o,
                         Load load, Weights weights = {}) {
  constexpr int LA = lda(C), LACC = C + 4;
  const int f_lo = HW - P, f_hi = HW + TT + P;
  auto valid = [&](int r) { return (unsigned)(tbase + r) < (unsigned)T; };
  const uint2* wf = reinterpret_cast<const uint2*>(p.w);
  size_t wofs = 0, bofs = 0;
  weights.start(wf);
  for (int j = 0; j < p.n_towers; ++j) {
    const int k = p.ks[j];
    const int half = (k - 1) / 2;
    const size_t conv_w = (size_t)k * k16(C) * C / 4;  // lane-fragments (4 bf16) of a conv
    int ext = tower_halo(k, p);
    load(f_lo - ext, f_hi + ext);
    weights.wait();
    __syncthreads();
    const uint2* w1 = wf + wofs;
    const uint2* w2 = w1 + p.n_pairs * conv_w;
    const uint2* w_next_tower = j + 1 < p.n_towers ? w1 + 2 * p.n_pairs * conv_w : nullptr;
    const bf16* b1 = p.b + bofs;
    const bf16* b2 = b1 + (size_t)p.n_pairs * C;
    for (int q = 0; q < p.n_pairs; ++q) {
      const int e1 = ext - half * p.dils[q];
      conv<C, C, NW>(AFloat<C>{A}, weights.use(w1 + q * conv_w, w2 + q * conv_w), b1 + q * C, k,
                     tc::same_rows(f_lo - e1, f_hi + e1, k, p.dils[q]),
                     [&](int r, int co, float2 v) {
                       store_split<C>(Bs, r, co, valid(r) ? v : make_float2(0.f, 0.f));
                     });
      weights.wait();
      __syncthreads();
      const int e2 = e1 - half;
      const auto w2q = weights.use(w2 + q * conv_w,
                                   q + 1 < p.n_pairs ? w1 + (q + 1) * conv_w : w_next_tower);
      if (q + 1 < p.n_pairs) {
        conv<C, C, NW>(ASplit<C>{Bs}, w2q, b2 + q * C, k,
                       tc::same_rows(f_lo - e2, f_hi + e2, k, 1), [&](int r, int co, float2 v) {
                         float2& d = tc::at2(A + r * LA + co);
                         d = valid(r) ? tc::add2(d, v) : make_float2(0.f, 0.f);
                       });
      } else {
        const bool first = j == 0, last = j + 1 == p.n_towers;
        const float n = (float)p.n_towers;
        conv<C, C, NW>(ASplit<C>{Bs}, w2q, b2 + q * C, k,
                       tc::same_rows(f_lo, f_hi, k, 1), [&](int r, int co, float2 v) {
          float2 t = valid(r) ? tc::add2(tc::at2(A + r * LA + co), v) : make_float2(0.f, 0.f);
          if (o.gout != nullptr) {
            if (!valid(r)) return;
            const size_t at = (gout_row0 + (size_t)(tbase + r)) * C + co;
            if (!first) t = tc::add2(tc::at2(o.gsum + at), t);
            if (last)
              store2(o.gout + at, make_float2(t.x / n, t.y / n));
            else
              tc::at2(o.gsum + at) = t;
            return;
          }
          float2& s = tc::at2(o.acc + (r - f_lo) * LACC + co);
          if (!first) t = tc::add2(s, t);
          s = last ? tc::leaky2(make_float2(t.x / n, t.y / n), o.post_slope) : t;
        });
      }
      weights.wait();
      __syncthreads();
      ext = e2;
    }
    wofs += 2 * p.n_pairs * conv_w;
    bofs += (size_t)2 * p.n_pairs * C;
  }
}

}  // namespace bf16x2
}  // namespace zv
