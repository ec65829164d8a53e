// Tensor-core tile of the fused HiFi-GAN kernels (mrf.cu, upsample_stage.cu,
// resblock.cu): one time tile of a multi-receptive-field stage, all towers
// (one for resblock.cu), with every intermediate activation in shared
// memory, and every convolution a sum over taps of GEMMs on the tensor cores
// in 3xTF32.
//
// Convolution as GEMM. For tap t of a conv with dilation d, output row r
// takes the shared-memory row r + (t - half) d as its A row (C_in wide) and
// the tap's C_in x C_out weight as B. A warp owns a 32-row x 32-column item
// of the output (2 x 4 fragments of mma.sync.m16n8k8, or 32 x C_out when
// C_out < 32) and walks k-steps of 8 input channels over all taps; the 16
// warps of a block take a conv's items in turn. 16 warps of small items
// beat 8 warps of 64-row items on every K1/K2 shape measured: more warps
// hide the latency of the shared-memory A loads and of the MMAs, and the
// smaller items waste less on a conv's ragged last rows.
//
// 3xTF32 (tc_common.cuh): both operands split hi/lo, three MMAs per
// product. The weights are split in the kernel
// too: splitting them once on the host doubles the bytes each B fragment
// load brings from L2, and measured slower for K1, whose 8.3 MB of weights
// do not stay in L1 (though faster for K2's narrower towers).
//
// Layouts. Activations are rows of C floats, padded to LD = C + 4 in shared
// memory: a fragment's 8 rows x 4 channels then fall on 32 distinct banks.
// Weights come in mma fragment order (built once per weight version by the
// wrapper): for each tap, each k-step ks of 8 input channels and each block
// nf of 8 output channels, 64 floats in which lane l holds w[ks*8 + l%4]
// [nf*8 + l/4] and w[ks*8 + l%4 + 4][nf*8 + l/4] side by side, so that a
// warp's B fragment is one coalesced 256-byte load. K1 and K2 read the B
// fragments straight from L2 (through L1, one k-step ahead) instead of
// staging them in shared memory: at C = 128 one tap is 64 KB, and every byte
// of shared memory is spent on the tile's rows, which set the halo
// recompute. A kernel may instead stage each conv's fragments, split once,
// in shared memory (BShared; resblock.cu at C <= 32, whose one-tower halo is
// small).
//
// The tower sum goes to float32 rows in global memory the block owns
// (tower 1 stores, later towers load, add and store; for a float32 output
// these are the output rows themselves), the last tower's mean to the
// output, or, with conv_post, to a shared buffer over the tile plus
// conv_post's halo. Every row is written by one thread of one block: no
// atomics, bitwise repeatable.
//
// bf16 inference runs on the bf16 tile of mrf_bf16.cuh (K1, K2, K3), which
// shares this tile's items, halos, tower sums and cost model.
#pragma once

#include <cstdint>

#include "mrf_common.cuh"
#include "tc_common.cuh"

namespace zv {
namespace tc {

constexpr int NT = 512;  // threads per block (K1, K2)
constexpr int NWARP = NT / 32;
constexpr int MF = 2;    // 16-row m fragments of a warp's item: 32 rows

__host__ __device__ constexpr int warp_cols(int co) { return co < 32 ? co : 32; }

__device__ __forceinline__ float2 leaky2(float2 v, float slope) {
  return make_float2(leaky(v.x, slope), leaky(v.y, slope));
}

__device__ __forceinline__ float2& at2(float* p) { return *reinterpret_cast<float2*>(p); }

__device__ __forceinline__ float2 add2(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }

// Where a conv's B fragments come from: `fetch(i)` reads lane-fragment i
// (fragment order, 32 a warp), `frag` gives its hi and lo TF32 halves.
// BGlobal: the float32 buffer through L1 from L2, split at each k-step.
struct BGlobal {
  const float2* w;
  __device__ __forceinline__ float2 fetch(size_t i) const { return __ldg(w + i); }
  __device__ __forceinline__ static void frag(float2 f, uint32_t (&h)[2], uint32_t (&l)[2]) {
    split(f.x, h[0], l[0]);
    split(f.y, h[1], l[1]);
  }
};

// BShared: staged in shared memory already split, {hi.x, hi.y, lo.x, lo.y}
// a lane-fragment.
struct BShared {
  const uint4* w;
  __device__ __forceinline__ uint4 fetch(size_t i) const { return w[i]; }
  __device__ __forceinline__ static void frag(uint4 f, uint32_t (&h)[2], uint32_t (&l)[2]) {
    h[0] = f.x;
    h[1] = f.y;
    l[0] = f.z;
    l[1] = f.w;
  }
};

__device__ __forceinline__ BGlobal l2_weights(const float* w) {
  return BGlobal{reinterpret_cast<const float2*>(w)};
}

// The weights of mrf_tile's convs, read from L2 (K1, K2).
struct L2Weights {
  __device__ __forceinline__ BGlobal operator()(const float* w, int /*k*/) const {
    return l2_weights(w);
  }
};

// The rows of one GEMM: output m (0 <= m < M) is window row o0 + os * m and
// reads, for tap t, shared row a0 + m + (t - half) * dil.
struct Rows {
  int M, o0, os, a0, half, dil;
};

// out[m][co] = bias[co] + sum_t sum_ci f(src[a0 + m + (t - half) dil][ci]) *
// w[t][ci][co] over `ntaps` taps, f the leaky relu (slope 0.1) when
// LEAKY_IN; src has CI + 4 floats a row, ws holds w in fragment order.
// epi(row, co, value) takes two finished neighbouring channels. NW warps
// take the items in turn.
template <int CI, int CO, bool LEAKY_IN, int NW = NWARP, class BSrc, class Epi>
__device__ void conv_tc(const float* src, BSrc ws, const float* __restrict__ bias, int ntaps,
                        Rows rw, Epi epi) {
  constexpr int LDI = CI + 4;
  constexpr int KS = CI / 8, NF = CO / 8;
  constexpr int NFW = warp_cols(CO) / 8;  // n fragments of a warp's item
  constexpr int NSL = NF / NFW;           // items across the channels
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
    // float offsets of the fragment rows g and g + 8 at tap offset 0; rows
    // past M (ragged last item) read row M - 1 and are not stored
    int ra[MF][2];
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ra[i][h] = (rw.a0 + min(m0 + i * 16 + g + 8 * h, rw.M - 1)) * LDI + t4;
    const size_t wl = (size_t)nf0 * 32 + lane;
    using Frag = decltype(ws.fetch(0));
    Frag bn[NFW];  // B of the next k-step, loaded one step ahead
#pragma unroll
    for (int j = 0; j < NFW; ++j) bn[j] = nk > 0 ? ws.fetch(wl + j * 32) : Frag{};
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t bh[NFW][2], bl[NFW][2];
#pragma unroll
      for (int j = 0; j < NFW; ++j) BSrc::frag(bn[j], bh[j], bl[j]);
      if (kk + 1 < nk) {
#pragma unroll
        for (int j = 0; j < NFW; ++j) bn[j] = ws.fetch(wl + ((size_t)(kk + 1) * NF + j) * 32);
      }
      const int tap = kk / KS, ks = kk - tap * KS;
      const float* at = src + (tap - rw.half) * rw.dil * LDI + ks * 8;
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        float av[4] = {at[ra[i][0]], at[ra[i][1]], at[ra[i][0] + 4], at[ra[i][1] + 4]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(LEAKY_IN ? leaky(av[e], 0.1f) : av[e], ah[e], al[e]);
#pragma unroll
        for (int j = 0; j < NFW; ++j) {
          mma(acc[i][j], al, bh[j]);
          mma(acc[i][j], ah, bl[j]);
          mma(acc[i][j], ah, bh[j]);
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

// A plain 'same' conv over window rows [lo, hi).
inline __device__ Rows same_rows(int lo, int hi, int k, int dil) {
  return Rows{hi - lo, lo, 1, lo, (k - 1) / 2, dil};
}

// Where the finished MRF mean of a window row goes. TO: the output's
// element type (float or bf16).
template <class TO>
struct TileOut {
  TO* gout;          // global [B][T][C] output, the mean over towers; or
  float* acc;        // (gout == nullptr) shared rows [HW - P, HW + TT + P)
  float post_slope;  // leaky slope applied to the mean kept in acc
  float* gsum;       // global float32 [B][T][C] partial tower sums (gout itself for a
                     // float output; unused with one tower)
};

// All towers of one MRF stage over one tile. `load(lo, hi)` fills window
// rows [lo, hi) of A with the stage input (zero outside [0, T)) and must
// leave Bf free; the mean over towers of rows [HW - P, HW + TT + P) goes to
// `o`. A and Bf hold W = TT + 2 HW rows of C + 4 floats. Weights: tower by
// tower, w1 [P][k] then w2 [P][k] taps in fragment order; biases b1 [P][C]
// then b2 [P][C]. `weights(w, k)`, called by every thread between convs
// (after the block's barrier), gives the B source of the conv whose k taps
// start at w.
template <int C, int NW = NWARP, class Load, class Weights = L2Weights>
__device__ void mrf_tile(float* A, float* Bf, const MrfParams& p, int HW, int TT, int P,
                         int tbase, int T, size_t gout_row0, const TileOut<float>& o, Load load,
                         Weights weights = {}) {
  constexpr int LD = C + 4;
  const int f_lo = HW - P, f_hi = HW + TT + P;
  auto valid = [&](int r) { return (unsigned)(tbase + r) < (unsigned)T; };
  size_t wofs = 0, bofs = 0;
  for (int j = 0; j < p.n_towers; ++j) {
    const int k = p.ks[j];
    const int half = (k - 1) / 2;
    const size_t conv_w = (size_t)k * C * C;
    int ext = tower_halo(k, p);
    load(f_lo - ext, f_hi + ext);
    __syncthreads();
    const float* w1 = p.w + wofs;
    const float* w2 = w1 + p.n_pairs * conv_w;
    const float* b1 = p.b + bofs;
    const float* b2 = b1 + (size_t)p.n_pairs * C;
    for (int q = 0; q < p.n_pairs; ++q) {
      const int e1 = ext - half * p.dils[q];
      conv_tc<C, C, true, NW>(A, weights(w1 + q * conv_w, k), b1 + q * C, k,
                          same_rows(f_lo - e1, f_hi + e1, k, p.dils[q]),
                          [&](int r, int co, float2 v) {
                            if (!valid(r)) v = make_float2(0.f, 0.f);
                            at2(Bf + r * LD + co) = leaky2(v, 0.1f);
                          });
      __syncthreads();
      const int e2 = e1 - half;
      if (q + 1 < p.n_pairs) {
        conv_tc<C, C, false, NW>(Bf, weights(w2 + q * conv_w, k), b2 + q * C, k,
                                 same_rows(f_lo - e2, f_hi + e2, k, 1),
                             [&](int r, int co, float2 v) {
                               float2& d = at2(A + r * LD + co);
                               d = valid(r) ? add2(d, v) : make_float2(0.f, 0.f);
                             });
      } else {
        const bool first = j == 0, last = j + 1 == p.n_towers;
        const float n = (float)p.n_towers;
        conv_tc<C, C, false, NW>(Bf, weights(w2 + q * conv_w, k), b2 + q * C, k,
                                 same_rows(f_lo, f_hi, k, 1),
                             [&](int r, int co, float2 v) {
          float2 t = valid(r) ? add2(at2(A + r * LD + co), v) : make_float2(0.f, 0.f);
          if (o.gout != nullptr) {
            if (!valid(r)) return;
            const size_t at = (gout_row0 + (size_t)(tbase + r)) * C + co;
            if (!first) t = add2(at2(o.gsum + at), t);
            if (last)
              store2(o.gout + at, make_float2(t.x / n, t.y / n));
            else
              at2(o.gsum + at) = t;
            return;
          }
          float2& s = at2(o.acc + (r - f_lo) * LD + co);
          if (!first) t = add2(s, t);
          s = last ? leaky2(make_float2(t.x / n, t.y / n), o.post_slope) : t;
        });
      }
      __syncthreads();
      ext = e2;
    }
    wofs += 2 * p.n_pairs * conv_w;
    bofs += (size_t)2 * p.n_pairs * C;
  }
}

// ---- host: the tile size

// Rounds of warp items (all nw warps busy) of one GEMM of `rows` output rows.
inline long gemm_rounds(int rows, int co, int nw = NWARP) {
  const long items = (long)((rows + 16 * MF - 1) / (16 * MF)) * (co / warp_cols(co));
  return (items + nw - 1) / nw;
}

// The MMA work of one tile's towers, in warp-item k-steps of `kstep` input
// channels (8 for the TF32 MMAs, 16 for the bf16 ones of mrf_bf16.cuh, C = 8
// padded to one): every conv over the rows it computes (the tile, conv_post's
// halo P and what later convs still need), rounded up to whole rounds of
// items of nw warps.
template <class E>
inline long towers_cost(const MrfParamsT<E>& p, int C, int TT, int P, int nw = NWARP,
                        int kstep = 8) {
  long cost = 0;
  for (int j = 0; j < p.n_towers; ++j) {
    const int k = p.ks[j], half = (k - 1) / 2;
    int ext = tower_halo(k, p);
    for (int q = 0; q < p.n_pairs; ++q) {
      const int e1 = ext - half * p.dils[q], e2 = e1 - half;
      cost += (gemm_rounds(TT + 2 * P + 2 * e1, C, nw) + gemm_rounds(TT + 2 * P + 2 * e2, C, nw)) * k;
      ext = e2;
    }
  }
  return cost * ((C + kstep - 1) / kstep);
}

// The tile (rows, a multiple of 4) that minimises waves x per-block cost
// among those whose shared memory, smem_of(TT) bytes, fits the budget; the
// waves are of `slots` blocks at a time (one per SM, or more where they fit
// together) over B x ceil(T / TT) blocks. Returns 0 if none fits.
template <class SmemOf, class CostOf>
inline int choose_tile(int T, int B, int slots, SmemOf smem_of, CostOf cost_of, int* smem_bytes,
                       long budget = SMEM_BUDGET) {
  int best = 0;
  double best_cost = 0.0;
  for (int TT = 16; TT <= 4096; TT += 4) {
    const long bytes = smem_of(TT);
    if (bytes > budget) break;
    const long blocks = (long)B * ((T + TT - 1) / TT);
    const double c = (double)((blocks + slots - 1) / slots) * (double)cost_of(TT);
    if (best == 0 || c < best_cost) {
      best = TT;
      best_cost = c;
      *smem_bytes = (int)bytes;
    }
    if (TT >= T) break;
  }
  return best;
}

inline int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

}  // namespace tc
}  // namespace zv
