// Float32 FMA tile of the fused ResBlock1 kernel (resblock.cu): one time
// tile of a multi-receptive-field stage, all towers, with every
// intermediate activation in shared memory. The tower parameters and halo
// helpers are shared with the tensor-core tile of mrf.cu and
// upsample_stage.cu (mrf_tc.cuh).
//
// Layout: activations are rows of C floats (NLC, channels contiguous); in
// shared memory a row is padded to LD = C + 4 floats so that the row groups
// of a warp fall on different banks. Conv weights are taps (k, in, out),
// biases (C,). A tile covers TT output rows plus a halo of HW rows on each
// side ("window coordinates": window row r is sequence row tbase + r).
//
// Arithmetic is float32 FMA on the CUDA cores, summed over taps and then
// input channels. Rows outside [0, T) are zeroed after every conv, exactly
// as zero padding does in the unfused convolutions.
#pragma once

#include <cuda_runtime.h>

namespace zv {

constexpr int NT = 256;  // threads per block
constexpr int RM = 4;    // output rows per thread per pass
constexpr int RN = 4;    // output channels per thread (one float4)
constexpr int MAX_TOWERS = 3;
constexpr int MAX_PAIRS = 3;

struct MrfParams {
  int n_towers;
  int ks[MAX_TOWERS];     // kernel size of each tower
  int n_pairs;
  int dils[MAX_PAIRS];    // dilation of each pair's first conv (shared by towers)
  const float* w;         // tower j: w1 [P][k][C][C] then w2 [P][k][C][C]
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

// 'same' conv of window rows [lo, hi): out[r][co] = bias[co] +
// sum_tap sum_ci f(src[r + (tap - half) * dil][ci]) * w[tap][ci][co], with f
// the leaky relu (slope 0.1) when LEAKY_IN. Each thread owns RM rows x RN
// channels per pass; epi(r, co, value) stores one finished float4.
template <int C, int LD, bool LEAKY_IN, class Epi>
__device__ void conv_rows(const float* src, const float* __restrict__ w,
                          const float* __restrict__ bias, int k, int dil, int lo, int hi,
                          Epi epi) {
  constexpr int NCG = C / RN;
  constexpr int NRG = NT / NCG;
  constexpr int CHUNK = NRG * RM;
  static_assert(NT % NCG == 0, "channel groups must divide the block");
  const int cg = threadIdx.x % NCG;
  const int rg = threadIdx.x / NCG;
  const int co = cg * RN;
  const int half = (k - 1) / 2;
  const float4 bv = ldg4(bias + co);
  for (int base = lo; base < hi; base += CHUNK) {
    const int r0 = base + rg * RM;
    if (r0 >= hi) continue;
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    for (int tap = 0; tap < k; ++tap) {
      const int off = (tap - half) * dil;
      const float* a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        // rows past hi (ragged last pass) read a valid row and are not stored
        const int r = min(r0 + i, hi - 1);
        a[i] = src + (r + off) * LD;
      }
      const float* wt = w + (size_t)tap * C * C + co;
#pragma unroll 4
      for (int ci = 0; ci < C; ci += 4) {
        float4 av[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          av[i] = *reinterpret_cast<const float4*>(a[i] + ci);
          if (LEAKY_IN) av[i] = leaky4(av[i], 0.1f);
        }
        const float4 w0 = ldg4(wt + (ci + 0) * C);
        const float4 w1 = ldg4(wt + (ci + 1) * C);
        const float4 w2 = ldg4(wt + (ci + 2) * C);
        const float4 w3 = ldg4(wt + (ci + 3) * C);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float xs[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
          const float4 ws[4] = {w0, w1, w2, w3};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[i][0] = fmaf(xs[c], ws[c].x, acc[i][0]);
            acc[i][1] = fmaf(xs[c], ws[c].y, acc[i][1]);
            acc[i][2] = fmaf(xs[c], ws[c].z, acc[i][2]);
            acc[i][3] = fmaf(xs[c], ws[c].w, acc[i][3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = r0 + i;
      if (r < hi)
        epi(r, co, make_float4(acc[i][0] + bv.x, acc[i][1] + bv.y, acc[i][2] + bv.z,
                               acc[i][3] + bv.w));
    }
  }
}

// Where the finished MRF mean of a window row goes.
struct MrfOut {
  float* acc;       // shared, rows [HW - P, HW + TT + P) of the tower sum
  float* gout;      // global [B][T][C] output, or nullptr when `post` keeps it in acc
  float post_slope; // leaky slope applied to the mean kept in acc (post only)
};

// All towers of one MRF stage over one tile. `load(lo, hi)` fills window
// rows [lo, hi) of A with the stage input (zero outside [0, T)) and must
// leave Bf free; the mean over towers of rows [HW - P, HW + TT + P) goes to
// `o`. A and Bf hold W = TT + 2 HW rows, acc TT + 2 P rows.
template <int C, int LD, class Load>
__device__ void mrf_tile(float* A, float* Bf, const MrfParams& p, int HW, int TT, int P,
                         int tbase, int T, size_t gout_row0, const MrfOut& o, Load load) {
  const int f_lo = HW - P, f_hi = HW + TT + P;
  auto valid = [&](int r) { return (unsigned)(tbase + r) < (unsigned)T; };
  size_t wofs = 0, bofs = 0;
  for (int j = 0; j < p.n_towers; ++j) {
    const int k = p.ks[j];
    const int half = (k - 1) / 2;
    int ext = tower_halo(k, p);
    load(f_lo - ext, f_hi + ext);
    __syncthreads();
    const float* w1 = p.w + wofs;
    const float* w2 = w1 + (size_t)p.n_pairs * k * C * C;
    const float* b1 = p.b + bofs;
    const float* b2 = b1 + (size_t)p.n_pairs * C;
    for (int q = 0; q < p.n_pairs; ++q) {
      const int e1 = ext - half * p.dils[q];
      conv_rows<C, LD, true>(A, w1 + (size_t)q * k * C * C, b1 + q * C, k, p.dils[q],
                             f_lo - e1, f_hi + e1, [&](int r, int co, float4 v) {
                               if (!valid(r)) v = make_float4(0.f, 0.f, 0.f, 0.f);
                               at4(Bf + r * LD + co) = leaky4(v, 0.1f);
                             });
      __syncthreads();
      const int e2 = e1 - half;
      const float* w2q = w2 + (size_t)q * k * C * C;
      if (q + 1 < p.n_pairs) {
        conv_rows<C, LD, false>(Bf, w2q, b2 + q * C, k, 1, f_lo - e2, f_hi + e2,
                                [&](int r, int co, float4 v) {
                                  float4& d = at4(A + r * LD + co);
                                  d = valid(r) ? make_float4(d.x + v.x, d.y + v.y, d.z + v.z,
                                                             d.w + v.w)
                                               : make_float4(0.f, 0.f, 0.f, 0.f);
                                });
      } else {
        const bool first = j == 0, last = j + 1 == p.n_towers;
        conv_rows<C, LD, false>(Bf, w2q, b2 + q * C, k, 1, f_lo, f_hi,
                                [&](int r, int co, float4 v) {
          const float4 d = at4(A + r * LD + co);
          float4 t = valid(r) ? make_float4(d.x + v.x, d.y + v.y, d.z + v.z, d.w + v.w)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
          float4& s = at4(o.acc + (r - f_lo) * LD + co);
          if (!first) t = make_float4(s.x + t.x, s.y + t.y, s.z + t.z, s.w + t.w);
          if (!last) {
            s = t;
            return;
          }
          const float n = (float)p.n_towers;
          t = make_float4(t.x / n, t.y / n, t.z / n, t.w / n);
          if (o.gout == nullptr) {
            s = leaky4(t, o.post_slope);
          } else if (valid(r)) {
            at4(o.gout + (gout_row0 + (size_t)(tbase + r)) * C + co) = t;
          }
        });
      }
      __syncthreads();
      ext = e2;
    }
    wofs += (size_t)2 * p.n_pairs * k * C * C;
    bofs += (size_t)2 * p.n_pairs * C;
  }
}

constexpr int SMEM_BUDGET = 227 * 1024;

}  // namespace zv
