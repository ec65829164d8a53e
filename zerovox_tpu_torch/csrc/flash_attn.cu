// Flash attention for Hopper (sm_90a): kernel K5, the FS2 encoder's and
// decoder's self-attention under ZEROVOX_ATTN=flash, forward and backward.
//
//   o = softmax(scale * q k^T + mask) v,   mask[i][j] = 0 where seg[i] == seg[j],
//                                          else MASK (the library's finite
//                                          DEFAULT_MASK_VALUE)
//
// over q, k, v [B, H, L, d] (any strides with the head dim contiguous; the
// model passes views of its [B, L, H, d] projections), segment ids [B, L]
// int32 (pads form their own segment), float32 or bf16 in and out, float32
// inside. The forward also writes lse [B, H, L] = the float32 log-sum-exp of
// each row's masked scores; the backward recomputes P from it.
//
// Replaces the TPU kernels that zerovox_tpu/models/fs2.py (MultiHeadAttention,
// its ZEROVOX_ATTN=flash branch) reaches through
// jax.experimental.pallas.ops.tpu.flash_attention: the forward (its
// _flash_attention_kernel), dK/dV (_flash_attention_dkv_kernel) and dQ
// (_flash_attention_dq_kernel). As there, D = rowsum(dO * O) is computed
// outside the kernels (ops/flash_attention.py), P is rounded to the input
// type before P.V, and dS before dS.Q and dS.K.
//
// What bounds it on an H100: tensor-core operations at the model's shapes
// (d = 264 for tts_medium, 256 for tts_medium_tpu): the forward does
// 4 B H L^2 d FLOP (two products), the backward 10 B H L^2 d (five: S and dP
// recomputed, dV, dK, dQ), against 4 B H L d elements in and out; at
// [24, 2, 512, 264] that is 13.3 / 33.2 GFLOP against 27-54 MB, 250-600
// FLOP a byte. The float32 path runs every product in 3xTF32 (tc_common.cuh,
// as K1-K4: three TF32 MMAs a product, float32-accurate), the bf16 path
// mma.sync.m16n8k16 with float32 accumulation.
//
// Design, a first kernel that is right and simple (no wgmma, TMA or warp
// specialisation yet): 8 warps a block; the tiles of one block sit in shared
// memory as rows of the head dim (padded so that a warp's fragment loads
// fall on distinct banks); each of the two products a step is a warp GEMM
// on mma.sync:
//   * forward, one block per (query tile of BQ rows, head, batch row): for
//     each key tile of BK = 32 rows, S = scale Q K^T + mask into shared
//     memory, the online softmax row by row (256 / BQ threads a row, the
//     running max and sum in their registers), P and each row's correction
//     into shared memory, then O = alpha O + P V with O in registers (warps
//     split O's rows in 16s and its columns in n-tiles of 8). BQ is the
//     largest of 64, 32, 16 that still gives every SM a block (zv_flash_fwd_tile):
//     the serving decoder (B = 1, H = 2, L = 1024) has only 32 query tiles of
//     64 rows for 132 SMs, and takes 16-row tiles (128 blocks);
//   * dK/dV, one block per (key tile of 32 rows, head, batch row), looping
//     over query tiles of 32: S^T = K Q^T and dP^T = V dO^T in the same warp
//     tile, P^T = exp(S^T - lse) and dS^T = P^T (dP^T - D) scale into shared
//     memory, then dV += P^T dO and dK += dS^T Q in registers;
//   * dQ, one block per (query tile of 32 rows, head, batch row), looping
//     over key tiles of 32: S and dP, dS into shared memory, dQ += dS K.
// Neither backward kernel uses atomics: each output row belongs to one
// block, so a step is bitwise repeatable. At d = 264 the float32 tiles take
// 146-156 KB of shared memory (one or two blocks an SM), the bf16 tiles
// half. bf16 pads the head dim to 16 (264 -> 272) with zeros in shared
// memory; TF32's k = 8 divides every supported d.
//
// Supported: d a multiple of 8 up to DMAX = 272, L a multiple of 64, every
// tensor's base 16-byte aligned and its batch, head and row strides
// multiples of 16 bytes. Anything else returns cudaErrorInvalidValue (the
// wrapper checks first and says why).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

#include "tc_common.cuh"

namespace zv {
namespace fa {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int DMAX = 272;            // the largest head dim
constexpr int NT_MAX = DMAX / 8;     // n-tiles of 8 columns in an output row
constexpr int BK = 32;               // forward: key rows a step
constexpr int BB = 32;               // backward: rows of a block's tile and of a step
constexpr int L_MULTIPLE = 64;
constexpr float MASK = -0.7f * FLT_MAX;  // the library's DEFAULT_MASK_VALUE

// ---- the two element types: fragments from shared memory and the product

// float32: 3xTF32 m16n8k8 (operands split into hi/lo TF32 halves at the load).
struct F32 {
  using T = float;
  static constexpr int KS = 8;    // k of one MMA
  static constexpr int PAD = 4;   // row padding (elements): a row is 4 mod 8 words
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  // A (16 x 8) at s[row * ld + k0 + col]
  static __device__ __forceinline__ void load_a(A& a, const float* s, int ld, int k0, int g, int t) {
    const float* p = s + g * ld + k0 + t;
    tc::split(p[0], a.hi[0], a.lo[0]);
    tc::split(p[8 * ld], a.hi[1], a.lo[1]);
    tc::split(p[4], a.hi[2], a.lo[2]);
    tc::split(p[8 * ld + 4], a.hi[3], a.lo[3]);
  }
  // B (8 x 8) with B[k][n] = s[n * ld + k0 + k]: the rows of s are the
  // product's columns (the second operand of Q K^T)
  static __device__ __forceinline__ void load_b_nt(B& b, const float* s, int ld, int k0, int g, int t) {
    const float* p = s + g * ld + k0 + t;
    tc::split(p[0], b.hi[0], b.lo[0]);
    tc::split(p[4], b.hi[1], b.lo[1]);
  }
  // B (8 x 8) with B[k][n] = s[(k0 + k) * ld + n] (the second operand of P V)
  static __device__ __forceinline__ void load_b_nn(B& b, const float* s, int ld, int k0, int g, int t) {
    const float* p = s + (k0 + t) * ld + g;
    tc::split(p[0], b.hi[0], b.lo[0]);
    tc::split(p[4 * ld], b.hi[1], b.lo[1]);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    tc::mma(d, a.lo, b.hi);
    tc::mma(d, a.hi, b.lo);
    tc::mma(d, a.hi, b.hi);
  }
  static __device__ __forceinline__ float cast(float x) { return x; }
  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

// bf16: m16n8k16, float32 accumulation.
struct BF16 {
  using T = bf16;
  static constexpr int KS = 16;
  static constexpr int PAD = 8;   // a row is 4 mod 8 words
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  static __device__ __forceinline__ uint32_t word(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ uint32_t pack(const bf16* lo, const bf16* hi) {
    return (uint32_t)__bfloat16_as_ushort(*lo) | ((uint32_t)__bfloat16_as_ushort(*hi) << 16);
  }
  static __device__ __forceinline__ void load_a(A& a, const bf16* s, int ld, int k0, int g, int t) {
    const bf16* p = s + g * ld + k0 + 2 * t;
    a.r[0] = word(p);
    a.r[1] = word(p + 8 * ld);
    a.r[2] = word(p + 8);
    a.r[3] = word(p + 8 * ld + 8);
  }
  static __device__ __forceinline__ void load_b_nt(B& b, const bf16* s, int ld, int k0, int g, int t) {
    const bf16* p = s + g * ld + k0 + 2 * t;
    b.r[0] = word(p);
    b.r[1] = word(p + 8);
  }
  static __device__ __forceinline__ void load_b_nn(B& b, const bf16* s, int ld, int k0, int g, int t) {
    const bf16* p = s + (k0 + 2 * t) * ld + g;
    b.r[0] = pack(p, p + ld);
    b.r[1] = pack(p + 8 * ld, p + 9 * ld);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    tc::mma16(d, a.r, b.r);
  }
  static __device__ __forceinline__ bf16 cast(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ void store2(bf16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
};

// ---- shared memory: regions carved in order, each rounded to 16 bytes

struct Carve {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t at = off;
    off += (bytes + 15) & ~size_t(15);
    return at;
  }
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The head dim as the products see it (zero tail to a multiple of KS) and a
// tile row's length in shared memory.
template <class P>
__host__ __device__ int dk_of(int d) { return round_up(d, P::KS); }
template <class P>
__host__ __device__ int ld_of(int d) { return dk_of<P>(d) + P::PAD; }

template <class P, int BQ>
struct FwdSmem {
  size_t q, k, v, s, p, alpha, l, segq, segk, bytes;
  __host__ __device__ FwdSmem(int d) {
    using T = typename P::T;
    const size_t ld = ld_of<P>(d);
    Carve c;
    q = c.take(BQ * ld * sizeof(T));
    k = c.take(BK * ld * sizeof(T));
    v = c.take(BK * ld * sizeof(T));
    s = c.take(BQ * (BK + 4) * sizeof(float));
    p = c.take(BQ * (BK + P::PAD) * sizeof(T));
    alpha = c.take(BQ * sizeof(float));
    l = c.take(BQ * sizeof(float));
    segq = c.take(BQ * sizeof(int));
    segk = c.take(BK * sizeof(int));
    bytes = c.off;
  }
};

// Both backward kernels: four tiles of BB rows (dK/dV: K, V, Q, dO; dQ: Q,
// dO, K, V), two BB x BB tiles of P or dS, and BB floats of lse, D and
// segment ids for the query rows, BB segment ids for the key rows.
template <class P>
struct BwdSmem {
  size_t t0, t1, t2, t3, p0, p1, lse, dsum, segq, segk, bytes;
  __host__ __device__ BwdSmem(int d) {
    using T = typename P::T;
    const size_t ld = ld_of<P>(d);
    Carve c;
    t0 = c.take(BB * ld * sizeof(T));
    t1 = c.take(BB * ld * sizeof(T));
    t2 = c.take(BB * ld * sizeof(T));
    t3 = c.take(BB * ld * sizeof(T));
    p0 = c.take(BB * (BB + P::PAD) * sizeof(T));
    p1 = c.take(BB * (BB + P::PAD) * sizeof(T));
    lse = c.take(BB * sizeof(float));
    dsum = c.take(BB * sizeof(float));
    segq = c.take(BB * sizeof(int));
    segk = c.take(BB * sizeof(int));
    bytes = c.off;
  }
};

// rows x d elements from global rows `stride` apart into shared rows of ld,
// 16 bytes a thread, with the zero tail [d, dk) that bf16's k = 16 reads.
template <class T>
__device__ __forceinline__ void load_tile(T* s, int ld, const T* g, int stride, int rows, int d,
                                          int dk) {
  constexpr int V = 16 / sizeof(T);
  const int nv = dk / V;
  for (int i = threadIdx.x; i < rows * nv; i += THREADS) {
    const int r = i / nv, c = (i - r * nv) * V;
    const uint4 x = c < d ? *reinterpret_cast<const uint4*>(g + (size_t)r * stride + c)
                          : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(s + r * ld + c) = x;
  }
}

__device__ __forceinline__ void load_seg(int* s, const int* seg, int rows) {
  if ((int)threadIdx.x < rows) s[threadIdx.x] = seg ? seg[threadIdx.x] : 0;
}

// One 16 x 8 tile of a product X Y^T over the head dim: X's rows at x (16
// of them), Y's at y (8), both rows of ld in shared memory.
template <class P>
__device__ __forceinline__ void tile_nt(float (&c)[4], const typename P::T* x,
                                        const typename P::T* y, int ld, int dk, int g, int t) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  for (int k0 = 0; k0 < dk; k0 += P::KS) {
    typename P::A a;
    typename P::B b;
    P::load_a(a, x, ld, k0, g, t);
    P::load_b_nt(b, y, ld, k0, g, t);
    P::mma(c, a, b);
  }
}

// acc (a warp's 16 rows x its n-tiles) += X Y: X 16 x kn at x (rows of ldx),
// Y kn x d at y (rows of ldy); the warp's n-tiles are wc, wc + nc, ...
template <class P, int NTW>
__device__ __forceinline__ void accumulate_nn(float (&acc)[NTW][4], const typename P::T* x,
                                              int ldx, const typename P::T* y, int ldy, int kn,
                                              int nt, int wc, int nc, int g, int t) {
  for (int k0 = 0; k0 < kn; k0 += P::KS) {
    typename P::A a;
    P::load_a(a, x, ldx, k0, g, t);
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const int n = wc + nc * i;
      if (n < nt) {
        typename P::B b;
        P::load_b_nn(b, y + n * 8, ldy, k0, g, t);
        P::mma(acc[i], a, b);
      }
    }
  }
}

// A warp's rows r0 + g and r0 + g + 8 of acc (times s0, s1) into global rows.
template <class P, int NTW>
__device__ __forceinline__ void store_rows(typename P::T* out, int stride, const float (&acc)[NTW][4],
                                           float s0, float s1, int nt, int wc, int nc, int g,
                                           int t) {
#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    const int n = wc + nc * i;
    if (n < nt) {
      typename P::T* p = out + (size_t)g * stride + n * 8 + 2 * t;
      P::store2(p, acc[i][0] * s0, acc[i][1] * s0);
      P::store2(p + (size_t)8 * stride, acc[i][2] * s1, acc[i][3] * s1);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* dsum;
  const int* seg;
  void* out0;   // forward: o;  dK/dV: dk;  dQ: dq
  void* out1;   // forward: lse; dK/dV: dv
  int B, H, L, d;
  int sb, sh, sl;  // strides (elements) of every [B, H, L, d] tensor
  float scale;
};

// ---- forward

template <class P, int BQ>
__global__ void __launch_bounds__(THREADS) fwd_kernel(Args a) {
  using T = typename P::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdSmem<P, BQ> lay(a.d);
  T* Qs = reinterpret_cast<T*>(smem + lay.q);
  T* Ks = reinterpret_cast<T*>(smem + lay.k);
  T* Vs = reinterpret_cast<T*>(smem + lay.v);
  float* Ss = reinterpret_cast<float*>(smem + lay.s);
  T* Ps = reinterpret_cast<T*>(smem + lay.p);
  float* alpha_s = reinterpret_cast<float*>(smem + lay.alpha);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  int* segq = reinterpret_cast<int*>(smem + lay.segq);
  int* segk = reinterpret_cast<int*>(smem + lay.segk);

  constexpr int SLD = BK + 4, PLD = BK + P::PAD;
  constexpr int RG = BQ / 16, NC = WARPS / RG, NTW = (NT_MAX + NC - 1) / NC;
  constexpr int STILES = RG * (BK / 8);
  constexpr int TPR = THREADS / BQ, CPT = BK / TPR;  // softmax: threads a row, columns a thread
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int d = a.d, dk = dk_of<P>(d), ld = ld_of<P>(d), nt = d / 8;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t base = (size_t)b * a.sb + (size_t)h * a.sh;
  const int* seg = a.seg ? a.seg + (size_t)b * a.L : nullptr;

  load_tile(Qs, ld, static_cast<const T*>(a.q) + base + (size_t)q0 * a.sl, a.sl, BQ, d, dk);
  load_seg(segq, seg ? seg + q0 : nullptr, BQ);

  const int srow = threadIdx.x / TPR, spart = threadIdx.x % TPR;
  float m_run = -INFINITY, l_run = 0.f;
  const int rg = warp % RG, wc = warp / RG;
  float acc[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < a.L; k0 += BK) {
    __syncthreads();  // the previous step is done with Ks, Vs, Ps
    load_tile(Ks, ld, static_cast<const T*>(a.k) + base + (size_t)k0 * a.sl, a.sl, BK, d, dk);
    load_tile(Vs, ld, static_cast<const T*>(a.v) + base + (size_t)k0 * a.sl, a.sl, BK, d, dk);
    load_seg(segk, seg ? seg + k0 : nullptr, BK);
    __syncthreads();
    // S = scale Q K^T + mask
    for (int i = warp; i < STILES; i += WARPS) {
      const int sr = i / (BK / 8), sc = i % (BK / 8);
      float c[4];
      tile_nt<P>(c, Qs + sr * 16 * ld, Ks + sc * 8 * ld, ld, dk, g, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = sr * 16 + g + 8 * (e >> 1), col = sc * 8 + 2 * t + (e & 1);
        Ss[r * SLD + col] = c[e] * a.scale + (segq[r] == segk[col] ? 0.f : MASK);
      }
    }
    __syncthreads();
    // online softmax: row srow, columns spart + TPR j
    {
      float s[CPT], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[j] = Ss[srow * SLD + spart + TPR * j];
        mx = fmaxf(mx, s[j]);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[j] - m_new);
        sum += p;
        Ps[srow * PLD + spart + TPR * j] = P::cast(p);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_run - m_new);  // 0 on the first step (m_run = -inf)
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (spart == 0) alpha_s[srow] = alpha;
    }
    __syncthreads();
    // O = alpha O + P V
    {
      const float a0 = alpha_s[rg * 16 + g], a1 = alpha_s[rg * 16 + g + 8];
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        acc[i][0] *= a0;
        acc[i][1] *= a0;
        acc[i][2] *= a1;
        acc[i][3] *= a1;
      }
      accumulate_nn<P, NTW>(acc, Ps + rg * 16 * PLD, PLD, Vs, ld, BK, nt, wc, NC, g, t);
    }
  }
  if (spart == 0) {
    l_s[srow] = l_run;
    static_cast<float*>(a.out1)[((size_t)b * a.H + h) * a.L + q0 + srow] = m_run + logf(l_run);
  }
  __syncthreads();
  const int r0 = rg * 16;
  store_rows<P, NTW>(static_cast<T*>(a.out0) + base + (size_t)(q0 + r0) * a.sl, a.sl, acc,
                     1.f / l_s[r0 + g], 1.f / l_s[r0 + g + 8], nt, wc, NC, g, t);
}

// ---- backward: one 16 x 8 tile of P (or P^T) and dS a warp, from S and dP
// at (row r, column col) of the tile; q-indexed values at qi, the pair of
// segment ids for the mask.
template <class P>
__device__ __forceinline__ void p_ds(const float (&s)[4], const float (&dp)[4], int sr, int sc,
                                     bool rows_are_keys, const float* lse, const float* dsum,
                                     const int* segq, const int* segk, float scale,
                                     typename P::T* p_out, typename P::T* ds_out, int pld, int g,
                                     int t) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = sr * 16 + g + 8 * (e >> 1), col = sc * 8 + 2 * t + (e & 1);
    const int qi = rows_are_keys ? col : r, ki = rows_are_keys ? r : col;
    const float x = s[e] * scale + (segq[qi] == segk[ki] ? 0.f : MASK);
    const float p = expf(x - lse[qi]);
    const float ds = p * (dp[e] - dsum[qi]) * scale;
    if (p_out) p_out[r * pld + col] = P::cast(p);
    ds_out[r * pld + col] = P::cast(ds);
  }
}

// dK and dV of one key tile: out0 = dk, out1 = dv.
template <class P>
__global__ void __launch_bounds__(THREADS) dkv_kernel(Args a) {
  using T = typename P::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem<P> lay(a.d);
  T* Ks = reinterpret_cast<T*>(smem + lay.t0);
  T* Vs = reinterpret_cast<T*>(smem + lay.t1);
  T* Qs = reinterpret_cast<T*>(smem + lay.t2);
  T* dOs = reinterpret_cast<T*>(smem + lay.t3);
  T* Pt = reinterpret_cast<T*>(smem + lay.p0);
  T* dSt = reinterpret_cast<T*>(smem + lay.p1);
  float* lse_s = reinterpret_cast<float*>(smem + lay.lse);
  float* dsum_s = reinterpret_cast<float*>(smem + lay.dsum);
  int* segq = reinterpret_cast<int*>(smem + lay.segq);
  int* segk = reinterpret_cast<int*>(smem + lay.segk);

  constexpr int PLD = BB + P::PAD;
  constexpr int RG = BB / 16, NC = WARPS / RG, NTW = (NT_MAX + NC - 1) / NC;
  static_assert(RG * (BB / 8) == WARPS, "one S tile a warp");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int d = a.d, dk = dk_of<P>(d), ld = ld_of<P>(d), nt = d / 8;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BB;
  const size_t base = (size_t)b * a.sb + (size_t)h * a.sh;
  const size_t rows = ((size_t)b * a.H + h) * a.L;
  const int* seg = a.seg ? a.seg + (size_t)b * a.L : nullptr;

  load_tile(Ks, ld, static_cast<const T*>(a.k) + base + (size_t)k0 * a.sl, a.sl, BB, d, dk);
  load_tile(Vs, ld, static_cast<const T*>(a.v) + base + (size_t)k0 * a.sl, a.sl, BB, d, dk);
  load_seg(segk, seg ? seg + k0 : nullptr, BB);

  const int sr = warp / (BB / 8), sc = warp % (BB / 8);  // this warp's S^T tile
  const int rg = warp % RG, wc = warp / RG;               // its rows and n-tiles of dK, dV
  float dk_acc[NTW][4], dv_acc[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int q0 = 0; q0 < a.L; q0 += BB) {
    __syncthreads();  // the previous step is done with Qs, dOs, Pt, dSt
    load_tile(Qs, ld, static_cast<const T*>(a.q) + base + (size_t)q0 * a.sl, a.sl, BB, d, dk);
    load_tile(dOs, ld, static_cast<const T*>(a.dout) + base + (size_t)q0 * a.sl, a.sl, BB, d, dk);
    if ((int)threadIdx.x < BB) {
      lse_s[threadIdx.x] = a.lse[rows + q0 + threadIdx.x];
      dsum_s[threadIdx.x] = a.dsum[rows + q0 + threadIdx.x];
    }
    load_seg(segq, seg ? seg + q0 : nullptr, BB);
    __syncthreads();
    {
      float s[4], dp[4];
      tile_nt<P>(s, Ks + sr * 16 * ld, Qs + sc * 8 * ld, ld, dk, g, t);    // S^T = K Q^T
      tile_nt<P>(dp, Vs + sr * 16 * ld, dOs + sc * 8 * ld, ld, dk, g, t);  // dP^T = V dO^T
      p_ds<P>(s, dp, sr, sc, true, lse_s, dsum_s, segq, segk, a.scale, Pt, dSt, PLD, g, t);
    }
    __syncthreads();
    accumulate_nn<P, NTW>(dv_acc, Pt + rg * 16 * PLD, PLD, dOs, ld, BB, nt, wc, NC, g, t);
    accumulate_nn<P, NTW>(dk_acc, dSt + rg * 16 * PLD, PLD, Qs, ld, BB, nt, wc, NC, g, t);
  }
  const size_t out = base + (size_t)(k0 + rg * 16) * a.sl;
  store_rows<P, NTW>(static_cast<T*>(a.out0) + out, a.sl, dk_acc, 1.f, 1.f, nt, wc, NC, g, t);
  store_rows<P, NTW>(static_cast<T*>(a.out1) + out, a.sl, dv_acc, 1.f, 1.f, nt, wc, NC, g, t);
}

// dQ of one query tile: out0 = dq.
template <class P>
__global__ void __launch_bounds__(THREADS) dq_kernel(Args a) {
  using T = typename P::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem<P> lay(a.d);
  T* Qs = reinterpret_cast<T*>(smem + lay.t0);
  T* dOs = reinterpret_cast<T*>(smem + lay.t1);
  T* Ks = reinterpret_cast<T*>(smem + lay.t2);
  T* Vs = reinterpret_cast<T*>(smem + lay.t3);
  T* dSs = reinterpret_cast<T*>(smem + lay.p0);
  float* lse_s = reinterpret_cast<float*>(smem + lay.lse);
  float* dsum_s = reinterpret_cast<float*>(smem + lay.dsum);
  int* segq = reinterpret_cast<int*>(smem + lay.segq);
  int* segk = reinterpret_cast<int*>(smem + lay.segk);

  constexpr int PLD = BB + P::PAD;
  constexpr int RG = BB / 16, NC = WARPS / RG, NTW = (NT_MAX + NC - 1) / NC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int d = a.d, dk = dk_of<P>(d), ld = ld_of<P>(d), nt = d / 8;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BB;
  const size_t base = (size_t)b * a.sb + (size_t)h * a.sh;
  const size_t rows = ((size_t)b * a.H + h) * a.L;
  const int* seg = a.seg ? a.seg + (size_t)b * a.L : nullptr;

  load_tile(Qs, ld, static_cast<const T*>(a.q) + base + (size_t)q0 * a.sl, a.sl, BB, d, dk);
  load_tile(dOs, ld, static_cast<const T*>(a.dout) + base + (size_t)q0 * a.sl, a.sl, BB, d, dk);
  if ((int)threadIdx.x < BB) {
    lse_s[threadIdx.x] = a.lse[rows + q0 + threadIdx.x];
    dsum_s[threadIdx.x] = a.dsum[rows + q0 + threadIdx.x];
  }
  load_seg(segq, seg ? seg + q0 : nullptr, BB);

  const int sr = warp / (BB / 8), sc = warp % (BB / 8);
  const int rg = warp % RG, wc = warp / RG;
  float acc[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < a.L; k0 += BB) {
    __syncthreads();  // the previous step is done with Ks, Vs, dSs
    load_tile(Ks, ld, static_cast<const T*>(a.k) + base + (size_t)k0 * a.sl, a.sl, BB, d, dk);
    load_tile(Vs, ld, static_cast<const T*>(a.v) + base + (size_t)k0 * a.sl, a.sl, BB, d, dk);
    load_seg(segk, seg ? seg + k0 : nullptr, BB);
    __syncthreads();
    {
      float s[4], dp[4];
      tile_nt<P>(s, Qs + sr * 16 * ld, Ks + sc * 8 * ld, ld, dk, g, t);    // S = Q K^T
      tile_nt<P>(dp, dOs + sr * 16 * ld, Vs + sc * 8 * ld, ld, dk, g, t);  // dP = dO V^T
      p_ds<P>(s, dp, sr, sc, false, lse_s, dsum_s, segq, segk, a.scale, nullptr, dSs, PLD, g, t);
    }
    __syncthreads();
    accumulate_nn<P, NTW>(acc, dSs + rg * 16 * PLD, PLD, Ks, ld, BB, nt, wc, NC, g, t);
  }
  store_rows<P, NTW>(static_cast<T*>(a.out0) + base + (size_t)(q0 + rg * 16) * a.sl, a.sl, acc,
                     1.f, 1.f, nt, wc, NC, g, t);
}

// ---- host side

template <class P>
bool supported(const Args& a) {
  const int v = 16 / (int)sizeof(typename P::T);  // elements in 16 bytes
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.out0, a.out1};
  for (const void* p : ptrs)
    if (p && reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return a.d % 8 == 0 && a.d >= 8 && a.d <= DMAX && a.L % L_MULTIPLE == 0 && a.L > 0 &&
         a.B > 0 && a.H > 0 && a.sb % v == 0 && a.sh % v == 0 && a.sl % v == 0;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

// The forward's query tile: the largest of 64, 32, 16 whose grid gives every
// SM a block.
int fwd_tile(int B, int H, int L, int sms) {
  if ((long long)B * H * (L / 64) >= sms) return 64;
  if ((long long)B * H * (L / 32) >= sms) return 32;
  return 16;
}

template <class K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, const Args& a, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

template <class P>
int fwd(const Args& a, void* stream) {
  if (!supported<P>(a) || !a.out1) return (int)cudaErrorInvalidValue;
  switch (fwd_tile(a.B, a.H, a.L, sm_count())) {
    case 64:
      return (int)launch(fwd_kernel<P, 64>, dim3(a.L / 64, a.H, a.B), FwdSmem<P, 64>(a.d).bytes,
                         a, stream);
    case 32:
      return (int)launch(fwd_kernel<P, 32>, dim3(a.L / 32, a.H, a.B), FwdSmem<P, 32>(a.d).bytes,
                         a, stream);
    default:
      return (int)launch(fwd_kernel<P, 16>, dim3(a.L / 16, a.H, a.B), FwdSmem<P, 16>(a.d).bytes,
                         a, stream);
  }
}

template <class P>
int dkv(const Args& a, void* stream) {
  if (!supported<P>(a) || !a.lse || !a.dsum || !a.out1) return (int)cudaErrorInvalidValue;
  return (int)launch(dkv_kernel<P>, dim3(a.L / BB, a.H, a.B), BwdSmem<P>(a.d).bytes, a, stream);
}

template <class P>
int dq(const Args& a, void* stream) {
  if (!supported<P>(a) || !a.lse || !a.dsum) return (int)cudaErrorInvalidValue;
  return (int)launch(dq_kernel<P>, dim3(a.L / BB, a.H, a.B), BwdSmem<P>(a.d).bytes, a, stream);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* dsum, const int* seg, void* out0, void* out1, int B, int H, int L,
               int d, int sb, int sh, int sl, float scale) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.dsum = dsum;
  a.seg = seg;
  a.out0 = out0;
  a.out1 = out1;
  a.B = B;
  a.H = H;
  a.L = L;
  a.d = d;
  a.sb = sb;
  a.sh = sh;
  a.sl = sl;
  a.scale = scale;
  return a;
}

}  // namespace fa
}  // namespace zv

using zv::fa::BF16;
using zv::fa::F32;

// q, k, v, o [B, H, L, d] sharing the strides (sb, sh, sl) in elements, the
// head dim contiguous; seg [B, L] int32 or null (no mask); lse [B, H, L]
// float32 contiguous. Each returns a cudaError_t.
extern "C" int zv_flash_fwd_f32(const float* q, const float* k, const float* v, float* o,
                                float* lse, const int* seg, int B, int H, int L, int d, int sb,
                                int sh, int sl, float scale, void* stream) {
  return zv::fa::fwd<F32>(zv::fa::make_args(q, k, v, nullptr, nullptr, nullptr, seg, o,
                                            lse, B, H, L, d, sb, sh, sl, scale), stream);
}

extern "C" int zv_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                                 const int* seg, int B, int H, int L, int d, int sb, int sh,
                                 int sl, float scale, void* stream) {
  return zv::fa::fwd<BF16>(zv::fa::make_args(q, k, v, nullptr, nullptr, nullptr, seg, o,
                                             lse, B, H, L, d, sb, sh, sl, scale), stream);
}

// dk, dv (shaped and strided as q) from q, k, v, dout (likewise), lse and
// dsum = rowsum(dout * o) [B, H, L] float32.
extern "C" int zv_flash_dkv_f32(const float* q, const float* k, const float* v, const float* dout,
                                const float* lse, const float* dsum, const int* seg, float* dk,
                                float* dv, int B, int H, int L, int d, int sb, int sh, int sl,
                                float scale, void* stream) {
  return zv::fa::dkv<F32>(zv::fa::make_args(q, k, v, dout, lse, dsum, seg, dk, dv, B, H,
                                            L, d, sb, sh, sl, scale), stream);
}

extern "C" int zv_flash_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* dsum, const int* seg, void* dk,
                                 void* dv, int B, int H, int L, int d, int sb, int sh, int sl,
                                 float scale, void* stream) {
  return zv::fa::dkv<BF16>(zv::fa::make_args(q, k, v, dout, lse, dsum, seg, dk, dv, B,
                                             H, L, d, sb, sh, sl, scale), stream);
}

// dq (shaped and strided as q).
extern "C" int zv_flash_dq_f32(const float* q, const float* k, const float* v, const float* dout,
                               const float* lse, const float* dsum, const int* seg, float* dq,
                               int B, int H, int L, int d, int sb, int sh, int sl, float scale,
                               void* stream) {
  return zv::fa::dq<F32>(zv::fa::make_args(q, k, v, dout, lse, dsum, seg, dq, nullptr, B,
                                           H, L, d, sb, sh, sl, scale), stream);
}

extern "C" int zv_flash_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* dsum, const int* seg, void* dq,
                                int B, int H, int L, int d, int sb, int sh, int sl, float scale,
                                void* stream) {
  return zv::fa::dq<BF16>(zv::fa::make_args(q, k, v, dout, lse, dsum, seg, dq, nullptr,
                                            B, H, L, d, sb, sh, sl, scale), stream);
}

// The forward's query tile (rows) for these sizes on the current device.
extern "C" int zv_flash_fwd_tile(int B, int H, int L) {
  return zv::fa::fwd_tile(B, H, L, zv::fa::sm_count());
}
