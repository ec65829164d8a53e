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
// recomputed, dV, dK, dQ; the two kernels compute S and dP each, seven in
// all), against 4 B H L d elements in and out; at [24, 2, 512, 264] that is
// 13.3 / 33.2 GFLOP against 27-54 MB, 250-600 FLOP a byte. The float32 path
// runs every product in 3xTF32 (tc_common.cuh, as K1-K4: three TF32 MMAs a
// product, float32-accurate), the bf16 forward mma.sync.m16n8k16 and the
// bf16 backward wgmma, with float32 accumulation. On this card
// mma.sync.m16n8k8 TF32 runs at ~320 TFLOP/s (scripts/bench_k5_breakdown.py),
// ~109 TFLOP/s of 3xTF32, and mma.sync.m16n8k16 bf16 at ~640.
//
// The forward (namespace fw; FlashAttention-2's layout). At the model's
// shapes it is bound by the tensor-core products and, in float32, by the
// integer and shared-memory work that feeds 3xTF32 (each operand split into
// hi and lo). A first forward that handed S and P to the softmax through
// shared memory, with four block barriers a step of keys, reached 10 % of
// the 3xTF32 bound at [24, 2, 512, 264]. What each choice does (times from
// scripts/bench_k5_breakdown.py on an NVIDIA H100 80GB HBM3 at 700 W, which
// also times the forward without each phase):
//   * S and P stay in registers. A block's 8 warps form 4 pairs; each pair
//     owns a row group of 16 query rows and a key group (below); its two
//     warps split the head dim: each computes S over its half of the head
//     dim, the halves are exchanged through shared memory (one pair barrier
//     a step, ~3 % of the float32 time) and summed, and each warp keeps the
//     online softmax's row max and sum in registers (quad shuffles) and O's
//     columns of its half (17 or 18 n-tiles: 68-72 floats a lane; a warp
//     holding a whole row of O at d = 264, 132 floats, would leave no room
//     for S's accumulators). O is rescaled only where a row max moved (a
//     warp vote; a scale of exactly 1 changes no bit). P's C fragments are
//     P.V's A fragments: in float32 by taking the keys of each 8-key block
//     in the order 2t, 2t + 1 (lane t's k and k + 4; V's B fragment is then
//     its rows 2t and 2t + 1), in bf16 by packing two 8-key n-tiles into one
//     m16n8k16 fragment (V by ldmatrix.trans).
//   * K and V by cp.async a step ahead into the other of two buffers, with
//     their segment ids: one block barrier a step of BK keys (float32 32,
//     bf16 64: 9 % faster than 32). Each thread walks its 16-byte chunks
//     without a division a chunk.
//   * S in float32: a warp's 16 x (its keys) strip, each Q fragment loaded
//     (8 bytes a row, register order) and split once a k-step for all of
//     them; the three 3xTF32 terms in their own accumulators, summed as
//     hh + (lh + hl). An operand's lo is left as x - hi: mma.sync reads a
//     TF32 operand's top 19 bits, so lo enters truncated (3 operations a
//     split; rounding lo as well: 34 % slower). bf16 takes Q and K by
//     ldmatrix.
//   * P.V in float32 splits V's B fragments PV_GROUP = 4 n-tiles at a time
//     and runs each 3xTF32 term over the group, so that no MMA waits on the
//     one before (one n-tile at a time, three chained MMAs each: 15 %
//     slower; all 17 at once: 21 % slower).
//   * Enough warps at the serving shapes. A block takes RG row groups (BQ =
//     16 RG query rows) and splits each row group's keys between KQ = 4 / RG
//     key groups: BQ is the largest of 64, 32, 16 whose grid gives every SM
//     a block (zv_flash_fwd_tile), so the serving decoder (B = 1, H = 2,
//     L = 1024: 128 query tiles of 16) runs 8 busy warps a block (32 rows
//     and 2 key groups: 44 % slower there). Key groups merge their m, l and
//     O by the log-sum-exp through shared memory at the end, in a fixed
//     order.
// Shared memory at d = 264, float32, BQ = 64: Q 67,584 bytes, two K and two
// V buffers 136,192, the S exchange 16,384: 220,672 bytes, one block an SM;
// at d = 272 231,424. Every step computes every key tile, masked or not, as
// the library kernel does. What bounds it now: at the training shape the
// two MMA phases take about a third of the float32 time each, the rest is
// the softmax, the exchange, the barriers and the copies (K and V come from
// L2 once for every 64 query rows).
//
// The bf16 backward (namespace wg; wgmma, float32 accumulation, TMA). A block
// owns BR = 64 output rows (dK/dV: keys, dQ: queries; one wgmma M), keeps
// them and their partner tile (K and V, or Q and dO) resident and streams
// the other side's rows, BS = 64 a step, with two warpgroups: dK/dV's first
// computes S^T = K Q^T, P^T and dV += P^T dO, its second dP^T = V dO^T,
// dS^T (P^T handed over through shared memory) and dK += dS^T Q, each
// gradient in 136 registers a thread (wgmma of N = 144 and 128 a k-step);
// dQ's first computes S and P, its second dP and dS, which it stores for
// both, and each takes its columns of dQ += dS K. Times below from
// scripts/bench_k5_breakdown.py on an NVIDIA H100 80GB HBM3 at 700 W at
// [24, 2, 512, 264], dK/dV / dQ; a first version (scalar B loads, register
// copies between three barriers a step, one 16 x 8 tile a warp) took
// 0.359-0.365 / 0.333-0.338 ms, these 0.143-0.145 / 0.139-0.141.
//   * The resident tiles as core matrices (8 rows x 16 bytes, 128
//     contiguous bytes) column chunk after column chunk, no swizzle (any
//     head dim up to 272; the pad chunks zero); the streamed ones as
//     16-column panels of 32-byte rows with TMA's 32-byte swizzle, which
//     wgmma reads both as a K-major B of S and dP (the head dim as k) and
//     as an MN-major B of the accumulations (rows as k): no tile is
//     transposed or copied twice.
//   * P^T and dS^T go from their accumulators to the accumulations' A as
//     registers (rounded to bf16 pairs), as the forward's P does; dQ's dS
//     through shared memory, since both warpgroups take it.
//   * The streamed tiles by TMA, one box a panel (16 columns x 64 rows of
//     one (b, h); the columns past d zero), issued by warp 0 while the S
//     wgmma run, completing on an mbarrier a buffer; their lse, D and
//     segment ids by cp.async. Boxes of one 16-byte chunk (8 columns, the
//     layout without swizzle; each 32-byte L2 sector fetched twice):
//     0.157 / 0.139; 16-byte cp.async from every thread: 0.177 / 0.156.
//   * S's first k-step runs with the wgmma's accumulator input off instead
//     of zeroing the registers, which ptxas serialised the wgmma behind
//     (0.167 / 0.147 before).
//   * One block an SM (226,832 bytes of shared memory; 222 and 151
//     registers, no spills).
// Measured and not taken: a redesign on mma.sync.m16n8k16
// (ldmatrix for every fragment, warp pairs splitting S's head dim, blocks of
// 32 rows, two an SM at 128 registers) 0.185 / 0.141; in it, 32-row blocks
// one an SM (183 registers) 0.239 / 0.190, 64-row blocks with 16 warps
// 0.219 / 0.146, with 8 warps 0.178 / 0.154. On wgmma: 32 streamed rows a
// step (half the shared memory) 0.178 / 0.171; clusters of two blocks
// sharing each streamed box by TMA multicast 0.165 / 0.151 against 0.168 /
// 0.148 (the cluster barrier a step costs what the halved L2 reads save);
// the accumulations waited for a step later, under the next S, 0.171 /
// 0.149 against 0.167 / 0.147 (ptxas serialises them).
// What bounds it now: taking out S and dP's wgmma saves 10 % / 16 %, the
// accumulations' 9 % / 12 %; fetching the streamed tiles for the first two
// steps only and computing on them again saves 24 % / 27 % (taking the
// fetch out altogether, on stale tiles, 32 % / 36 %); the rest is each
// warpgroup's S -> P or dS -> accumulation chain, the P handover and one
// block an SM. Every key tile is computed, masked or not, as the library
// does.
//
// The float32 backward (namespace tf). A first backward, the same kernels
// in float32 and bf16, reached 6.5 % of the bound in float32:
// shared-memory loads, operand splits and register shuffles, not the MMAs,
// set its pace. Each block still owns
// 32 output rows (dK/dV: keys, dQ: queries) and loops over the other side's
// tiles of 32 rows, 8 warps, one block an SM. What the design does about
// each cause (scripts/bench_k5_breakdown.py times each):
//   * Fragments in register order. S and dP take the head dim's k-steps in
//     the order 2t, 2t + 1 of each lane (the same products as t, t + 4), so
//     an A fragment row and a B fragment are one 8-byte load each; P^T, dS^T
//     and dS are written as m16n8k8 A fragments, split, hi[4] and lo[4] of
//     a lane in 16 bytes each. Rows are 8 or 24 mod 32 words, so no load
//     has a bank conflict. (hi, lo) pairs stored together cost ~5 register
//     moves an MMA to repack.
//   * Independent accumulators. S and dP keep their three 3xTF32 terms in
//     separate accumulators (warp tile 16 x 16: 6 MMAs a k-step, none
//     waiting on another), summed once as hh + (lh + hl).
//   * Copies off the critical path, without registers. The streamed tiles
//     (dK/dV: Q, dO; dQ: K, V) stay raw in two buffers; the next step's
//     come by cp.async into the other one, started at the top of the step,
//     with their lse, D and segment ids. Operands are split into TF32 hi
//     and lo at their fragment load: the integer work fits beside the MMAs,
//     while splitting each tile once into hi and lo planes as it landed
//     took a pass over shared memory and a barrier every step (8 % slower),
//     and a register prefetch of the next tiles (68-72 registers) spilled.
//   * Fewer barriers. dV += P^T dO (warps 0-3) starts once P^T is written;
//     dK += dS^T Q (warps 4-7, which wrote dS^T) waits only for them.
// Shared memory at d = 264: 220,160 bytes a block (two resident tiles
// 67,584, two buffers 135,168, P^T and dS^T 16,384, step vectors 1,024); at
// d = 272 232,448, all that a block may have. What
// bounds it now: the MMA phases themselves, near the shared-memory or
// integer throughput of the 16 x 16 warp tile. Measured slower: 16 warps a
// block with the head dim split between warp pairs, pairs of blocks (a
// cluster) splitting the head dim, 32 x 16 warp tiles.
// Neither backward kernel uses atomics: each output row belongs to one
// block, so a step is bitwise repeatable.
//
// The wide head dims on clusters (namespace cl: forward, dK/dV and dQ;
// float32, and bf16 below). At d = 272 the tuned kernels above hold
// whole rows of their tiles in shared memory and use all that a block may
// have. Above DMAX a float32 call launches thread block clusters of n =
// ceil(d / PART_MAX) blocks (PART_MAX = 264; n at most CLUSTER_MAX = 8, the
// portable cluster size, so d up to 2112), one cluster for each of the tuned
// kernel's blocks. Rank r
// of a cluster owns a contiguous part of the head dim (d's n-tiles of 8
// columns split as evenly as they go, the wider parts first: 528 -> 264 +
// 264, 280 -> 144 + 136, 1040 -> 264 + 264 + 256 + 256): the Q and K (dO
// and V) columns it multiplies for S (dP), and the output columns it owns
// (o; dK, dV; dQ). Each block is the tuned float32 kernel's block at its
// part (the forward fw's, its warp pairs splitting the part; the backward
// tf's; the forward is one template, float32 and bf16), except that S (and
// dP) over its part is a partial: every warp
// writes its partial tile to its block's exchange, the cluster barrier
// passes, and every warp reads the same tile of every rank's exchange
// through distributed shared memory (mapa + ld.shared::cluster, 16 bytes a
// lane) and sums them in rank order (the forward's pair halves summed first
// within each rank). So every rank holds bitwise the same S and dP, m and l
// (rank 0 writes lse), and no block computes S or dP over a part it does not
// own: S and dP are computed once across the cluster, each operand tile is
// read by the one block that owns its columns, and no atomics are needed.
// The exchange is one buffer, not two: at a part of 264 the forward's
// layout (BQ = 64) already takes 220,672 bytes, and a second 16,384-byte
// buffer would not fit (the backward's 228,352 bytes likewise with a second
// 8,192). So the cluster barrier is split: a step writes its partials after
// waiting on the arrival that every rank made once it had read the last
// step's, which leaves that wait under the next step's S. In the forward a
// warp pair first sums its two halves in its block's shared memory (fw's
// pair exchange, one pair barrier) and the cluster exchanges one partial a
// pair (8,192 bytes more at 64 rows: 228,864), and P.V of key tile j - 1
// runs between the arrival at step j's exchange barrier and the wait on it
// (V arrives a step after K; O sees the same operations in the same
// order). Times from scripts/bench_k5_breakdown.py
// --wide on an NVIDIA H100 80GB HBM3 at 700 W, [24, 1, 512, 528] / [1, 1,
// 1024, 528]: with neither 0.437 / 0.149 ms, each half's partial
// exchanged 0.426 / 0.145, P.V after the exchange 0.419 / 0.149, both
// 0.416 / 0.145. What bounds them now: the exchange and its exposed
// barrier, 19 % / 35 % of the forward (taken out: 0.339 / 0.095, fw's
// time at [24, 2, 512, 264]) and 16 % / 18 % of dK/dV / dQ (0.909 ->
// 0.767, 0.778 -> 0.635 ms at [24, 1, 512, 528]); the rest is fw's and
// tf's. Parts stop at 264, not 272: at 272 the backward's tiles take all
// of a block's shared memory and leave no room for its exchange.
//
// bf16 on clusters. A bf16 d above DMAX up to REACH_BF16 = 1408
// runs the forward above at parts of PART_MAX (fw's bf16 block: 64-key
// steps, Q and K by ldmatrix, V by ldmatrix.trans, P packed into m16n8k16 A
// fragments, rounded to bf16 as it is packed; a part's zero tail [pd, pd +
// 8) as fw's; 229,120 bytes at a part of 264, BQ = 64), and the backward on
// wg's block at parts of at most PART_BF16 = 176 columns (dkv_bf16_kernel,
// dq_bf16_kernel: two warpgroups, the streamed tiles by TMA into 32-byte
// swizzled panels at the rank's columns, P^T and dS^T as the
// accumulations' register A, no atomics; d = 528 on clusters of three).
// Its shared memory is the design question: wg's layout at 272 columns
// takes 226,832 bytes, and an exchange of the two warpgroups' float32
// partials of S^T and dP^T (64 x 64 each) needs 32,768 more. At parts of 176
// the resident tiles, streamed buffers, P handover and step vectors take
// 153,104 bytes (45,056 + 90,112 + 16,384 + 1,552), which leaves room for two
// exchange buffers by step parity (65,536: 218,640 in all): a step writes
// its partial to buffer j & 1 and sums the ranks' partials by a
// reduce-scatter and an all-gather (mapa + ld.shared::cluster, 16 bytes a
// lane, each piece summed in rank order by one rank; two cluster barriers),
// and no rank writes that buffer again before every rank has passed the
// next step's barriers, so the split barrier of the float32 kernels is not
// needed (one at the end keeps each block alive while others read it).
// Times from scripts/bench_k5_breakdown.py --wide on an NVIDIA H100 80GB
// HBM3 at 700 W, dK/dV / dQ at [24, 1, 512, 528]: 0.309 / 0.304 ms; every
// rank reading every rank's whole partial after one barrier (the first
// design, 24 remote pieces a thread a step against 11) 0.329 / 0.324. What
// bounds them now: the exchange, 42 % (taken out: 0.179 / 0.175; its
// remote reads 0.061 / 0.063, its barriers 0.069 / 0.065); the rest is
// wg's. The forward likewise spends 31 % in its exchange at [24, 1, 512,
// 528] (0.172 -> 0.119 ms without it, fw's time at [24, 2, 512, 264]); a
// pair's warps each summing half of S over the ranks and swapping halves
// was no faster (bf16 0.172 either way; float32 0.416 -> 0.427, spilling).
// A part of 264 with one buffer would take 251,904 bytes. Each rank's
// accumulations are one wgmma of N = 176 (dK/dV, 88 registers a thread)
// or 96 + 80 (dQ, by warpgroup); a part narrower than 176 computes the pad
// columns and stores none of them. Only the summation order of S and dP
// changes against wg: P and dS are rounded to bf16 where wg rounds them.
//
// The wide head dims otherwise (namespace wd: forward, dK/dV and dQ, float32
// and bf16 as one template on mma.sync): a head dim above its dtype's
// clusters' reach (float32 2112, bf16 1408) runs these kernels, whose shared
// memory and registers do not grow with d: a block owns BR = 64 output rows (4 warps of
// 16) and one column slice of its output (the forward's o and dQ 128
// columns, dK and dV 64: two accumulators), and streams the operands of S
// (and of dP) through shared memory in head-dim chunks of 128 bytes a row
// (32 float32 or 64 bf16 columns, the tail zero), two buffers by cp.async,
// a step ahead. S (and dP) accumulate over every chunk of a step's 64 rows;
// after the last chunk come the softmax (the forward's online, in the log2
// domain as fw), P and dS, and the slice's accumulation against the slice
// of V (dO and Q; K) that arrived under the step's chunks. P and dS stay in
// registers: their C fragments are the accumulation's A fragments, as fw's
// P (bf16: rounded as they are packed), so that no shared memory grows with
// them and two blocks an SM fit (at most 109,312 bytes a block). The grid is
// (row tiles x slices, H, B), one launch a kernel: S and dP are recomputed
// once a slice (at d = 528: 5 slices of o and dQ, 9 of dK/dV). Every slice
// computes S with the same instructions in the same order, so its m and l
// are bitwise those of the others; the slice at column 0 writes lse. No
// atomics: each output element belongs to one block.
//
// Supported: d a multiple of 8 (the wrapper zero-pads any other), L a
// multiple of 64, every tensor's base 16-byte aligned and its batch, head
// and row strides multiples of 16 bytes: d <= DMAX = 272 on fw, tf and wg,
// above it on cl (float32 up to 2112, bf16 up to 1408) and wd. Anything
// else returns cudaErrorInvalidValue (the wrapper checks first and says
// why).
#include <cuda.h>  // CUtensorMap (cuTensorMapEncodeTiled is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "tc_common.cuh"

namespace zv {
namespace fa {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int DMAX = 272;            // the largest head dim of fw, tf and wg (above: wd)
constexpr int NT_MAX = DMAX / 8;     // n-tiles of 8 columns in an output row
constexpr int L_MULTIPLE = 64;
constexpr float MASK = -0.7f * FLT_MAX;  // the library's DEFAULT_MASK_VALUE

// ---- the two element types: k of one MMA, row padding, fragments, stores

// float32: 3xTF32 m16n8k8 (operands split into hi/lo TF32 halves at the load);
// mma is 3xTF32's term order, lo.hi, hi.lo, hi.hi, as the float32 backward
// adds its terms into one accumulator.
struct F32 {
  using T = float;
  static constexpr int KS = 8;    // k of one MMA
  static constexpr int PAD = 4;   // row padding (elements): a row is 4 mod 8 words
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    tc::mma(d, a.lo, b.hi);
    tc::mma(d, a.hi, b.lo);
    tc::mma(d, a.hi, b.hi);
  }
  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

// bf16: m16n8k16, float32 accumulation.
struct BF16 {
  using T = bf16;
  static constexpr int KS = 16;
  static constexpr int PAD = 8;   // a row is 4 mod 8 words
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

__device__ __forceinline__ void load_seg(int* s, const int* seg, int rows) {
  if ((int)threadIdx.x < rows) s[threadIdx.x] = seg ? seg[threadIdx.x] : 0;
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

// ---- the float32 backward (3xTF32): raw tiles, the streamed ones copied by
// cp.async a step ahead into the other of two buffers, every fragment loaded
// in the register order of its MMA and split there. See the header for the
// design; namespace wg serves bf16.
namespace tf {

constexpr int TB = 32;            // rows of a block's resident tiles and of a step's streamed ones
constexpr int NTW_KV = 9;         // dK or dV n-tiles a warp: 4 warps cover 34
constexpr int NTW_Q = 5;          // dQ n-tiles a warp: 8 warps cover 34
constexpr int FRAG = 256;         // floats of one A fragment block: hi then lo, 4 a lane
constexpr int FRAGS = 2 * (TB / 8) * FRAG;  // a TB x TB matrix as A fragments (2 row groups)

// A row of a tile: ld(d) floats, 8 or 24 mod 32 words, so that a half warp's
// 8-byte loads (row g, columns 2t, 2t + 1) and a warp's 4-byte loads (row t,
// column g) fall on distinct banks, and rows stay 16-byte aligned.
__host__ __device__ inline int ld_of(int d) { return d % 16 == 0 ? d + 8 : d; }

// res0/res1: the block's resident tiles (dK/dV: K, V; dQ: Q, dO); buf[2]:
// the streamed tiles of a step (dK/dV: Q then dO; dQ: K then V), the next
// step's arriving in the other; pa: P^T (dK/dV only), pb: dS^T or dS, both
// as A fragments, pb also P from its S warp to its dP warp; lse, D and
// segment ids, two sets by step parity for the streamed rows (dK/dV: lse,
// D, segq; dQ: segk), the first set for the block's own rows.
struct Smem {
  size_t res0, res1, buf0, buf1, pa, pb, lse, dsum, segq, segk, bytes;
  __host__ __device__ Smem(int d) {
    const size_t tile = (size_t)TB * ld_of(d) * sizeof(float);
    Carve c;
    res0 = c.take(tile);
    res1 = c.take(tile);
    buf0 = c.take(2 * tile);
    buf1 = c.take(2 * tile);
    pa = c.take(FRAGS * sizeof(float));
    pb = c.take(FRAGS * sizeof(float));
    lse = c.take(2 * TB * sizeof(float));
    dsum = c.take(2 * TB * sizeof(float));
    segq = c.take(2 * TB * sizeof(int));
    segk = c.take(2 * TB * sizeof(int));
    bytes = c.off;
  }
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float2 split2(float x) {
  uint32_t hi, lo;
  tc::split(x, hi, lo);
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(tc::smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(tc::smem_u32(dst)), "l"(src)
               : "memory");
}

// Operands of S = X Y^T (or S^T), on the k-order 2t, 2t + 1 of each k-step
// (lane t's k and k + 4 of the MMA): the same products, each fragment row
// one 8-byte load already in register order, split here.
// A (16 x 8) at s[row * ld + k0 + k]
__device__ __forceinline__ void load_a_nt(F32::A& a, const float* s, int ld, int k0, int g,
                                          int t) {
  const float2 x0 = *reinterpret_cast<const float2*>(s + g * ld + k0 + 2 * t);
  const float2 x1 = *reinterpret_cast<const float2*>(s + (g + 8) * ld + k0 + 2 * t);
  tc::split(x0.x, a.hi[0], a.lo[0]);
  tc::split(x1.x, a.hi[1], a.lo[1]);
  tc::split(x0.y, a.hi[2], a.lo[2]);
  tc::split(x1.y, a.hi[3], a.lo[3]);
}
// B (8 x 8), B[k][n] = s[n * ld + k0 + k]
__device__ __forceinline__ void load_b_nt(F32::B& b, const float* s, int ld, int k0, int g,
                                          int t) {
  const float2 x = *reinterpret_cast<const float2*>(s + g * ld + k0 + 2 * t);
  tc::split(x.x, b.hi[0], b.lo[0]);
  tc::split(x.y, b.hi[1], b.lo[1]);
}
// B (8 x 8), B[k][n] = s[(k0 + k) * ld + n] (the natural k-order)
__device__ __forceinline__ void load_b_nn(F32::B& b, const float* s, int ld, int k0, int g,
                                          int t) {
  const float* p = s + (k0 + t) * ld + g;
  tc::split(p[0], b.hi[0], b.lo[0]);
  tc::split(p[4 * ld], b.hi[1], b.lo[1]);
}

// A TB x TB matrix (P^T, dS^T or dS) as A fragments: block (r, kk) holds rows
// 16 r.., columns 8 kk.., lane l's hi[0..3] at l * 4, its lo[0..3] at 128 + l * 4.
__device__ __forceinline__ void load_a_frag(F32::A& a, const float* x, int r, int kk, int lane) {
  const float* p = x + (r * (TB / 8) + kk) * FRAG + lane * 4;
  const uint4 h = *reinterpret_cast<const uint4*>(p);
  const uint4 l = *reinterpret_cast<const uint4*>(p + 128);
  a.hi[0] = h.x, a.hi[1] = h.y, a.hi[2] = h.z, a.hi[3] = h.w;
  a.lo[0] = l.x, a.lo[1] = l.y, a.lo[2] = l.z, a.lo[3] = l.w;
}
// element (row R, column C) of it, split
__device__ __forceinline__ void store_frag(float* x, int R, int C, float v) {
  const int rr = R & 15, cc = C & 7;
  float* p = x + ((R >> 4) * (TB / 8) + (C >> 3)) * FRAG + ((rr & 7) * 4 + (cc & 3)) * 4 +
             (rr >> 3) + 2 * (cc >> 2);
  const float2 hl = split2(v);
  p[0] = hl.x;
  p[128] = hl.y;
}

// Two tiles (TB rows of d floats each, global rows `stride` apart) by
// cp.async, 16 bytes a thread, to s0 and s1: a block's resident tiles, or a
// step's streamed ones into a buffer (s1 = s0 + TB ld).
__device__ __forceinline__ void copy2(float* s0, float* s1, int ld, const float* g0,
                                      const float* g1, int stride, int d) {
  const int nv = d / 4;
  for (int i = threadIdx.x; i < TB * nv; i += THREADS) {
    const int r = i / nv, c = (i - r * nv) * 4;
    cp_async16(s0 + r * ld + c, g0 + (size_t)r * stride + c);
    cp_async16(s1 + r * ld + c, g1 + (size_t)r * stride + c);
  }
}

// A warp's 16 x 16 tile of X Y^T over the head dim: X 16 rows of ld at x, Y
// 16 rows at y, both split at each fragment load. The three products of
// 3xTF32 go to their own accumulators, so that no MMA waits on the one
// before it, and are summed at the end as hh + (lh + hl).
__device__ __forceinline__ void s_tile(float (&s)[2][4], const float* x, const float* y, int ld,
                                       int d, int g, int t) {
  float lh[2][4], hl[2][4], hh[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) lh[n][e] = hl[n][e] = hh[n][e] = 0.f;
#pragma unroll 11
  for (int k0 = 0; k0 < d; k0 += 8) {
    F32::A a;
    load_a_nt(a, x, ld, k0, g, t);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      F32::B b;
      load_b_nt(b, y + n * 8 * ld, ld, k0, g, t);
      tc::mma(lh[n], a.lo, b.hi);
      tc::mma(hl[n], a.hi, b.lo);
      tc::mma(hh[n], a.hi, b.hi);
    }
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = hh[n][e] + (lh[n][e] + hl[n][e]);
}

// acc[r] (rows 16 r + g, + 8; n-tiles wc + nc i) += X Y: X TB x TB as A
// fragments at x, Y TB x d at y; each product adds lo.hi, hi.lo, hi.hi to
// its accumulator, the row groups interleaved.
template <int NTW>
__device__ __forceinline__ void accumulate(float (&acc)[2][NTW][4], const float* x, const float* y,
                                           int ld, int nt, int wc, int nc, int lane, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < TB / 8; ++kk) {
    F32::A a[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) load_a_frag(a[r], x, r, kk, lane);
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const int n = wc + nc * i;
      if (n < nt) {
        F32::B b;
        load_b_nn(b, y + n * 8, ld, kk * 8, g, t);
#pragma unroll
        for (int r = 0; r < 2; ++r) tc::mma(acc[r][i], a[r].lo, b.hi);
#pragma unroll
        for (int r = 0; r < 2; ++r) tc::mma(acc[r][i], a[r].hi, b.lo);
#pragma unroll
        for (int r = 0; r < 2; ++r) tc::mma(acc[r][i], a[r].hi, b.hi);
      }
    }
  }
}

// S (or S^T) and dP (or dP^T) of a step, then P and dS. Warp w takes tile
// (row group rg, column group cg) = ((w & 3) >> 1, w & 1) of S (w < 4) or
// dP. The S warps write P (dK/dV: P^T as A fragments to pa) and hand P to
// their dP partner through pb; the dP warps write dS (or dS^T) as A
// fragments to pb. Tile rows are keys when rows_are_keys, else queries;
// columns the other. On return P^T is complete; dS is complete once the dP
// warps (4-7) have passed a barrier.
__device__ __forceinline__ void s_p_ds(const float* xs, const float* xd, const float* ys,
                                       const float* yd, int ld, int d, bool rows_are_keys,
                                       const float* lse, const float* dsum, const int* segq,
                                       const int* segk, float scale, float* pa, float* pb,
                                       bool write_pt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = (warp & 3) >> 1, cg = warp & 1;
  const bool is_s = warp < 4;
  float s[2][4];
  s_tile(s, (is_s ? xs : xd) + rg * 16 * ld, (is_s ? ys : yd) + cg * 16 * ld, ld, d, g, t);
  const int r0 = rg * 16, c0 = cg * 16;
  float* xch = pb + (warp & 3) * 8 * 32 + lane;
  if (is_s) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1), c = c0 + n * 8 + 2 * t + (e & 1);
        const int qi = rows_are_keys ? c : r, ki = rows_are_keys ? r : c;
        const float x = s[n][e] * scale + (segq[qi] == segk[ki] ? 0.f : MASK);
        const float p = expf(x - lse[qi]);
        xch[(n * 4 + e) * 32] = p;
        if (write_pt) store_frag(pa, r, c, p);
      }
  }
  __syncthreads();  // P handed over
  if (!is_s) {
    float p[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = xch[(n * 4 + e) * 32];
    named_sync(1, 128);  // every dP warp has read P before pb is overwritten
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1), c = c0 + n * 8 + 2 * t + (e & 1);
        const int qi = rows_are_keys ? c : r;
        store_frag(pb, r, c, p[n][e] * (s[n][e] - dsum[qi]) * scale);
      }
  }
}

// dK and dV of one key tile of TB rows: out0 = dk, out1 = dv.
__global__ void __launch_bounds__(THREADS, 1) dkv_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay(a.d);
  float* Ks = reinterpret_cast<float*>(smem + lay.res0);
  float* Vs = reinterpret_cast<float*>(smem + lay.res1);
  float* Pt = reinterpret_cast<float*>(smem + lay.pa);
  float* dSt = reinterpret_cast<float*>(smem + lay.pb);
  int* segk = reinterpret_cast<int*>(smem + lay.segk);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int d = a.d, ld = ld_of(d), nt = d / 8;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * TB;
  const size_t base = (size_t)b * a.sb + (size_t)h * a.sh;
  const size_t rows = ((size_t)b * a.H + h) * a.L;
  const int* seg = a.seg ? a.seg + (size_t)b * a.L : nullptr;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* dout = static_cast<const float*>(a.dout) + base;

  // a step's Q, dO, lse, D and segment ids into buffer j & 1 (one group)
  const int lid = threadIdx.x;
  auto stage = [&](int j) {
    float* buf = reinterpret_cast<float*>(smem + ((j & 1) ? lay.buf1 : lay.buf0));
    const int q0 = j * TB, o = (j & 1) * TB;
    copy2(buf, buf + TB * ld, ld, q + (size_t)q0 * a.sl, dout + (size_t)q0 * a.sl, a.sl, d);
    if (lid < TB) {
      cp_async4(reinterpret_cast<float*>(smem + lay.lse) + o + lid, a.lse + rows + q0 + lid);
      cp_async4(reinterpret_cast<float*>(smem + lay.dsum) + o + lid, a.dsum + rows + q0 + lid);
      if (seg) cp_async4(reinterpret_cast<int*>(smem + lay.segq) + o + lid, seg + q0 + lid);
      else reinterpret_cast<int*>(smem + lay.segq)[o + lid] = 0;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  copy2(Ks, Vs, ld, static_cast<const float*>(a.k) + base + (size_t)k0 * a.sl,
        static_cast<const float*>(a.v) + base + (size_t)k0 * a.sl, a.sl, d);
  load_seg(segk, seg ? seg + k0 : nullptr, TB);
  stage(0);

  // dV += P^T dO (warps 0-3), dK += dS^T Q (4-7): both row groups, n-tiles
  // (w & 3) + 4 i
  const bool is_dv = warp < 4;
  float acc[2][NTW_KV][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < NTW_KV; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][i][e] = 0.f;

  const int steps = a.L / TB;
  for (int j = 0; j < steps; ++j) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // step j's tiles have arrived; step j - 1 is done with the other buffer
    if (j + 1 < steps) stage(j + 1);
    const float* Qs = reinterpret_cast<const float*>(smem + ((j & 1) ? lay.buf1 : lay.buf0));
    const float* dOs = Qs + TB * ld;
    const int o = (j & 1) * TB;
    // S^T = K Q^T, dP^T = V dO^T
    s_p_ds(Ks, Vs, Qs, dOs, ld, d, true, reinterpret_cast<const float*>(smem + lay.lse) + o,
           reinterpret_cast<const float*>(smem + lay.dsum) + o,
           reinterpret_cast<const int*>(smem + lay.segq) + o, segk, a.scale, Pt, dSt, true);
    if (is_dv) {
      accumulate(acc, Pt, dOs, ld, nt, warp & 3, 4, lane, g, t);
    } else {
      named_sync(2, 128);  // dS^T is complete
      accumulate(acc, dSt, Qs, ld, nt, warp & 3, 4, lane, g, t);
    }
  }
  float* out = static_cast<float*>(is_dv ? a.out1 : a.out0) + base + (size_t)k0 * a.sl;
  store_rows<F32, NTW_KV>(out, a.sl, acc[0], 1.f, 1.f, nt, warp & 3, 4, g, t);
  store_rows<F32, NTW_KV>(out + (size_t)16 * a.sl, a.sl, acc[1], 1.f, 1.f, nt, warp & 3, 4, g, t);
}

// dQ of one query tile of TB rows: out0 = dq.
__global__ void __launch_bounds__(THREADS, 1) dq_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay(a.d);
  float* Qs = reinterpret_cast<float*>(smem + lay.res0);
  float* dOs = reinterpret_cast<float*>(smem + lay.res1);
  float* dSs = reinterpret_cast<float*>(smem + lay.pb);
  float* lse_s = reinterpret_cast<float*>(smem + lay.lse);
  float* dsum_s = reinterpret_cast<float*>(smem + lay.dsum);
  int* segq = reinterpret_cast<int*>(smem + lay.segq);
  int* segk = reinterpret_cast<int*>(smem + lay.segk);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int d = a.d, ld = ld_of(d), nt = d / 8;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TB;
  const size_t base = (size_t)b * a.sb + (size_t)h * a.sh;
  const size_t rows = ((size_t)b * a.H + h) * a.L;
  const int* seg = a.seg ? a.seg + (size_t)b * a.L : nullptr;
  const float* kp = static_cast<const float*>(a.k) + base;
  const float* vp = static_cast<const float*>(a.v) + base;

  // a step's K, V and segment ids into buffer j & 1 (one group)
  const int lid = threadIdx.x;
  auto stage = [&](int j) {
    float* buf = reinterpret_cast<float*>(smem + ((j & 1) ? lay.buf1 : lay.buf0));
    const int k0 = j * TB, o = (j & 1) * TB;
    copy2(buf, buf + TB * ld, ld, kp + (size_t)k0 * a.sl, vp + (size_t)k0 * a.sl, a.sl, d);
    if (lid < TB) {
      if (seg) cp_async4(segk + o + lid, seg + k0 + lid);
      else segk[o + lid] = 0;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  copy2(Qs, dOs, ld, static_cast<const float*>(a.q) + base + (size_t)q0 * a.sl,
        static_cast<const float*>(a.dout) + base + (size_t)q0 * a.sl, a.sl, d);
  if (lid < TB) {
    lse_s[lid] = a.lse[rows + q0 + lid];
    dsum_s[lid] = a.dsum[rows + q0 + lid];
  }
  load_seg(segq, seg ? seg + q0 : nullptr, TB);
  stage(0);

  // dQ += dS K: both row groups, n-tiles w + 8 i
  float acc[2][NTW_Q][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < NTW_Q; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][i][e] = 0.f;

  const int steps = a.L / TB;
  for (int j = 0; j < steps; ++j) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // step j's tiles have arrived; step j - 1 is done with the other buffer
    if (j + 1 < steps) stage(j + 1);
    const float* Ks = reinterpret_cast<const float*>(smem + ((j & 1) ? lay.buf1 : lay.buf0));
    const float* Vs = Ks + TB * ld;
    // S = Q K^T, dP = dO V^T
    s_p_ds(Qs, dOs, Ks, Vs, ld, d, false, lse_s, dsum_s, segq, segk + (j & 1) * TB, a.scale,
           nullptr, dSs, false);
    __syncthreads();  // dS is complete
    accumulate(acc, dSs, Ks, ld, nt, warp, WARPS, lane, g, t);
  }
  float* out = static_cast<float*>(a.out0) + base + (size_t)q0 * a.sl;
  store_rows<F32, NTW_Q>(out, a.sl, acc[0], 1.f, 1.f, nt, warp, WARPS, g, t);
  store_rows<F32, NTW_Q>(out + (size_t)16 * a.sl, a.sl, acc[1], 1.f, 1.f, nt, warp, WARPS, g, t);
}

}  // namespace tf

// ---- the forward (FlashAttention-2's layout): see the header. Warp w is
// in pair u = w % PAIRS, head-dim half dh = w / PAIRS; pair u takes row
// group u % RG and key group u / RG.
namespace fw {

constexpr int PAIRS = WARPS / 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// A block of RG row groups: its key groups, query rows, key rows a step (32
// in float32, 64 in bf16), a key group's keys a step, S's n-tiles and O's
// n-tiles a warp (half a row; bf16 in pairs of n-tiles).
template <class P, int RG>
struct Tile {
  static constexpr int KQ = PAIRS / RG;
  static constexpr int BQ = 16 * RG;
  static constexpr int BK = imax(4 * P::KS, KQ * P::KS);
  static constexpr int KW = BK / KQ;
  static constexpr int NS = KW / 8;
  static constexpr int NTD = P::KS == 8 ? (NT_MAX + 1) / 2 : 2 * ((NT_MAX / 2 + 1) / 2);
};

// Row lengths in shared memory. float32: Q and K rows 8 or 24 mod 32 words
// (a half warp's 8-byte fragment loads on distinct banks), V rows 4 or 12
// mod 16 (a warp's 4-byte loads of rows 2t, 2t + 1 at column g on distinct
// banks). bf16: 16-byte rows an odd number of 16 bytes apart (ldmatrix).
template <class P>
__host__ __device__ int ld_qk(int d) { return P::KS == 8 ? tf::ld_of(d) : ld_of<P>(d); }
template <class P>
__host__ __device__ int ld_v(int d) { return P::KS == 8 ? d + 4 : ld_of<P>(d); }

// Q; two buffers of K and of V (after the last step: the partial O's of key
// groups 1.. as C fragments); the S exchange; segment ids of the query rows
// and of the two key tiles; each key group's row max and sum.
template <class P, int RG>
struct Smem {
  size_t q, k, v, xch, segq, segk, ml, bytes;
  __host__ __device__ Smem(int d) {
    using T = typename P::T;
    using C = Tile<P, RG>;
    Carve c;
    q = c.take((size_t)C::BQ * ld_qk<P>(d) * sizeof(T));
    k = c.take((size_t)2 * C::BK * ld_qk<P>(d) * sizeof(T));
    v = c.take((size_t)2 * C::BK * ld_v<P>(d) * sizeof(T));
    const size_t part = (size_t)RG * (C::KQ - 1) * 2 * C::NTD * 32 * 4 * sizeof(float);
    if (c.off < k + part) c.off = k + part;
    xch = c.take((size_t)WARPS * C::NS * 4 * 32 * sizeof(float));
    segq = c.take(C::BQ * sizeof(int));
    segk = c.take(2 * C::BK * sizeof(int));
    ml = c.take(C::KQ > 1 ? RG * C::KQ * 16 * 2 * sizeof(float) : 0);
    bytes = c.off;
  }
};

// 3xTF32's split for the forward: hi = rna_tf32(x), lo = x - hi as it is
// (the MMA reads its top 19 bits).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tc::to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// rows x d elements from global rows `stride` apart into shared rows of ld,
// by cp.async, 16 bytes a thread: each thread walks its chunks THREADS
// apart without a division a chunk
template <class T>
__device__ __forceinline__ void copy_rows(T* s, int ld, const T* g, int stride, int rows, int d) {
  constexpr int V = 16 / sizeof(T);
  const int nv = d / V, dr = THREADS / nv, dc = (THREADS - dr * nv) * V;
  const int r = threadIdx.x / nv;
  int c = (threadIdx.x - r * nv) * V;
  const T* gp = g + (size_t)r * stride + c;
  T* sp = s + r * ld + c;
  for (int i = threadIdx.x; i < rows * nv; i += THREADS) {
    tf::cp_async16(sp, gp);
    c += dc;
    gp += (size_t)dr * stride + dc;
    sp += dr * ld + dc;
    if (c >= d) {
      c -= d;
      gp += stride - d;
      sp += ld - d;
    }
  }
}

// float32: this warp's S strip (16 rows x 8 NS keys) over k-steps [kb, ke)
// of 8 columns: Q rows at q, the keys' rows at k, both rows of ld.
template <int NS>
__device__ __forceinline__ void s_part(float (&s)[NS][4], const float* q, const float* k, int ld,
                                       int kb, int ke, int g, int t) {
  float lh[NS][4], hl[NS][4], hh[NS][4];
#pragma unroll
  for (int c = 0; c < NS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) lh[c][e] = hl[c][e] = hh[c][e] = 0.f;
  const float* q0 = q + g * ld + 2 * t;
  const float* k0 = k + g * ld + 2 * t;
#pragma unroll 3
  for (int ks = kb; ks < ke; ++ks) {
    const float2 x0 = *reinterpret_cast<const float2*>(q0 + ks * 8);
    const float2 x1 = *reinterpret_cast<const float2*>(q0 + 8 * ld + ks * 8);
    F32::A a;
    split(x0.x, a.hi[0], a.lo[0]);
    split(x1.x, a.hi[1], a.lo[1]);
    split(x0.y, a.hi[2], a.lo[2]);
    split(x1.y, a.hi[3], a.lo[3]);
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      const float2 y = *reinterpret_cast<const float2*>(k0 + c * 8 * ld + ks * 8);
      F32::B b;
      split(y.x, b.hi[0], b.lo[0]);
      split(y.y, b.hi[1], b.lo[1]);
      tc::mma(lh[c], a.lo, b.hi);
      tc::mma(hl[c], a.hi, b.lo);
      tc::mma(hh[c], a.hi, b.hi);
    }
  }
#pragma unroll
  for (int c = 0; c < NS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[c][e] = hh[c][e] + (lh[c][e] + hl[c][e]);
}

// bf16: the same over k-steps [kb, ke) of 16 columns, Q and K by ldmatrix;
// with fewer than 4 n-tiles, even and odd k-steps into accumulators of their
// own.
template <int NS>
__device__ __forceinline__ void s_part(float (&s)[NS][4], const bf16* q, const bf16* k, int ld,
                                       int kb, int ke, int lane) {
  constexpr bool TWO = NS < 4;
  float se[NS][4], so[TWO ? NS : 1][4];
#pragma unroll
  for (int c = 0; c < NS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) se[c][e] = so[TWO ? c : 0][e] = 0.f;
  const bf16* qa = q + (lane & 15) * ld + (lane >> 4) * 8;
  const bf16* kp = k + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
  auto step = [&](auto& acc, int ks) {
    uint32_t a[4];
    tc::ldsm_x4(a, qa + ks * 16);
#pragma unroll
    for (int c = 0; c < NS; c += 2) {
      uint32_t r[4];
      tc::ldsm_x4(r, kp + c * 8 * ld + ks * 16);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      tc::mma16(acc[c], a, b0);
      tc::mma16(acc[c + 1], a, b1);
    }
  };
  if constexpr (TWO) {
    for (int ks = kb; ks < ke; ks += 2) {
      step(se, ks);
      if (ks + 1 < ke) step(so, ks + 1);
    }
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = se[c][e] + so[c][e];
  } else {
    for (int ks = kb; ks < ke; ++ks) step(se, ks);
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = se[c][e];
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tc::smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// float32: acc (this warp's n-tiles n0.., ntw of them) += P V over the
// warp's 8 NS keys: P as A fragments straight from S's C fragments (keys
// 2t, 2t + 1 of each 8 as lane t's k, k + 4), V's rows at v (rows of ldv).
// V's B fragments are split PV_GROUP n-tiles at a time, then each of the
// three terms runs over the group, so that no MMA waits on the one before.
constexpr int PV_GROUP = 4;
template <int NS, int NTD>
__device__ __forceinline__ void pv(float (&acc)[NTD][4], const float (&p)[NS][4], const float* v,
                                   int ldv, int n0, int ntw, int lane, int g, int t) {
#pragma unroll
  for (int kb = 0; kb < NS; ++kb) {
    F32::A a;
    split(p[kb][0], a.hi[0], a.lo[0]);
    split(p[kb][2], a.hi[1], a.lo[1]);
    split(p[kb][1], a.hi[2], a.lo[2]);
    split(p[kb][3], a.hi[3], a.lo[3]);
    const float* vr = v + (kb * 8 + 2 * t) * ldv + n0 * 8 + g;
#pragma unroll
    for (int i0 = 0; i0 < NTD; i0 += PV_GROUP) {
      F32::B b[PV_GROUP];
#pragma unroll
      for (int j = 0; j < PV_GROUP && i0 + j < NTD; ++j)
        if (i0 + j < ntw) {
          split(vr[(i0 + j) * 8], b[j].hi[0], b[j].lo[0]);
          split(vr[(i0 + j) * 8 + ldv], b[j].hi[1], b[j].lo[1]);
        }
#pragma unroll
      for (int j = 0; j < PV_GROUP && i0 + j < NTD; ++j)
        if (i0 + j < ntw) tc::mma(acc[i0 + j], a.lo, b[j].hi);
#pragma unroll
      for (int j = 0; j < PV_GROUP && i0 + j < NTD; ++j)
        if (i0 + j < ntw) tc::mma(acc[i0 + j], a.hi, b[j].lo);
#pragma unroll
      for (int j = 0; j < PV_GROUP && i0 + j < NTD; ++j)
        if (i0 + j < ntw) tc::mma(acc[i0 + j], a.hi, b[j].hi);
    }
  }
}

// bf16: the same, P rounded to bf16 and two 8-key n-tiles packed into one
// m16n8k16 A fragment, V's B fragments by ldmatrix.trans, 16 columns a load.
template <int NS, int NTD>
__device__ __forceinline__ void pv(float (&acc)[NTD][4], const float (&p)[NS][4], const bf16* v,
                                   int ldv, int n0, int ntw, int lane, int, int) {
  const bf16* vp = v + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldv + n0 * 8 + (lane >> 4) * 8;
#pragma unroll
  for (int kb = 0; kb < NS / 2; ++kb) {
    const uint32_t a[4] = {pack_bf16(p[2 * kb][0], p[2 * kb][1]),
                           pack_bf16(p[2 * kb][2], p[2 * kb][3]),
                           pack_bf16(p[2 * kb + 1][0], p[2 * kb + 1][1]),
                           pack_bf16(p[2 * kb + 1][2], p[2 * kb + 1][3])};
#pragma unroll
    for (int i = 0; i < NTD; i += 2) {
      if (i < ntw) {
        uint32_t r[4];
        ldsm_x4_trans(r, vp + kb * 16 * ldv + i * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        tc::mma16(acc[i], a, b0);
        tc::mma16(acc[i + 1], a, b1);
      }
    }
  }
}

// o and lse of BQ query rows: out0 = o, out1 = lse.
template <class P, int RG>
__global__ void __launch_bounds__(THREADS, 1) fwd_kernel(Args a) {
  using T = typename P::T;
  using C = Tile<P, RG>;
  constexpr int KQ = C::KQ, BK = C::BK, KW = C::KW, NS = C::NS, NTD = C::NTD;
  constexpr bool F = std::is_same_v<P, F32>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<P, RG> lay(a.d);
  T* Qs = reinterpret_cast<T*>(smem + lay.q);
  T* Kb = reinterpret_cast<T*>(smem + lay.k);
  T* Vb = reinterpret_cast<T*>(smem + lay.v);
  float* xch = reinterpret_cast<float*>(smem + lay.xch);
  int* segq = reinterpret_cast<int*>(smem + lay.segq);
  int* segk = reinterpret_cast<int*>(smem + lay.segk);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int u = warp % PAIRS, dh = warp / PAIRS, rg = u % RG, kq = u / RG;
  const int d = a.d, ldq = ld_qk<P>(d), ldv = ld_v<P>(d), nt = d / 8;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * C::BQ;
  const size_t base = (size_t)b * a.sb + (size_t)h * a.sh;
  const int* seg = a.seg ? a.seg + (size_t)b * a.L : nullptr;
  const T* kg = static_cast<const T*>(a.k) + base;
  const T* vg = static_cast<const T*>(a.v) + base;
  const int lid = threadIdx.x;

  // this warp's half of the head dim: S's k-steps [kb, ke), O's n-tiles n0.. (ntw)
  const int nk = round_up(d, P::KS) / P::KS, kh = (nk + 1) / 2;
  const int kb = dh ? kh : 0, ke = dh ? nk : kh;
  int n0, ntw;
  if constexpr (F) {
    const int nh = (nt + 1) / 2;
    n0 = dh ? nh : 0;
    ntw = dh ? nt - nh : nh;
  } else {  // in pairs of n-tiles (16 columns): the zero tail's n-tile is computed, not stored
    const int np = (nt + 1) / 2, ph = (np + 1) / 2;
    n0 = dh ? 2 * ph : 0;
    ntw = dh ? 2 * (np - ph) : 2 * ph;
  }

  // step j's K, V and key segment ids into buffer j & 1 (one group)
  auto stage = [&](int j) {
    const int k0 = j * BK;
    copy_rows(Kb + (j & 1) * BK * ldq, ldq, kg + (size_t)k0 * a.sl, a.sl, BK, d);
    copy_rows(Vb + (j & 1) * BK * ldv, ldv, vg + (size_t)k0 * a.sl, a.sl, BK, d);
    if (lid < BK) {
      if (seg) tf::cp_async4(segk + (j & 1) * BK + lid, seg + k0 + lid);
      else segk[(j & 1) * BK + lid] = 0;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  copy_rows(Qs, ldq, static_cast<const T*>(a.q) + base + (size_t)q0 * a.sl, a.sl, C::BQ, d);
  if (lid < C::BQ) {
    if (seg) tf::cp_async4(segq + lid, seg + q0 + lid);
    else segq[lid] = 0;
  }
  stage(0);
  if constexpr (!F) {  // bf16's zero tail [d, dk) of every row the products read
    if (round_up(d, 16) != d) {
      for (int r = lid; r < C::BQ + 4 * BK; r += THREADS) {
        T* row = r < C::BQ ? Qs + r * ldq
                 : r < C::BQ + 2 * BK ? Kb + (r - C::BQ) * ldq : Vb + (r - C::BQ - 2 * BK) * ldv;
        *reinterpret_cast<uint4*>(row + d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  float acc[NTD][4];
#pragma unroll
  for (int i = 0; i < NTD; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int sq[2] = {0, 0};
  const float sl2 = a.scale * LOG2E;  // scores in the log2 domain: exp2 of the difference
  float* xmine = xch + warp * (NS * 4 * 32) + lane;
  const float* xother = xch + (warp ^ PAIRS) * (NS * 4 * 32) + lane;

  const int steps = a.L / BK;
  for (int j = 0; j < steps; ++j) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // step j's tiles have arrived; step j - 1 is done with the other buffer
    if (j + 1 < steps) stage(j + 1);
    if (j == 0) {
      sq[0] = segq[rg * 16 + g];
      sq[1] = segq[rg * 16 + g + 8];
    }
    const T* Ks = Kb + ((j & 1) * BK + kq * KW) * ldq;
    const T* Vs = Vb + ((j & 1) * BK + kq * KW) * ldv;
    const int* sk = segk + (j & 1) * BK + kq * KW + 2 * t;
    // S over this warp's half of the head dim, plus its partner's half
    float s[NS][4];
    if constexpr (F) s_part<NS>(s, Qs + rg * 16 * ldq, Ks, ldq, kb, ke, g, t);
    else s_part<NS>(s, Qs + rg * 16 * ldq, Ks, ldq, kb, ke, lane);
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) xmine[(c * 4 + e) * 32] = s[c][e];
    tf::named_sync(1 + u, 64);
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] += xother[(c * 4 + e) * 32];
    // the online softmax of rows g and g + 8 (lane quads share a row)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fmaf(s[c][e], sl2, sq[e >> 1] == sk[c * 8 + (e & 1)] ? 0.f : MASK);
        s[c][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);  // 0 on the first step (m = -inf)
      m[r] = mx[r];
    }
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[c][e] - m[e >> 1]);
        s[c][e] = p;
        ls[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // else O stays as it is
#pragma unroll
      for (int i = 0; i < NTD; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }
    }
    pv<NS, NTD>(acc, s, Vs, ldv, n0, ntw, lane, g, t);
  }

  // each row's sum over the quad; key groups merge by their row max
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float mt[2] = {m[0], m[1]}, lt[2] = {l[0], l[1]};
  if constexpr (KQ > 1) {
    float* ml = reinterpret_cast<float*>(smem + lay.ml);  // [rg][kq][row]{m, l}
    float* part = reinterpret_cast<float*>(smem + lay.k);
    __syncthreads();  // every warp is done with K and V: their buffers take the partial O's
    if (dh == 0 && t == 0) {
      float* x = ml + (rg * KQ + kq) * 32;
      x[2 * g] = m[0];
      x[2 * g + 1] = l[0];
      x[2 * (g + 8)] = m[1];
      x[2 * (g + 8) + 1] = l[1];
    }
    __syncthreads();
    float f[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* x = ml + rg * KQ * 32 + 2 * (g + 8 * r);
      float mm = x[0];
#pragma unroll
      for (int w = 1; w < KQ; ++w) mm = fmaxf(mm, x[w * 32]);
      float ll = 0.f;
#pragma unroll
      for (int w = 0; w < KQ; ++w) ll += exp2f(x[w * 32] - mm) * x[w * 32 + 1];
      mt[r] = mm;
      lt[r] = ll;
      f[r] = exp2f(m[r] - mm);
    }
#pragma unroll
    for (int i = 0; i < NTD; ++i) {
      acc[i][0] *= f[0];
      acc[i][1] *= f[0];
      acc[i][2] *= f[1];
      acc[i][3] *= f[1];
    }
    auto slot = [&](int w) { return part + ((rg * (KQ - 1) + w - 1) * 2 + dh) * (NTD * 128); };
    if (kq != 0) {
      float* x = slot(kq) + lane * 4;
#pragma unroll
      for (int i = 0; i < NTD; ++i)
        if (i < ntw)
          *reinterpret_cast<float4*>(x + i * 128) = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                                                acc[i][3]);
    }
    __syncthreads();
    if (kq == 0) {
#pragma unroll
      for (int w = 1; w < KQ; ++w) {
        const float* x = slot(w) + lane * 4;
#pragma unroll
        for (int i = 0; i < NTD; ++i)
          if (i < ntw) {
            const float4 y = *reinterpret_cast<const float4*>(x + i * 128);
            acc[i][0] += y.x;
            acc[i][1] += y.y;
            acc[i][2] += y.z;
            acc[i][3] += y.w;
          }
      }
    }
  }
  if (kq == 0) {
    const float inv0 = 1.f / lt[0], inv1 = 1.f / lt[1];
    T* out = static_cast<T*>(a.out0) + base + (size_t)(q0 + rg * 16 + g) * a.sl + 2 * t;
#pragma unroll
    for (int i = 0; i < NTD; ++i) {
      const int n = n0 + i;
      if (i < ntw && n < nt) {
        P::store2(out + n * 8, acc[i][0] * inv0, acc[i][1] * inv0);
        P::store2(out + (size_t)8 * a.sl + n * 8, acc[i][2] * inv1, acc[i][3] * inv1);
      }
    }
    if (dh == 0 && t == 0) {
      float* lse = static_cast<float*>(a.out1) + ((size_t)b * a.H + h) * a.L + q0 + rg * 16 + g;
      lse[0] = mt[0] * LN2 + logf(lt[0]);
      lse[8] = mt[1] * LN2 + logf(lt[1]);
    }
  }
}

}  // namespace fw

// ---- the bf16 backward on wgmma (namespace wg): a block owns 64 rows, two
// warpgroups, 64 streamed rows a step; see the header.
namespace wg {

constexpr int BR = 64;               // rows of a block's resident tiles (one wgmma M)
constexpr int BS = 64;               // rows of a step's streamed tiles (S's wgmma N)
constexpr int CB = DMAX / 8;         // 16-byte chunks of a tile row (every head dim)
constexpr int RTILE = BR * CB * 8;   // elements of a resident tile
constexpr int NP = DMAX / 16;        // 16-column panels of a streamed tile
constexpr int PANEL = BS * 16;       // elements of a panel: BS rows of 32 bytes
constexpr int STILE = NP * PANEL;    // elements of a streamed tile
constexpr int NS = BS / 2;           // S's accumulators a thread
constexpr int KS = BS / 16;          // k-steps of an accumulation over a step's rows
constexpr int N0 = 144;              // columns of an accumulation's first wgmma (N; whole panels)
constexpr int N1 = DMAX - N0;        // and of its second
constexpr int BOX = PANEL * 2;       // bytes of one TMA box: a panel
constexpr float LOG2E = 1.4426950408889634f;
static_assert((BS == 64 || BS == 32) && N0 % 16 == 0 && N1 % 16 == 0, "the layout");

// The wgmma kernels' parameters: the streamed tensors (dK/dV: Q, dO; dQ: K,
// V) as TMA tensor maps of boxes of 16 columns x BS rows of one (b, h), 32-byte
// swizzled, dims (d, L, H, B), or (d, H, L, B) when H's stride is the smaller
// (l_inner 0).
struct Params {
  CUtensorMap t0, t1;
  Args a;
  int l_inner;
};

// Shared memory: res0/res1 the block's tiles (dK/dV: K, V; dQ: Q, dO);
// buf0/buf1 a step's streamed tiles (dK/dV: Q then dO; dQ: K then V); xp P
// from warpgroup 0 to warpgroup 1 (64 x 64 floats), in dQ then dS (bf16);
// the streamed rows' lse, D (dK/dV) and segment ids by step parity. The
// resident tiles are core matrices (8 rows x 16 bytes, 128 contiguous
// bytes) by column chunk: row r's chunk c at (c BR + r) 16 bytes; the
// streamed ones 16-column panels of BS rows of 32 bytes, as TMA's 32-byte
// swizzle lands them (row r's 16-byte half c at 32 r + 16 (c ^ (r / 4 % 2))).
struct Smem {
  size_t res0, res1, buf0, buf1, xp, lse, dsum, seg, bar, bytes;
  __host__ __device__ Smem(bool dkv) {
    Carve c;
    res0 = c.take(RTILE * sizeof(bf16));
    res1 = c.take(RTILE * sizeof(bf16));
    buf0 = c.take(2 * STILE * sizeof(bf16));
    buf1 = c.take(2 * STILE * sizeof(bf16));
    xp = c.take(4 * NS * 32 * sizeof(float));
    lse = c.take(dkv ? 2 * BS * sizeof(float) : 0);
    dsum = c.take(dkv ? 2 * BS * sizeof(float) : 0);
    seg = c.take(2 * BS * sizeof(int));
    bar = c.take(2 * sizeof(uint64_t));  // an mbarrier a buffer
    bytes = c.off;
  }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(tc::smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(tc::smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(tc::smem_u32(bar)), "r"(parity) : "memory");
}

// Step j's two streamed tiles (rows r0.. of (b, h) in t0 and t1) into buf
// and buf + STILE by TMA, a box a panel (np of them: the head dim's; the
// columns past d zero), completing on bar; warp 0.
__device__ __forceinline__ void tma_tiles(bf16* buf, const Params& p, int r0, int h, int b, int np,
                                          uint64_t* bar, int lane) {
  if (lane == 0) mbar_expect(bar, 2 * np * BOX);
  __syncwarp();
  const int c1 = p.l_inner ? r0 : h, c2 = p.l_inner ? h : r0;
  for (int i = lane; i < 2 * np; i += 32) {
    const int one = i >= np, c = i - one * np;
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(tc::smem_u32(buf + one * STILE + c * PANEL)),
        "l"(reinterpret_cast<uint64_t>(one ? &p.t1 : &p.t0)), "r"(16 * c), "r"(c1), "r"(c2), "r"(b),
        "r"(tc::smem_u32(bar)) : "memory");
  }
}

// A shared-memory matrix descriptor without swizzle: lbo, sbo the byte
// strides between core matrices along k and along m (or n).
__device__ __forceinline__ uint64_t desc(const bf16* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((tc::smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// k-step ks of a core-matrix tile of BR rows as a K-major A (its rows m)
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int ks) {
  return desc(tile + ks * 2 * BR * 8, BR * 16, 128);
}
constexpr uint64_t SW32 = 3ull << 62;  // a descriptor's 32-byte swizzle
// k-step ks of a streamed tile as a K-major B: a panel, 8-row groups 256
// bytes apart
__device__ __forceinline__ uint64_t desc_ks(const bf16* tile, int ks) {
  return desc(tile + ks * PANEL, 16, 256) | SW32;
}
// rows 16 kk.. (k) and panels p0.. (n) of a streamed tile as an MN-major B:
// panels a panel apart, 8-row groups 256 bytes apart
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk, int p0) {
  return desc(tile + p0 * PANEL + 16 * kk * 16, PANEL * 2, 256) | SW32;
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from touching r before the wait that precedes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64) = A B^T (+ d when acc), both K-major in shared memory
__device__ __forceinline__ void mma_s(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 32) = A B^T (+ d when acc), both K-major in shared memory
__device__ __forceinline__ void mma_s(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x N0) += A (registers) B, B MN-major in shared memory
__device__ __forceinline__ void mma_acc(float (&d)[72], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
      "}, {%72, %73, %74, %75}, %76, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x N1) += A (registers) B, B MN-major in shared memory
__device__ __forceinline__ void mma_acc(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x N0) += A B, A K-major and B MN-major in shared memory
__device__ __forceinline__ void mma_acc_ss(float (&d)[72], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(a), "l"(b));
}

// d (64 x N1) += A B, A K-major and B MN-major in shared memory
__device__ __forceinline__ void mma_acc_ss(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b));
}

// A 64-row tile from global rows `stride` apart by cp.async: warp w copies
// rows 8w..8w + 7, each group of 8 lanes one 128-byte core matrix.
__device__ __forceinline__ void copy_tile(bf16* s, const bf16* g, int stride, int nv, int warp,
                                          int lane) {
  const int r = 8 * warp + (lane & 7);
  const bf16* gp = g + (size_t)r * stride;
  for (int c = lane >> 3; c < nv; c += 4) tf::cp_async16(s + (c * BR + r) * 8, gp + c * 8);
}

// chunks [nv, CB) of a tile of `rows` rows: zero (the head dim's pad, which
// S's last k-step reads when d / 8 is odd, and the columns no output keeps)
__device__ __forceinline__ void zero_pad(bf16* s, int rows, int nv) {
  for (int i = threadIdx.x; i < (CB - nv) * rows; i += THREADS)
    *reinterpret_cast<uint4*>(s + (nv * rows + i) * 8) = make_uint4(0u, 0u, 0u, 0u);
}

// K, V (or Q, dO): their pad chunks zero; both buffers' streamed tiles: the
// panels past the head dim's np (TMA zeroes the columns past d in its boxes)
__device__ __forceinline__ void zero_pads(bf16* res, int nv, int np) {
  zero_pad(res, BR, nv);
  zero_pad(res + RTILE, BR, nv);
  for (int i = threadIdx.x; i < 4 * (NP - np) * PANEL / 8; i += THREADS) {
    const int tile = i / ((NP - np) * PANEL / 8), j = i - tile * ((NP - np) * PANEL / 8);
    *reinterpret_cast<uint4*>(res + 2 * RTILE + tile * STILE + np * PANEL + j * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// A fragments (m16n8k16's, as wgmma takes them from registers) of a 64 x BS
// accumulator rounded to bf16: k-step kk from n-tiles 2 kk, 2 kk + 1.
__device__ __forceinline__ void to_a(uint32_t (&af)[KS][4], const float (&s)[NS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) af[kk][i] = fw::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// A warp's rows 16 w + g, + 8 of an accumulation's columns c0.. into global
// rows.
template <int NA>
__device__ __forceinline__ void store_cols(bf16* out, int stride, const float (&acc)[NA], int c0,
                                           int d, int g, int t) {
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int col = c0 + 8 * j + 2 * t;
    if (col < d) {
      *reinterpret_cast<uint32_t*>(out + (size_t)g * stride + col) =
          fw::pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(out + (size_t)(g + 8) * stride + col) =
          fw::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// dK and dV of 64 key rows: out0 = dk, out1 = dv. Warpgroup 0: S^T = K Q^T,
// P^T, dV += P^T dO; warpgroup 1: dP^T = V dO^T, dS^T, dK += dS^T Q.
__global__ void __launch_bounds__(THREADS, 1) dkv_kernel(const __grid_constant__ Params pr) {
  extern __shared__ __align__(128) unsigned char wsmem[];
  unsigned char* smem = wsmem;
  const Args& a = pr.a;
  const Smem lay(true);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar);
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.res0);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.res1);
  float* xp = reinterpret_cast<float*>(smem + lay.xp);
  float* lse_s = reinterpret_cast<float*>(smem + lay.lse);
  float* dsum_s = reinterpret_cast<float*>(smem + lay.dsum);
  int* segq = reinterpret_cast<int*>(smem + lay.seg);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2, w = warp & 3;
  const int d = a.d, nv = d / 8, nk = (d + 15) / 16;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BR;
  const size_t base = (size_t)b * a.sb + (size_t)h * a.sh;
  const size_t rows = ((size_t)b * a.H + h) * a.L;
  const int* seg = a.seg ? a.seg + (size_t)b * a.L : nullptr;
  const int lid = threadIdx.x;

  auto buf = [&](int j) { return reinterpret_cast<bf16*>(smem + ((j & 1) ? lay.buf1 : lay.buf0)); };
  // a step's Q, dO, lse, D and segment ids into buffer j & 1 (one group)
  auto stage = [&](int j) {
    const int q0 = j * BS, o = (j & 1) * BS;
    if (warp == 0) tma_tiles(buf(j), pr, q0, h, b, nk, bars + (j & 1), lane);
    if (lid < BS) {
      tf::cp_async4(lse_s + o + lid, a.lse + rows + q0 + lid);
      tf::cp_async4(dsum_s + o + lid, a.dsum + rows + q0 + lid);
      if (seg) tf::cp_async4(segq + o + lid, seg + q0 + lid);
      else segq[o + lid] = 0;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  zero_pads(Ks, nv, nk);
  if (lid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  copy_tile(Ks, static_cast<const bf16*>(a.k) + base + (size_t)k0 * a.sl, a.sl, nv, warp, lane);
  copy_tile(Vs, static_cast<const bf16*>(a.v) + base + (size_t)k0 * a.sl, a.sl, nv, warp, lane);
  stage(0);

  int sk[2] = {0, 0};  // the segment ids of this thread's key rows
  if (seg) {
    sk[0] = seg[k0 + 16 * w + g];
    sk[1] = seg[k0 + 16 * w + g + 8];
  }
  const float sl2 = a.scale * LOG2E;  // scores in the log2 domain
  float* xw = xp + w * (NS * 32) + lane;
  float acc0[N0 / 2], acc1[N1 / 2];  // the gradient's columns 0..N0 - 1, N0..
#pragma unroll
  for (int i = 0; i < N0 / 2; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N1 / 2; ++i) acc1[i] = 0.f;

  const int steps = a.L / BS;
  for (int j = 0; j < steps; ++j) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_wait(bars + (j & 1), (j >> 1) & 1);
    __syncthreads();  // step j's tiles have arrived; step j - 1 is done with the other buffer
    const bf16* Qs = buf(j);
    const bf16* dOs = Qs + STILE;
    const int o = (j & 1) * BS + 2 * t;
    float s[NS];  // the first k-step writes it (its wgmma's scale-d off)
    const bf16* x = grp ? Vs : Ks;
    const bf16* y = grp ? dOs : Qs;
    wg_fence();
    for (int ks = 0; ks < nk; ++ks) mma_s(s, desc_k(x, ks), desc_ks(y, ks), ks);
    wg_commit();
    if (j + 1 < steps) stage(j + 1);  // the copies issue while the tensor cores run
    wg_wait();
    fence_regs(s);
    if (grp == 0) {  // P^T = exp2(S^T scale log2(e) - lse log2(e)) where the segments match
#pragma unroll
      for (int c = 0; c < BS / 8; ++c) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + o + 8 * c);
        const int2 sq = *reinterpret_cast<const int2*>(segq + o + 8 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = (e & 1) ? l2.y : l2.x;
          const int sg = (e & 1) ? sq.y : sq.x;
          const float p = sk[e >> 1] == sg ? exp2f(fmaf(s[4 * c + e], sl2, -(lq * LOG2E))) : 0.f;
          s[4 * c + e] = p;
          xw[(4 * c + e) * 32] = p;
        }
      }
      bar_arrive(1, THREADS);  // P to warpgroup 1
    } else {  // dS^T = P^T (dP^T - D) scale
      tf::named_sync(1, THREADS);
#pragma unroll
      for (int c = 0; c < BS / 8; ++c) {
        const float2 d2 = *reinterpret_cast<const float2*>(dsum_s + o + 8 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * c + e] = xw[(4 * c + e) * 32] * (s[4 * c + e] - ((e & 1) ? d2.y : d2.x)) * a.scale;
      }
    }
    uint32_t af[KS][4];
    to_a(af, s);
    const bf16* yb = grp ? Qs : dOs;  // dV += P^T dO, dK += dS^T Q
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      mma_acc(acc0, af[kk], desc_mn(yb, kk, 0));
      mma_acc(acc1, af[kk], desc_mn(yb, kk, N0 / 16));
    }
    wg_commit();
    wg_wait();
    fence_regs(acc0);
    fence_regs(acc1);
  }
  bf16* out = static_cast<bf16*>(grp ? a.out0 : a.out1) + base + (size_t)(k0 + 16 * w) * a.sl;
  store_cols(out, a.sl, acc0, 0, d, g, t);
  store_cols(out, a.sl, acc1, N0, d, g, t);
}

// dQ of 64 query rows: out0 = dq. Warpgroup 0: S = Q K^T and P; warpgroup
// 1: dP = dO V^T and dS, into shared memory; each warpgroup then half of
// dQ += dS K.
__global__ void __launch_bounds__(THREADS, 1) dq_kernel(const __grid_constant__ Params pr) {
  extern __shared__ __align__(128) unsigned char wsmem[];
  unsigned char* smem = wsmem;
  const Args& a = pr.a;
  const Smem lay(false);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar);
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.res0);
  bf16* dOs = reinterpret_cast<bf16*>(smem + lay.res1);
  float* xp = reinterpret_cast<float*>(smem + lay.xp);
  bf16* dSs = reinterpret_cast<bf16*>(smem + lay.xp);  // after P is read
  int* segk = reinterpret_cast<int*>(smem + lay.seg);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2, w = warp & 3;
  const int d = a.d, nv = d / 8, nk = (d + 15) / 16;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BR;
  const size_t base = (size_t)b * a.sb + (size_t)h * a.sh;
  const size_t rows = ((size_t)b * a.H + h) * a.L;
  const int* seg = a.seg ? a.seg + (size_t)b * a.L : nullptr;
  const int lid = threadIdx.x;

  auto buf = [&](int j) { return reinterpret_cast<bf16*>(smem + ((j & 1) ? lay.buf1 : lay.buf0)); };
  // a step's K, V and segment ids into buffer j & 1 (one group)
  auto stage = [&](int j) {
    const int k0 = j * BS, o = (j & 1) * BS;
    if (warp == 0) tma_tiles(buf(j), pr, k0, h, b, nk, bars + (j & 1), lane);
    if (lid < BS) {
      if (seg) tf::cp_async4(segk + o + lid, seg + k0 + lid);
      else segk[o + lid] = 0;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  zero_pads(Qs, nv, nk);
  if (lid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  copy_tile(Qs, static_cast<const bf16*>(a.q) + base + (size_t)q0 * a.sl, a.sl, nv, warp, lane);
  copy_tile(dOs, static_cast<const bf16*>(a.dout) + base + (size_t)q0 * a.sl, a.sl, nv, warp,
            lane);
  stage(0);

  float lq[2], dr[2];  // lse log2(e), D and segment ids of this thread's query rows
  int sq[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * w + g + 8 * r;
    lq[r] = a.lse[rows + row] * LOG2E;
    dr[r] = a.dsum[rows + row];
    if (seg) sq[r] = seg[row];
  }
  const float sl2 = a.scale * LOG2E;
  float* xw = xp + w * (NS * 32) + lane;
  // dQ's columns 0..N0 - 1 (warpgroup 0) or N0.. (warpgroup 1, the first
  // N1 / 2 of them)
  float acc[N0 / 2];
  float (&acc1)[N1 / 2] = *reinterpret_cast<float(*)[N1 / 2]>(acc);
#pragma unroll
  for (int i = 0; i < N0 / 2; ++i) acc[i] = 0.f;

  const int steps = a.L / BS;
  for (int j = 0; j < steps; ++j) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_wait(bars + (j & 1), (j >> 1) & 1);
    __syncthreads();  // step j's tiles have arrived; step j - 1 is done with the other buffer
    const bf16* Kt = buf(j);
    const bf16* Vt = Kt + STILE;
    float s[NS];  // the first k-step writes it (its wgmma's scale-d off)
    const bf16* x = grp ? dOs : Qs;
    const bf16* y = grp ? Vt : Kt;
    wg_fence();
    for (int ks = 0; ks < nk; ++ks) mma_s(s, desc_k(x, ks), desc_ks(y, ks), ks);
    wg_commit();
    if (j + 1 < steps) stage(j + 1);  // the copies issue while the tensor cores run
    wg_wait();
    fence_regs(s);
    if (grp == 0) {  // P = exp2(S scale log2(e) - lse log2(e)) where the segments match
      const int* sk = segk + (j & 1) * BS + 2 * t;
#pragma unroll
      for (int c = 0; c < BS / 8; ++c) {
        const int2 k2 = *reinterpret_cast<const int2*>(sk + 8 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xw[(4 * c + e) * 32] = sq[e >> 1] == ((e & 1) ? k2.y : k2.x)
                                     ? exp2f(fmaf(s[4 * c + e], sl2, -lq[e >> 1])) : 0.f;
      }
      bar_arrive(1, THREADS);  // P to warpgroup 1
    } else {  // dS = P (dP - D) scale, into shared memory as a K-major A
      tf::named_sync(1, THREADS);
#pragma unroll
      for (int c = 0; c < BS / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * c + e] = xw[(4 * c + e) * 32] * (s[4 * c + e] - dr[e >> 1]) * a.scale;
      tf::named_sync(2, THREADS / 2);  // every warp of the group has read P
#pragma unroll
      for (int c = 0; c < BS / 8; ++c) {
        bf16* p = dSs + (c * BR + 16 * w + g) * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(p) = fw::pack_bf16(s[4 * c], s[4 * c + 1]);
        *reinterpret_cast<uint32_t*>(p + 64) = fw::pack_bf16(s[4 * c + 2], s[4 * c + 3]);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();  // dS is complete
    wg_fence();  // dQ's columns of warpgroup grp += dS K
    if (grp == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) mma_acc_ss(acc, desc_k(dSs, kk), desc_mn(Kt, kk, 0));
    } else {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_acc_ss(acc1, desc_k(dSs, kk), desc_mn(Kt, kk, N0 / 16));
    }
    wg_commit();
    wg_wait();
    fence_regs(acc);
  }
  bf16* out = static_cast<bf16*>(a.out0) + base + (size_t)(q0 + 16 * w) * a.sl;
  if (grp == 0) store_cols(out, a.sl, acc, 0, d, g, t);
  else store_cols(out, a.sl, acc1, N0, d, g, t);
}

}  // namespace wg

// ---- the wide head dims (namespace wd): d above DMAX, a multiple of 8, no
// upper bound; float32 (3xTF32 mma.sync.m16n8k8) and bf16 (mma.sync.m16n8k16)
// are one template. See the header for the design.
namespace wd {

constexpr int WARPS_W = 4;                // warps a block, 16 of its rows each
constexpr int THREADS_W = 32 * WARPS_W;
constexpr int BR = 16 * WARPS_W;          // a block's rows: queries (forward, dQ) or keys (dK/dV)
constexpr int BS = BR;                    // the other side's rows a step
constexpr int CHUNK_BYTES = 128;          // a row of a head-dim chunk: 32 float32 or 64 bf16
constexpr int CS_FWD = 128;               // o's columns a block
constexpr int CS_DKV = 64;                // dK's and dV's columns a block (two accumulators)
constexpr int CS_DQ = 128;                // dQ's columns a block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The products of one element type: A (16 x KS, row-major) and B (KS x 8)
// fragments loaded from shared memory, B either n-major (B[k][n] = s[n ld +
// k], the rows of Y in X Y^T) or k-major (B[k][n] = s[k ld + n]); and A
// from a C tile in registers (lda_c) with its k-major B (ldb_kp).
template <class P>
struct Ops;

// float32: 3xTF32, each operand split into TF32 hi and lo at its load.
template <>
struct Ops<F32> {
  using T = float;
  using A = F32::A;
  using B = F32::B;
  static constexpr int KS = 8;
  static __device__ __forceinline__ void lda(A& a, const float* s, int ld, int k0, int g, int t) {
    const float* p = s + g * ld + k0 + t;
    tc::split(p[0], a.hi[0], a.lo[0]);
    tc::split(p[8 * ld], a.hi[1], a.lo[1]);
    tc::split(p[4], a.hi[2], a.lo[2]);
    tc::split(p[8 * ld + 4], a.hi[3], a.lo[3]);
  }
  static __device__ __forceinline__ void ldb_n(B& b, const float* s, int ld, int k0, int g, int t) {
    const float* p = s + g * ld + k0 + t;
    tc::split(p[0], b.hi[0], b.lo[0]);
    tc::split(p[4], b.hi[1], b.lo[1]);
  }
  static __device__ __forceinline__ void ldb_k(B& b, const float* s, int ld, int k0, int g, int t) {
    const float* p = s + (k0 + t) * ld + g;
    tc::split(p[0], b.hi[0], b.lo[0]);
    tc::split(p[4 * ld], b.hi[1], b.lo[1]);
  }
  // B[k][n] = s[(k0 + k') ld + n] on the k-order of lda_c: lane t's k and
  // k + 4 are rows 2t and 2t + 1
  static __device__ __forceinline__ void ldb_kp(B& b, const float* s, int ld, int k0, int g,
                                                int t) {
    const float* p = s + (k0 + 2 * t) * ld + g;
    tc::split(p[0], b.hi[0], b.lo[0]);
    tc::split(p[ld], b.hi[1], b.lo[1]);
  }
  // A (16 x 8) straight from the C fragments of a 16 x 8 NS tile, k-step kk:
  // columns 2t, 2t + 1 of n-tile kk as lane t's k and k + 4
  template <int NS>
  static __device__ __forceinline__ void lda_c(A& a, const float (&c)[NS][4], int kk) {
    tc::split(c[kk][0], a.hi[0], a.lo[0]);
    tc::split(c[kk][2], a.hi[1], a.lo[1]);
    tc::split(c[kk][1], a.hi[2], a.lo[2]);
    tc::split(c[kk][3], a.hi[3], a.lo[3]);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    F32::mma(d, a, b);
  }
};

// bf16: m16n8k16, two bf16 a register (the lower k in the low half).
template <>
struct Ops<BF16> {
  using T = bf16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  static constexpr int KS = 16;
  static __device__ __forceinline__ uint32_t pair(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ uint32_t pair2(const bf16* p, int ld) {  // p[0], p[ld]
    return (uint32_t)__bfloat16_as_ushort(p[0]) | ((uint32_t)__bfloat16_as_ushort(p[ld]) << 16);
  }
  static __device__ __forceinline__ void lda(A& a, const bf16* s, int ld, int k0, int g, int t) {
    const bf16* p = s + g * ld + k0 + 2 * t;
    a.r[0] = pair(p);
    a.r[1] = pair(p + 8 * ld);
    a.r[2] = pair(p + 8);
    a.r[3] = pair(p + 8 * ld + 8);
  }
  static __device__ __forceinline__ void ldb_n(B& b, const bf16* s, int ld, int k0, int g, int t) {
    const bf16* p = s + g * ld + k0 + 2 * t;
    b.r[0] = pair(p);
    b.r[1] = pair(p + 8);
  }
  static __device__ __forceinline__ void ldb_k(B& b, const bf16* s, int ld, int k0, int g, int t) {
    const bf16* p = s + (k0 + 2 * t) * ld + g;
    b.r[0] = pair2(p, ld);
    b.r[1] = pair2(p + 8 * ld, ld);
  }
  static __device__ __forceinline__ void ldb_kp(B& b, const bf16* s, int ld, int k0, int g,
                                                int t) {
    ldb_k(b, s, ld, k0, g, t);
  }
  // A (16 x 16) from the C fragments of n-tiles 2 kk and 2 kk + 1, rounded to
  // bf16
  template <int NS>
  static __device__ __forceinline__ void lda_c(A& a, const float (&c)[NS][4], int kk) {
    a.r[0] = fw::pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a.r[1] = fw::pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a.r[2] = fw::pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a.r[3] = fw::pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    tc::mma16(d, a.r, b.r);
  }
};

// Row lengths in shared memory (elements). A chunk row (DC columns) is 4 mod
// 32 words, so that the natural fragment loads (row g, column t or pair t)
// of a warp fall on distinct banks; a slice row (CS columns) CS + 4 in
// float32 and CS + 8 in bf16, so that the k-major loads (rows 2t and 2t + 1,
// column g) do.
template <class P>
struct Lay {
  using T = typename Ops<P>::T;
  static constexpr int DC = CHUNK_BYTES / (int)sizeof(T);  // a chunk's columns
  static constexpr int LDC = DC + 16 / (int)sizeof(T);
};
template <class P>
__host__ __device__ constexpr int slice_ld(int cs) {
  return cs + (std::is_same_v<P, F32> ? 4 : 8);
}

// Shared memory of each kernel (bytes): chunks of the block's rows and of a
// step's rows in two buffers, slices of a step's rows, a step's vectors.
template <class P>
constexpr size_t region(int rows, int cols) {
  return (size_t)rows * cols * sizeof(typename Ops<P>::T);
}
// forward: Q and K chunks, V's slice, the keys' segment ids
template <class P>
constexpr size_t fwd_smem() {
  return 2 * region<P>(BR + BS, Lay<P>::LDC) + region<P>(BS, slice_ld<P>(CS_FWD)) + BS * 4;
}
// dK/dV: K, V, Q and dO chunks, Q's and dO's slices, the queries' lse, D and
// segment ids
template <class P>
constexpr size_t dkv_smem() {
  return 4 * region<P>(BR + BS, Lay<P>::LDC) + 2 * region<P>(BS, slice_ld<P>(CS_DKV)) + 3 * BS * 4;
}
// dQ: Q, dO, K and V chunks, K's slice, the keys' segment ids
template <class P>
constexpr size_t dq_smem() {
  return 4 * region<P>(BR + BS, Lay<P>::LDC) + region<P>(BS, slice_ld<P>(CS_DQ)) + BS * 4;
}

__device__ __forceinline__ void cp_async16z(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(tc::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Every group but the last committed one has landed (all of them when
// `all`); then the block's copies are visible to every thread.
__device__ __forceinline__ void wait_landed(bool all) {
  if (all) asm volatile("cp.async.wait_group 0;" ::: "memory");
  else asm volatile("cp.async.wait_group 1;" ::: "memory");
  __syncthreads();
}

// rows x W columns (c0..) of a tensor's rows (`stride` apart, g at row 0,
// column 0) into shared rows of ld, by cp.async; columns from d on are zero.
template <class T, int W>
__device__ __forceinline__ void copy_cols(T* s, int ld, const T* g, int stride, int rows, int c0,
                                          int d) {
  constexpr int V = 16 / (int)sizeof(T), NV = W / V;
  for (int i = threadIdx.x; i < rows * NV; i += THREADS_W) {
    const int r = i / NV, c = (i - r * NV) * V;
    const bool ok = c0 + c < d;
    cp_async16z(s + r * ld + c, g + (size_t)r * stride + (ok ? c0 + c : 0), ok);
  }
}

// n BS-row vectors (float32 or int32) of a step by cp.async, 4 bytes a thread
__device__ __forceinline__ void copy_vec(void* s, const void* g) {
  if ((int)threadIdx.x < BS) tf::cp_async4(static_cast<int*>(s) + threadIdx.x,
                                           static_cast<const int*>(g) + threadIdx.x);
}

// acc (16 rows x 8 N columns) += X Y^T over the columns [0, kd): X's 16 rows
// at x, Y's 8 N rows at y, rows of ld.
template <class P, int N>
__device__ __forceinline__ void mma_nt(float (&acc)[N][4], const typename Ops<P>::T* x,
                                       const typename Ops<P>::T* y, int ld, int kd, int g, int t) {
  using O = Ops<P>;
#pragma unroll 2
  for (int k0 = 0; k0 < kd; k0 += O::KS) {
    typename O::A a;
    O::lda(a, x, ld, k0, g, t);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      typename O::B b;
      O::ldb_n(b, y + n * 8 * ld, ld, k0, g, t);
      O::mma(acc[n], a, b);
    }
  }
}

// acc (16 x 8 N) += X Y: X the warp's 16 x 8 NS tile (P or dS) in the C
// fragments x, Y 8 NS x 8 N at y (rows of ldy); only the n-tiles below nv.
template <class P, int N, int NS>
__device__ __forceinline__ void mma_rc(float (&acc)[N][4], const float (&x)[NS][4],
                                       const typename Ops<P>::T* y, int ldy, int nv, int g,
                                       int t) {
  using O = Ops<P>;
#pragma unroll
  for (int kk = 0; kk < 8 * NS / O::KS; ++kk) {
    typename O::A a;
    O::template lda_c<NS>(a, x, kk);
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (n < nv) {
        typename O::B b;
        O::ldb_kp(b, y + n * 8, ldy, kk * O::KS, g, t);
        O::mma(acc[n], a, b);
      }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// The block's part of an output: rows r0 + g, + 8 of the tile's 16 (out at
// row r0, column c0), its n-tiles below nv, times s0 and s1.
template <class P, int N>
__device__ __forceinline__ void store_out(typename Ops<P>::T* out, int stride, const float (&x)[N][4],
                                          float s0, float s1, int nv, int g, int t) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < nv) {
      typename Ops<P>::T* p = out + (size_t)g * stride + n * 8 + 2 * t;
      P::store2(p, x[n][0] * s0, x[n][1] * s0);
      P::store2(p + (size_t)8 * stride, x[n][2] * s1, x[n][3] * s1);
    }
}

// Where a block stands: its row tile and column slice of CS columns
// (blockIdx.x = tile x slices + slice), its (b, h) and the chunks of the
// head dim.
template <class P, int CS>
struct Where {
  int r0, c0, nv, nc;
  size_t base;
  const int* seg;
  __device__ explicit Where(const Args& a) {
    const int ns = (a.d + CS - 1) / CS;
    const int tile = blockIdx.x / ns;
    c0 = (blockIdx.x - tile * ns) * CS;
    r0 = tile * BR;
    nv = min(CS / 8, (a.d - c0) / 8);
    nc = (a.d + Lay<P>::DC - 1) / Lay<P>::DC;
    base = (size_t)blockIdx.z * a.sb + (size_t)blockIdx.y * a.sh;
    seg = a.seg ? a.seg + (size_t)blockIdx.z * a.L : nullptr;
  }
};

// k-columns of chunk c that the products take: to a multiple of KS (the
// zero tail of the last chunk in bf16)
template <class P>
__device__ __forceinline__ int chunk_k(int d, int c) {
  const int left = d - c * Lay<P>::DC;
  return min(Lay<P>::DC, round_up(left, Ops<P>::KS));
}

// o and lse of BR query rows, o's columns [c0, c0 + CS_FWD): out0 = o, out1 =
// lse (written by the slice at c0 = 0). Step st takes key tile st / nc's
// chunk st % nc: S accumulates over the chunks; after the last one, the
// online softmax and O += P V on the slice of V that came with the tile's
// first chunk.
template <class P>
__global__ void __launch_bounds__(THREADS_W, 1) fwd_kernel(Args a) {
  using T = typename Ops<P>::T;
  using Y = Lay<P>;
  constexpr int LDC = Y::LDC, LDS = slice_ld<P>(CS_FWD), NO = CS_FWD / 8, NS = BS / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qc = reinterpret_cast<T*>(smem);
  T* kc = qc + 2 * BR * LDC;
  T* vs = kc + 2 * BS * LDC;
  int* segk = reinterpret_cast<int*>(vs + BS * LDS);

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const Where<P, CS_FWD> at(a);
  const int d = a.d, nc = at.nc;
  const T* qg = static_cast<const T*>(a.q) + at.base + (size_t)at.r0 * a.sl;
  const T* kg = static_cast<const T*>(a.k) + at.base;
  const T* vg = static_cast<const T*>(a.v) + at.base;

  auto stage = [&](int st) {  // step st's chunk of Q and of K (one group)
    const int j = st / nc, c = st - j * nc;
    copy_cols<T, Y::DC>(qc + (st & 1) * BR * LDC, LDC, qg, a.sl, BR, c * Y::DC, d);
    copy_cols<T, Y::DC>(kc + (st & 1) * BS * LDC, LDC, kg + (size_t)j * BS * a.sl, a.sl, BS,
                        c * Y::DC, d);
    commit();
  };
  int sq[2] = {0, 0};
  if (at.seg) {
    sq[0] = at.seg[at.r0 + 16 * w + g];
    sq[1] = at.seg[at.r0 + 16 * w + g + 8];
  }
  float o[NO][4], s[NS][4];
  zero(o);
  zero(s);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * LOG2E;  // scores in the log2 domain

  const int steps = a.L / BS * nc;
  stage(0);
  for (int st = 0; st < steps; ++st) {
    const int j = st / nc, c = st - j * nc;
    if (c == 0) {  // V's slice and the keys' segment ids of tile j, landing under its chunks
      if (st > 0) __syncthreads();  // every warp is done with tile j - 1's
      copy_cols<T, CS_FWD>(vs, LDS, vg + (size_t)j * BS * a.sl, a.sl, BS, at.c0, d);
      if (at.seg) copy_vec(segk, at.seg + j * BS);
      else if ((int)threadIdx.x < BS) segk[threadIdx.x] = 0;
      commit();
    }
    // this step's chunks (the slice too at the tile's last); step st - 1 is
    // done with the other buffer
    wait_landed(c != 0 || nc == 1);
    if (st + 1 < steps) stage(st + 1);
    mma_nt<P, NS>(s, qc + (st & 1) * BR * LDC + 16 * w * LDC, kc + (st & 1) * BS * LDC, LDC,
                  chunk_k<P>(d, c), g, t);
    if (c != nc - 1) continue;
    // the online softmax of rows g and g + 8 (lane quads share a row)
    float mx[2] = {m[0], m[1]};
    const int* sk = segk + 2 * t;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fmaf(s[n][e], sl2, sq[e >> 1] == sk[n * 8 + (e & 1)] ? 0.f : MASK);
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        ls[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    mma_rc<P, NO, NS>(o, s, vs, LDS, at.nv, g, t);  // P rounded to T
    zero(s);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row = at.r0 + 16 * w;
  store_out<P, NO>(static_cast<T*>(a.out0) + at.base + (size_t)row * a.sl + at.c0, a.sl, o,
                   1.f / l[0], 1.f / l[1], at.nv, g, t);
  if (at.c0 == 0 && t == 0) {  // every slice has the same m and l; the first writes lse
    float* lse = static_cast<float*>(a.out1) + ((size_t)blockIdx.z * a.H + blockIdx.y) * a.L + row + g;
    lse[0] = m[0] * LN2 + logf(l[0]);
    lse[8] = m[1] * LN2 + logf(l[1]);
  }
}

// dK and dV of BR key rows, columns [c0, c0 + CS_DKV): out0 = dk, out1 = dv.
// Step st takes query tile st / nc's chunk st % nc: S^T = K Q^T and dP^T = V
// dO^T accumulate over the chunks; after the last, P^T and dS^T, then dV +=
// P^T dO and dK += dS^T Q on the slices of dO and Q that came with the
// tile's first chunk.
template <class P>
__global__ void __launch_bounds__(THREADS_W, 1) dkv_kernel(Args a) {
  using T = typename Ops<P>::T;
  using Y = Lay<P>;
  constexpr int LDC = Y::LDC, LDS = slice_ld<P>(CS_DKV), NO = CS_DKV / 8, NS = BS / 8;
  constexpr int XC = BR * LDC, YC = BS * LDC;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xc = reinterpret_cast<T*>(smem);  // [buffer][K, V] chunks
  T* yc = xc + 4 * XC;                 // [buffer][Q, dO] chunks
  T* qs = yc + 4 * YC;
  T* dos = qs + BS * LDS;
  float* lse_s = reinterpret_cast<float*>(dos + BS * LDS);
  float* dsum_s = lse_s + BS;
  int* segq = reinterpret_cast<int*>(dsum_s + BS);

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const Where<P, CS_DKV> at(a);
  const int d = a.d, nc = at.nc;
  const size_t rows = ((size_t)blockIdx.z * a.H + blockIdx.y) * a.L;
  const T* kg = static_cast<const T*>(a.k) + at.base + (size_t)at.r0 * a.sl;
  const T* vg = static_cast<const T*>(a.v) + at.base + (size_t)at.r0 * a.sl;
  const T* qg = static_cast<const T*>(a.q) + at.base;
  const T* og = static_cast<const T*>(a.dout) + at.base;

  auto stage = [&](int st) {  // step st's chunks of K, V, Q and dO (one group)
    const int j = st / nc, c = st - j * nc, c0 = c * Y::DC;
    T* x = xc + (st & 1) * 2 * XC;
    T* y = yc + (st & 1) * 2 * YC;
    const size_t q0 = (size_t)j * BS * a.sl;
    copy_cols<T, Y::DC>(x, LDC, kg, a.sl, BR, c0, d);
    copy_cols<T, Y::DC>(x + XC, LDC, vg, a.sl, BR, c0, d);
    copy_cols<T, Y::DC>(y, LDC, qg + q0, a.sl, BS, c0, d);
    copy_cols<T, Y::DC>(y + YC, LDC, og + q0, a.sl, BS, c0, d);
    commit();
  };
  int sk[2] = {0, 0};
  if (at.seg) {
    sk[0] = at.seg[at.r0 + 16 * w + g];
    sk[1] = at.seg[at.r0 + 16 * w + g + 8];
  }
  float dk[NO][4], dv[NO][4], s[NS][4], dp[NS][4];
  zero(dk);
  zero(dv);
  zero(s);
  zero(dp);
  const float sl2 = a.scale * LOG2E;

  const int steps = a.L / BS * nc;
  stage(0);
  for (int st = 0; st < steps; ++st) {
    const int j = st / nc, c = st - j * nc;
    if (c == 0) {  // the slices of Q and dO, lse, D and segment ids of tile j
      if (st > 0) __syncthreads();
      const size_t q0 = (size_t)j * BS * a.sl;
      copy_cols<T, CS_DKV>(qs, LDS, qg + q0, a.sl, BS, at.c0, d);
      copy_cols<T, CS_DKV>(dos, LDS, og + q0, a.sl, BS, at.c0, d);
      copy_vec(lse_s, a.lse + rows + j * BS);
      copy_vec(dsum_s, a.dsum + rows + j * BS);
      if (at.seg) copy_vec(segq, at.seg + j * BS);
      else if ((int)threadIdx.x < BS) segq[threadIdx.x] = 0;
      commit();
    }
    wait_landed(c != 0 || nc == 1);
    if (st + 1 < steps) stage(st + 1);
    const T* x = xc + (st & 1) * 2 * XC + 16 * w * LDC;
    const T* y = yc + (st & 1) * 2 * YC;
    const int kd = chunk_k<P>(d, c);
    mma_nt<P, NS>(s, x, y, LDC, kd, g, t);
    mma_nt<P, NS>(dp, x + XC, y + YC, LDC, kd, g, t);
    if (c != nc - 1) continue;
    // P^T = exp2(S^T scale log2(e) - lse log2(e)) where the segments match;
    // dS^T = P^T (dP^T - D) scale
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + 2 * t + (e & 1);
        const float p = sk[e >> 1] == segq[qi]
                            ? exp2f(fmaf(s[n][e], sl2, -(lse_s[qi] * LOG2E))) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dsum_s[qi]) * a.scale;
      }
    mma_rc<P, NO, NS>(dv, s, dos, LDS, at.nv, g, t);
    mma_rc<P, NO, NS>(dk, dp, qs, LDS, at.nv, g, t);
    zero(s);
    zero(dp);
  }
  const size_t out = at.base + (size_t)(at.r0 + 16 * w) * a.sl + at.c0;
  store_out<P, NO>(static_cast<T*>(a.out0) + out, a.sl, dk, 1.f, 1.f, at.nv, g, t);
  store_out<P, NO>(static_cast<T*>(a.out1) + out, a.sl, dv, 1.f, 1.f, at.nv, g, t);
}

// dQ of BR query rows, columns [c0, c0 + CS_DQ): out0 = dq. Step st takes key
// tile st / nc's chunk st % nc: S = Q K^T and dP = dO V^T over the chunks;
// after the last, P and dS, then dQ += dS K on K's slice.
template <class P>
__global__ void __launch_bounds__(THREADS_W, 1) dq_kernel(Args a) {
  using T = typename Ops<P>::T;
  using Y = Lay<P>;
  constexpr int LDC = Y::LDC, LDS = slice_ld<P>(CS_DQ), NO = CS_DQ / 8, NS = BS / 8;
  constexpr int XC = BR * LDC, YC = BS * LDC;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xc = reinterpret_cast<T*>(smem);  // [buffer][Q, dO] chunks
  T* yc = xc + 4 * XC;                 // [buffer][K, V] chunks
  T* ks = yc + 4 * YC;
  int* segk = reinterpret_cast<int*>(ks + BS * LDS);

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const Where<P, CS_DQ> at(a);
  const int d = a.d, nc = at.nc;
  const size_t rows = ((size_t)blockIdx.z * a.H + blockIdx.y) * a.L;
  const T* qg = static_cast<const T*>(a.q) + at.base + (size_t)at.r0 * a.sl;
  const T* og = static_cast<const T*>(a.dout) + at.base + (size_t)at.r0 * a.sl;
  const T* kg = static_cast<const T*>(a.k) + at.base;
  const T* vg = static_cast<const T*>(a.v) + at.base;

  auto stage = [&](int st) {  // step st's chunks of Q, dO, K and V (one group)
    const int j = st / nc, c = st - j * nc, c0 = c * Y::DC;
    T* x = xc + (st & 1) * 2 * XC;
    T* y = yc + (st & 1) * 2 * YC;
    const size_t k0 = (size_t)j * BS * a.sl;
    copy_cols<T, Y::DC>(x, LDC, qg, a.sl, BR, c0, d);
    copy_cols<T, Y::DC>(x + XC, LDC, og, a.sl, BR, c0, d);
    copy_cols<T, Y::DC>(y, LDC, kg + k0, a.sl, BS, c0, d);
    copy_cols<T, Y::DC>(y + YC, LDC, vg + k0, a.sl, BS, c0, d);
    commit();
  };
  int sq[2] = {0, 0};
  float lq[2], dq_sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = at.r0 + 16 * w + g + 8 * r;
    if (at.seg) sq[r] = at.seg[row];
    lq[r] = a.lse[rows + row] * LOG2E;
    dq_sum[r] = a.dsum[rows + row];
  }
  float dq[NO][4], s[NS][4], dp[NS][4];
  zero(dq);
  zero(s);
  zero(dp);
  const float sl2 = a.scale * LOG2E;

  const int steps = a.L / BS * nc;
  stage(0);
  for (int st = 0; st < steps; ++st) {
    const int j = st / nc, c = st - j * nc;
    if (c == 0) {  // K's slice and the keys' segment ids of tile j
      if (st > 0) __syncthreads();
      copy_cols<T, CS_DQ>(ks, LDS, kg + (size_t)j * BS * a.sl, a.sl, BS, at.c0, d);
      if (at.seg) copy_vec(segk, at.seg + j * BS);
      else if ((int)threadIdx.x < BS) segk[threadIdx.x] = 0;
      commit();
    }
    wait_landed(c != 0 || nc == 1);
    if (st + 1 < steps) stage(st + 1);
    const T* x = xc + (st & 1) * 2 * XC + 16 * w * LDC;
    const T* y = yc + (st & 1) * 2 * YC;
    const int kd = chunk_k<P>(d, c);
    mma_nt<P, NS>(s, x, y, LDC, kd, g, t);
    mma_nt<P, NS>(dp, x + XC, y + YC, LDC, kd, g, t);
    if (c != nc - 1) continue;
    // P = exp2(S scale log2(e) - lse log2(e)) where the segments match; dS =
    // P (dP - D) scale
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ki = n * 8 + 2 * t + (e & 1), r = e >> 1;
        const float p = sq[r] == segk[ki] ? exp2f(fmaf(s[n][e], sl2, -lq[r])) : 0.f;
        dp[n][e] = p * (dp[n][e] - dq_sum[r]) * a.scale;
      }
    mma_rc<P, NO, NS>(dq, dp, ks, LDS, at.nv, g, t);
    zero(s);
    zero(dp);
  }
  store_out<P, NO>(static_cast<T*>(a.out0) + at.base + (size_t)(at.r0 + 16 * w) * a.sl + at.c0,
                   a.sl, dq, 1.f, 1.f, at.nv, g, t);
}

}  // namespace wd

// ---- the wide head dims on thread block clusters (namespace cl): each
// block of a cluster owns one part of the head dim. See the header.
namespace cl {

constexpr int PART_MAX = 264;    // the widest part a block of the forward, and of the float32 backward, takes
constexpr int PART_BF16 = 176;   // the widest part a block of the bf16 backward takes (11 panels)
constexpr int CLUSTER_MAX = 8;   // the portable cluster size: float32 d up to CLUSTER_MAX * PART_MAX
constexpr int REACH_BF16 = CLUSTER_MAX * PART_BF16;  // the widest bf16 head dim on clusters
constexpr int XCH_BWD = WARPS * 2 * 128;  // the backward's exchange (floats): a warp's 16 x 16 tile

__device__ __forceinline__ int ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return (int)r;
}
// The cluster barrier in its two halves: every thread of every block of the
// cluster arrives (its shared-memory writes and reads before it are then
// done), and a wait returns once all have.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// 16 bytes at p (a shared-memory address of this block) in block `rank`'s
// shared memory (distributed shared memory)
__device__ __forceinline__ float4 ld_rank(const float* p, int rank) {
  uint32_t at;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(at) : "r"(tc::smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(at) : "memory");
  return v;
}

// The parts of a head dim d (a multiple of 8) at parts of at most `part`
// columns: n = ceil(d / part) ranks; of its d / 8 = q n + m n-tiles, rank r
// takes q (the first m ranks q + 1) from n-tile r q + min(r, m) on.
__host__ __device__ inline int ranks(int d, int part) { return (d / 8 + part / 8 - 1) / (part / 8); }
struct Part {
  int c0, pd, pd0;  // its first column, its width, rank 0's width (the widest: every rank's layout)
  __host__ __device__ Part(int d, int n, int r) {
    const int nt = d / 8, q = nt / n, m = nt % n;
    c0 = 8 * (r * q + (r < m ? r : m));
    pd = 8 * (q + (r < m ? 1 : 0));
    pd0 = 8 * (q + (m > 0 ? 1 : 0));
  }
};

// x (a warp's C fragments, 4 floats a lane an n-tile) = the sum over the
// cluster's ranks, in rank order, of each rank's partial at `slot`.
template <int N>
__device__ __forceinline__ void sum_ranks(float (&x)[N][4], const float* slot, int n, int lane) {
  for (int r = 0; r < n; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const float4 p = ld_rank(slot + c * 128 + lane * 4, r);
      x[c][0] = r ? x[c][0] + p.x : p.x;
      x[c][1] = r ? x[c][1] + p.y : p.y;
      x[c][2] = r ? x[c][2] + p.z : p.z;
      x[c][3] = r ? x[c][3] + p.w : p.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void put_slot(float* slot, const float (&x)[N][4], int lane) {
#pragma unroll
  for (int c = 0; c < N; ++c)
    *reinterpret_cast<float4*>(slot + c * 128 + lane * 4) = make_float4(x[c][0], x[c][1], x[c][2],
                                                                        x[c][3]);
}

// Shared memory of the forward: fw's at rank 0's part, then a slot of S's
// partial for each warp pair.
template <class P, int RG>
__host__ __device__ inline size_t fwd_smem(int pd0) {
  return fw::Smem<P, RG>(pd0).bytes +
         (size_t)fw::PAIRS * fw::Tile<P, RG>::NS * 128 * sizeof(float);
}

// o and lse of BQ query rows, o's columns of this rank's part: out0 = o,
// out1 = lse (rank 0). fw's block at the part (float32 or bf16): each warp
// pair sums its halves of S in shared memory, the pairs' sums are summed
// across the cluster, and P.V of key tile j - 1 runs under step j's exchange
// barrier (V arrives a step after K).
template <class P, int RG>
__global__ void __launch_bounds__(THREADS, 1) fwd_kernel(Args a) {
  using T = typename P::T;
  using C = fw::Tile<P, RG>;
  constexpr int KQ = C::KQ, BK = C::BK, KW = C::KW, NS = C::NS, NTD = C::NTD;
  constexpr int PAIRS = fw::PAIRS;
  constexpr bool F = std::is_same_v<P, F32>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = nctarank(), rank = ctarank();
  const Part pt(a.d, n, rank);
  const fw::Smem<P, RG> lay(pt.pd0);  // one layout in every rank: the exchange at one offset
  T* Qs = reinterpret_cast<T*>(smem + lay.q);
  T* Kb = reinterpret_cast<T*>(smem + lay.k);
  T* Vb = reinterpret_cast<T*>(smem + lay.v);
  float* xch = reinterpret_cast<float*>(smem + lay.xch);
  int* segq = reinterpret_cast<int*>(smem + lay.segq);
  int* segk = reinterpret_cast<int*>(smem + lay.segk);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int u = warp % PAIRS, dh = warp / PAIRS, rg = u % RG, kq = u / RG;
  const int pd = pt.pd, ldq = fw::ld_qk<P>(pt.pd0), ldv = fw::ld_v<P>(pt.pd0), nt = pd / 8;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x / n * C::BQ;
  const size_t base = (size_t)b * a.sb + (size_t)h * a.sh + pt.c0;  // this rank's columns
  const int* seg = a.seg ? a.seg + (size_t)b * a.L : nullptr;
  const T* kcols = static_cast<const T*>(a.k) + base;
  const T* vcols = static_cast<const T*>(a.v) + base;
  const int lid = threadIdx.x;

  // this warp's half of the part: S's k-steps [kb, ke), O's n-tiles n0.. (ntw)
  int kb, ke, n0, ntw;
  if constexpr (F) {
    const int kh = (nt + 1) / 2;
    kb = dh ? kh : 0;
    ke = dh ? nt : kh;
    n0 = dh ? kh : 0;
    ntw = dh ? nt - kh : kh;
  } else {  // fw's: k-steps of 16 columns, o's n-tiles in pairs (the zero tail's computed, not stored)
    const int nk = (pd + 15) / 16, kh = (nk + 1) / 2, np = (nt + 1) / 2, ph = (np + 1) / 2;
    kb = dh ? kh : 0;
    ke = dh ? nk : kh;
    n0 = dh ? 2 * ph : 0;
    ntw = dh ? 2 * (np - ph) : 2 * ph;
  }

  // key tile j's part of K and its segment ids, or its part of V, into
  // buffer j & 1 (a step commits one group: K of tile j + 1, V of tile j)
  auto fetch_k = [&](int j) {
    fw::copy_rows(Kb + (j & 1) * BK * ldq, ldq, kcols + (size_t)j * BK * a.sl, a.sl, BK, pd);
    if (lid < BK) {
      if (seg) tf::cp_async4(segk + (j & 1) * BK + lid, seg + j * BK + lid);
      else segk[(j & 1) * BK + lid] = 0;
    }
  };
  auto fetch_v = [&](int j) {
    fw::copy_rows(Vb + (j & 1) * BK * ldv, ldv, vcols + (size_t)j * BK * a.sl, a.sl, BK, pd);
  };
  fw::copy_rows(Qs, ldq, static_cast<const T*>(a.q) + base + (size_t)q0 * a.sl, a.sl, C::BQ, pd);
  if (lid < C::BQ) {
    if (seg) tf::cp_async4(segq + lid, seg + q0 + lid);
    else segq[lid] = 0;
  }
  fetch_k(0);
  asm volatile("cp.async.commit_group;" ::: "memory");
  if constexpr (!F) {  // bf16's zero tail [pd, pd + 8) of every row the products read (fw's)
    if (pd % 16 != 0) {
      for (int r = lid; r < C::BQ + 4 * BK; r += THREADS) {
        T* row = r < C::BQ ? Qs + r * ldq
                 : r < C::BQ + 2 * BK ? Kb + (r - C::BQ) * ldq : Vb + (r - C::BQ - 2 * BK) * ldv;
        *reinterpret_cast<uint4*>(row + pd) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  float acc[NTD][4];
#pragma unroll
  for (int i = 0; i < NTD; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float pp[NS][4];  // P of the last key tile
  int sq[2] = {0, 0};
  const float sl2 = a.scale * fw::LOG2E;
  // this warp's half of S and its partner's; the pair's partial, which
  // warp dh = 0 publishes to the cluster
  float* mine = xch + warp * (NS * 128);
  const float* other = xch + (warp ^ PAIRS) * (NS * 128);
  float* slot = reinterpret_cast<float*>(smem + lay.bytes) + u * (NS * 128);
  auto pv_of = [&](const float (&p)[NS][4], int j) {
    fw::pv<NS, NTD>(acc, p, Vb + ((j & 1) * BK + kq * KW) * ldv, ldv, n0, ntw, lane, g, t);
  };

  const int steps = a.L / BK;
  for (int j = 0; j < steps; ++j) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // K of tile j and V of tile j - 1 have arrived; the other buffers are free
    if (j + 1 < steps) fetch_k(j + 1);
    fetch_v(j);
    asm volatile("cp.async.commit_group;" ::: "memory");
    if (j == 0) {
      sq[0] = segq[rg * 16 + g];
      sq[1] = segq[rg * 16 + g + 8];
    }
    const T* Kt = Kb + ((j & 1) * BK + kq * KW) * ldq;
    const int* sk = segk + (j & 1) * BK + kq * KW + 2 * t;
    float s[NS][4];
    if constexpr (F) fw::s_part<NS>(s, Qs + rg * 16 * ldq, Kt, ldq, kb, ke, g, t);
    else fw::s_part<NS>(s, Qs + rg * 16 * ldq, Kt, ldq, kb, ke, lane);
    // the pair's halves: x0 + x1 in both warps
    put_slot<NS>(mine, s, lane);
    tf::named_sync(1 + u, 64);  // the partner's half is written
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      const float4 y = *reinterpret_cast<const float4*>(other + c * 128 + lane * 4);
      s[c][0] += y.x;
      s[c][1] += y.y;
      s[c][2] += y.z;
      s[c][3] += y.w;
    }
    // S = the ranks' partials summed in rank order: the same S, m and l in
    // every rank. The exchange is written once every rank has read the
    // last step's (the second half of its barrier, arrived at below).
    if (j > 0) cluster_wait();
    if (dh == 0) put_slot<NS>(slot, s, lane);
    cluster_arrive();
    if (j > 0) pv_of(pp, j - 1);  // under the barrier
    cluster_wait();
    sum_ranks<NS>(s, slot, n, lane);
    cluster_arrive();
    // the online softmax of rows g and g + 8 (lane quads share a row)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fmaf(s[c][e], sl2, sq[e >> 1] == sk[c * 8 + (e & 1)] ? 0.f : MASK);
        s[c][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);  // 0 on the first step (m = -inf)
      m[r] = mx[r];
    }
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[c][e] - m[e >> 1]);
        s[c][e] = p;
        ls[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < NTD; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }
    }
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) pp[c][e] = s[c][e];
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();  // V of the last key tile has arrived
  pv_of(pp, steps - 1);
  cluster_wait();  // no rank reads this block's exchange any more: it may exit

  // each row's sum over the quad; key groups merge by their row max (fw's)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float mt[2] = {m[0], m[1]}, lt[2] = {l[0], l[1]};
  if constexpr (KQ > 1) {
    float* ml = reinterpret_cast<float*>(smem + lay.ml);  // [rg][kq][row]{m, l}
    float* part = reinterpret_cast<float*>(smem + lay.k);
    __syncthreads();  // every warp is done with K and V: their buffers take the partial O's
    if (dh == 0 && t == 0) {
      float* x = ml + (rg * KQ + kq) * 32;
      x[2 * g] = m[0];
      x[2 * g + 1] = l[0];
      x[2 * (g + 8)] = m[1];
      x[2 * (g + 8) + 1] = l[1];
    }
    __syncthreads();
    float f[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* x = ml + rg * KQ * 32 + 2 * (g + 8 * r);
      float mm = x[0];
#pragma unroll
      for (int w = 1; w < KQ; ++w) mm = fmaxf(mm, x[w * 32]);
      float ll = 0.f;
#pragma unroll
      for (int w = 0; w < KQ; ++w) ll += exp2f(x[w * 32] - mm) * x[w * 32 + 1];
      mt[r] = mm;
      lt[r] = ll;
      f[r] = exp2f(m[r] - mm);
    }
#pragma unroll
    for (int i = 0; i < NTD; ++i) {
      acc[i][0] *= f[0];
      acc[i][1] *= f[0];
      acc[i][2] *= f[1];
      acc[i][3] *= f[1];
    }
    auto at = [&](int w) { return part + ((rg * (KQ - 1) + w - 1) * 2 + dh) * (NTD * 128); };
    if (kq != 0) {
      float* x = at(kq) + lane * 4;
#pragma unroll
      for (int i = 0; i < NTD; ++i)
        if (i < ntw)
          *reinterpret_cast<float4*>(x + i * 128) = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                                                acc[i][3]);
    }
    __syncthreads();
    if (kq == 0) {
#pragma unroll
      for (int w = 1; w < KQ; ++w) {
        const float* x = at(w) + lane * 4;
#pragma unroll
        for (int i = 0; i < NTD; ++i)
          if (i < ntw) {
            const float4 y = *reinterpret_cast<const float4*>(x + i * 128);
            acc[i][0] += y.x;
            acc[i][1] += y.y;
            acc[i][2] += y.z;
            acc[i][3] += y.w;
          }
      }
    }
  }
  if (kq == 0) {
    const float inv0 = 1.f / lt[0], inv1 = 1.f / lt[1];
    T* out = static_cast<T*>(a.out0) + base + (size_t)(q0 + rg * 16 + g) * a.sl + 2 * t;
#pragma unroll
    for (int i = 0; i < NTD; ++i) {
      const int nn = n0 + i;
      if (i < ntw && nn < nt) {
        P::store2(out + nn * 8, acc[i][0] * inv0, acc[i][1] * inv0);
        P::store2(out + (size_t)8 * a.sl + nn * 8, acc[i][2] * inv1, acc[i][3] * inv1);
      }
    }
    if (rank == 0 && dh == 0 && t == 0) {  // every rank has the same m and l
      float* lse = static_cast<float*>(a.out1) + ((size_t)b * a.H + h) * a.L + q0 + rg * 16 + g;
      lse[0] = mt[0] * fw::LN2 + logf(lt[0]);
      lse[8] = mt[1] * fw::LN2 + logf(lt[1]);
    }
  }
}

// tf::s_p_ds on the part, with each warp's S (S^T) or dP (dP^T) tile summed
// across the cluster before P and dS: xch is this block's exchange, `first`
// the block's first step.
__device__ __forceinline__ void s_p_ds(const float* xs, const float* xd, const float* ys,
                                       const float* yd, int ld, int pd, bool rows_are_keys,
                                       const float* lse, const float* dsum, const int* segq,
                                       const int* segk, float scale, float* pa, float* pb,
                                       bool write_pt, float* xch, int n, bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = (warp & 3) >> 1, cg = warp & 1;
  const bool is_s = warp < 4;
  float s[2][4];
  tf::s_tile(s, (is_s ? xs : xd) + rg * 16 * ld, (is_s ? ys : yd) + cg * 16 * ld, ld, pd, g, t);
  float* slot = xch + warp * 256;
  if (!first) cluster_wait();  // every rank has read the last step's partials
  put_slot<2>(slot, s, lane);
  cluster_arrive();
  cluster_wait();
  sum_ranks<2>(s, slot, n, lane);
  cluster_arrive();
  const int r0 = rg * 16, c0 = cg * 16;
  float* hand = pb + (warp & 3) * 8 * 32 + lane;
  if (is_s) {
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1), c = c0 + nn * 8 + 2 * t + (e & 1);
        const int qi = rows_are_keys ? c : r, ki = rows_are_keys ? r : c;
        const float x = s[nn][e] * scale + (segq[qi] == segk[ki] ? 0.f : MASK);
        const float p = expf(x - lse[qi]);
        hand[(nn * 4 + e) * 32] = p;
        if (write_pt) tf::store_frag(pa, r, c, p);
      }
  }
  __syncthreads();  // P handed over
  if (!is_s) {
    float p[2][4];
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nn][e] = hand[(nn * 4 + e) * 32];
    tf::named_sync(1, 128);  // every dP warp has read P before pb is overwritten
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1), c = c0 + nn * 8 + 2 * t + (e & 1);
        const int qi = rows_are_keys ? c : r;
        tf::store_frag(pb, r, c, p[nn][e] * (s[nn][e] - dsum[qi]) * scale);
      }
  }
}

// Shared memory of the backward: tf's at rank 0's part, then the exchange.
__host__ __device__ inline size_t bwd_xch(int pd0) { return tf::Smem(pd0).bytes; }
__host__ __device__ inline size_t bwd_smem(int pd0) {
  return bwd_xch(pd0) + XCH_BWD * sizeof(float);
}

// dK and dV of one key tile of TB rows, this rank's columns: out0 = dk,
// out1 = dv. tf's block at the part: it streams its part of Q and dO.
__global__ void __launch_bounds__(THREADS, 1) dkv_kernel(Args a) {
  using tf::TB;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = nctarank(), rank = ctarank();
  const Part pt(a.d, n, rank);
  const tf::Smem lay(pt.pd0);
  float* Ks = reinterpret_cast<float*>(smem + lay.res0);
  float* Vs = reinterpret_cast<float*>(smem + lay.res1);
  float* Pt = reinterpret_cast<float*>(smem + lay.pa);
  float* dSt = reinterpret_cast<float*>(smem + lay.pb);
  int* segk = reinterpret_cast<int*>(smem + lay.segk);
  float* xch = reinterpret_cast<float*>(smem + bwd_xch(pt.pd0));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int pd = pt.pd, ld = tf::ld_of(pt.pd0), nt = pd / 8;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x / n * TB;
  const size_t base = (size_t)b * a.sb + (size_t)h * a.sh + pt.c0;  // this rank's columns
  const size_t rows = ((size_t)b * a.H + h) * a.L;
  const int* seg = a.seg ? a.seg + (size_t)b * a.L : nullptr;
  const float* qcols = static_cast<const float*>(a.q) + base;
  const float* docols = static_cast<const float*>(a.dout) + base;

  // query tile j's part of Q and dO, its lse, D and segment ids into buffer j & 1
  const int lid = threadIdx.x;
  auto fetch = [&](int j) {
    float* dst = reinterpret_cast<float*>(smem + ((j & 1) ? lay.buf1 : lay.buf0));
    const size_t row0 = (size_t)j * TB * a.sl;
    const int o = (j & 1) * TB;
    tf::copy2(dst, dst + TB * ld, ld, qcols + row0, docols + row0, a.sl, pd);
    if (lid < TB) {
      tf::cp_async4(reinterpret_cast<float*>(smem + lay.lse) + o + lid, a.lse + rows + j * TB + lid);
      tf::cp_async4(reinterpret_cast<float*>(smem + lay.dsum) + o + lid,
                    a.dsum + rows + j * TB + lid);
      if (seg) tf::cp_async4(reinterpret_cast<int*>(smem + lay.segq) + o + lid, seg + j * TB + lid);
      else reinterpret_cast<int*>(smem + lay.segq)[o + lid] = 0;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  tf::copy2(Ks, Vs, ld, static_cast<const float*>(a.k) + base + (size_t)k0 * a.sl,
            static_cast<const float*>(a.v) + base + (size_t)k0 * a.sl, a.sl, pd);
  load_seg(segk, seg ? seg + k0 : nullptr, TB);
  fetch(0);

  // dV += P^T dO (warps 0-3), dK += dS^T Q (4-7): both row groups, n-tiles
  // (w & 3) + 4 i of the part
  const bool is_dv = warp < 4;
  float acc[2][tf::NTW_KV][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < tf::NTW_KV; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][i][e] = 0.f;

  const int steps = a.L / TB;
  for (int j = 0; j < steps; ++j) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // query tile j has arrived; tile j - 1 is done with the other buffer
    if (j + 1 < steps) fetch(j + 1);
    const float* Qt = reinterpret_cast<const float*>(smem + ((j & 1) ? lay.buf1 : lay.buf0));
    const float* dOt = Qt + TB * ld;
    const int o = (j & 1) * TB;
    // S^T = K Q^T, dP^T = V dO^T, each summed across the cluster
    s_p_ds(Ks, Vs, Qt, dOt, ld, pd, true, reinterpret_cast<const float*>(smem + lay.lse) + o,
           reinterpret_cast<const float*>(smem + lay.dsum) + o,
           reinterpret_cast<const int*>(smem + lay.segq) + o, segk, a.scale, Pt, dSt, true, xch,
           n, j == 0);
    if (is_dv) {
      tf::accumulate(acc, Pt, dOt, ld, nt, warp & 3, 4, lane, g, t);
    } else {
      tf::named_sync(2, 128);  // dS^T is complete
      tf::accumulate(acc, dSt, Qt, ld, nt, warp & 3, 4, lane, g, t);
    }
  }
  cluster_wait();  // no rank reads this block's exchange any more: dK and dV out
  float* out = static_cast<float*>(is_dv ? a.out1 : a.out0) + base + (size_t)k0 * a.sl;
  store_rows<F32, tf::NTW_KV>(out, a.sl, acc[0], 1.f, 1.f, nt, warp & 3, 4, g, t);
  store_rows<F32, tf::NTW_KV>(out + (size_t)16 * a.sl, a.sl, acc[1], 1.f, 1.f, nt, warp & 3, 4, g,
                              t);
}

// dQ of one query tile of TB rows, this rank's columns: out0 = dq. tf's block
// at the part: it streams its part of K and V.
__global__ void __launch_bounds__(THREADS, 1) dq_kernel(Args a) {
  using tf::TB;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = nctarank(), rank = ctarank();
  const Part pt(a.d, n, rank);
  const tf::Smem lay(pt.pd0);
  float* Qs = reinterpret_cast<float*>(smem + lay.res0);
  float* dOs = reinterpret_cast<float*>(smem + lay.res1);
  float* dSs = reinterpret_cast<float*>(smem + lay.pb);
  float* lse_s = reinterpret_cast<float*>(smem + lay.lse);
  float* dsum_s = reinterpret_cast<float*>(smem + lay.dsum);
  int* segq = reinterpret_cast<int*>(smem + lay.segq);
  int* segk = reinterpret_cast<int*>(smem + lay.segk);
  float* xch = reinterpret_cast<float*>(smem + bwd_xch(pt.pd0));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int pd = pt.pd, ld = tf::ld_of(pt.pd0), nt = pd / 8;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x / n * TB;
  const size_t base = (size_t)b * a.sb + (size_t)h * a.sh + pt.c0;  // this rank's columns
  const size_t rows = ((size_t)b * a.H + h) * a.L;
  const int* seg = a.seg ? a.seg + (size_t)b * a.L : nullptr;
  const float* kcols = static_cast<const float*>(a.k) + base;
  const float* vcols = static_cast<const float*>(a.v) + base;

  // key tile j's part of K and V and its segment ids into buffer j & 1
  const int lid = threadIdx.x;
  auto fetch = [&](int j) {
    float* dst = reinterpret_cast<float*>(smem + ((j & 1) ? lay.buf1 : lay.buf0));
    const size_t row0 = (size_t)j * TB * a.sl;
    const int o = (j & 1) * TB;
    tf::copy2(dst, dst + TB * ld, ld, kcols + row0, vcols + row0, a.sl, pd);
    if (lid < TB) {
      if (seg) tf::cp_async4(segk + o + lid, seg + j * TB + lid);
      else segk[o + lid] = 0;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  tf::copy2(Qs, dOs, ld, static_cast<const float*>(a.q) + base + (size_t)q0 * a.sl,
            static_cast<const float*>(a.dout) + base + (size_t)q0 * a.sl, a.sl, pd);
  if (lid < TB) {
    lse_s[lid] = a.lse[rows + q0 + lid];
    dsum_s[lid] = a.dsum[rows + q0 + lid];
  }
  load_seg(segq, seg ? seg + q0 : nullptr, TB);
  fetch(0);

  // dQ += dS K: both row groups, n-tiles w + 8 i of the part
  float acc[2][tf::NTW_Q][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < tf::NTW_Q; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][i][e] = 0.f;

  const int steps = a.L / TB;
  for (int j = 0; j < steps; ++j) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // key tile j has arrived; tile j - 1 is done with the other buffer
    if (j + 1 < steps) fetch(j + 1);
    const float* Kt = reinterpret_cast<const float*>(smem + ((j & 1) ? lay.buf1 : lay.buf0));
    const float* Vt = Kt + TB * ld;
    // S = Q K^T, dP = dO V^T, each summed across the cluster
    s_p_ds(Qs, dOs, Kt, Vt, ld, pd, false, lse_s, dsum_s, segq, segk + (j & 1) * TB, a.scale,
           nullptr, dSs, false, xch, n, j == 0);
    __syncthreads();  // dS is complete
    tf::accumulate(acc, dSs, Kt, ld, nt, warp, WARPS, lane, g, t);
  }
  cluster_wait();  // no rank reads this block's exchange any more: dQ out
  float* out = static_cast<float*>(a.out0) + base + (size_t)q0 * a.sl;
  store_rows<F32, tf::NTW_Q>(out, a.sl, acc[0], 1.f, 1.f, nt, warp, WARPS, g, t);
  store_rows<F32, tf::NTW_Q>(out + (size_t)16 * a.sl, a.sl, acc[1], 1.f, 1.f, nt, warp, WARPS, g,
                             t);
}


// ---- the bf16 backward on clusters: wg's block at a part of at most
// PART_BF16 columns (two warpgroups, the streamed tiles by TMA, P^T and dS^T
// as the accumulations' register A), its S and dP partials summed across
// the cluster through an exchange of two buffers by step parity.

constexpr int CB16 = PART_BF16 / 8;        // 16-byte chunks of a resident row
constexpr int RT16 = wg::BR * CB16 * 8;    // elements of a resident tile
constexpr int NP16 = PART_BF16 / 16;       // 16-column panels of a streamed tile
constexpr int ST16 = NP16 * wg::PANEL;     // elements of a streamed tile
constexpr int NQ0 = 96;                    // dQ's columns of warpgroup 0 (whole panels)
constexpr int NQ1 = PART_BF16 - NQ0;       // and of warpgroup 1
constexpr int XCH16 = 2 * wg::NS * 128;    // floats of an exchange buffer: each warpgroup's 64 x 64
static_assert(PART_BF16 % 16 == 0 && NQ0 % 16 == 0 && NQ1 % 16 == 0 && wg::BS == 64, "the layout");

// wg's Smem at PART_BF16 columns, then the exchange's two buffers.
struct SmemB {
  size_t res0, res1, buf0, buf1, xp, lse, dsum, seg, bar, xch, bytes;
  __host__ __device__ SmemB(bool dkv) {
    Carve c;
    res0 = c.take(RT16 * sizeof(bf16));
    res1 = c.take(RT16 * sizeof(bf16));
    buf0 = c.take(2 * ST16 * sizeof(bf16));
    buf1 = c.take(2 * ST16 * sizeof(bf16));
    xp = c.take(4 * wg::NS * 32 * sizeof(float));
    lse = c.take(dkv ? 2 * wg::BS * sizeof(float) : 0);
    dsum = c.take(dkv ? 2 * wg::BS * sizeof(float) : 0);
    seg = c.take(2 * wg::BS * sizeof(int));
    bar = c.take(2 * sizeof(uint64_t));
    xch = c.take(2 * XCH16 * sizeof(float));
    bytes = c.off;
  }
};

// d (64 x PART_BF16) += A (registers) B, B MN-major in shared memory
__device__ __forceinline__ void mma_acc(float (&d)[88], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87"
      "}, {%88, %89, %90, %91}, %92, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x NQ0) += A B, A K-major and B MN-major in shared memory
__device__ __forceinline__ void mma_acc_ss(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b));
}

// d (64 x NQ1) += A B, A K-major and B MN-major in shared memory
__device__ __forceinline__ void mma_acc_ss(float (&d)[40], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b));
}

// The pad of this rank's tiles: chunks [nv, CB16) of both resident tiles,
// panels [np, NP16) of both buffers' streamed tiles (TMA zeroes the columns
// past d in its boxes; a box past the part reads the next part's columns,
// which the zero chunks of the resident tile cancel in S and dP and no
// output keeps).
__device__ __forceinline__ void zero_part_pads(bf16* res, int nv, int np) {
  for (int i = threadIdx.x; i < (CB16 - nv) * wg::BR; i += THREADS) {
    *reinterpret_cast<uint4*>(res + (nv * wg::BR + i) * 8) = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(res + RT16 + (nv * wg::BR + i) * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  const int per = (NP16 - np) * wg::PANEL / 8;  // 16-byte pieces of a tile's pad panels
  for (int i = threadIdx.x; i < 4 * per; i += THREADS) {
    const int tile = i / per;
    *reinterpret_cast<uint4*>(res + 2 * RT16 + tile * ST16 + np * wg::PANEL + (i - tile * per) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// Step j's two streamed tiles (rows r0.. of (b, h), the np panels of this
// rank's part from column c0) into buf and buf + ST16 by TMA, completing on
// bar; warp 0.
__device__ __forceinline__ void tma_part(bf16* buf, const wg::Params& p, int r0, int c0, int h,
                                         int b, int np, uint64_t* bar, int lane) {
  if (lane == 0) wg::mbar_expect(bar, 2 * np * wg::BOX);
  __syncwarp();
  const int c1 = p.l_inner ? r0 : h, c2 = p.l_inner ? h : r0;
  for (int k = lane; k < 2 * np; k += 32) {
    const int one = k >= np, c = k - one * np;
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(tc::smem_u32(buf + one * ST16 + c * wg::PANEL)),
        "l"(reinterpret_cast<uint64_t>(one ? &p.t1 : &p.t0)), "r"(c0 + 16 * c), "r"(c1), "r"(c2),
        "r"(b), "r"(tc::smem_u32(bar)) : "memory");
  }
}

// s (a warpgroup's 64 x 64 accumulator, 32 floats a thread, 8 pieces of 16
// bytes) = the sum over the cluster's ranks, in rank order, of each rank's
// partial, by a reduce-scatter and an all-gather through distributed shared
// memory: each thread writes its partial to this block's exchange buffer at
// slot (one of two by step parity, so that no rank writes a buffer another
// may still read); after the cluster barrier, rank r sums the pieces c with
// c % n == r over every rank (its own from registers) and writes each sum
// back in place (no other rank reads those pieces in this round); after a
// second barrier it reads every other piece's sum from the rank that made
// it. So each rank reads 2 (n - 1) / n of a partial from the others, not n
// partials.
__device__ __forceinline__ void sum_partials(float (&s)[wg::NS], float* slot, int n, int rank) {
  constexpr int PIECES = wg::NS / 4;
#pragma unroll
  for (int c = 0; c < PIECES; ++c)
    *reinterpret_cast<float4*>(slot + c * 512) = make_float4(s[4 * c], s[4 * c + 1], s[4 * c + 2],
                                                             s[4 * c + 3]);
  cluster_arrive();
  cluster_wait();
#pragma unroll
  for (int c = 0; c < PIECES; ++c) {  // this rank's pieces: every rank's partial, in rank order
    if (c % n != rank) continue;
    const float4 x = make_float4(s[4 * c], s[4 * c + 1], s[4 * c + 2], s[4 * c + 3]);
    float4 acc = x;
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX; ++r) {
      if (r >= n) break;
      const float4 p = r == rank ? x : ld_rank(slot + c * 512, r);
      acc = r ? make_float4(acc.x + p.x, acc.y + p.y, acc.z + p.z, acc.w + p.w) : p;
    }
    s[4 * c] = acc.x;
    s[4 * c + 1] = acc.y;
    s[4 * c + 2] = acc.z;
    s[4 * c + 3] = acc.w;
    *reinterpret_cast<float4*>(slot + c * 512) = acc;
  }
  cluster_arrive();
  cluster_wait();
#pragma unroll
  for (int c = 0; c < PIECES; ++c) {  // the other pieces' sums, each from the rank that made it
    if (c % n == rank) continue;
    const float4 p = ld_rank(slot + c * 512, c % n);
    s[4 * c] = p.x;
    s[4 * c + 1] = p.y;
    s[4 * c + 2] = p.z;
    s[4 * c + 3] = p.w;
  }
}

// dK and dV of 64 key rows, this rank's columns: out0 = dk, out1 = dv.
// Warpgroup 0: S^T = K Q^T over the part, summed across the cluster, P^T,
// dV += P^T dO; warpgroup 1: dP^T = V dO^T likewise, dS^T, dK += dS^T Q.
__global__ void __launch_bounds__(THREADS, 1) dkv_bf16_kernel(const __grid_constant__ wg::Params pr) {
  extern __shared__ __align__(128) unsigned char wsmem[];
  unsigned char* smem = wsmem;
  const Args& a = pr.a;
  const int n = nctarank(), rank = ctarank();
  const Part pt(a.d, n, rank);
  const SmemB lay(true);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar);
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.res0);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.res1);
  float* xp = reinterpret_cast<float*>(smem + lay.xp);
  float* lse_s = reinterpret_cast<float*>(smem + lay.lse);
  float* dsum_s = reinterpret_cast<float*>(smem + lay.dsum);
  int* segq = reinterpret_cast<int*>(smem + lay.seg);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2, w = warp & 3;
  const int pd = pt.pd, nv = pd / 8, nk = (pd + 15) / 16;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x / n * wg::BR;
  const size_t base = (size_t)b * a.sb + (size_t)h * a.sh + pt.c0;  // this rank's columns
  const size_t rows = ((size_t)b * a.H + h) * a.L;
  const int* seg = a.seg ? a.seg + (size_t)b * a.L : nullptr;
  const int lid = threadIdx.x;
  // this thread's pieces of its warpgroup's slot in the exchange's buffer 0
  float* slot = reinterpret_cast<float*>(smem + lay.xch) + grp * (wg::NS * 128) + (lid & 127) * 4;

  auto buf = [&](int j) { return reinterpret_cast<bf16*>(smem + ((j & 1) ? lay.buf1 : lay.buf0)); };
  // query tile j's part of Q and dO by TMA, its lse, D and segment ids into buffer j & 1
  auto stage = [&](int j) {
    const int q0 = j * wg::BS, o = (j & 1) * wg::BS;
    if (warp == 0) tma_part(buf(j), pr, q0, pt.c0, h, b, nk, bars + (j & 1), lane);
    if (lid < wg::BS) {
      tf::cp_async4(lse_s + o + lid, a.lse + rows + q0 + lid);
      tf::cp_async4(dsum_s + o + lid, a.dsum + rows + q0 + lid);
      if (seg) tf::cp_async4(segq + o + lid, seg + q0 + lid);
      else segq[o + lid] = 0;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  zero_part_pads(Ks, nv, nk);
  if (lid == 0) {
    wg::mbar_init(bars);
    wg::mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  wg::copy_tile(Ks, static_cast<const bf16*>(a.k) + base + (size_t)k0 * a.sl, a.sl, nv, warp, lane);
  wg::copy_tile(Vs, static_cast<const bf16*>(a.v) + base + (size_t)k0 * a.sl, a.sl, nv, warp, lane);
  stage(0);

  int sk[2] = {0, 0};  // the segment ids of this thread's key rows
  if (seg) {
    sk[0] = seg[k0 + 16 * w + g];
    sk[1] = seg[k0 + 16 * w + g + 8];
  }
  const float sl2 = a.scale * wg::LOG2E;  // scores in the log2 domain
  float* xw = xp + w * (wg::NS * 32) + lane;
  float acc[PART_BF16 / 2];  // the gradient's columns of the part (and its pad)
#pragma unroll
  for (int i = 0; i < PART_BF16 / 2; ++i) acc[i] = 0.f;

  const int steps = a.L / wg::BS;
  for (int j = 0; j < steps; ++j) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    wg::mbar_wait(bars + (j & 1), (j >> 1) & 1);
    __syncthreads();  // step j's tiles have arrived; step j - 1 is done with the other buffer
    const bf16* Qt = buf(j);
    const bf16* dOt = Qt + ST16;
    const int o = (j & 1) * wg::BS + 2 * t;
    float s[wg::NS];  // the first k-step writes it (its wgmma's scale-d off)
    const bf16* xs = grp ? Vs : Ks;
    const bf16* ys = grp ? dOt : Qt;
    wg::wg_fence();
    for (int kk = 0; kk < nk; ++kk) wg::mma_s(s, wg::desc_k(xs, kk), wg::desc_ks(ys, kk), kk);
    wg::wg_commit();
    if (j + 1 < steps) stage(j + 1);  // the copies issue while the tensor cores run
    wg::wg_wait();
    wg::fence_regs(s);
    sum_partials(s, slot + (j & 1) * XCH16, n, rank);  // S^T (dP^T) over the whole head dim
    if (grp == 0) {  // P^T = exp2(S^T scale log2(e) - lse log2(e)) where the segments match
#pragma unroll
      for (int c = 0; c < wg::BS / 8; ++c) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + o + 8 * c);
        const int2 sq = *reinterpret_cast<const int2*>(segq + o + 8 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = (e & 1) ? l2.y : l2.x;
          const int sg = (e & 1) ? sq.y : sq.x;
          const float p =
              sk[e >> 1] == sg ? exp2f(fmaf(s[4 * c + e], sl2, -(lq * wg::LOG2E))) : 0.f;
          s[4 * c + e] = p;
          xw[(4 * c + e) * 32] = p;
        }
      }
      wg::bar_arrive(1, THREADS);  // P to warpgroup 1
    } else {  // dS^T = P^T (dP^T - D) scale
      tf::named_sync(1, THREADS);
#pragma unroll
      for (int c = 0; c < wg::BS / 8; ++c) {
        const float2 d2 = *reinterpret_cast<const float2*>(dsum_s + o + 8 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * c + e] = xw[(4 * c + e) * 32] * (s[4 * c + e] - ((e & 1) ? d2.y : d2.x)) * a.scale;
      }
    }
    uint32_t af[wg::KS][4];
    wg::to_a(af, s);
    const bf16* yb = grp ? Qt : dOt;  // dV += P^T dO, dK += dS^T Q on the part's columns
    wg::wg_fence();
#pragma unroll
    for (int kk = 0; kk < wg::KS; ++kk) mma_acc(acc, af[kk], wg::desc_mn(yb, kk, 0));
    wg::wg_commit();
    wg::wg_wait();
    wg::fence_regs(acc);
  }
  cluster_arrive();  // this block has read every rank's last partials
  cluster_wait();    // and every rank this block's: it may exit
  bf16* out = static_cast<bf16*>(grp ? a.out0 : a.out1) + base + (size_t)(k0 + 16 * w) * a.sl;
  wg::store_cols(out, a.sl, acc, 0, pd, g, t);
}

// dQ of 64 query rows, this rank's columns: out0 = dq. Warpgroup 0: S = Q
// K^T over the part, summed across the cluster, and P; warpgroup 1: dP = dO
// V^T likewise and dS, into shared memory; then dQ += dS K, warpgroup 0 on
// the part's first NQ0 columns, 1 on the rest.
__global__ void __launch_bounds__(THREADS, 1) dq_bf16_kernel(const __grid_constant__ wg::Params pr) {
  extern __shared__ __align__(128) unsigned char wsmem[];
  unsigned char* smem = wsmem;
  const Args& a = pr.a;
  const int n = nctarank(), rank = ctarank();
  const Part pt(a.d, n, rank);
  const SmemB lay(false);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar);
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.res0);
  bf16* dOs = reinterpret_cast<bf16*>(smem + lay.res1);
  float* xp = reinterpret_cast<float*>(smem + lay.xp);
  bf16* dSs = reinterpret_cast<bf16*>(smem + lay.xp);  // after P is read
  int* segk = reinterpret_cast<int*>(smem + lay.seg);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2, w = warp & 3;
  const int pd = pt.pd, nv = pd / 8, nk = (pd + 15) / 16;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x / n * wg::BR;
  const size_t base = (size_t)b * a.sb + (size_t)h * a.sh + pt.c0;  // this rank's columns
  const size_t rows = ((size_t)b * a.H + h) * a.L;
  const int* seg = a.seg ? a.seg + (size_t)b * a.L : nullptr;
  const int lid = threadIdx.x;
  float* slot = reinterpret_cast<float*>(smem + lay.xch) + grp * (wg::NS * 128) + (lid & 127) * 4;

  auto buf = [&](int j) { return reinterpret_cast<bf16*>(smem + ((j & 1) ? lay.buf1 : lay.buf0)); };
  // key tile j's part of K and V by TMA and its segment ids into buffer j & 1
  auto stage = [&](int j) {
    const int k0 = j * wg::BS, o = (j & 1) * wg::BS;
    if (warp == 0) tma_part(buf(j), pr, k0, pt.c0, h, b, nk, bars + (j & 1), lane);
    if (lid < wg::BS) {
      if (seg) tf::cp_async4(segk + o + lid, seg + k0 + lid);
      else segk[o + lid] = 0;
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  zero_part_pads(Qs, nv, nk);
  if (lid == 0) {
    wg::mbar_init(bars);
    wg::mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  wg::copy_tile(Qs, static_cast<const bf16*>(a.q) + base + (size_t)q0 * a.sl, a.sl, nv, warp, lane);
  wg::copy_tile(dOs, static_cast<const bf16*>(a.dout) + base + (size_t)q0 * a.sl, a.sl, nv, warp,
                lane);
  stage(0);

  float lq[2], dr[2];  // lse log2(e), D and segment ids of this thread's query rows
  int sq[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * w + g + 8 * r;
    lq[r] = a.lse[rows + row] * wg::LOG2E;
    dr[r] = a.dsum[rows + row];
    if (seg) sq[r] = seg[row];
  }
  const float sl2 = a.scale * wg::LOG2E;
  float* xw = xp + w * (wg::NS * 32) + lane;
  // dQ's columns 0..NQ0 - 1 of the part (warpgroup 0) or NQ0.. (warpgroup 1,
  // the first NQ1 / 2 of them)
  float acc[NQ0 / 2];
  float (&acc1)[NQ1 / 2] = *reinterpret_cast<float(*)[NQ1 / 2]>(acc);
#pragma unroll
  for (int i = 0; i < NQ0 / 2; ++i) acc[i] = 0.f;

  const int steps = a.L / wg::BS;
  for (int j = 0; j < steps; ++j) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    wg::mbar_wait(bars + (j & 1), (j >> 1) & 1);
    __syncthreads();  // step j's tiles have arrived; step j - 1 is done with the other buffer
    const bf16* Kt = buf(j);
    const bf16* Vt = Kt + ST16;
    float s[wg::NS];  // the first k-step writes it (its wgmma's scale-d off)
    const bf16* xs = grp ? dOs : Qs;
    const bf16* ys = grp ? Vt : Kt;
    wg::wg_fence();
    for (int kk = 0; kk < nk; ++kk) wg::mma_s(s, wg::desc_k(xs, kk), wg::desc_ks(ys, kk), kk);
    wg::wg_commit();
    if (j + 1 < steps) stage(j + 1);  // the copies issue while the tensor cores run
    wg::wg_wait();
    wg::fence_regs(s);
    sum_partials(s, slot + (j & 1) * XCH16, n, rank);  // S (dP) over the whole head dim
    if (grp == 0) {  // P = exp2(S scale log2(e) - lse log2(e)) where the segments match
      const int* sk = segk + (j & 1) * wg::BS + 2 * t;
#pragma unroll
      for (int c = 0; c < wg::BS / 8; ++c) {
        const int2 k2 = *reinterpret_cast<const int2*>(sk + 8 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xw[(4 * c + e) * 32] = sq[e >> 1] == ((e & 1) ? k2.y : k2.x)
                                     ? exp2f(fmaf(s[4 * c + e], sl2, -lq[e >> 1])) : 0.f;
      }
      wg::bar_arrive(1, THREADS);  // P to warpgroup 1
    } else {  // dS = P (dP - D) scale, into shared memory as a K-major A
      tf::named_sync(1, THREADS);
#pragma unroll
      for (int c = 0; c < wg::BS / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * c + e] = xw[(4 * c + e) * 32] * (s[4 * c + e] - dr[e >> 1]) * a.scale;
      tf::named_sync(2, THREADS / 2);  // every warp of the group has read P
#pragma unroll
      for (int c = 0; c < wg::BS / 8; ++c) {
        bf16* p = dSs + (c * wg::BR + 16 * w + g) * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(p) = fw::pack_bf16(s[4 * c], s[4 * c + 1]);
        *reinterpret_cast<uint32_t*>(p + 64) = fw::pack_bf16(s[4 * c + 2], s[4 * c + 3]);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();  // dS is complete
    wg::wg_fence();  // dQ's columns of warpgroup grp += dS K
    if (grp == 0) {
#pragma unroll
      for (int kk = 0; kk < wg::KS; ++kk)
        mma_acc_ss(acc, wg::desc_k(dSs, kk), wg::desc_mn(Kt, kk, 0));
    } else {
#pragma unroll
      for (int kk = 0; kk < wg::KS; ++kk)
        mma_acc_ss(acc1, wg::desc_k(dSs, kk), wg::desc_mn(Kt, kk, NQ0 / 16));
    }
    wg::wg_commit();
    wg::wg_wait();
    wg::fence_regs(acc);
  }
  cluster_arrive();  // this block has read every rank's last partials
  cluster_wait();    // and every rank this block's: it may exit
  bf16* out = static_cast<bf16*>(a.out0) + base + (size_t)(q0 + 16 * w) * a.sl;
  if (grp == 0) wg::store_cols(out, a.sl, acc, 0, pd, g, t);
  else wg::store_cols(out, a.sl, acc1, NQ0, pd, g, t);
}

}  // namespace cl

// ---- host side

template <class P>
bool supported(const Args& a) {
  const int v = 16 / (int)sizeof(typename P::T);  // elements in 16 bytes
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.out0, a.out1};
  for (const void* p : ptrs)
    if (p && reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return a.d % 8 == 0 && a.d >= 8 && a.L % L_MULTIPLE == 0 && a.L > 0 &&
         a.B > 0 && a.H > 0 && a.sb % v == 0 && a.sh % v == 0 && a.sl % v == 0;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

// The forward's query tile (rows a block, 16 RG): the largest of 64, 32, 16
// whose grid gives every SM a block; the block splits each row group's keys
// between 4 / RG key groups.
int fwd_tile(int B, int H, int L, int sms) {
  if ((long long)B * H * (L / 64) >= sms) return 64;
  if ((long long)B * H * (L / 32) >= sms) return 32;
  return 16;
}

template <class K, class A>
cudaError_t launch(K kernel, dim3 grid, size_t smem, const A& a, void* stream,
                   int threads = THREADS) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// A wide kernel on its grid, (row tiles x column slices of cs, H, B), with
// all of an SM's shared memory asked for: two blocks an SM fit.
template <class K>
cudaError_t launch_wide(K kernel, int cs, size_t smem, const Args& a, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  return launch(kernel, dim3(a.L / wd::BR * ((a.d + cs - 1) / cs), a.H, a.B), smem, a, stream,
                wd::THREADS_W);
}

// The ranks of the cluster that a call above DMAX runs on, or 0 for the wide
// kernels (namespace wd): a float32 d up to CLUSTER_MAX * PART_MAX and a
// bf16 d up to REACH_BF16 run on clusters, the forward (and the float32
// backward) at parts of PART_MAX, the bf16 backward at parts of PART_BF16.
// A rule on d, the dtype and the kernel, not a fallback.
template <class P>
int cluster_ranks(const Args& a, bool forward) {
  constexpr bool F = std::is_same_v<P, F32>;
  if (a.d <= DMAX || (!F && a.d > cl::REACH_BF16)) return 0;
  const int n = cl::ranks(a.d, F || forward ? cl::PART_MAX : cl::PART_BF16);
  return n <= cl::CLUSTER_MAX ? n : 0;
}

// A cluster kernel on its grid, (row tiles x n ranks, H, B) in clusters of
// (n, 1, 1), once the card has said that such a cluster fits; its
// parameter `arg` (Args, or the bf16 backward's Params).
template <class K, class A>
cudaError_t launch_cluster(K kernel, int tile_rows, int n, size_t smem, const Args& a,
                           const A& arg, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.L / tile_rows * n, a.H, a.B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, arg);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <class P, int RG>
int cl_fwd_launch(const Args& a, int n, void* stream) {
  const cl::Part p0(a.d, n, 0);
  return (int)launch_cluster(cl::fwd_kernel<P, RG>, 16 * RG, n, cl::fwd_smem<P, RG>(p0.pd0), a, a,
                             stream);
}

template <class P, int RG>
int fwd_launch(const Args& a, void* stream) {
  return (int)launch(fw::fwd_kernel<P, RG>, dim3(a.L / (16 * RG), a.H, a.B),
                     fw::Smem<P, RG>(a.d).bytes, a, stream);
}

template <class P>
int fwd(const Args& a, void* stream) {
  if (!supported<P>(a) || !a.out1) return (int)cudaErrorInvalidValue;
  if (const int n = cluster_ranks<P>(a, true)) {
    switch (fwd_tile(a.B, a.H * n, a.L, sm_count())) {  // over every block
      case 64:
        return cl_fwd_launch<P, 4>(a, n, stream);
      case 32:
        return cl_fwd_launch<P, 2>(a, n, stream);
      default:
        return cl_fwd_launch<P, 1>(a, n, stream);
    }
  }
  if (a.d > DMAX)
    return (int)launch_wide(wd::fwd_kernel<P>, wd::CS_FWD, wd::fwd_smem<P>(), a, stream);
  switch (fwd_tile(a.B, a.H, a.L, sm_count())) {
    case 64:
      return fwd_launch<P, 4>(a, stream);
    case 32:
      return fwd_launch<P, 2>(a, stream);
    default:
      return fwd_launch<P, 1>(a, stream);
  }
}

// The backward: float32 on the kernels of namespace tf, bf16 on those of
// namespace wg; above DMAX on clusters (cl) or the wide kernels (wd).

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, or null
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &got) !=
            cudaSuccess || got != cudaDriverEntryPointSuccess)
      return EncodeTiled(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A [B, H, L, d] bf16 tensor (a's shape and strides) as boxes of 16 columns x
// wg::BS rows of one (b, h), 32-byte swizzled; the smaller-strided of L and H
// goes first.
bool tile_map(CUtensorMap* m, const void* base, const Args& a, bool l_inner) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)a.d, (cuuint64_t)(l_inner ? a.L : a.H),
                              (cuuint64_t)(l_inner ? a.H : a.L), (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)(l_inner ? a.sl : a.sh) * 2,
                                 (cuuint64_t)(l_inner ? a.sh : a.sl) * 2, (cuuint64_t)a.sb * 2};
  const cuuint32_t box[4] = {16, l_inner ? (cuuint32_t)wg::BS : 1u,
                             l_inner ? 1u : (cuuint32_t)wg::BS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The wgmma kernels' parameters, streaming s0 and s1.
bool wg_params(wg::Params* p, const Args& a, const void* s0, const void* s1) {
  p->a = a;
  p->l_inner = a.sl <= a.sh;
  return tile_map(&p->t0, s0, a, p->l_inner) && tile_map(&p->t1, s1, a, p->l_inner);
}
template <class P>
int dkv(const Args& a, void* stream) {
  if (!supported<P>(a) || !a.lse || !a.dsum || !a.out1) return (int)cudaErrorInvalidValue;
  constexpr bool F = std::is_same_v<P, F32>;
  const int n = cluster_ranks<P>(a, false);
  if (n && F)
    return (int)launch_cluster(cl::dkv_kernel, tf::TB, n,
                               cl::bwd_smem(cl::Part(a.d, n, 0).pd0), a, a, stream);
  if (!n && a.d > DMAX)
    return (int)launch_wide(wd::dkv_kernel<P>, wd::CS_DKV, wd::dkv_smem<P>(), a, stream);
  if constexpr (F)
    return (int)launch(tf::dkv_kernel, dim3(a.L / tf::TB, a.H, a.B), tf::Smem(a.d).bytes, a,
                       stream);
  wg::Params p;
  if (!wg_params(&p, a, a.q, a.dout)) return (int)cudaErrorInvalidValue;
  if (n)
    return (int)launch_cluster(cl::dkv_bf16_kernel, wg::BR, n, cl::SmemB(true).bytes, a, p,
                               stream);
  return (int)launch(wg::dkv_kernel, dim3(a.L / wg::BR, a.H, a.B), wg::Smem(true).bytes, p,
                     stream);
}

template <class P>
int dq(const Args& a, void* stream) {
  if (!supported<P>(a) || !a.lse || !a.dsum) return (int)cudaErrorInvalidValue;
  constexpr bool F = std::is_same_v<P, F32>;
  const int n = cluster_ranks<P>(a, false);
  if (n && F)
    return (int)launch_cluster(cl::dq_kernel, tf::TB, n,
                               cl::bwd_smem(cl::Part(a.d, n, 0).pd0), a, a, stream);
  if (!n && a.d > DMAX)
    return (int)launch_wide(wd::dq_kernel<P>, wd::CS_DQ, wd::dq_smem<P>(), a, stream);
  if constexpr (F)
    return (int)launch(tf::dq_kernel, dim3(a.L / tf::TB, a.H, a.B), tf::Smem(a.d).bytes, a,
                       stream);
  wg::Params p;
  if (!wg_params(&p, a, a.k, a.v)) return (int)cudaErrorInvalidValue;
  if (n)
    return (int)launch_cluster(cl::dq_bf16_kernel, wg::BR, n, cl::SmemB(false).bytes, a, p,
                               stream);
  return (int)launch(wg::dq_kernel, dim3(a.L / wg::BR, a.H, a.B), wg::Smem(false).bytes, p,
                     stream);
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
