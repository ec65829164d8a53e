#!/usr/bin/env python3
"""Where kernel K5 spends its time on the card: `zerovox_tpu_torch/csrc/
flash_attn.cu` against copies of itself with a phase taken out or a design
choice changed, timed in turns (CUDA events; views of [B, L, h, d] tensors,
segment ids with per-row valid lengths from seed 21, as chip_smoke.py phase
21 passes them): the forward (`fw::fwd_kernel`, float32 and bf16) at the
training shape [24, 2, 512, 264] and the serving shapes [1, 2, 1024, 264]
(decoder) and [1, 2, 256, 264] (encoder), the float32 backward
(`tf::dkv_kernel`, `tf::dq_kernel`) and the bf16 one (`wg::dkv_kernel`,
`wg::dq_kernel`) at the training shape.

    python3 scripts/bench_k5_breakdown.py [--parent DIR]

Variants, built from text substitutions of the source with the kernels' own
nvcc flags (each substitution must match the source exactly once:
`tests/test_torch_flash_bwd_emulation.py` and
`tests/test_torch_flash_fwd_emulation.py` check that on the CPU); a variant
without an MMA also loses whatever only fed it:

  kernel        the source as it is (forward and backward);
  fwd_no_s_mma  the forward's S without its MMAs;
  fwd_no_pv_mma the forward's P.V without its MMAs;
  fwd_no_fetch  the forward's K and V not copied from device memory;
  fwd_rna_lo    the float32 forward's operand split with lo rounded to TF32
                (cvt.rna's rounding, as tc::split) instead of truncated by
                the MMA: the design choice it replaced;
  fwd_pv_group_1, fwd_pv_group_17
                the float32 forward's P.V splitting V's B fragments one
                n-tile (each n-tile's three MMAs in a chain) or a warp's
                17 n-tiles at a time instead of 4;
  fwd_rows_32   the forward's tile rule taking 32 query rows (2 key groups)
                where it takes 16 (4 key groups);
  no_s_mma      the backward's S and dP (S^T and dP^T) without their MMAs;
  no_acc_mma    the backward's dK/dV and dQ accumulation without its MMAs;
  no_fetch      the backward's streamed tiles not copied (cp.async);
  bf16_no_s_mma, bf16_no_acc_mma, bf16_no_fetch
                the same three of the bf16 backward (`wg::dkv_kernel`,
                `wg::dq_kernel`; no_fetch: no TMA box issued, each step's
                barrier expecting none);
  bf16_rows_32  the bf16 backward streaming 32 rows a step instead of 64
                (S's wgmma N 32, half the shared memory; a block owns 64
                rows, one wgmma M, either way);
  bf16_fetch_twice
                the bf16 backward fetching its streamed tiles for the first
                two steps only, then computing on them again: real data
                without the fetch (no_fetch computes on stale shared memory);
  cl_fwd_no_fetch, cl_no_fetch
                the float32 cluster forward's (`cl::fwd_kernel`) and
                backward's (`cl::dkv_kernel`, `cl::dq_kernel`) parts of K and
                V (Q and dO; K and V) not copied from device memory;
  cl_fwd_split_sums
                the cluster forward with each warp of a pair summing half of
                S's n-tiles over the ranks (its own partial from registers)
                and the pair swapping halves through shared memory: half the
                remote reads, one pair barrier more;
  cl_fwd_no_dsmem, cl_no_dsmem
                the cluster kernels with each warp's S (and dP) summed from
                its own block's exchange only: no distributed shared
                memory read, the cluster barriers kept;
  cl_fwd_no_exchange, cl_no_exchange
                the same with the cluster barriers taken out too (the
                partials summed from the block's own exchange without a
                barrier): with cl_*_no_dsmem, the barriers' time (the
                cl_fwd_* variants act on the float32 and the bf16 forward,
                one template);
  clb_no_dsmem, clb_no_exchange
                the same two of the bf16 cluster backward
                (`cl::dkv_bf16_kernel`, `cl::dq_bf16_kernel`): S and dP
                summed from the block's own exchange, with and without the
                cluster barriers;
  clb_all_ranks the bf16 cluster backward's exchange as every rank reading
                every rank's whole partial after one barrier, the design
                its reduce-scatter replaced;
  parent        (with --parent) DIR's flash_attn.cu, the kernels it had
                (forward and backward).

With --wide the run times the kernels of d above 272 instead, float32 and
bf16, at tts_medium's one head (d = 528): the forward at [1, 1, 1024, 528],
[24, 1, 512, 528] and [1, 1, 256, 528] and the backward at
[24, 1, 512, 528], in the variants that take a phase out of the cluster
kernels (the fwd_* and float32 backward ones of the MMAs act on them too:
`cl` calls `fw`'s and `tf`'s product functions) and with --parent DIR's.

A variant's distance from `kernel` is the device time of what it takes out.
Beside them, the rate of the instructions the kernels are built on: a
kernel that only runs `mma.sync.m16n8k8` TF32 on registers (8 independent
accumulators a warp sharing their operands, 6 chains of three MMAs as
3xTF32 adds them, or 8 accumulators with operands of their own), and
`mma.sync.m16n8k16` bf16 (8 independent accumulators), with 4, 8 and 16
warps on each SM, in TFLOP/s. Prints the card's name and power limit, then
one JSON object with ptxas's registers and spills of every kernel, and of
the bf16 backward's kernels in each variant.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "zerovox_tpu_torch" / "csrc" / "flash_attn.cu"
SHAPE = (24, 2, 512, 264)  # the backward's
FWD_SHAPES = {"train": (24, 2, 512, 264), "serve": (1, 2, 1024, 264), "enc": (1, 2, 256, 264)}
# a warp's S (dP) as the sum of its own block's exchange: no distributed
# shared memory
_LOCAL_FWD = ("#pragma unroll\n    for (int c = 0; c < NS; ++c)\n#pragma unroll\n"
              "      for (int e = 0; e < 4; ++e) s[c][e] = slot[c * 128 + lane * 4 + e];\n")
_LOCAL_BWD = ("#pragma unroll\n  for (int c = 0; c < 2; ++c)\n#pragma unroll\n"
              "    for (int e = 0; e < 4; ++e) s[c][e] = slot[c * 128 + lane * 4 + e];\n")
# the cluster forward with each warp of a pair summing half of S's n-tiles
# over the ranks (this rank's partial from registers) and the pair swapping
# halves through shared memory: half the remote reads, a pair barrier more
_SPLIT_SUMS_FN = (
    "template <int N>\n"
    "__device__ __forceinline__ void sum_ranks_part(float (&x)[N][4], const float* slot, int n,\n"
    "                                               int rank, int c0, int c1, int lane) {\n"
    "#pragma unroll\n"
    "  for (int c = 0; c < N; ++c) {\n"
    "    if (c < c0 || c >= c1) continue;\n"
    "    const float4 own = make_float4(x[c][0], x[c][1], x[c][2], x[c][3]);\n"
    "    float4 acc = own;\n"
    "#pragma unroll\n"
    "    for (int r = 0; r < CLUSTER_MAX; ++r) {\n"
    "      if (r >= n) break;\n"
    "      const float4 p = r == rank ? own : ld_rank(slot + c * 128 + lane * 4, r);\n"
    "      acc = r ? make_float4(acc.x + p.x, acc.y + p.y, acc.z + p.z, acc.w + p.w) : p;\n"
    "    }\n"
    "    x[c][0] = acc.x;\n    x[c][1] = acc.y;\n    x[c][2] = acc.z;\n    x[c][3] = acc.w;\n"
    "  }\n"
    "}\n\n")
_SPLIT_SUMS = (
    "    constexpr int CH = (NS + 1) / 2;\n"
    "    sum_ranks_part<NS>(s, slot, n, rank, dh ? CH : 0, dh ? NS : CH, lane);\n"
    "    cluster_arrive();\n"
    "#pragma unroll\n"
    "    for (int c = 0; c < NS; ++c)\n"
    "      if ((c < CH) == (dh == 0))\n"
    "        *reinterpret_cast<float4*>(mine + c * 128 + lane * 4) =\n"
    "            make_float4(s[c][0], s[c][1], s[c][2], s[c][3]);\n"
    "    tf::named_sync(1 + u, 64);\n"
    "#pragma unroll\n"
    "    for (int c = 0; c < NS; ++c)\n"
    "      if ((c < CH) != (dh == 0)) {\n"
    "        const float4 y = *reinterpret_cast<const float4*>(other + c * 128 + lane * 4);\n"
    "        s[c][0] = y.x;\n        s[c][1] = y.y;\n        s[c][2] = y.z;\n        s[c][3] = y.w;\n"
    "      }\n")
# the bf16 cluster backward's exchange: its reduce-scatter loop, and the
# design it replaced (every rank reads every rank's whole partial, in rank
# order, after one barrier; the rest of the function then dead)
_CLB_RS = ("#pragma unroll\n  for (int c = 0; c < PIECES; ++c) {  // this rank's pieces: every rank's "
           "partial, in rank order\n")
_CLB_ALL = ("  for (int r = 0; r < n; ++r) {\n#pragma unroll\n    for (int c = 0; c < PIECES; ++c) {\n"
            "      const float4 p = ld_rank(slot + c * 512, r);\n"
            "      s[4 * c] = r ? s[4 * c] + p.x : p.x;\n"
            "      s[4 * c + 1] = r ? s[4 * c + 1] + p.y : p.y;\n"
            "      s[4 * c + 2] = r ? s[4 * c + 2] + p.z : p.z;\n"
            "      s[4 * c + 3] = r ? s[4 * c + 3] + p.w : p.w;\n    }\n  }\n  return;\n")
# its remote reads as reads of the block's own exchange
_LOCAL_CLB = [("      const float4 p = r == rank ? x : ld_rank(slot + c * 512, r);\n",
               "      const float4 p = r == rank ? x : *reinterpret_cast<const float4*>(slot + c * 512);\n"),
              ("    const float4 p = ld_rank(slot + c * 512, c % n);\n",
               "    const float4 p = *reinterpret_cast<const float4*>(slot + c * 512);\n")]
VARIANTS = {
    "kernel": [],
    "fwd_no_s_mma": [("      tc::mma(lh[c], a.lo, b.hi);\n      tc::mma(hl[c], a.hi, b.lo);\n"
                      "      tc::mma(hh[c], a.hi, b.hi);\n", ""),
                     ("      tc::mma16(acc[c], a, b0);\n      tc::mma16(acc[c + 1], a, b1);\n", "")],
    "fwd_no_pv_mma": [("        if (i0 + j < ntw) tc::mma(acc[i0 + j], a.lo, b[j].hi);\n", "        ;\n"),
                      ("        if (i0 + j < ntw) tc::mma(acc[i0 + j], a.hi, b[j].lo);\n", "        ;\n"),
                      ("        if (i0 + j < ntw) tc::mma(acc[i0 + j], a.hi, b[j].hi);\n", "        ;\n"),
                      ("        tc::mma16(acc[i], a, b0);\n        tc::mma16(acc[i + 1], a, b1);\n",
                       "")],
    "fwd_no_fetch": [("    copy_rows(Kb + (j & 1) * BK * ldq, ldq, kg + (size_t)k0 * a.sl, a.sl, BK, d);\n"
                      "    copy_rows(Vb + (j & 1) * BK * ldv, ldv, vg + (size_t)k0 * a.sl, a.sl, BK, d);\n",
                      "")],
    "fwd_rna_lo": [("  lo = __float_as_uint(x - __uint_as_float(hi));\n",
                    "  lo = tc::to_tf32(x - __uint_as_float(hi));\n")],
    "fwd_trunc_hi": [("  hi = tc::to_tf32(x);\n  lo = __float_as_uint(x - __uint_as_float(hi));\n",
                      "  hi = __float_as_uint(x);\n"
                      "  lo = __float_as_uint(x - __uint_as_float(hi & 0xFFFFE000u));\n")],
    "fwd_pv_group_6": [("constexpr int PV_GROUP = 4;\n", "constexpr int PV_GROUP = 6;\n")],
    "fwd_bf16_bk32": [("imax(4 * P::KS, KQ * P::KS);", "imax(32, KQ * P::KS);")],
    "fwd_s_unroll_1": [("#pragma unroll 3\n  for (int ks = kb; ks < ke; ++ks) {",
                        "#pragma unroll 1\n  for (int ks = kb; ks < ke; ++ks) {")],
    "fwd_s_unroll_6": [("#pragma unroll 3\n  for (int ks = kb; ks < ke; ++ks) {",
                        "#pragma unroll 6\n  for (int ks = kb; ks < ke; ++ks) {")],
    "fwd_no_exchange": [("    tf::named_sync(1 + u, 64);\n", ""),
                        ("      for (int e = 0; e < 4; ++e) xmine[(c * 4 + e) * 32] = s[c][e];\n",
                         "      for (int e = 0; e < 4; ++e) s[c][e] *= 2.f;\n"),
                        ("      for (int e = 0; e < 4; ++e) s[c][e] += xother[(c * 4 + e) * 32];\n",
                         "      for (int e = 0; e < 4; ++e) s[c][e] += 1.f;\n")],
    "fwd_pv_group_1": [("constexpr int PV_GROUP = 4;\n", "constexpr int PV_GROUP = 1;\n")],
    "fwd_pv_group_17": [("constexpr int PV_GROUP = 4;\n", "constexpr int PV_GROUP = 17;\n")],
    "fwd_rows_32": [("  if ((long long)B * H * (L / 32) >= sms) return 32;\n  return 16;\n",
                     "  return 32;\n")],
    "no_s_mma": [("      tc::mma(lh[n], a.lo, b.hi);\n      tc::mma(hl[n], a.hi, b.lo);\n"
                  "      tc::mma(hh[n], a.hi, b.hi);\n", "")],
    "no_acc_mma": [("        for (int r = 0; r < 2; ++r) tc::mma(acc[r][i], a[r].lo, b.hi);\n",
                    "        continue;\n")],
    "no_fetch": [("    copy2(buf, buf + TB * ld, ld, q + (size_t)q0 * a.sl, dout + (size_t)q0 * a.sl, a.sl, d);\n",
                  ""),
                 ("    copy2(buf, buf + TB * ld, ld, kp + (size_t)k0 * a.sl, vp + (size_t)k0 * a.sl, a.sl, d);\n",
                  "")],
    "bf16_no_s_mma": [("    const bf16* y = grp ? dOs : Qs;\n    wg_fence();\n"
                       "    for (int ks = 0; ks < nk; ++ks) mma_s(s, desc_k(x, ks), desc_ks(y, ks), ks);\n",
                       "    const bf16* y = grp ? dOs : Qs;\n    wg_fence();\n"
                       "#pragma unroll\n    for (int i = 0; i < NS; ++i) s[i] = 0.f;\n"),
                      ("    const bf16* y = grp ? Vt : Kt;\n    wg_fence();\n"
                       "    for (int ks = 0; ks < nk; ++ks) mma_s(s, desc_k(x, ks), desc_ks(y, ks), ks);\n",
                       "    const bf16* y = grp ? Vt : Kt;\n    wg_fence();\n"
                       "#pragma unroll\n    for (int i = 0; i < NS; ++i) s[i] = 0.f;\n")],
    "bf16_no_acc_mma": [("      mma_acc(acc0, af[kk], desc_mn(yb, kk, 0));\n"
                         "      mma_acc(acc1, af[kk], desc_mn(yb, kk, N0 / 16));\n", "      (void)af;\n"),
                        ("mma_acc_ss(acc, desc_k(dSs, kk), desc_mn(Kt, kk, 0));", "(void)dSs;"),
                        ("mma_acc_ss(acc1, desc_k(dSs, kk), desc_mn(Kt, kk, N0 / 16));", "(void)dSs;")],
    "bf16_no_fetch": [("  if (lane == 0) mbar_expect(bar, 2 * np * BOX);\n",
                       "  if (lane == 0) mbar_expect(bar, 0);\n"),
                      ("  for (int i = lane; i < 2 * np; i += 32) {\n", "  for (int i = lane; i < 0; i += 32) {\n")],
    "bf16_rows_32": [("constexpr int BS = 64;", "constexpr int BS = 32;")],
    "bf16_fetch_twice": [("    if (warp == 0) tma_tiles(buf(j), pr, q0, h, b, nk, bars + (j & 1), lane);\n",
                          "    if (warp == 0) tma_tiles(buf(j), pr, q0, h, b, j < 2 ? nk : 0, bars + (j & 1), lane);\n"),
                         ("    if (warp == 0) tma_tiles(buf(j), pr, k0, h, b, nk, bars + (j & 1), lane);\n",
                          "    if (warp == 0) tma_tiles(buf(j), pr, k0, h, b, j < 2 ? nk : 0, bars + (j & 1), lane);\n")],
    "cl_fwd_no_fetch": [("    fw::copy_rows(Kb + (j & 1) * BK * ldq, ldq, kcols + (size_t)j * BK * a.sl, a.sl, BK, pd);\n",
                         ""),
                        ("    fw::copy_rows(Vb + (j & 1) * BK * ldv, ldv, vcols + (size_t)j * BK * a.sl, a.sl, BK, pd);\n",
                         "")],
    "cl_fwd_no_dsmem": [("    sum_ranks<NS>(s, slot, n, lane);\n", _LOCAL_FWD)],
    "cl_fwd_no_exchange": [("    if (j > 0) cluster_wait();\n"
                            "    if (dh == 0) put_slot<NS>(slot, s, lane);\n"
                            "    cluster_arrive();\n"
                            "    if (j > 0) pv_of(pp, j - 1);  // under the barrier\n"
                            "    cluster_wait();\n"
                            "    sum_ranks<NS>(s, slot, n, lane);\n    cluster_arrive();\n",
                            "    if (dh == 0) put_slot<NS>(slot, s, lane);\n"
                            "    if (j > 0) pv_of(pp, j - 1);  // under the barrier\n"
                            "    tf::named_sync(1 + u, 64);  // the pair's slot is written\n"
                            + _LOCAL_FWD),
                           ("  cluster_wait();  // no rank reads this block's exchange any more: it may exit\n",
                            "")],
    "cl_no_fetch": [("    tf::copy2(dst, dst + TB * ld, ld, qcols + row0, docols + row0, a.sl, pd);\n", ""),
                    ("    tf::copy2(dst, dst + TB * ld, ld, kcols + row0, vcols + row0, a.sl, pd);\n", "")],
    "cl_no_dsmem": [("  sum_ranks<2>(s, slot, n, lane);\n", _LOCAL_BWD)],
    "cl_fwd_split_sums": [("template <int N>\n__device__ __forceinline__ void put_slot(",
                           _SPLIT_SUMS_FN + "template <int N>\n__device__ __forceinline__ void put_slot("),
                          ("    sum_ranks<NS>(s, slot, n, lane);\n    cluster_arrive();\n", _SPLIT_SUMS)],
    "clb_no_dsmem": _LOCAL_CLB,
    "clb_no_exchange": _LOCAL_CLB + [
        ("                                                             s[4 * c + 3]);\n"
         "  cluster_arrive();\n  cluster_wait();\n",
         "                                                             s[4 * c + 3]);\n"),
        ("    *reinterpret_cast<float4*>(slot + c * 512) = acc;\n  }\n  cluster_arrive();\n"
         "  cluster_wait();\n", "    *reinterpret_cast<float4*>(slot + c * 512) = acc;\n  }\n"),
        ("  cluster_arrive();  // this block has read every rank's last partials\n"
         "  cluster_wait();    // and every rank this block's: it may exit\n"
         "  bf16* out = static_cast<bf16*>(grp ? a.out0 : a.out1)",
         "  bf16* out = static_cast<bf16*>(grp ? a.out0 : a.out1)"),
        ("  cluster_arrive();  // this block has read every rank's last partials\n"
         "  cluster_wait();    // and every rank this block's: it may exit\n"
         "  bf16* out = static_cast<bf16*>(a.out0)",
         "  bf16* out = static_cast<bf16*>(a.out0)")],
    "clb_all_ranks": [(_CLB_RS, _CLB_ALL + _CLB_RS)],
    "cl_no_exchange": [("  if (!first) cluster_wait();  // every rank has read the last step's partials\n"
                        "  put_slot<2>(slot, s, lane);\n  cluster_arrive();\n  cluster_wait();\n"
                        "  sum_ranks<2>(s, slot, n, lane);\n  cluster_arrive();\n",
                        "  put_slot<2>(slot, s, lane);\n" + _LOCAL_BWD),
                       ("  cluster_wait();  // no rank reads this block's exchange any more: dK and dV out\n",
                        ""),
                       ("  cluster_wait();  // no rank reads this block's exchange any more: dQ out\n",
                        "")],
}
# the variants --wide times (and the parent's, with --parent)
WIDE_VARIANTS = ("kernel", "fwd_no_s_mma", "fwd_no_pv_mma", "no_s_mma", "no_acc_mma",
                 "cl_fwd_no_fetch", "cl_fwd_no_dsmem", "cl_fwd_no_exchange", "cl_fwd_split_sums", "cl_no_fetch",
                 "cl_no_dsmem", "cl_no_exchange", "clb_no_dsmem", "clb_no_exchange",
                 "clb_all_ranks")
WIDE_FWD_SHAPES = {"train": (24, 1, 512, 528), "serve": (1, 1, 1024, 528),
                   "enc": (1, 1, 256, 528)}
WIDE_SHAPE = (24, 1, 512, 528)

MMA_RATE_CU = r"""
#include <cstdint>
#include "tc_common.cuh"
// CHAINS independent accumulators a warp, DEPTH dependent MMAs on each a
// round; FRESH: each accumulator's MMA takes its own A and B registers
// (else all share one A and one B, which the operand reuse cache serves);
// BF16: mma.sync.m16n8k16 bf16 instead of m16n8k8 TF32
template <int CHAINS, int DEPTH, bool FRESH, bool BF16 = false>
__global__ void rate(float* out, int rounds) {
  uint32_t a[CHAINS][4], b[CHAINS][2];
  for (int c = 0; c < CHAINS; ++c) {
    for (int i = 0; i < 4; ++i) a[c][i] = threadIdx.x * 977u + i + (FRESH ? 7u * c : 0u);
    for (int i = 0; i < 2; ++i) b[c][i] = threadIdx.x * 131u + i + (FRESH ? 5u * c : 0u);
  }
  float acc[CHAINS][4] = {};
  for (int r = 0; r < rounds; ++r)
#pragma unroll
    for (int k = 0; k < DEPTH; ++k)
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) {
        if constexpr (BF16) zv::tc::mma16(acc[c], a[FRESH ? c : 0], b[FRESH ? c : 0]);
        else zv::tc::mma(acc[c], a[FRESH ? c : 0], b[FRESH ? c : 0]);
      }
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  if (s == 1.2345f) out[threadIdx.x] = s;
}
extern "C" int zv_mma_rate(int kind, int blocks, int warps, int rounds, float* out) {
  if (kind == 0) rate<8, 1, false><<<blocks, 32 * warps>>>(out, rounds);
  else if (kind == 1) rate<6, 3, false><<<blocks, 32 * warps>>>(out, rounds);
  else if (kind == 2) rate<8, 1, true><<<blocks, 32 * warps>>>(out, rounds);
  else rate<8, 1, false, true><<<blocks, 32 * warps>>>(out, rounds);
  return (int)cudaGetLastError();
}
"""


def mma_rate(torch, tmp: Path, _cuda, cuda_time_ms) -> dict:
    """TFLOP/s of mma.sync.m16n8k8 TF32 run on registers: one block of
    4, 8 or 16 warps on each SM, 8 independent accumulators a warp
    ("independent"), 6 chains of three ("chains_of_3"), or 8 accumulators
    each with its own A and B registers ("fresh_operands"); and of
    mma.sync.m16n8k16 bf16 with 8 independent accumulators
    ("bf16_independent")."""
    cu = tmp / "mma_rate.cu"
    cu.write_text(MMA_RATE_CU)
    so = tmp / "mma_rate.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{_cuda.CSRC}", "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.zv_mma_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out, rounds = torch.zeros(512, device="cuda"), 4096
    res = {}
    for kind, name, per_round, flop in ((0, "independent", 8, 2048), (1, "chains_of_3", 18, 2048),
                                        (2, "fresh_operands", 8, 2048),
                                        (3, "bf16_independent", 8, 4096)):
        for warps in (4, 8, 16):
            ms = cuda_time_ms(lambda: _cuda.check(lib.zv_mma_rate(kind, sms, warps, rounds,
                                                                  out.data_ptr()), "mma_rate"),
                              iters=5, warmup=1)
            res[f"{name}_{warps}w"] = sms * warps * rounds * per_round * flop / (ms * 1e-3) / 1e12
    return res


def variant_source(src: str, subs) -> str:
    """src with every (old, new) of subs applied; raises unless each old
    occurs exactly once."""
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in flash_attn.cu once")
        src = src.replace(old, new)
    return src


def build(tmp: Path, _cuda, parent: Path | None, wide: bool = False) -> tuple[dict, list[str], dict]:
    src = SOURCE.read_text()
    sources = {name: variant_source(src, subs) for name, subs in VARIANTS.items()
               if not wide or name in WIDE_VARIANTS}
    if parent is not None:
        sources["parent"] = (parent / "zerovox_tpu_torch" / "csrc" / "flash_attn.cu").read_text()
    procs = {}
    for name, text in sources.items():
        cu = tmp / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{_cuda.CSRC}", "-o", str(tmp / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas, bf16_bwd = {}, [], {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if name == "kernel":  # registers and spills of each kernel
            ptxas = [ln.strip() for ln in log.splitlines() if "ptxas" in ln or "spill" in ln]
        bf16_bwd[name] = {k: v for k, v in _cuda.ptxas_kernels(log.splitlines()).items()
                          if ("2cl" if wide else "2wg") in k}
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        for fn, argtypes in _cuda.SIGNATURES["flash_attn"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas, bf16_bwd


def inputs(torch, np, shape, rng):
    """q, k, v, dO (views of [B, L, h, d] float32 tensors), segment ids"""
    B, h, L, d = shape

    def t():
        return torch.from_numpy(rng.normal(size=(B, L, h, d)).astype(np.float32)).cuda() \
            .transpose(1, 2)

    q, k, v, do = t(), t(), t(), t()
    n = rng.integers(L // 2, L + 1, size=B)
    n[0] = L
    seg = torch.from_numpy((np.arange(L)[None] >= n[:, None]).astype(np.int32)).cuda()
    return q, k, v, do, seg


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--wide", action="store_true", help="the kernels at d = 528")
    args = ap.parse_args()
    fwd_shapes, shape = (WIDE_FWD_SHAPES, WIDE_SHAPE) if args.wide else (FWD_SHAPES, SHAPE)
    kinds = ("f32", "bf16")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_k5_breakdown: needs a CUDA card")
    from zerovox_tpu_torch.ops import _cuda
    from zerovox_tpu_torch.ops import flash_attention as fa
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(21)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    passes = {}
    for label, fshape in fwd_shapes.items():  # the forward: o and lse into buffers of their own
        q, k, v, _, seg = inputs(torch, np, fshape, rng)
        scale = 1.0 / math.sqrt(fshape[3])
        for kind in kinds:
            x = [q, k, v] if kind == "f32" else [t.bfloat16() for t in (q, k, v)]
            o, lse = torch.empty_like(x[0]), x[0].new_empty(fshape[:3], dtype=torch.float32)
            dims = [*fshape, *x[0].stride()[:3]]

            def fwd(lib, x=x, o=o, lse=lse, seg=seg, dims=dims, scale=scale, kind=kind):
                _cuda.check(getattr(lib, f"zv_flash_fwd_{kind}")(
                    x[0].data_ptr(), x[1].data_ptr(), x[2].data_ptr(), o.data_ptr(),
                    lse.data_ptr(), seg.data_ptr(), *dims, scale, stream()), "fwd")

            passes[f"fwd_{kind}_{label}"] = fwd
    q, k, v, do, seg = inputs(torch, np, shape, np.random.default_rng(21))
    scale = 1.0 / math.sqrt(shape[3])
    o, lse = fa.flash_fwd(q, k, v, seg, scale)
    dsum = (do * o).sum(-1).contiguous()
    dk, dv, dq = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dims = [*shape, *q.stride()[:3]]

    def dkv(lib):
        _cuda.check(lib.zv_flash_dkv_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                         lse.data_ptr(), dsum.data_ptr(), seg.data_ptr(),
                                         dk.data_ptr(), dv.data_ptr(), *dims, scale, stream()),
                    "dkv")

    def dq_(lib):
        _cuda.check(lib.zv_flash_dq_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                        lse.data_ptr(), dsum.data_ptr(), seg.data_ptr(),
                                        dq.data_ptr(), *dims, scale, stream()), "dq")

    passes.update({"dkv": dkv, "dq": dq_})
    qb, kb, vb, dob = (x.bfloat16() for x in (q, k, v, do))
    ob, lseb = fa.flash_fwd(qb, kb, vb, seg, scale)
    dsumb = (dob.float() * ob.float()).sum(-1).contiguous()
    dkb, dvb, dqb = torch.empty_like(qb), torch.empty_like(qb), torch.empty_like(qb)

    def dkv_bf16(lib):
        _cuda.check(lib.zv_flash_dkv_bf16(qb.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                                          dob.data_ptr(), lseb.data_ptr(), dsumb.data_ptr(),
                                          seg.data_ptr(), dkb.data_ptr(), dvb.data_ptr(), *dims,
                                          scale, stream()), "dkv_bf16")

    def dq_bf16(lib):
        _cuda.check(lib.zv_flash_dq_bf16(qb.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                                         dob.data_ptr(), lseb.data_ptr(), dsumb.data_ptr(),
                                         seg.data_ptr(), dqb.data_ptr(), *dims, scale, stream()),
                    "dq_bf16")

    passes.update({"dkv_bf16": dkv_bf16, "dq_bf16": dq_bf16})

    def timed(name: str) -> list[str]:
        """the passes a variant is timed on: its own side of the kernel"""
        if name.startswith(("fwd_", "cl_fwd_")):
            return [p for p in passes if p.startswith("fwd_")]
        if name.startswith(("bf16_", "clb_")):
            return ["dkv_bf16", "dq_bf16"]
        if name in ("kernel", "parent"):
            return list(passes)
        return ["dkv", "dq"]

    with tempfile.TemporaryDirectory() as tmp:
        libs, ptxas, bf16_bwd = build(Path(tmp), _cuda, args.parent, args.wide)
        ms = {name: {p: [] for p in timed(name)} for name in libs}
        for names in (list(libs), list(libs)[::-1]):  # in turns, each order once
            for name in names:
                for p in timed(name):
                    ms[name][p].append(cuda_time_ms(lambda: passes[p](libs[name]), iters=20,
                                                    warmup=3))
        rate = mma_rate(torch, Path(tmp), _cuda, cuda_time_ms)
    print(card)
    print(json.dumps({"k5_breakdown": {"fwd_shapes": fwd_shapes, "bwd_shape": list(shape),
                                       "ms": ms, "card": card, "mma_tflops": rate,
                                       "ptxas": ptxas,
                                       ("ptxas_cluster" if args.wide else "ptxas_bf16_bwd"):
                                           bf16_bwd}}))


if __name__ == "__main__":
    main()
