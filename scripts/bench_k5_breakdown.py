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
  parent        (with --parent) DIR's flash_attn.cu, the kernels it had
                (forward and backward).

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
}

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


def build(tmp: Path, _cuda, parent: Path | None) -> tuple[dict, list[str], dict]:
    src = SOURCE.read_text()
    sources = {name: variant_source(src, subs) for name, subs in VARIANTS.items()}
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
                          if "2wg" in k}
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
    args = ap.parse_args()
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
    for label, shape in FWD_SHAPES.items():  # the forward: o and lse into buffers of their own
        q, k, v, _, seg = inputs(torch, np, shape, rng)
        scale = 1.0 / math.sqrt(shape[3])
        for kind in ("f32", "bf16"):
            x = [q, k, v] if kind == "f32" else [t.bfloat16() for t in (q, k, v)]
            o, lse = torch.empty_like(x[0]), x[0].new_empty(shape[:3], dtype=torch.float32)
            dims = [*shape, *x[0].stride()[:3]]

            def fwd(lib, x=x, o=o, lse=lse, seg=seg, dims=dims, scale=scale, kind=kind):
                _cuda.check(getattr(lib, f"zv_flash_fwd_{kind}")(
                    x[0].data_ptr(), x[1].data_ptr(), x[2].data_ptr(), o.data_ptr(),
                    lse.data_ptr(), seg.data_ptr(), *dims, scale, stream()), "fwd")

            passes[f"fwd_{kind}_{label}"] = fwd
    q, k, v, do, seg = inputs(torch, np, SHAPE, np.random.default_rng(21))
    scale = 1.0 / math.sqrt(SHAPE[3])
    o, lse = fa.flash_fwd(q, k, v, seg, scale)
    dsum = (do * o).sum(-1).contiguous()
    dk, dv, dq = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dims = [*SHAPE, *q.stride()[:3]]

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
        if name.startswith("fwd_"):
            return [p for p in passes if p.startswith("fwd_")]
        if name.startswith("bf16_"):
            return ["dkv_bf16", "dq_bf16"]
        if name in ("kernel", "parent"):
            return list(passes)
        return ["dkv", "dq"]

    with tempfile.TemporaryDirectory() as tmp:
        libs, ptxas, bf16_bwd = build(Path(tmp), _cuda, args.parent)
        ms = {name: {p: [] for p in timed(name)} for name in libs}
        for names in (list(libs), list(libs)[::-1]):  # in turns, each order once
            for name in names:
                for p in timed(name):
                    ms[name][p].append(cuda_time_ms(lambda: passes[p](libs[name]), iters=20,
                                                    warmup=3))
        rate = mma_rate(torch, Path(tmp), _cuda, cuda_time_ms)
    print(card)
    print(json.dumps({"k5_breakdown": {"fwd_shapes": FWD_SHAPES, "bwd_shape": list(SHAPE),
                                       "ms": ms, "card": card, "mma_tflops": rate,
                                       "ptxas": ptxas, "ptxas_bf16_bwd": bf16_bwd}}))


if __name__ == "__main__":
    main()
