#!/usr/bin/env python3
"""Where the bf16 K1, K2 and K3's time goes on the card: `zerovox_tpu_torch/
csrc/mrf.cu`, `upsample_stage.cu` and `resblock.cu` (with the tile headers
they include) against copies with one part of the tile's GEMMs taken out,
timed in turns at the main path's shapes (bucket 689 of the default vocoder
and of the single-tower one, CUDA events):

  K1-bf16   [1, 44096, 128];
  K2-bf16   [1, 44096, 128] -> [1, 88192, 64];
  K2+post   [1, 88192, 64] -> [1, 176384];
  K3-bf16   [1, 44096, 128], [1, 88192, 64], [1, 176384, 32] (one tower, k 3).

    python3 scripts/bench_mrf_breakdown.py [--tree DIR] [--out FILE]

Variants, built from text substitutions of the sources with the kernels' own
nvcc flags:

  kernel     the sources as they are;
  no_mma     the tensor-core products replaced by an empty asm on the same
             registers: the accumulators stay at 0, and ptxas, which sees
             no instruction use them, drops the operands' loads and
             conversions too, so what is left is the time outside the
             GEMMs' inner loops (window loads, epilogues, barriers);
  no_split   the activations loaded but not split or converted: their raw
             float32 bits go to the products as they are (the bf16x2
             design: also where conv1's epilogue and K2's staging split
             them into shared memory);
  no_bfetch  no B fragment read, from L2 or from K3's staged copy (each
             replaced by its index; K3's copies into shared memory stay).

Beside them, the bf16x2 design's choices against their alternatives:

  unroll_N   each GEMM's k-step loop unrolled by N = 1 or 4 instead of 2
             (KK_UNROLL);
  b_ahead_2  B fragments two k-steps ahead of the MMAs (B_AHEAD = 2);
  items_64   warp items of 64 output channels (ITEM_COLS = 64; the tile's
             cost model still counts items of 32).

A variant's distance from `kernel` is the device time of what it takes out.
The substitutions follow the tile's design: `bf16x2` (bf16 mma.sync.m16n8k16
with a two-term activation split, `csrc/mrf_bf16.cuh`) or, in a tree that has
no such header, `2xtf32` (the TF32 tile on bf16 weights with the lo.hi and
hi.hi products, `csrc/mrf_tc.cuh` and `tc_common.cuh`). Every substitution
of a tree's design must match its file exactly once
(`tests/test_torch_mrf_breakdown.py` checks the bf16x2 set on the CPU).

--tree DIR times an earlier checkout (`git archive` into a gitignored
directory) with its own package, packers and wrappers; a bf16x2 tree from
before K3's staged copy (`BSmem`) has no text for `no_bfetch`'s second
substitution and is refused. Prints the card's
name and power limit, then one JSON object (also written to FILE).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("mrf", "upsample_stage", "resblock")
TF32_MMA = ('asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "\n'
            '      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"')
BF16_MMA = ('asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "\n'
            '      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"')
EMPTY_ASM = 'asm volatile(""'
# (file in csrc/, old, new) a variant; a design's set
DESIGNS = {
    "2xtf32": {
        "kernel": [],
        "no_mma": [("tc_common.cuh", TF32_MMA, EMPTY_ASM)],
        "no_split": [("mrf_tc.cuh",
                      "for (int e = 0; e < 4; ++e) split(LEAKY_IN ? leaky(av[e], 0.1f) : av[e], "
                      "ah[e], al[e]);",
                      "for (int e = 0; e < 4; ++e) ah[e] = al[e] = __float_as_uint(av[e]);")],
        "no_bfetch": [("mrf_tc.cuh",
                       "uint32_t fetch(size_t i) const { return __ldg(w + i); }",
                       "uint32_t fetch(size_t i) const { return (uint32_t)i; }")],
    },
    "bf16x2": {
        "kernel": [],
        "no_mma": [("tc_common.cuh", BF16_MMA, EMPTY_ASM)],
        "no_split": [("mrf_bf16.cuh",
                      "for (int e = 0; e < NE; ++e) split2(tc::leaky2(v[e], 0.1f), ah[e], al[e]);",
                      "for (int e = 0; e < NE; ++e) ah[e] = __float_as_uint(v[e].x), "
                      "al[e] = __float_as_uint(v[e].y);"),
                     ("mrf_bf16.cuh", "split2(tc::leaky2(v, 0.1f), h, l);",
                      "h = __float_as_uint(v.x), l = __float_as_uint(v.y);"),
                     ("upsample_stage.cu",
                      "zv::bf16x2::split2(make_float2(v.x, v.y), h.x, l.x);\n"
                      "      zv::bf16x2::split2(make_float2(v.z, v.w), h.y, l.y);",
                      "h = make_uint2(__float_as_uint(v.x), __float_as_uint(v.z)), "
                      "l = make_uint2(__float_as_uint(v.y), __float_as_uint(v.w));")],
        "no_bfetch": [("mrf_bf16.cuh", "return __ldg(w + i);",
                       "return make_uint2((uint32_t)i, (uint32_t)i);"),
                      ("mrf_bf16.cuh", "return s[i];", "return make_uint2((uint32_t)i, (uint32_t)i);")],
        "unroll_1": [("mrf_bf16.cuh", "constexpr int KK_UNROLL = 2;", "constexpr int KK_UNROLL = 1;")],
        "unroll_4": [("mrf_bf16.cuh", "constexpr int KK_UNROLL = 2;", "constexpr int KK_UNROLL = 4;")],
        "b_ahead_2": [("mrf_bf16.cuh", "constexpr int B_AHEAD = 1;", "constexpr int B_AHEAD = 2;")],
        "items_64": [("mrf_bf16.cuh", "constexpr int ITEM_COLS = 32;",
                      "constexpr int ITEM_COLS = 64;")],
    },
}
B = 1
T1, C1, C2, C3 = 44096, 128, 64, 32  # bucket 689 x rates 8, 8; stage widths
K3_SHAPES = ((T1, C1), (2 * T1, C2), (4 * T1, C3))  # the single-tower vocoder's stages 1-3
KS, DILS, UP_K, STRIDE, PAD, POST_K = (3, 7, 11), (1, 3, 5), 4, 2, 1, 7


def design_of(tree: Path) -> str:
    return "bf16x2" if (tree / "zerovox_tpu_torch" / "csrc" / "mrf_bf16.cuh").exists() else "2xtf32"


def variant_sources(csrc: Path, subs) -> dict[str, str]:
    """{file: text} of every csrc file with the variant's (file, old, new)
    substitutions applied; raises unless each old occurs exactly once."""
    out = {p.name: p.read_text() for p in csrc.glob("*.cu*")}
    for name, old, new in subs:
        if out[name].count(old) != 1:
            raise RuntimeError(f"{old!r} is not in {name} once")
        out[name] = out[name].replace(old, new)
    return out


def bf16_registers(log: str) -> dict:
    """{bf16 entry function: "R registers, S bytes spilled"} from nvcc's
    -Xptxas -v output, each function by its name and widths
    (`mrf_kernel_bf16<128>`)."""
    out, name, spill = {}, None, "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"((?:mrf|stage|resblock)_kernel(?:_bf16)?)I((?:Li\d+E)+)", ln)
            m = m if "bfloat16" in ln else None
            name = m and f"{m[1]}<{','.join(re.findall(r'Li(\d+)E', m[2]))}>"
        elif name is not None and "spill stores" in ln:
            spill = ln.strip().split(",")[1].strip().split()[0]
        elif name is not None and "Used" in ln and "registers" in ln:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out[name] = f"{regs} registers, {spill} bytes spilled"
    return out


def build(tmp: Path, csrc: Path, variants: dict, _cuda) -> tuple[dict, dict]:
    """Every variant's libraries, one nvcc a (variant, source), all started
    together; returns ({variant: {source: CDLL}}, {variant: bf16_registers})."""
    procs = {}
    for name, subs in variants.items():
        d = tmp / name
        d.mkdir()
        for fname, text in variant_sources(csrc, subs).items():
            (d / fname).write_text(text)
        for src in SOURCES:
            procs[name, src] = subprocess.Popen(
                [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(d / f"lib{src}.so"),
                 str(d / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for (name, src), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}/{src}.cu:\n{log}")
        ptxas.setdefault(name, {}).update(bf16_registers(log))
        lib = ctypes.CDLL(str(tmp / name / f"lib{src}.so"))
        for fn, argtypes in _cuda.SIGNATURES[src].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs.setdefault(name, {})[src] = lib
    return libs, ptxas


def cases(torch):
    """{case: callable} of the six bf16 launches on seeded inputs, through
    the tree's own packers and wrappers."""
    from zerovox_tpu_torch.ops.mrf import fused_mrf, pack_towers
    from zerovox_tpu_torch.ops.resblock import fused_resblock1
    from zerovox_tpu_torch.ops.upsample_stage import fused_upsample_stage, pack_upsampler

    gen = torch.Generator().manual_seed(11)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda().bfloat16()

    def towers(C, ks=KS):
        return pack_towers([(rnd(3, k, C, C, scale=(k * C) ** -0.5), rnd(3, C, scale=0.5),
                             rnd(3, k, C, C, scale=(k * C) ** -0.5), rnd(3, C, scale=0.5))
                            for k in ks])

    def upsampler(ci, co):
        return pack_upsampler(rnd(UP_K, ci, co, scale=(UP_K * ci / STRIDE) ** -0.5),
                              rnd(co, scale=0.5), STRIDE)

    x1, m1 = rnd(B, T1, C1), towers(C1)
    x2, up2, m2 = rnd(B, T1, C1), upsampler(C1, C2), towers(C2)
    x3, up3, m3 = rnd(B, 2 * T1, C2), upsampler(C2, C3), towers(C3)
    post = (rnd(POST_K, C3, 1, scale=(POST_K * C3) ** -0.5), rnd(1, scale=0.1))
    out = {f"k1 [1,{T1},{C1}]": lambda: fused_mrf(x1, m1, DILS, KS),
           f"k2 [1,{T1},{C1}]->[1,{2 * T1},{C2}]":
               lambda: fused_upsample_stage(x2, up2, PAD, m2, DILS, KS),
           f"k2+post [1,{2 * T1},{C2}]->[1,{4 * T1}]":
               lambda: fused_upsample_stage(x3, up3, PAD, m3, DILS, KS, post=post)}
    for T, C in K3_SHAPES:
        x, tw = rnd(B, T, C), towers(C, (3,))
        out[f"k3 [1,{T},{C}]"] = (lambda x=x, tw=tw:
                                  fused_resblock1(x, *tw.towers[0], DILS, packed=tw))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_mrf_breakdown: needs a CUDA card")
    import zerovox_tpu_torch
    from zerovox_tpu_torch.ops import _cuda
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    if Path(zerovox_tpu_torch.__file__).resolve().parent != tree / "zerovox_tpu_torch":
        sys.exit(f"imported {zerovox_tpu_torch.__file__}, not {tree}'s package")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    design = design_of(tree)
    variants = DESIGNS[design]
    _cuda.ensure_built()  # the wrappers' libraries; each variant's replace them below
    fns = cases(torch)
    tmp = Path(tempfile.mkdtemp(prefix="mrf_breakdown_"))
    try:
        libs, ptxas = build(tmp, tree / "zerovox_tpu_torch" / "csrc", variants, _cuda)
        ms = {name: {c: [] for c in fns} for name in libs}
        for names in (list(libs), list(libs)[::-1]):  # in turns, each order once
            for name in names:
                _cuda._libs.update(libs[name])
                for c, fn in fns.items():
                    ms[name][c].append(cuda_time_ms(fn, iters=args.iters, warmup=3))
        _cuda._libs.update(libs["kernel"])
        launches = {c: fn() for c, fn in fns.items()}
        torch.cuda.synchronize()
        finite = {c: bool(torch.isfinite(y.float()).all()) for c, y in launches.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result = {"mrf_breakdown": {"tree": str(tree), "design": design, "ms": ms,
                                "kernel_finite": finite, "card": card, "ptxas": ptxas}}
    print(card)
    print(json.dumps(result))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result) + "\n")


if __name__ == "__main__":
    main()
