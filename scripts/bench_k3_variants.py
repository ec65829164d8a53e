#!/usr/bin/env python3
"""Kernel K3's layout choices on the card: `zerovox_tpu_torch/csrc/resblock.cu`
built with its layout constants set to each candidate, checked against
`resblock1_plain` and timed in turns (CUDA events) at the single-tower
vocoder's three stage shapes (mel bucket 689; k 3, dilations 1,3,5) and at
the narrow widths C = 16 and 8 (a 256-channel single-tower vocoder's last
stage, HiFi-GAN V2's), for the float32 kernel and for the bf16 one.

    python3 scripts/bench_k3_variants.py [--dtypes f32 bf16] [--parent DIR]

float32 variants (STAGE_MAX_C, the warps of a block at C <= 32: WARPS_C32,
WARPS_C16 and WARPS_C8 all set to it):

  source      (32, *)   the layouts the source takes (8, 16 and 4 warps at C = 32, 16, 8)
  l2          (0, 16)   B fragments from L2 at every width, as K1 reads them
  staged      (64, 16)  each conv's weights split once into shared memory at C <= 64
  staged_w8   (64, 8)   as staged, C <= 32 in blocks of 8 warps, 2 an SM
  staged_w4   (64, 4)   as staged, C <= 32 in blocks of 4 warps, 4 an SM
  l2_w8       (0, 8)    as l2, C <= 32 in blocks of 8 warps

bf16 variants (BF16_STAGE_MIN_C, the warps of a bf16 block at C <= 64:
BF16_WARPS_C64, _C32, _C16 and _C8 all set to it; `*` keeps the source's):

  bf16_source    the layouts the source takes (staged at C = 64; 16, 8, 16
                 and 4 warps at C = 64, 32, 16, 8)
  bf16_l2        (256, *)  B fragments from L2 at every width
  bf16_staged    (8, *)    staged wherever two convs fit in half a block's share (C <= 64)
  bf16_w4        (*, 4)    blocks of 4 warps, 4 an SM
  bf16_w8        (*, 8)    blocks of 8 warps, 2 an SM
  bf16_w16       (*, 16)   blocks of 16 warps, 1 an SM

`--parent DIR` also builds DIR's resblock.cu (a checkout of an earlier
commit) and times it beside them, at the widths given by `--parent-widths`
(default all five), on the weight layouts it reads: float32 in m16n8k8
fragment order, bf16 in the m16n8k8 order of bf16 values (the bf16 kernel
before its move to m16n8k16). Every float32 tensor-core variant must give
the same bits (they differ only in where B comes from and which warp runs an
item) and be within 5e-4 of the plain version; so must every bf16 variant,
each within one bf16 step of the plain version with at most 1 % of the
outputs off its rounding (the parent's bf16 kernel too). Prints the card's
name and power limit, ptxas's register and spill lines, then one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {"source": None, "l2": (0, 16), "staged": (64, 16), "staged_w8": (64, 8),
            "staged_w4": (64, 4), "l2_w8": (0, 8)}
BF16_VARIANTS = {"bf16_source": None, "bf16_l2": (256, None), "bf16_staged": (8, None),
                 "bf16_w4": (None, 4), "bf16_w8": (None, 8), "bf16_w16": (None, 16)}
# stages 1-3 at mel bucket 689, then C = 16 and 8 at bucket 689's last two stage lengths
SHAPES = ((44096, 128), (88192, 64), (176384, 32), (88192, 16), (176384, 8))
DILS = (1, 3, 5)
TOL = 5e-4
BF16X2_SHARE = 0.01  # chip_smoke.py's bound on the bf16 outputs off plain's rounding


def substitute(src: str, consts: dict) -> str:
    """src with each `constexpr int NAME = <n>;` of `consts` set to its value;
    raises unless each occurs once."""
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"resblock.cu no longer holds {name} once")
    return src


def variant_sources(src: str, dtypes) -> dict[str, str]:
    """{variant: resblock.cu text} of the variants of `dtypes`."""
    out = {}
    if "f32" in dtypes:
        for name, layout in VARIANTS.items():
            out[name] = src if layout is None else substitute(src, {
                "STAGE_MAX_C": layout[0], "WARPS_C32": layout[1], "WARPS_C16": layout[1],
                "WARPS_C8": layout[1]})
    if "bf16" in dtypes:
        for name, layout in BF16_VARIANTS.items():
            consts = {}
            if layout is not None and layout[0] is not None:
                consts["BF16_STAGE_MIN_C"] = layout[0]
            if layout is not None and layout[1] is not None:
                consts.update({f"BF16_WARPS_C{c}": layout[1] for c in (64, 32, 16, 8)})
            out[name] = substitute(src, consts)
    return out


def build(tmp: Path, _cuda, parent: Path | None, dtypes) -> tuple[dict, dict]:
    sources = {name: (text, _cuda.CSRC)
               for name, text in variant_sources((_cuda.CSRC / "resblock.cu").read_text(),
                                                 dtypes).items()}
    if parent is not None:
        csrc = parent / "zerovox_tpu_torch" / "csrc"
        sources["parent"] = ((csrc / "resblock.cu").read_text(), csrc)
    procs = {}
    for name, (text, inc) in sources.items():
        cu = tmp / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{inc}", "-o", str(tmp / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln or "entry function" in ln]
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        for fn, argtypes in _cuda.SIGNATURES["resblock"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def bf16_step(t) -> float:
    m = t.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtypes", nargs="+", choices=("f32", "bf16"), default=["f32", "bf16"])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--parent-widths", type=int, nargs="+", default=[8, 16, 32, 64, 128])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_k3_variants: needs a CUDA card")
    from zerovox_tpu_torch.device import use_full_f32
    from zerovox_tpu_torch.ops import _cuda
    from zerovox_tpu_torch.ops.mrf import mma_fragments, pack_towers
    from zerovox_tpu_torch.ops.resblock import resblock1_plain
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    use_full_f32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as d:
        libs, ptxas = build(Path(d), _cuda, args.parent, args.dtypes)
    for name, lines in ptxas.items():
        for ln in lines:
            print(f"  {name}: {ln}")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(6)
    rows = []
    for T, C in SHAPES:
        P, k = len(DILS), 3
        x = torch.randn(1, T, C, generator=gen).cuda()
        tw = [(torch.randn(P, k, C, C, generator=gen) / (k * C) ** 0.5).cuda(),
              (torch.randn(P, C, generator=gen) / 2).cuda(),
              (torch.randn(P, k, C, C, generator=gen) / (k * C) ** 0.5).cuda(),
              (torch.randn(P, C, generator=gen) / 2).cuda()]
        for dtype in args.dtypes:
            bf = dtype == "bf16"
            xd = x.bfloat16() if bf else x
            twd = [t.bfloat16() for t in tw] if bf else tw
            packed = pack_towers([tuple(twd)])
            w = packed.w16 if bf else packed.w
            # the parent's bf16 kernel read bf16 values in m16n8k8 fragment order
            w_parent = torch.cat([mma_fragments(t) for t in (twd[0], twd[2])]) if bf else packed.w
            fn = "zv_resblock1_bf16" if bf else "zv_resblock1_f32"
            ref = resblock1_plain(xd, *twd, DILS)
            names = [n for n in libs if n.startswith("bf16_") == bf and n != "parent"]
            if args.parent is not None and C in args.parent_widths:
                names.append("parent")

            def call(name, out, xd=xd, w=w, w_parent=w_parent, fn=fn, b=packed.b):
                err = getattr(libs[name], fn)(
                    xd.data_ptr(), out.data_ptr(), (w_parent if name == "parent" else w).data_ptr(),
                    b.data_ptr(), 1, T, C, k, P, *DILS, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err} at [1,{T},{C}] {dtype}")

            outs = {}
            for name in names:
                out = torch.empty_like(xd)
                call(name, out)
                torch.cuda.synchronize()
                outs[name] = out
            source = "bf16_source" if bf else "source"
            errs = {name: (o.float() - ref.float()).abs().max().item() for name, o in outs.items()}
            bitwise = {name: torch.equal(o, outs[source]) for name, o in outs.items()
                       if name != "parent"}
            tile_fn = "zv_resblock1_bf16_tile" if bf else "zv_resblock1_tile"
            tiles = {name: getattr(libs[name], tile_fn)(1, T, C, k, P, *DILS)
                     for name in names if name != "parent"}
            times = {name: [] for name in names}
            for name in names + names[::-1]:
                out = outs[name]
                times[name].append(cuda_time_ms(lambda: call(name, out), iters=args.iters,
                                                warmup=2))
            plain_ms = cuda_time_ms(lambda: resblock1_plain(xd, *twd, DILS), iters=5, warmup=1)
            flop = 36.0 * C * C * T
            row = {"shape": f"[1,{T},{C}]", "dtype": dtype, "gflop": flop / 1e9,
                   "bound_ms": (1e3 * 2 * flop / 989e12 if bf else 1e3 * 3 * flop / 495e12),
                   "plain_ms": plain_ms, "max_abs_err": errs, "bitwise_as_source": bitwise,
                   "tile": tiles, "turns_ms": times,
                   "mean_ms": {n: sum(v) / len(v) for n, v in times.items()}}
            bad = [n for n, ok in bitwise.items() if not ok]
            if bf:
                step = bf16_step(ref)
                row["bf16_step"] = step
                row["share_off_plain"] = {n: (o != ref).float().mean().item()
                                          for n, o in outs.items()}
                bad += [n for n in outs if not (errs[n] <= step
                                                and row["share_off_plain"][n] <= BF16X2_SHARE)]
            else:
                bad += [n for n, e in errs.items() if not e < TOL]
            print(json.dumps(row), flush=True)
            rows.append(row)
            if bad:
                sys.exit(f"bench_k3_variants: {bad} wrong at [1,{T},{C}] {dtype}: {errs}, "
                         f"bitwise {bitwise}")
            del outs, ref, packed, w, w_parent
        del x, tw
    print(card)
    print(json.dumps({"k3_variants": rows, "card": card}))


if __name__ == "__main__":
    main()
