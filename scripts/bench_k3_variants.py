#!/usr/bin/env python3
"""Kernel K3's layout choices on the card: `zerovox_tpu_torch/csrc/resblock.cu`
built with its two layout constants set to each candidate, checked against
`resblock1_plain` and timed in turns (CUDA events) at the single-tower
vocoder's three stage shapes (mel bucket 689; k 3, dilations 1,3,5) and at
the narrow widths C = 16 and 8 (a 256-channel single-tower vocoder's last
stage, HiFi-GAN V2's).

    python3 scripts/bench_k3_variants.py [--parent DIR]

Variants (STAGE_MAX_C, the warps of a block at C <= 32: WARPS_C32, WARPS_C16 and
WARPS_C8 all set to it):

  source      (32, *)   the layouts the source takes (8, 16 and 4 warps at C = 32, 16, 8)
  l2          (0, 16)   B fragments from L2 at every width, as K1 reads them
  staged      (64, 16)  each conv's weights split once into shared memory at C <= 64
  staged_w8   (64, 8)   as staged, C <= 32 in blocks of 8 warps, 2 an SM
  staged_w4   (64, 4)   as staged, C <= 32 in blocks of 4 warps, 4 an SM
  l2_w8       (0, 8)    as l2, C <= 32 in blocks of 8 warps

`--parent DIR` also builds DIR's resblock.cu (a checkout of an earlier
commit) and times it beside them on its own weight layout, at the widths
it was built for (`--parent-widths`, default 32 64 128). Every
tensor-core variant must give the same bits (they differ only in where B
comes from and which warp runs an item); each is held within 5e-4 of the
plain version. Prints the card's name and power limit, ptxas's register
and spill lines, then one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {"source": None, "l2": (0, 16), "staged": (64, 16), "staged_w8": (64, 8),
            "staged_w4": (64, 4), "l2_w8": (0, 8)}
# stages 1-3 at mel bucket 689, then C = 16 and 8 at bucket 689's last two stage lengths
SHAPES = ((44096, 128), (88192, 64), (176384, 32), (88192, 16), (176384, 8))
DILS = (1, 3, 5)
TOL = 5e-4


def build(tmp: Path, _cuda, parent: Path | None) -> tuple[dict, dict]:
    src = (_cuda.CSRC / "resblock.cu").read_text()
    sources = {}
    for name, layout in VARIANTS.items():
        if layout is None:
            sources[name] = (src, _cuda.CSRC)
            continue
        stage_max_c, warps = layout
        text, n1 = re.subn(r"constexpr int STAGE_MAX_C = \d+;", f"constexpr int STAGE_MAX_C = {stage_max_c};", src)
        text, n2 = re.subn(r"constexpr int (WARPS_C32|WARPS_C16|WARPS_C8) = \d+;",
                           rf"constexpr int \1 = {warps};", text)
        if n1 != 1 or n2 != 3:
            raise RuntimeError("resblock.cu no longer holds STAGE_MAX_C and WARPS_C32/C16/C8 once each")
        sources[name] = (text, _cuda.CSRC)
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
        lib.zv_resblock1_f32.argtypes = _cuda.SIGNATURES["resblock"]["zv_resblock1_f32"]
        lib.zv_resblock1_f32.restype = ctypes.c_int
        if name != "parent":
            lib.zv_resblock1_tile.argtypes = _cuda.SIGNATURES["resblock"]["zv_resblock1_tile"]
            lib.zv_resblock1_tile.restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--parent-widths", type=int, nargs="+", default=[32, 64, 128])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_k3_variants: needs a CUDA card")
    from zerovox_tpu_torch.device import use_full_f32
    from zerovox_tpu_torch.ops import _cuda
    from zerovox_tpu_torch.ops.mrf import pack_towers
    from zerovox_tpu_torch.ops.resblock import resblock1_plain
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    use_full_f32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as d:
        libs, ptxas = build(Path(d), _cuda, args.parent)
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
        packed = pack_towers([tuple(tw)])
        flat_w = torch.cat([tw[0].reshape(-1), tw[2].reshape(-1)])  # the parent's layout
        flat_b = torch.cat([tw[1].reshape(-1), tw[3].reshape(-1)])
        ref = resblock1_plain(x, *tw, DILS)
        outs = {}
        names = [n for n in libs if n != "parent" or C in args.parent_widths]

        def call(name, out):
            w, b = (flat_w, flat_b) if name == "parent" else (packed.w, packed.b)
            err = libs[name].zv_resblock1_f32(x.data_ptr(), out.data_ptr(), w.data_ptr(),
                                              b.data_ptr(), 1, T, C, k, P, *DILS, stream)
            if err != 0:
                raise RuntimeError(f"{name}: CUDA error {err} at [1,{T},{C}]")

        for name in names:
            out = torch.empty_like(x)
            call(name, out)
            torch.cuda.synchronize()
            outs[name] = out
        errs = {name: (o - ref).abs().max().item() for name, o in outs.items()}
        bitwise = {name: torch.equal(o, outs["source"]) for name, o in outs.items() if name != "parent"}
        tiles = {name: libs[name].zv_resblock1_tile(1, T, C, k, P, *DILS)
                 for name in names if name != "parent"}
        order = names + names[::-1]
        times = {name: [] for name in names}
        for name in order:
            out = outs[name]
            times[name].append(cuda_time_ms(lambda: call(name, out), iters=args.iters, warmup=2))
        plain_ms = cuda_time_ms(lambda: resblock1_plain(x, *tw, DILS), iters=5, warmup=1)
        row = {"shape": f"[1,{T},{C}]", "gflop": 36.0 * C * C * T / 1e9,
               "bound_3xtf32_ms": 1e3 * 3 * 36.0 * C * C * T / 495e12, "plain_ms": plain_ms,
               "max_abs_err": errs, "bitwise_as_source": bitwise, "tile": tiles,
               "turns_ms": times, "mean_ms": {n: sum(v) / len(v) for n, v in times.items()}}
        print(json.dumps(row), flush=True)
        rows.append(row)
        bad = [n for n, e in errs.items() if not e < TOL] + [n for n, ok in bitwise.items() if not ok]
        if bad:
            sys.exit(f"bench_k3_variants: {bad} wrong at [1,{T},{C}]: {errs}, bitwise {bitwise}")
        del x, tw, packed, flat_w, flat_b, ref, outs
    print(card)
    print(json.dumps({"k3_variants": rows, "card": card}))


if __name__ == "__main__":
    main()
