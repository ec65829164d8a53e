#!/usr/bin/env python3
"""Where kernel K4's time goes on the card: `zerovox_tpu_torch/csrc/se_conv.cu`
against copies of itself with its MMA phases taken out, timed in turns at the
training shape [24, 32, 80, 500] (CUDA events, relu on).

    python3 scripts/bench_k4_breakdown.py

Variants, built from text substitutions of the source with the kernels' own
nvcc flags:

  kernel       the source as it is;
  no_conv_mma  forward and dgrad without their MMAs (accumulators left at 0);
  no_wgrad     backward without wgrad's MMAs;
  no_mma       neither: window loads, conversion and epilogues alone.

A variant's distance from `kernel` is the device time of what it takes out.
Prints the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (24, 32, 80, 500)
ZERO_ACC = "for (auto& a : acc) for (auto& b : a) for (auto& c : b) c = 0.f;"
CONV = [("conv_row(Uh, Ul, Bs, warp, acc);", ZERO_ACC), ("conv_row(Gh, Gl, Bs, warp, acc);", ZERO_ACC)]
WGRAD = [("for (int kstep = 0; kstep < TH * 4; ++kstep) {", "for (int kstep = 0; kstep < 0; ++kstep) {")]
VARIANTS = {"kernel": [], "no_conv_mma": CONV, "no_wgrad": WGRAD, "no_mma": CONV + WGRAD}


def build(tmp: Path, _cuda) -> dict:
    src = (_cuda.CSRC / "se_conv.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in se_conv.cu once")
            text = text.replace(old, new)
        cu = tmp / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{_cuda.CSRC}", "-o", str(tmp / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        for fn, argtypes in _cuda.SIGNATURES["se_conv"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_k4_breakdown: needs a CUDA card")
    from zerovox_tpu_torch.ops import _cuda
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    B, C, H, W = SHAPE
    gen = torch.Generator().manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    x, w = rnd(B, C, H, W), rnd(C, C, 3, 3, scale=(9 * C) ** -0.5)
    s, t = (torch.rand(C, generator=gen) + 0.5).cuda(), rnd(C, scale=0.3)
    y, dy, dsum, dsq, dm = rnd(B, C, H, W), rnd(B, C, H, W), rnd(C), rnd(C), rnd(B, C)

    def ptr(a):
        return a.data_ptr()

    def fwd(lib):
        out = [torch.empty_like(x), x.new_empty(C), x.new_empty(C), x.new_empty(B, C),
               x.new_empty(lib.zv_se_conv_fwd_tiles(B, H, W) * 2 * C)]
        _cuda.check(lib.zv_se_conv_fwd_f32(*map(ptr, (x, w, s, t, *out)), B, H, W, 1,
                                           torch.cuda.current_stream().cuda_stream), "fwd")

    def bwd(lib):
        out = [torch.empty_like(x), x.new_empty(C * C * 9 + 2 * C),
               x.new_empty(lib.zv_se_conv_bwd_blocks(B, H, W) * (C * C * 9 + 2 * C))]
        _cuda.check(lib.zv_se_conv_bwd_f32(*map(ptr, (x, y, dy, w, s, t, dsum, dsq, dm, *out)),
                                           B, H, W, 1, torch.cuda.current_stream().cuda_stream), "bwd")

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), _cuda)
        ms = {name: {"fwd": [], "bwd": []} for name in libs}
        for names in (list(libs), list(libs)[::-1]):  # in turns, each order once
            for name in names:
                ms[name]["fwd"].append(cuda_time_ms(lambda: fwd(libs[name]), iters=30, warmup=3))
                ms[name]["bwd"].append(cuda_time_ms(lambda: bwd(libs[name]), iters=30, warmup=3))
    print(card)
    print(json.dumps({"k4_breakdown": {"shape": list(SHAPE), "ms": ms, "card": card}}))


if __name__ == "__main__":
    main()
