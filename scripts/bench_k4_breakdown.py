#!/usr/bin/env python3
"""Where kernel K4's time goes on the card: `zerovox_tpu_torch/csrc/se_conv.cu`
against copies of itself with its MMA phases taken out, timed in turns at the
training shape [24, 32, 80, 500] (CUDA events, relu on), the float32 kernels
and the bf16 ones (namespace `bf`).

    python3 scripts/bench_k4_breakdown.py

Variants, built from text substitutions of the source with the kernels' own
nvcc flags, each taking the same phases out of both precisions:

  kernel       the source as it is;
  no_conv_mma  forward and dgrad without their MMAs (accumulators left at 0);
  no_wgrad     backward without wgrad's MMAs;
  no_mma       neither: window loads, conversion and epilogues alone.

The bf16 pass's other phases, taken out alone:

  no_convert   no conversion of the raw windows into u (and g);
  no_store     y and dx not stored;
  no_fetch     no raw window copied.

Beside them, the bf16 forward's design against its alternatives:

  fwd_2_stages two raw windows in each block's ring (FWD_STAGES = 2), which
               leaves room for one block an SM, against one window and two
               blocks;
  fwd_1_block  one window and one block an SM (FWD_BLOCKS = 1);
  store_NB     y and dx leave in N-byte pieces (STORE_P = N / 2 bf16, 64 / N
               lanes a channel row) instead of 8-byte ones: N = 2, 4, 16.

A variant's distance from `kernel` is the device time of what it takes out
(or the price of the alternative). A profile of the `kernel` variant splits
each pass's time by CUDA kernel (the sums' second and third passes, the
backward's partial rows). Every substitution must match the source exactly once
(`tests/test_torch_k4_breakdown.py` checks that on the CPU). Prints the
card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "zerovox_tpu_torch" / "csrc" / "se_conv.cu"
SHAPE = (24, 32, 80, 500)
ZERO_ACC = "for (auto& a : acc) for (auto& b : a) for (auto& c : b) c = 0.f;"
CONV = [("conv_row(Uh, Ul, Bs, warp, acc);", ZERO_ACC),  # float32 forward
        ("conv_row(Gh, Gl, Bs, warp, acc);", ZERO_ACC),  # float32 dgrad
        ("conv_row(U, Bs, warp, acc);", ZERO_ACC),  # bf16 forward
        ("conv_row(G, Bs, warp, acc);", ZERO_ACC)]  # bf16 dgrad
WGRAD = [("for (int kstep = 0; kstep < TH * 4; ++kstep) {",  # float32
          "for (int kstep = 0; kstep < 0; ++kstep) {"),
         ("for (int kstep = 0; kstep < TH * 2; kstep += 2) {",  # bf16
          "for (int kstep = 0; kstep < 0; kstep += 2) {")]
VARIANTS = {"kernel": [], "no_conv_mma": CONV, "no_wgrad": WGRAD, "no_mma": CONV + WGRAD,
            "no_convert": [("if (c0 < Win::WR) store(r0, c0, v0);", ""),
                           ("if (it1 != it && c1 < Win::WR) store(r1, c1, v1);", "")],
            "no_store": [("store_piece<P>(d + off + P * q, src + off + P * q);", ";"),
                         ("store_piece<P>(d + i, src + i);", ";"),
                         ("for (int k = lo; k < hi; ++k) d[k] = src[k];", ";")],
            "no_fetch": [("cp16(dst, (first & ~(uintptr_t)15) + 16 * k);", ";")],
            "fwd_2_stages": [("constexpr int FWD_STAGES = 1;", "constexpr int FWD_STAGES = 2;")],
            "fwd_1_block": [("constexpr int FWD_BLOCKS = 2;", "constexpr int FWD_BLOCKS = 1;")],
            **{f"store_{2 * p}B": [("constexpr int STORE_P = 4;", f"constexpr int STORE_P = {p};")]
               for p in (1, 2, 8)}}


def variant_source(src: str, subs) -> str:
    """src with every (old, new) of subs applied; raises unless each old
    occurs exactly once."""
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in se_conv.cu once")
        src = src.replace(old, new)
    return src


def build(tmp: Path, _cuda) -> tuple[dict, list[str]]:
    src = SOURCE.read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        cu = tmp / f"{name}.cu"
        cu.write_text(variant_source(src, subs))
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{_cuda.CSRC}", "-o", str(tmp / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if name == "kernel":  # registers, shared memory and spills of each kernel
            ptxas = [ln.strip() for ln in log.splitlines() if "ptxas" in ln or "spill" in ln]
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        for fn, argtypes in _cuda.SIGNATURES["se_conv"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


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
    NPART = C * C * 9 + 2 * C
    gen = torch.Generator().manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    x, w = rnd(B, C, H, W), rnd(C, C, 3, 3, scale=(9 * C) ** -0.5)
    s, t = (torch.rand(C, generator=gen) + 0.5).cuda(), rnd(C, scale=0.3)
    y, dy, dsum, dsq, dm = rnd(B, C, H, W), rnd(B, C, H, W), rnd(C), rnd(C), rnd(B, C)
    xb, wb, yb, dyb = x.bfloat16(), w.bfloat16(), y.bfloat16(), dy.bfloat16()

    def ptr(a):
        return a.data_ptr()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd(lib):
        out = [torch.empty_like(x), x.new_empty(C), x.new_empty(C), x.new_empty(B, C),
               x.new_empty(lib.zv_se_conv_fwd_tiles(B, H, W) * 2 * C)]
        _cuda.check(lib.zv_se_conv_fwd_f32(*map(ptr, (x, w, s, t, *out)), B, H, W, 1, stream()), "fwd")

    def bwd(lib):
        out = [torch.empty_like(x), x.new_empty(NPART),
               x.new_empty(lib.zv_se_conv_bwd_blocks(B, H, W) * NPART)]
        _cuda.check(lib.zv_se_conv_bwd_f32(*map(ptr, (x, y, dy, w, s, t, dsum, dsq, dm, *out)),
                                           B, H, W, 1, stream()), "bwd")

    def fwd_bf16(lib):
        out = [torch.empty_like(xb), s.new_empty(C), s.new_empty(C), s.new_empty(B, C),
               s.new_empty(lib.zv_se_conv_fwd_tiles(B, H, W) * 2 * C)]
        _cuda.check(lib.zv_se_conv_fwd_bf16(*map(ptr, (xb, wb, s, t, *out)), B, H, W, 1, stream()),
                    "fwd_bf16")

    def bwd_bf16(lib):
        out = [torch.empty_like(xb), s.new_empty(NPART),
               s.new_empty(lib.zv_se_conv_bf16_blocks(B, H, W, 1) * NPART)]
        _cuda.check(lib.zv_se_conv_bwd_bf16(*map(ptr, (xb, yb, dyb, wb, s, t, dsum, dsq, dm, *out)),
                                            B, H, W, 1, stream()), "bwd_bf16")

    passes = {"fwd": fwd, "bwd": bwd, "bf16_fwd": fwd_bf16, "bf16_bwd": bwd_bf16}
    with tempfile.TemporaryDirectory() as tmp:
        libs, ptxas = build(Path(tmp), _cuda)
        ms = {name: {p: [] for p in passes} for name in libs}
        for names in (list(libs), list(libs)[::-1]):  # in turns, each order once
            for name in names:
                for p, fn in passes.items():
                    ms[name][p].append(cuda_time_ms(lambda: fn(libs[name]), iters=30, warmup=3))
        split = {p: kernel_split(torch, lambda: fn(libs["kernel"])) for p, fn in passes.items()}
    print(card)
    print(json.dumps({"k4_breakdown": {"shape": list(SHAPE), "ms": ms, "kernel_us": split,
                                       "card": card, "ptxas": ptxas}}))


def kernel_split(torch, fn, calls: int = 10) -> dict:
    """Device microseconds a call of fn() by CUDA kernel (torch.profiler),
    and the events' time a call for comparison: their difference is time the
    device waited on the host."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us and ("kernel" in ev.key or "se_conv" in ev.key):
            out[ev.key[-60:]] = us / calls
    out["events_us"] = start.elapsed_time(end) * 1e3 / calls
    return out


if __name__ == "__main__":
    main()
