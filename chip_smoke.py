#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`zerovox_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py              # the whole check; exits 0 only if every phase passed
    python3 chip_smoke.py --profile DIR   # also a torch.profiler breakdown of tts_ex,
                                          # written to DIR/profile_main_path.txt

Phases, in order; any failure exits nonzero:

1. Device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. Build: every CUDA kernel from `zerovox_tpu_torch/csrc/`, with nvcc's
   register and shared-memory report.
3. Kernels at the main path's shapes (bucket 689 of bench.py's text), each
   against its plain PyTorch version on the card (max abs diff < 5e-4),
   timed with CUDA events beside the plain version and the card's bound.
4. The main path at full width (default ZeroVoxConfig + HiFi-GAN, random
   weights from seed 0): speaker_embed -> tts_ex -> tts_stream, with the
   kernels' launch counts read around that run; then RTF and first-chunk
   latency by bench.py's method.
5. The same weights on the CPU (plain versions) on a short text: the card's
   waveform must match within 1e-3.

The line before the last is a JSON object {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# bench.py's text and forced duration: 102 phones x 6 frames = 612 frames, mel bucket 689
TEXT = ("The quick brown fox jumps over the lazy dog while the curious cat "
        "watches from a sunny windowsill in the early morning light.")
FRAMES_PER_PHONE = 6
SHORT_TEXT = "Hello world."  # text bucket 16, mel bucket 96 (the CPU cross-check)

KERNEL_TOL = 5e-4  # fused kernel against its unfused version
WAV_TOL = 1e-3  # waveform against the float32 CPU run
STREAM_TOL = 1e-4  # streamed chunks against the full render on the card
# H100 SXM data sheet: float32 outside the tensor cores, and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(flop: float, nbytes: float) -> tuple[float, str]:
    """(least milliseconds the card could take, what bounds it)."""
    t_ops, t_bytes = flop / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def mrf_work(T: int, C: int, kernel_sizes, n_pairs: int) -> tuple[float, float]:
    """(FLOP, bytes of weights) of one MRF stage over T rows: each tower runs
    n_pairs x 2 convs of k taps, 2 k C^2 FLOP a row each."""
    flop = 4.0 * n_pairs * sum(kernel_sizes) * C * C * T
    weights = 4.0 * sum(2 * n_pairs * (k * C * C + C) for k in kernel_sizes)
    return flop, weights


def random_towers(torch, gen, C, kernel_sizes, n_pairs, dev):
    def w(*shape, fan_in):
        return (torch.randn(*shape, generator=gen) / fan_in ** 0.5).to(dev)

    return [(w(n_pairs, k, C, C, fan_in=k * C), w(n_pairs, C, fan_in=4),
             w(n_pairs, k, C, C, fan_in=k * C), w(n_pairs, C, fan_in=4)) for k in kernel_sizes]


def kernel_phase(torch, dev, hcfg, mel_frames: int) -> list[dict]:
    """Each kernel at the main path's shapes against its plain version."""
    from zerovox_tpu_torch.ops.mrf import fused_mrf, mrf_plain
    from zerovox_tpu_torch.ops.upsample_stage import fused_upsample_stage, upsample_stage_plain
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    ks, dils = tuple(hcfg.resblock_kernel_sizes), tuple(hcfg.resblock_dilation_sizes[0])
    P = len(dils)
    c0, rates, up_ks = hcfg.upsample_initial_channel, hcfg.upsample_rates, hcfg.upsample_kernel_sizes
    gen = torch.Generator().manual_seed(1234)
    rows = []

    def measure(name, source, replaces, shape, fn, plain, flop, nbytes):
        got = fn()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != plain {tuple(ref.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        err = (got - ref).abs().max().item()
        check(err < KERNEL_TOL, f"{name}: max abs diff {err} against the plain version")
        ms, plain_ms = cuda_time_ms(fn, iters=10, warmup=2), cuda_time_ms(plain, iters=5, warmup=1)
        bound_ms, bound_by = bound(flop, nbytes)
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "gflop": flop / 1e9, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None}
        print(json.dumps(row), flush=True)
        rows.append(row)

    # stage 1 (K1): the MRF at C = c0 / 4 over mel_frames * rates[0] * rates[1] rows
    C1, T1 = c0 // 4, mel_frames * rates[0] * rates[1]
    x1 = torch.randn(1, T1, C1, generator=gen).to(dev)
    tw1 = random_towers(torch, gen, C1, ks, P, dev)
    flop, wbytes = mrf_work(T1, C1, ks, P)
    measure("fused_mrf", "zerovox_tpu_torch/csrc/mrf.cu", "zerovox_tpu/ops/pallas/mrf.py:93",
            f"[1,{T1},{C1}]", lambda: fused_mrf(x1, tw1, dils, ks),
            lambda: mrf_plain(x1, tw1, dils), flop, wbytes + 8.0 * T1 * C1)

    # stages 2 and 3 (K2): upsample stages, the last with conv_post
    T_in, C_in = T1, C1
    for i in (2, 3):
        C_out, u, k = c0 // 2 ** (i + 1), rates[i], up_ks[i]
        T_out = T_in * u
        x = torch.randn(1, T_in, C_in, generator=gen).to(dev)
        up_w = (torch.randn(k, C_in, C_out, generator=gen) / (k * C_in / u) ** 0.5).to(dev)
        up_b = (torch.randn(C_out, generator=gen) / 2).to(dev)
        tw = random_towers(torch, gen, C_out, ks, P, dev)
        last = i == len(rates) - 1
        post = ((torch.randn(7, C_out, 1, generator=gen) / (7 * C_out) ** 0.5).to(dev),
                torch.zeros(1).to(dev)) if last else None
        flop, wbytes = mrf_work(T_out, C_out, ks, P)
        flop += 2.0 * T_out * C_in * C_out * k / u  # k / u taps reach each output row
        wbytes += 4.0 * (k * C_in * C_out + C_out)
        if last:
            flop += 2.0 * 7 * C_out * T_out
            wbytes += 4.0 * (7 * C_out + 1)
        out_elems = T_out * (1 if last else C_out)
        args = (x, up_w, up_b, u, (k - u) // 2, tw, dils)
        measure("fused_upsample_stage" + ("+post" if last else ""),
                "zerovox_tpu_torch/csrc/upsample_stage.cu", "zerovox_tpu/ops/pallas/packed.py:249",
                f"[1,{T_in},{C_in}]->" + (f"[1,{T_out}]" if last else f"[1,{T_out},{C_out}]"),
                lambda: fused_upsample_stage(*args, ks, post=post),
                lambda: upsample_stage_plain(*args, post=post),
                flop, wbytes + 4.0 * (T_in * C_in + out_elems))
        T_in, C_in = T_out, C_out
    return rows


def profile_tts(torch, engine, spk, dur, out: Path) -> None:
    """torch.profiler over three tts_ex calls: device time by kernel and the
    device's busy share of the window, the table written to `out`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            engine.tts_ex(TEXT, spk, duration=dur)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()

    # device activity (kernels and copies; one stream, so they do not overlap)
    busy_s = sum(e.self_device_time_total for e in avgs
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation) / 1e6
    out.mkdir(parents=True, exist_ok=True)
    table = avgs.table(sort_by="self_cuda_time_total", row_limit=40)
    (out / "profile_main_path.txt").write_text(f"{card_line()}\n{table}\n")
    print(json.dumps({"profile": {"calls": 3, "wall_ms": 1e3 * wall, "device_busy_ms": 1e3 * busy_s,
                                  "device_busy_share": busy_s / wall}}), flush=True)


def main() -> None:
    if not (ROOT / "zerovox_tpu_torch" / "__init__.py").is_file():
        fail("the zerovox_tpu_torch package is not beside this script; run it from a checkout")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    # ---- 1. device
    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA card")
    import zerovox_tpu_torch

    check(Path(zerovox_tpu_torch.__file__).resolve().parent == ROOT / "zerovox_tpu_torch",
          f"imported zerovox_tpu_torch from {zerovox_tpu_torch.__file__}, not from this checkout")
    from zerovox_tpu_torch.device import use_full_f32
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.ops import _cuda
    from zerovox_tpu_torch.ops.mrf import fused_mrf
    from zerovox_tpu_torch.ops.upsample_stage import fused_upsample_stage
    from zerovox_tpu_torch.synthesize import MEL_BUCKETS, TEXT_BUCKETS, ZeroVoxTTS, pick_bucket
    from zerovox_tpu_torch.utils.profiling import RtfStats, cuda_time_ms

    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line()
    print(f"device: {kind} (count {count}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card)
    use_full_f32()  # TF32 off: matmuls and cuDNN convolutions in full float32
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    # ---- 2. build
    phase("build")
    info = _cuda.ensure_built()
    print(f"build seconds: {info['seconds']:.2f}")
    for name, lines in info["ptxas"].items():
        for ln in lines:
            if "registers" in ln or "smem" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}")

    # ---- 3. kernels at the main path's shapes
    phase("kernels")
    hcfg = HifiGanConfig()
    engine = ZeroVoxTTS.from_random(seed=0)
    sr, hop = engine.cfg.audio.sampling_rate, engine.cfg.audio.hop_size
    n_phones = len(engine.text2phonemeids(TEXT)[0])
    n_frames = n_phones * FRAMES_PER_PHONE
    bucket = pick_bucket(n_frames, MEL_BUCKETS)
    print(f"text: {n_phones} phones x {FRAMES_PER_PHONE} = {n_frames} frames, mel bucket {bucket}")
    rows = kernel_phase(torch, dev, hcfg, bucket)

    # ---- 4. the main path at full width
    phase("main path")
    refwav = np.random.default_rng(0).normal(size=2 * sr).astype(np.float32) * 0.1
    dur = np.full(n_phones, FRAMES_PER_PHONE, dtype=np.int32)
    fused_mrf.launches = fused_upsample_stage.launches = 0
    spk = engine.speaker_embed(refwav)
    wav, _, n, mel = engine.tts_ex(TEXT, spk, duration=dur)
    per_call = (fused_mrf.launches, fused_upsample_stage.launches)
    chunks = list(engine.tts_stream(TEXT, spk, duration=dur))
    torch.cuda.synchronize()
    launches = {"fused_mrf": fused_mrf.launches, "fused_upsample_stage": fused_upsample_stage.launches}
    print(f"launches: tts_ex {dict(zip(launches, per_call))}; speaker_embed + tts_ex + "
          f"tts_stream ({len(chunks)} chunks) {launches}")
    check(tuple(spk.shape) == (1, 1, engine.cfg.model.emb_size) and bool(torch.isfinite(spk).all()),
          f"speaker embedding {tuple(spk.shape)} not finite or misshapen")
    check(n == n_frames and wav.shape == (n_frames * hop,), f"wav {wav.shape}, {n} frames")
    check(bool(np.isfinite(wav).all()) and bool(np.isfinite(mel).all()), "non-finite wav or mel")
    check(per_call[0] >= 1 and per_call[1] >= 2,
          f"tts_ex launched fused_mrf {per_call[0]}x, fused_upsample_stage {per_call[1]}x")
    streamed = np.concatenate(chunks)
    check(streamed.shape == wav.shape, f"stream {streamed.shape} != tts {wav.shape}")
    stream_err = float(np.max(np.abs(streamed - wav)))
    check(stream_err < STREAM_TOL * min(float(np.max(np.abs(wav))), 1.0),
          f"stream differs from tts by {stream_err}")
    print(f"wav: {wav.shape[0]} samples, peak {np.max(np.abs(wav)):.6g}; "
          f"stream max abs diff {stream_err:.3g}")
    for row in rows:
        row["launches"] = launches[row["name"].removesuffix("+post")]

    # device time of each stage of tts_ex at this bucket (CUDA events)
    ids, puncts = engine.text2phonemeids(TEXT)
    enc, _, _ = engine._encode(ids, puncts, spk, dur)
    mel_b = engine._decode(enc, spk, bucket)
    stages = {
        "encode": cuda_time_ms(lambda: engine._encode(ids, puncts, spk, dur), iters=10),
        "decode": cuda_time_ms(lambda: engine._decode(enc, spk, bucket), iters=10),
        "vocode": cuda_time_ms(lambda: engine._vocode(mel_b), iters=10),
    }
    print(json.dumps({"stage_ms": stages, "bucket": bucket, "card": card}), flush=True)

    # bench.py's method: RTF over 25 tts_ex calls after 10 warm-up; first-chunk p50 over 15
    stats = RtfStats(warmup=10)
    for _ in range(25):
        t0 = time.perf_counter()
        w, _, _, _ = engine.tts_ex(TEXT, spk, duration=dur)
        stats.add(w.shape[0] / sr, time.perf_counter() - t0)
    lat = RtfStats(warmup=4)
    for _ in range(15):
        t0 = time.perf_counter()
        gen = engine.tts_stream(TEXT, spk, duration=dur)
        next(gen)
        first = time.perf_counter() - t0
        for _ in gen:
            pass
        lat.add(wav.shape[0] / sr, time.perf_counter() - t0, first_chunk_s=first)
    print(json.dumps({"rtf": stats.mean_rtf, "first_chunk_p50_ms": lat.p50_first_chunk_ms,
                      "voice_s": wav.shape[0] / sr, "bucket": bucket,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}),
          flush=True)
    if "--profile" in sys.argv:
        profile_tts(torch, engine, spk, dur, Path(sys.argv[sys.argv.index("--profile") + 1]))

    # ---- 5. the same weights on the CPU (plain versions)
    phase("cpu cross-check")
    sd, meldec_sd = engine.state_dicts()
    cpu = ZeroVoxTTS(engine.cfg, sd, hcfg, meldec_sd, device="cpu")
    ids = engine.text2phonemeids(SHORT_TEXT)[0]
    d_short = np.full(len(ids), FRAMES_PER_PHONE, dtype=np.int32)
    check(pick_bucket(len(ids), TEXT_BUCKETS) == 16
          and pick_bucket(int(d_short.sum()), MEL_BUCKETS) == 96,
          f"short text: {len(ids)} phones, {int(d_short.sum())} frames")
    w_card, _, n_card = engine.tts(SHORT_TEXT, spk, duration=d_short)
    w_cpu, _, n_cpu = cpu.tts(SHORT_TEXT, spk.cpu(), duration=d_short)
    check(n_card == n_cpu and w_card.shape == w_cpu.shape, f"card {w_card.shape}, cpu {w_cpu.shape}")
    cpu_err, peak = float(np.max(np.abs(w_card - w_cpu))), float(np.max(np.abs(w_cpu)))
    print(f"card vs cpu: {n_cpu} frames, max abs diff {cpu_err:.3g}, peak {peak:.6g}")
    # random weights give a quiet waveform, so the bound holds relative to its peak too
    check(peak > 0 and cpu_err < WAV_TOL * min(peak, 1.0),
          f"card waveform differs from the CPU run by {cpu_err} (peak {peak})")

    # ---- results
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
