#!/usr/bin/env python3
"""This tree against an earlier checkout of it, on one card, in turns.

    python3 scripts/parent_turns.py PARENT_DIR [--rounds N] [--runs M] [--out FILE]

PARENT_DIR holds the earlier commit's files (`git archive`). Child processes
run N rounds (default 1) of parent, change, change, parent; each imports the
`zerovox_tpu_torch` package of its own tree and builds its own kernels. Each
measures first-chunk latency as `chip_smoke.py` phases 4 and 8 do (p50 of
`tts_stream` to its first chunk over M calls, default 15, the first 5 not
counted; bench.py's text with forced durations): on the default engine and
on the StyleTTS engine with the single-tower vocoder, random weights from
seed 0; the bf16 K4's forward and backward at the training shape
[24, 32, 80, 500]; the bf16 K1 and K2 (with and without conv_post) at the
main path's and one streamed window's shapes, and the bf16 K3 at the
single-tower vocoder's three stage shapes and at C = 16 and 8; K5's
forward at the training shape [24, 2, 512, 264] and the serving shapes
[1, 2, 1024, 264] (decoder) and [1, 2, 256, 264] (encoder), and its
backward (dK/dV, dQ and both, D's reduction included) at the training
shape, in float32 and bf16, by CUDA events (the forward's launches queued
behind a sleeping kernel, so that its small shapes read device time); the
same at tts_medium's one head (d = 528, the kernels of d above 272: the
forward at [1, 1, 1024, 528], [24, 1, 512, 528] and [1, 1, 256, 528], the
backward at [24, 1, 512, 528]), each beside scaled_dot_product_attention
(SDPA) on the boolean segment mask on the same inputs (its forward, and its
backward by autograd); and the float32 and the bf16-mixed train step of
tts_medium at 1 head (chip_smoke.py phase 23's: batch 24, mel bucket 512,
the tree's own chip_smoke.py corpus and config) under flash and under einsum
in turns. The
first parent and change children also save the float32 K1, K2, K3 and K4's
outputs, the bf16 K1, K2 and K3's, the bf16 K4's (y, sum, sq, m; dx, dw,
ds, dt) and K5's (forward o and lse, backward dq, dk, dv from them; float32
and bf16, at K5_OUT_SHAPES: one for each of the forward's layouts, and
d = 528) on
seeded inputs, and the two sets are compared with `torch.equal`; the bf16
K4's dw, ds and dt,
which sum per-block partials that follow the grid, also by their largest
distance relative to the parent's largest value (held to BF16_RED_TOL).
The outputs of a kernel whose arithmetic this tree changed against its
parent (REDESIGNED: K5's bf16 kernels of d above 272, redesigned as
clusters that split the head dim: o, lse, dq, dk and dv at d = 528) are
compared instead by their largest distance relative to the parent's
largest value, held to the kernel's bound against plain: one bf16 step of
the largest value for a bf16 o, two for a bf16 gradient, REDESIGNED_TOL
for a float32 tensor (lse). Everything else, K5's float32 cluster kernels
at d = 528 included, is held bitwise.

Prints the card's name and power limit, then one JSON object (also written
to FILE when given).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K4_SHAPE = (24, 32, 80, 500)
BF16_RED_TOL = 1e-3  # tests/test_torch_gpu.py's bound for the bf16 K4's float32 reductions
# outputs whose arithmetic this tree changed (key prefixes)
REDESIGNED = ("k5_fwd_bf16_d528_", "k5_bwd_bf16_d528_")
REDESIGNED_TOL = 1e-4  # x the largest value: tests/test_torch_gpu.py's bound for K5's gradients
K5_SHAPE = (24, 2, 512, 264)
K5_FWD_SHAPES = {"train": K5_SHAPE, "serve": (1, 2, 1024, 264), "enc": (1, 2, 256, 264)}
# the outputs compared with the parent's: the forward's 64-, 32- and 16-row tiles on 132 SMs
K5_OUT_SHAPES = {"rows64": (9, 2, 512, 264), "rows32": (3, 2, 1024, 264),
                 "rows16": (1, 2, 1024, 264), "d528": (3, 1, 512, 528)}
# tts_medium at 1 head: the kernels of d above 272
K5_WIDE_SHAPE = (24, 1, 512, 528)
K5_WIDE_FWD_SHAPES = {"train_d528": K5_WIDE_SHAPE, "serve_d528": (1, 1, 1024, 528),
                      "enc_d528": (1, 1, 256, 528)}
K3_SHAPES = ((44096, 128), (88192, 64), (176384, 32), (88192, 16), (176384, 8))
TEXT = ("The quick brown fox jumps over the lazy dog while the curious cat "
        "watches from a sunny windowsill in the early morning light.")
FRAMES_PER_PHONE = 6


def kernel_outputs(torch) -> dict:
    """K1, K2 (plain and with conv_post), K3 and K4 forward and backward on
    seeded inputs at their paths' widths."""
    from zerovox_tpu_torch.ops import flash_attention as fa
    from zerovox_tpu_torch.ops.mrf import fused_mrf, pack_towers
    from zerovox_tpu_torch.ops.resblock import fused_resblock1
    from zerovox_tpu_torch.ops.se_conv import (se_conv_bwd, se_conv_bwd_bf16, se_conv_fwd,
                                               se_conv_fwd_bf16)
    from zerovox_tpu_torch.ops.upsample_stage import fused_upsample_stage, pack_upsampler

    gen = torch.Generator().manual_seed(77)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    def towers(C):
        return [(rnd(3, k, C, C, scale=(k * C) ** -0.5), rnd(3, C, scale=0.5),
                 rnd(3, k, C, C, scale=(k * C) ** -0.5), rnd(3, C, scale=0.5)) for k in (3, 7, 11)]

    def bf(ts):
        return [tuple(t.bfloat16() for t in tw) for tw in ts]

    dils, ks = (1, 3, 5), (3, 7, 11)
    x1, tw1 = rnd(1, 11008, 128), towers(128)
    out = {"k1": fused_mrf(x1, pack_towers(tw1), dils, ks),
           "k1_bf16": fused_mrf(x1.bfloat16(), pack_towers(bf(tw1)), dils, ks)}
    for name, (T_in, ci, co, post) in {"k2": (11008, 128, 64, False),
                                       "k2_post": (22016, 64, 32, True)}.items():
        up_w, up_b = rnd(4, ci, co, scale=(2 * ci) ** -0.5), rnd(co, scale=0.5)
        x, tw = rnd(1, T_in, ci), towers(co)
        p = (rnd(7, co, 1, scale=(7 * co) ** -0.5), rnd(1, scale=0.1)) if post else None
        out[name] = fused_upsample_stage(x, pack_upsampler(up_w, up_b, 2), 1, pack_towers(tw), dils,
                                         ks, post=p)
        out[name + "_bf16"] = fused_upsample_stage(
            x.bfloat16(), pack_upsampler(up_w.bfloat16(), up_b.bfloat16(), 2), 1,
            pack_towers(bf(tw)), dils, ks, post=tuple(t.bfloat16() for t in p) if post else None)
    for C, T in ((128, 11008), (64, 22016), (32, 44032), (16, 44032), (8, 88064)):
        x, tower = rnd(1, T, C), towers(C)[0]
        out[f"k3_{C}"] = fused_resblock1(x, *tower, dils)
        out[f"k3_bf16_{C}"] = fused_resblock1(x.bfloat16(), *bf([tower])[0], dils)
    x, w = rnd(4, 32, 80, 500), rnd(32, 32, 3, 3, scale=288 ** -0.5)
    s, t = (torch.rand(32, generator=gen) + 0.5).cuda(), rnd(32, scale=0.3)
    for relu in (True, False):
        fwd = se_conv_fwd(x, w, s, t, relu)
        bwd = se_conv_bwd(x, fwd[0], rnd(4, 32, 80, 500), w, s, t, rnd(32), rnd(32), rnd(4, 32), relu)
        for i, a in enumerate(fwd):
            out[f"k4_fwd_{relu}_{i}"] = a
        for i, a in enumerate(bwd):
            out[f"k4_bwd_{relu}_{i}"] = a
    xb, wb = x.bfloat16(), w.bfloat16()
    for relu in (True, False):
        fwd = se_conv_fwd_bf16(xb, wb, s, t, relu)
        bwd = se_conv_bwd_bf16(xb, fwd[0], rnd(4, 32, 80, 500).bfloat16(), wb, s, t, rnd(32),
                               rnd(32), rnd(4, 32), relu)
        for name, a in zip(("y", "sum", "sq", "m"), fwd):
            out[f"k4_bf16_fwd_{relu}_{name}"] = a
        for name, a in zip(("dx", "dw", "ds", "dt"), bwd):
            out[f"k4_bf16_bwd_{relu}_{name}"] = a
    for label, shape in K5_OUT_SHAPES.items():
        for kind, (q, k, v, seg, do, scale) in k5_inputs(torch, shape).items():
            o, lse = fa.flash_fwd(q, k, v, seg, scale)
            out[f"k5_fwd_{kind}_{label}_o"], out[f"k5_fwd_{kind}_{label}_lse"] = o, lse
            for name, a in zip(("dq", "dk", "dv"), fa.flash_bwd(q, k, v, o, lse, do, seg, scale)):
                out[f"k5_bwd_{kind}_{label}_{name}"] = a
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def k5_inputs(torch, shape) -> dict:
    """K5's inputs at [B, h, L, d] as chip_smoke.py phase 21 makes them (views
    of [B, L, h, d] tensors, segment ids with per-row valid lengths, seed
    21), float32 and bf16: {kind: (q, k, v, seg, do, scale)}."""
    import numpy as np

    B, h, L, d = shape
    rng = np.random.default_rng(21)

    def t():
        return torch.from_numpy(rng.normal(size=(B, L, h, d)).astype(np.float32)).cuda() \
            .transpose(1, 2)

    q, k, v, do = t(), t(), t(), t()
    n = rng.integers(L // 2, L + 1, size=B)
    n[0] = L
    seg = torch.from_numpy((np.arange(L)[None] >= n[:, None]).astype(np.int32)).cuda()
    scale = d ** -0.5
    return {"f32": (q, k, v, seg, do, scale),
            "bf16": (*(x.bfloat16() for x in (q, k, v)), seg, do.bfloat16(), scale)}


def queued_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """CUDA-event ms of fn() with its launches queued behind a kernel that
    sleeps ~10 ms, so that the events time the device running them back to
    back, not the host launching them (a forward at [1, 2, 256, 264] takes
    less device time than its wrapper's host time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k5_ms(torch) -> dict:
    """ms of K5's forward at K5_FWD_SHAPES and K5_WIDE_FWD_SHAPES
    (queued_ms) and of its backward at K5_SHAPE and K5_WIDE_SHAPE by CUDA
    events: dK/dV, dQ and both (D's reduction included, as chip_smoke.py
    phase 21's flash_bwd row), float32 and bf16; at d = 528 SDPA's forward
    (`sdpa_fwd_*`, queued_ms) and backward (`sdpa_bwd_*`) beside them."""
    import torch.nn.functional as F

    from zerovox_tpu_torch.ops import flash_attention as fa
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    res = {}
    for label, shape in {**K5_FWD_SHAPES, **K5_WIDE_FWD_SHAPES}.items():
        for kind, (q, k, v, seg, _, scale) in k5_inputs(torch, shape).items():
            res[f"fwd_{label}_{kind}"] = queued_ms(torch, lambda: fa.flash_fwd(q, k, v, seg, scale))
            if label.endswith("_d528"):
                mask = seg[:, None, :, None] == seg[:, None, None, :]
                res[f"sdpa_fwd_{label}_{kind}"] = queued_ms(
                    torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                  scale=scale))
    for tag, shape in (("", K5_SHAPE), ("_d528", K5_WIDE_SHAPE)):
        for kind, (q, k, v, seg, do, scale) in k5_inputs(torch, shape).items():
            o, lse = fa.flash_fwd(q, k, v, seg, scale)
            calls = {"dkv": lambda: fa.flash_bwd_dkv(q, k, v, o, lse, do, seg, scale),
                     "dq": lambda: fa.flash_bwd_dq(q, k, v, o, lse, do, seg, scale),
                     "bwd": lambda: fa.flash_bwd(q, k, v, o, lse, do, seg, scale)}
            for part, fn in calls.items():
                res[f"{part}{tag}_{kind}"] = cuda_time_ms(fn, iters=20, warmup=3)
            if tag:
                mask = seg[:, None, :, None] == seg[:, None, None, :]
                qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
                so = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=scale)
                res[f"sdpa_bwd{tag}_{kind}"] = cuda_time_ms(
                    lambda: torch.autograd.grad(so, (qg, kg, vg), do, retain_graph=True),
                    iters=20, warmup=3)
                del so, qg, kg, vg
            del o, lse
        torch.cuda.empty_cache()
    return res


def flash_step_ms(torch) -> dict:
    """The float32 and the bf16-mixed train step of tts_medium at 1 head (d =
    528) as chip_smoke.py phase 23 runs it (the tree's own chip_smoke.py:
    its config, corpus and batch 24 at mel bucket 512), device ms by CUDA
    events (3 steps after 1), flash and einsum in turns (flash, einsum,
    einsum, flash): {"flash": [ms, ms], "einsum": [ms, ms], "flash_bf16":
    ..., "einsum_bf16": ...}."""
    import chip_smoke as cs

    from zerovox_tpu_torch.training.data import SpeechDataModule
    from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig, device_batch
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    cfg = cs.train_config(fused=True, base=cs.tts_medium_heads(1))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        cs.write_corpus(root, "train", cfg.symbols(), cfg.audio.num_mels, cs.TRAIN_UTTS,
                        (80, 100), seed=0)
        dm = SpeechDataModule([{"path": {"preprocessed_path": "train"}}], cfg.symbols(), cs.STATS,
                              batch_size=cs.TRAIN_BATCH, num_workers=4, seed=0,
                              base_path=str(root))
        dm.prepare_data()
        batch = device_batch(next(iter(dm.train_dataloader(0))), "cuda")
        res = {}
        for precision, tag in (("32", ""), ("bf16-mixed", "_bf16")):
            trainer = Trainer(cfg, TrainerConfig(max_epochs=1, warmup_epochs=1, seed=0,
                                                 precision=precision,
                                                 out_folder=str(root / "model")),
                              steps_per_epoch=2)
            state = trainer.init_state()
            for kind in ("flash", "einsum", "einsum", "flash"):
                cs.set_attention(kind if kind == "flash" else None)
                res.setdefault(kind + tag, []).append(
                    cuda_time_ms(lambda: trainer.train_step(state, batch), iters=3, warmup=1))
            cs.set_attention(None)
            del trainer, state
        del batch
    torch.cuda.empty_cache()
    return res


def redesigned_bound(parent, key: str) -> float:
    """The bound of a REDESIGNED output against the parent's, relative to
    the parent's largest value: REDESIGNED_TOL for a float32 tensor, one
    bf16 step of the largest value for a bf16 o, two for a bf16 gradient."""
    import math

    import torch

    if parent.dtype != torch.bfloat16:
        return REDESIGNED_TOL
    m = parent.float().abs().max().item()
    step = 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0
    return (1 if key.endswith("_o") else 2) * step / max(m, 1e-30)


def k4_bf16_ms(torch) -> dict:
    """CUDA-event ms of the bf16 K4's forward and backward (relu on) at
    K4_SHAPE, on seeded inputs."""
    from zerovox_tpu_torch.ops.se_conv import se_conv_bwd_bf16, se_conv_fwd_bf16
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    B, C, H, W = K4_SHAPE
    gen = torch.Generator().manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    x, w = rnd(B, C, H, W).bfloat16(), rnd(C, C, 3, 3, scale=(9 * C) ** -0.5).bfloat16()
    s, t = (torch.rand(C, generator=gen) + 0.5).cuda(), rnd(C, scale=0.3)
    dy, dsum, dsq, dm = rnd(B, C, H, W).bfloat16(), rnd(C), rnd(C), rnd(B, C)
    y = se_conv_fwd_bf16(x, w, s, t, True)[0]
    return {"fwd": cuda_time_ms(lambda: se_conv_fwd_bf16(x, w, s, t, True), iters=30, warmup=3),
            "bwd": cuda_time_ms(lambda: se_conv_bwd_bf16(x, y, dy, w, s, t, dsum, dsq, dm, True),
                                iters=30, warmup=3)}


def bf16_tile_ms(torch) -> dict:
    """CUDA-event ms of the bf16 K1, K2 and K2 with conv_post at the main
    path's shapes (bucket 689: K1 [1, 44096, 128]) and at one streamed
    window's (172 frames: [1, 11008, 128]), and of the bf16 K3 (one tower, k
    3) at K3_SHAPES, on seeded inputs."""
    from zerovox_tpu_torch.ops.mrf import fused_mrf, pack_towers
    from zerovox_tpu_torch.ops.resblock import fused_resblock1
    from zerovox_tpu_torch.ops.upsample_stage import fused_upsample_stage, pack_upsampler
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    gen = torch.Generator().manual_seed(9)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda().bfloat16()

    def towers(C, ks=(3, 7, 11)):
        return pack_towers([(rnd(3, k, C, C, scale=(k * C) ** -0.5), rnd(3, C, scale=0.5),
                             rnd(3, k, C, C, scale=(k * C) ** -0.5), rnd(3, C, scale=0.5))
                            for k in ks])

    dils, ks = (1, 3, 5), (3, 7, 11)
    m128, m64, m32 = towers(128), towers(64), towers(32)
    up64 = pack_upsampler(rnd(4, 128, 64, scale=256 ** -0.5), rnd(64, scale=0.5), 2)
    up32 = pack_upsampler(rnd(4, 64, 32, scale=128 ** -0.5), rnd(32, scale=0.5), 2)
    post = (rnd(7, 32, 1, scale=224 ** -0.5), rnd(1, scale=0.1))
    res = {}
    for label, T1 in (("main", 44096), ("window", 11008)):
        x1, x2, x3 = rnd(1, T1, 128), rnd(1, T1, 128), rnd(1, 2 * T1, 64)
        fns = {"k1": lambda: fused_mrf(x1, m128, dils, ks),
               "k2": lambda: fused_upsample_stage(x2, up64, 1, m64, dils, ks),
               "k2_post": lambda: fused_upsample_stage(x3, up32, 1, m32, dils, ks, post=post)}
        for name, fn in fns.items():
            res[f"{name}_{label}"] = cuda_time_ms(fn, iters=20, warmup=3)
    for T, C in K3_SHAPES:
        x, tw = rnd(1, T, C), towers(C, (3,))
        res[f"k3_{C}"] = cuda_time_ms(lambda: fused_resblock1(x, *tw.towers[0], dils, packed=tw),
                                      iters=20, warmup=3)
    return res


def first_chunk_p50(torch, engine, refwav, runs: int) -> float:
    import numpy as np

    from zerovox_tpu_torch.utils.profiling import RtfStats

    spk = engine.speaker_embed(refwav)
    dur = np.full(len(engine.text2phonemeids(TEXT)[0]), FRAMES_PER_PHONE, np.int32)
    lat = RtfStats(warmup=4)
    for _ in range(runs):
        t0 = time.perf_counter()
        gen = engine.tts_stream(TEXT, spk, duration=dur)
        next(gen)
        first = time.perf_counter() - t0
        for _ in gen:
            pass
        lat.add(1.0, time.perf_counter() - t0, first_chunk_s=first)
    return lat.p50_first_chunk_ms


def child(root: Path, out: Path, dump: Path | None, runs: int) -> None:
    sys.path.insert(0, str(root))
    import dataclasses as dc

    import numpy as np
    import torch

    import zerovox_tpu_torch
    from zerovox_tpu_torch.config import ZeroVoxConfig
    from zerovox_tpu_torch.device import use_full_f32
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS

    if Path(zerovox_tpu_torch.__file__).resolve().parent != (root / "zerovox_tpu_torch").resolve():
        sys.exit(f"imported {zerovox_tpu_torch.__file__}, not {root}'s package")
    use_full_f32()
    if dump is not None:
        torch.save(kernel_outputs(torch), dump)
    refwav = np.random.default_rng(0).normal(size=2 * 22050).astype(np.float32) * 0.1
    res = {"k4_bf16_ms": k4_bf16_ms(torch), "bf16_tile_ms": bf16_tile_ms(torch),
           "k5_ms": k5_ms(torch), "flash_step_ms": flash_step_ms(torch)}
    res["main"] = first_chunk_p50(torch, ZeroVoxTTS.from_random(seed=0), refwav, runs)
    base = ZeroVoxConfig()
    cfg = dc.replace(base, model=dc.replace(
        base.model, decoder=dc.replace(base.model.decoder, kind="styletts")))
    hcfg = HifiGanConfig(resblock="1", upsample_initial_channel=512, upsample_rates=(8, 8, 2, 2),
                         upsample_kernel_sizes=(16, 16, 4, 4), resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3, 5),))
    res["styletts"] = first_chunk_p50(torch, ZeroVoxTTS.from_random(cfg, hcfg, seed=0), refwav,
                                      runs)
    out.write_text(json.dumps(res))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", nargs="?", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--runs", type=int, default=15)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--result", type=Path, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dump", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.result, args.dump, args.runs)
        return
    if args.parent is None:
        ap.error("give the parent checkout's directory")
    import torch

    if not torch.cuda.is_available():
        sys.exit("parent_turns: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    turns = {"parent": [], "change": []}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        dumps = {}
        for i, label in enumerate(("parent", "change", "change", "parent") * args.rounds):
            root = args.parent.resolve() if label == "parent" else ROOT
            res = tmp / f"{i}.json"
            cmd = [sys.executable, str(Path(__file__).resolve()), "--child", str(root),
                   "--result", str(res), "--runs", str(args.runs)]
            if label not in dumps:
                dumps[label] = tmp / f"{label}.pt"
                cmd += ["--dump", str(dumps[label])]
            proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
            if proc.returncode != 0:
                sys.exit(f"parent_turns: the {label} child failed:\n{proc.stdout}\n{proc.stderr}")
            turns[label].append(json.loads(res.read_text()))
        a, b = torch.load(dumps["parent"]), torch.load(dumps["change"])
        redesigned = {k: ((b[k].double() - a[k].double()).abs().max()
                          / a[k].double().abs().max().clamp_min(1e-30)).item()
                      for k in a if k.startswith(REDESIGNED)}
        redesigned_tol = {k: redesigned_bound(a[k], k) for k in redesigned}
        bitwise = {k: a[k].shape == b[k].shape and torch.equal(a[k], b[k])
                   for k in a if not k.startswith(REDESIGNED)}
        red_err = {k: ((b[k] - a[k]).abs().max() / a[k].abs().max().clamp_min(1e-30)).item()
                   for k in a if k.startswith("k4_bf16_bwd") and k[-2:] in ("dw", "ds", "dt")}
    k4 = {label: [t.pop("k4_bf16_ms") for t in ts] for label, ts in turns.items()}
    k12 = {label: [t.pop("bf16_tile_ms") for t in ts] for label, ts in turns.items()}
    k5 = {label: [t.pop("k5_ms") for t in ts] for label, ts in turns.items()}
    steps = {label: [t.pop("flash_step_ms") for t in ts] for label, ts in turns.items()}
    medians = {label: {k: statistics.median(t[k] for t in ts) for k in ts[0]}
               for label, ts in turns.items()}
    k4_medians = {label: {p: statistics.median(m[p] for m in ms) for p in ("fwd", "bwd")}
                  for label, ms in k4.items()}
    k12_medians = {label: {c: statistics.median(m[c] for m in ms) for c in ms[0]}
                   for label, ms in k12.items()}
    k5_medians = {label: {c: statistics.median(m[c] for m in ms) for c in ms[0]}
                  for label, ms in k5.items()}
    result = {"first_chunk_p50_ms": turns, "median_of_p50s_ms": medians, "runs": args.runs,
              "k4_bf16_ms": k4, "k4_bf16_median_ms": k4_medians,
              "bf16_tile_ms": k12, "bf16_tile_median_ms": k12_medians,
              "k5_ms": k5, "k5_median_ms": k5_medians, "flash_step_d528_ms": steps,
              "redesigned_rel_err_vs_parent": redesigned,
              "redesigned_rel_bound": redesigned_tol,
              "redesigned_within": bool(redesigned) and all(v <= redesigned_tol[k]
                                                             for k, v in redesigned.items()),
              "kernels_bitwise_as_parent": bitwise,
              "all_bitwise": all(bitwise.values()) and a.keys() == b.keys(),
              "f32_bitwise": all(v for k, v in bitwise.items() if "bf16" not in k),
              "k4_bf16_reductions_rel_err": red_err,
              "k4_bf16_reductions_within_tol": all(v <= BF16_RED_TOL for v in red_err.values()),
              "card": card}
    print(card)
    print(json.dumps(result))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result) + "\n")


if __name__ == "__main__":
    main()
