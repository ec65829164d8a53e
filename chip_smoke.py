#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`zerovox_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py              # the whole check; exits 0 only if every phase passed
    python3 chip_smoke.py --profile DIR   # also torch.profiler breakdowns of tts_ex (float32
                                          # and bf16) and of a train step, in DIR/profile_*.txt
    python3 chip_smoke.py --only 12 --repeat 20 [--dump DIR]
                                          # phases 1-2, then phase 12 (18-23) alone, 20 times:
                                          # each repeat's failure is recorded and the run goes
                                          # on; exits nonzero if any repeat failed. --dump
                                          # writes phase 12's variance predictions per repeat

Phases, in order; any failure exits nonzero:

1. Device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. Build: every CUDA kernel from `zerovox_tpu_torch/csrc/`, with ptxas's
   register and spill report of each entry function.
3. Kernels at their paths' shapes, each against its plain PyTorch version on
   the card, timed with CUDA events beside the plain version and the card's
   bound for the kernel's method (3xTF32 tensor cores for all four): K1 and
   K2 at the serving path's (bucket 689 of bench.py's text) and at one
   streamed window's shapes, with the tile each takes (max abs diff <
   5e-4); K3 at phase 8's three vocoder stage shapes, with its tile (<
   5e-4); K1 and K3 at the narrow widths C = 16 and 8 and K2 at (16, 8)
   with conv_post (phase 16's shapes, < 5e-4); K4 forward and backward (`se_conv`) at the
   training path's [24, 32, 80, 500] (y and dx < 5e-4 absolute, every reduction
   < 1e-4 x the plain result's max |value|), with F.conv2d alone beside them;
   and K4's bf16 forward and backward on those inputs in bf16 (y and dx
   within 2^-8 x the plain result's max, the float32 sums and gradients
   within 1e-3 x theirs), with F.conv2d in bf16 beside them. Beside each
   K1, K2 and K3 row its bf16 variant (bf16 inference) on the same inputs
   rounded to bf16, within one bf16 step of the largest output of its plain
   version, timed beside the plain version and the float32 kernel: the bf16
   K1, K2 and K3 (bf16 tensor cores, two terms an activation) with at most
   1 % of the outputs differing from the plain version's rounding, against
   two bf16 products a product (their former two TF32 products beside it).
4. The serving path at full width (default ZeroVoxConfig + HiFi-GAN, random
   weights from seed 0): speaker_embed -> tts_ex -> tts_stream, with the
   kernels' launch counts read around that run; then RTF and first-chunk
   latency by bench.py's method.
5. The same weights on the CPU (plain versions) on a short text: the card's
   waveform must match within 1e-3.
6. The training path at full width (ZeroVoxConfig with packed_speaker=1,
   fused_speaker=True, random weights from seed 0): a synthetic corpus of 48
   utterances, SpeechDataModule at batch 24, Trainer.fit for 6 steps with the
   launch counts read around it (6 + 6 K4 launches a step) and finite losses;
   then the step's device time with and without the fused stage 1, in turns.
7. One train step at reduced depth (one FFT layer each side, dropout 0) on
   the card and on the CPU from the same weights and batch: losses within
   1e-4 relative, every gradient within 1e-3 x its tensor's max |value|.
8. The StyleTTS-decoder path at full width (ZeroVoxConfig with the StyleTTS
   decoder, a single-tower HiFi-GAN at V1's widths, random weights from seed
   0): speaker_embed -> tts_ex (3 K3 launches) -> tts_stream -> tts_batch at
   B=4 with forced durations (K3 only if the engine's VOCODER_ALL_BATCHES),
   with the launch counts read around that run; RTF, first-chunk p50 and
   stage times; then the card against the CPU on a short text and on one
   tts_batch of 2 rows (1e-3).
9. The default engine's tts_batch at B=4 (2 K2 launches; K1 only if
   VOCODER_ALL_BATCHES); then the batch rule: K1 (stage 1 of the default
   vocoder) and K3 (stages 1-3 of the single-tower one) at B=4 and B=8
   against their plain stages, timed in turns, and whether each kernel wins
   at both sizes beside the engine's setting.
10. Serving: the main-path engine at full width (seed 0, the five bundled
   voices, warmup at batch 1, 4 and 8) behind make_server (max batch 8,
   20 ms window) over localhost HTTP, by scripts/bench_http.py's method:
   15 lone POST /tts against the direct tts, 15 streams' first audio byte
   against the direct tts_stream's first chunk (p50s), 5 rounds of 8
   concurrent POSTs (BATCH_TEXTS x 2 voices; requests/s, batches a round).
   Every HTTP row within one int16 step + 1e-3 of a direct tts_batch of its
   window; a stream within one int16 step of tts_stream_text; K1 and K2
   launched by the dispatch thread; /health without errors.
11. The vocoder's gradients on the card: Generator(use_pallas=True) under
   grad raises (no kernel launched); Generator(use_pallas=False) at V1's
   widths cut to two stages gives the mel's and every parameter's gradient
   within 1e-3 x its tensor's max of the CPU's (TF32 off).
12. Checkpoints on the training config cut to one FFT layer a side (K4 on):
   Trainer.fit for 2 epochs of 2 steps writes checkpoints/0000 and
   0001.msgpack with their .json; the file read back equals the trained
   weights bitwise; restore_train_state + one step gives the uninterrupted
   run's losses (1e-5 relative); an engine on the checkpoint through
   ZeroVoxTTS.from_checkpoint synthesizes the main-path text on the card
   within 1e-3 of the CPU.
13. The demo CLI (`python3 -m zerovox_tpu_torch.cli.demo --random-model`)
   in its own process: exit 0 and a WAV of the length it prints.
14. The training CLI (`zerovox_tpu_torch.cli.train.run`, what `main` runs
   after reading its YAML) at tts_medium full width, batch 24, bf16-mixed
   with the fused stage 1 (bf16 K4, 6 + 6 launches a step, no float32 one),
   bf16 second moments, the device corpus cache, a run name, pruning, a
   profile of 2 steps (its device split printed), then --resume; the
   bf16-mixed step beside the float32 step of phase 6's configuration from
   the same weights (epoch 0's losses within 5e-2 relative; device time in
   turns).
15. bf16 inference (`precision="bf16"`) on the main path (bucket 689) and on
   the StyleTTS path with the single-tower vocoder, random weights from seed
   0, bench.py's text with forced durations: speaker_embed -> tts_ex ->
   tts_stream -> tts_batch at B=4 with the launch counts read around it
   (the bf16 K1 once and K2 twice a tts_ex, the bf16 K3 three times on the
   StyleTTS path; no float32 kernel); float32 waveforms within
   min(5e-2, 5e-2 x peak) of the card's float32 engine and, on a short
   text, of a CPU bf16 run (the StyleTTS path: within half the peak, its
   decoder amplifying bf16 rounding as the JAX package's does); on the
   short text, the engine's stages card against CPU, each on the card's
   input, the vocoder within min(5e-2, 5e-2 x peak); streamed chunks within
   four bf16 steps of the full render's peak, with what a window changes
   (cuDNN's convolutions, reported; the bf16 kernel, bitwise none);
   RTF, first-chunk p50, stage times and tts_batch
   at B=4 of the bf16 and float32 engines in turns; the bf16 K1 at B=4
   against its plain stage in turns; a fused-speaker model's speaker_embed
   through the bf16 K4; one POST /tts to a bf16 engine, its row within one
   int16 step + 1e-3 of the direct tts_batch.

16. Narrow vocoders on the main path: the default acoustic model at full
   width with HiFi-GAN V2 (128 initial channels: K1 at C = 64 and 32, K2 at
   (32, 16) and at (16, 8) with conv_post), then with a 256-channel
   single-tower vocoder (K3 at C = 128, 64, 32, 16), random weights from seed
   0, bench.py's text with forced durations (bucket 689): speaker_embed ->
   tts_ex -> tts_stream with each kernel's launches by width read around it
   (each width once a tts_ex and once a streamed window, no other kernel);
   the engine's vocoder within 1e-3 of the same weights' nn.Modules on the
   card, the engine within 1e-3 of the CPU on the short text; RTF and
   first-chunk p50; the same engine in bf16 launching only the bf16
   kernels at the same widths, its waveform within min(5e-2, 5e-2 x peak)
   of the float32 engine's (phase 15's main-path bound); then HiFi-GAN V3
   (jik876/hifi-gan `config_v3.json`: ResBlock2 towers, rates 8,8,4, 256
   initial channels), which no kernel fuses: no launch of K1-K5 in either
   precision, the same checks, its streaming halo printed (27 frames by
   ResBlock1's formula, an over-estimate for ResBlock2). Phase 3's narrow-width rows (`@` and the
   width in their names: K1 and K3 at [1, 88192, 16] and [1, 176384, 8], K2
   at (16, 8) with conv_post on [1, 88192, 16]) take their launches from
   this phase (K1 and K2 from V2, K3 from the single tower).
17. Vocoder GAN training: a synthetic preprocess dir of 48 one-second
   harmonic-plus-noise items (mels by the port's MelFrontend) in build/;
   `cli.train_vocoder.main` at its defaults (HiFi-GAN V1, MPD 2,3,5,7,11,
   MSD x 3, batch 16, 32-frame segments, float32, device cache, fused) for 2
   epochs of 3 steps with a checkpoint each, no fused kernel launched,
   finite losses; `--checkpoint` of epoch 0 gives epoch 1's losses within
   1e-5 relative; the first split round within 1e-5 of the fused one (both
   with cuDNN's deterministic algorithms); bf16-mixed for 3 steps, finite,
   its first loss within 5e-2 of float32's; the step's device time in
   float32 and bf16-mixed in turns and `--bench`'s rows; one round at small
   widths (32 initial channels, MPD 2,3, MSD x 2) card against a float64
   CPU run (losses 1e-4 relative, gradients 1e-3 x each tensor's max); PQMF (1e-5 of the max)
   and Griffin-Lim at 2 rounds (1e-4) card against CPU, 32 rounds timed; the
   trained `generator.msgpack` as the vocoder of a ZeroVoxTTS through
   `from_checkpoint(meldec_model=...)`: its tts_ex launches K1 once and K2
   twice and stays within 1e-3 of the same generator's nn.Modules.
   `--profile` adds the device's busy share over two GAN steps.
18. Preprocessing and the tools: the native CTC library built with g++ (its
   path printed); a tone-speak corpus of 32 utterances (`make_corpus`,
   22050 Hz, seed 0) in build/; `cli.preprocess.run` with tts_medium's
   audio and model limits and `--aligner tone` on the card, then with
   `--device cpu` and on the card again (its set-up paid): train.txt,
   labels, durations, startstop and pitch equal, mels within 1e-4 (float64
   STFT, TF32 off), energies and stats.json's
   within 1e-5 relative; the durations within 3 hops of the synthesizer's
   on average; the tone CTC emissions card against CPU within 1e-4;
   `forced_align_torch` on the card gives the native Viterbi's tokens on
   every utterance; `cli.stats.run`; Trainer.fit for 2 steps at batch 8 on
   phase 6's configuration over the corpus (6 + 6 K4 launches a step,
   finite losses); `export_items` with that checkpoint's engine
   (`from_checkpoint`, HiFi-GAN V1 from seed 12) at batch 8, K1 once and
   K2 twice a batch, two items against a CPU engine's `export_batch` of
   the same rows (1e-3); `edit_meldec` add then remove gives back the
   checkpoint's bytes, `dump_ckpt` lists the converter's names; utterances/s
   and per-stage ms of preprocessing on the card and on the CPU, and the
   export's items/s.
19. Data parallelism on the one card, the serving mesh, the JAX vocoder
   resume and the kernel build cache, with cuDNN's deterministic
   algorithms: (a) phase 6's configuration (tts_medium, packed_speaker=1,
   fused_speaker=True, batch 24 of a synthetic corpus) through a world-1
   NCCL process group formed through a file store: 2 steps in float32 and 2
   in bf16-mixed, each against the same trainer's steps without a group and
   that run against itself (losses and every gradient bitwise, or within
   1e-6 relative where the ungrouped run differs from itself), 6 + 6 K4
   launches a grouped step (bf16 K4 in bf16-mixed), the step's ms without
   and with the group in turns; and two ungrouped runs with the trainers'
   default algorithms (atomics allowed), each step's largest gradient and
   weight gaps printed by leaf; (b) tts_batch at B=4 through a one-device
   serving mesh, bitwise the engine without one, K2 twice and K1 once (as
   phase 9), both timed in turns; (c) the vocoder trainer (V1's rates at 32
   initial channels, MPD 2,3, MSD x 2, batch 4) after one round, written as
   the JAX trainer's vocoder-0000.msgpack (`save_jax_state`) and as the
   port's .pt, each restored and run one more round: losses and weights
   bitwise; (d) two child processes building and loading the kernels with
   ZEROVOX_COMPILE_CACHE on one fresh directory: a miss with build seconds
   for each library (`len(_cuda.SIGNATURES)`, five), then as many hits with
   saved seconds, both `format_cache_stats()`
   lines printed. `--profile` adds (a)'s and (b)'s device splits.
20. Tensor parallelism on the one card: two gloo ranks on cuda:0 (NCCL
   refuses two ranks on one device; the library's default stays NCCL)
   spawned by `parallel.mesh.spawn(..., backend="gloo",
   mesh=MeshConfig(data=1, model=2))`, phase 6's configuration and batch, 2
   steps in float32 and 2 in bf16-mixed: (a) under deterministic
   algorithms, the 1 x 2 step's losses, running statistics and its
   gradients and weights gathered whole against one process's data-only
   step from the same state (restored from the 1 x 2 run's
   `save_train_state` before each step), and against that step with the
   model axis's arithmetic emulated in one process (`split_emulation`:
   each split layer's blocks summed in the ranks' order): float32 within phase 19's
   1e-6 of the emulation, and of the data-only step within the larger of
   1e-6 and twice the emulation's own gap (what the reassociation
   measures); the weights over the elements whose gradients were above
   1e-6 of the largest (below, Adam's first step takes the sign of
   rounding); bf16-mixed within the CPU test's bf16 bounds (losses and
   running statistics 5e-2, each gradient group within 1.5 x the bf16
   step's own distance from float32); (b) under the trainers' default
   algorithms, every replicated parameter bitwise equal on both ranks
   after each step; (c) 6 + 6 K4 launches a step on each rank (the bf16 K4
   in bf16-mixed); (d) each rank's parameter elements equal to its rule's
   count, printed with each rank's peak memory and the 1 x 2 step's ms in
   turns with the one-process step (two ranks share the card: no speed
   result).

21. Flash attention (K5, `ZEROVOX_ATTN=flash`; phases 1-20 run with it unset
   and launch no K5): K5's forward at the serving decoder's [1, 2, 1024,
   264], the training decoder's [24, 2, 512, 264] and the serving
   encoder's [1, 2, 256, 264], and its backward
   (dK/dV, dQ, both) at the training shape, float32 and bf16, on views of
   [B, L, h, d] tensors with per-row valid lengths from seed 21, each
   against its plain version (float32 within 5e-4; bf16 within one bf16
   step of the largest output forward and two backward, the bf16 backward
   also within two of the float32 kernel's on the widened inputs), timed
   beside it and beside scaled_dot_product_attention on the boolean segment
   mask, with the forward's query tile, key groups, registers and spill
   bytes, and the bf16 backward kernels' registers and spill bytes
   (the whole backward's rows name SDPA's
   backend and its gradients' distance from plain); the main-path engine at full width on
   bench.py's text twice (204 phones, text bucket 256) at 5 frames a phone
   (mel bucket 1024): tts_ex under flash launches K5's forward 10 times (4
   encoder, 6 decoder layers), its waveform within 1e-3 of the same engine
   on the einsum path and of a CPU run of the port under flash, the bf16
   engine under flash (10 bf16 K5 launches) within phase 15's bound of the
   card's float32, tts_stream and tts_batch at B = 2 under flash within
   1e-3 of the einsum path's, 10 launches each, RTF and the encode and
   decode stages' device ms flash against einsum in turns; phase 6's training configuration and corpus
   (batch 24, mel bucket 512, text bucket 128) from the same weights and
   batch under flash and einsum: float32 losses within 1e-4 relative and
   gradients within 1e-3 x each tensor's max (the speaker encoder's, on
   batch statistics, in aggregate as phase 7), bf16-mixed losses within
   5e-2 of float32 and gradients no further from float32's than 1.5 x the
   einsum bf16-mixed step's, 6 + 6 + 6 K5 launches a step (forward, dK/dV,
   dQ; bf16 ones in bf16-mixed) and none on einsum, 12 + 6 + 6 with remat;
   train_step's device ms and peak memory flash against einsum in turns,
   both precisions. `--only 21` runs it after phases 1-2.
22. The JAX package's lane-aligned `configs/tts_medium_tpu.yaml` (written in
   code, `tts_medium_tpu()`: punct_emb_dim 0, d_model 512, two heads of
   256), random weights from seed 0: K5's rows of phase 21 at d = 256 ([1, 2,
   1024, 256], [24, 2, 512, 256] and [1, 2, 256, 256] forward, the backward
   at the training shape; names ending in `_d256`, the same bounds); (a)
   the engine with the default vocoder on bench.py's text (bucket 689):
   phase 16's checks (K1 once and K2 twice a tts_ex and a streamed window,
   no other kernel, a [1, 1, 512] speaker embedding, the stream within
   1e-4, the vocoder against its nn.Modules and the engine against the CPU
   within 1e-3, RTF, first chunk, bf16 within phase 15's bound); (b) its
   encode, decode and vocode device ms, RTF, first-chunk p50 and tts_batch
   at B=4 in turns with phase 4's tts_medium engine; (c) phase 21's flash
   serving on this model (10 K5 forward launches a tts_ex in float32 and in
   bf16, against einsum, the CPU and float32); (d) its float32 train_step
   at batch 24, mel bucket 512 with the fused stage 1 (6 + 6 K4 launches a
   step, finite losses), device ms and peak memory in turns with phase 6's
   tts_medium step, phase 7's one step card against CPU, and phase 21's
   flash training on this model (6 + 6 + 6 K5 launches a step at [24, 2,
   512, 256], float32 and bf16-mixed; flash against einsum timed in float32
   only). `--only 22` runs it after phases 1-2.
23. Every head dim (`ZEROVOX_ATTN=flash`): tts_medium (`ZeroVoxConfig()`)
   with 4 heads in the encoder and the decoder (d = 528 / 4 = 132, which
   `flash_attention` zero-pads to 136 onto the tuned kernels) and with 1
   head (d = 528: the cluster kernels, float32 on clusters of two blocks
   each owning 264 columns; bf16's forward likewise, its backward on
   clusters of three owning 176), random weights from
   seed 0 at full width and depth: (a) K5's rows of phase 21 at [1, h,
   1024, d], [24, h, 512, d] and [1, h, 256, d] (names ending `_d132`,
   `_d528`; inputs and valid lengths from seed 23; at d = 132 each timed
   call pads and slices as the model does), phase 21's bounds, the bound's
   FLOP at d itself, the cluster's ranks and parts (the backward's apart)
   or the wide kernels' recompute beside it, registers and spills, SDPA's
   time and backend or its refusal, each bf16 cluster row also held to the
   float32 kernel on the widened inputs (one bf16 step forward, two
   backward); then the kernels of d above 272 alone at [1, 1, 256, 280]
   (clusters of two), [1, 1, 256, 1040] (of four; the bf16 backward of
   six) and [1, 1, 256, 2184] (above both dtypes' reach: the wide
   kernels), forward
   and backward (`_alone_d280`, `_alone_d1040`, `_alone_d2184`); (b) phase
   21's flash tts_ex on each config (10 K5 forward launches, float32 and
   bf16; within 1e-3 of einsum and of the CPU, bf16 within phase 15's
   bound); (c) phase 21's flash training on each config (6 + 6 + 6 K5
   launches a step, 12 + 6 + 6 with remat; float32 and bf16-mixed against
   einsum; device ms and peak memory in turns in float32, and at d = 528
   in bf16-mixed too). `--only 23` runs it after phases 1-2.

The last three lines are the card's name and power limit, a JSON object
{"kernels": [...]}, and {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}.
"""

from __future__ import annotations

import contextlib
import http.client
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build"  # gitignored: the kernels' libraries and the synthetic corpus

# bench.py's text and forced duration: 102 phones x 6 frames = 612 frames, mel bucket 689
TEXT = ("The quick brown fox jumps over the lazy dog while the curious cat "
        "watches from a sunny windowsill in the early morning light.")
FRAMES_PER_PHONE = 6
SHORT_TEXT = "Hello world."  # text bucket 16, mel bucket 96 (the CPU cross-check)
# tts_batch's rows: texts of different lengths, one speaker each
BATCH_TEXTS = (TEXT, SHORT_TEXT, "A third sentence, of middling length, for the batch.",
               "And the fourth one.")

KERNEL_TOL = 5e-4  # fused kernel against its unfused version
WAV_TOL = 1e-3  # waveform against the float32 CPU run
STREAM_TOL = 1e-4  # streamed chunks against the full render on the card
# stage 1 of the speaker encoder in training: batch 24 (cli/train.py's default)
# x 32 channels over the 80-mel x 500-frame reference crop (training/data.py)
SE_SHAPE = (24, 32, 80, 500)
RED_TOL = 1e-4  # a kernel's reductions, relative to the plain result's max |value|
TRAIN_BATCH, TRAIN_UTTS, TRAIN_EPOCHS = 24, 48, 3  # 2 steps an epoch
STEP_LOSS_RTOL = 1e-4  # a train step's losses on the card against the CPU
STEP_GRAD_TOL = 1e-3  # its gradients, relative to each tensor's max |value|
SPK_BATCH_STATS_TOL = 2e-2  # see train_cross_check: ~6x the CPU float32 run's own distance
STATS = {"pitch_min": 50.0, "pitch_max": 400.0, "energy_min": 0.1, "energy_max": 50.0}
# H100 SXM data sheet: float32 outside the tensor cores, dense TF32 on the
# tensor cores, and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16_ULP = 2.0 ** -8  # bf16 K4's y and dx, relative to the plain result's max |value|
BF16X2_SHARE = 0.01  # bf16 K1-K3: outputs off plain's rounding (emulated ~0.2 %, one term ~37 %)
BF16_RED_TOL = 1e-3  # bf16 K4's float32 sums and gradients, likewise
MIXED_LOSS_RTOL = 5e-2  # bf16-mixed epoch-0 loss against float32's (docs/PERFORMANCE.md:130-133)
BF16_WAV_TOL = 5e-2  # bf16 inference's waveform (docs/PERFORMANCE.md:130-133)
BF16_WAV_REL = 5e-2  # ... and 5e-2 of its peak (these random-weight waveforms are quiet)
STYLETTS_BF16_REL = 0.5  # the StyleTTS path's whole engine: half the peak (see bf16_path)
BF16_STREAM_STEPS = 4  # bf16 stream against the full render: bf16 steps of the peak
CHUNK_FRAMES = 96  # tts_stream's default chunk; a window adds the receptive-field halo each side
# serving: bench_http.py's 15 runs of each lone measure, rounds of 8 concurrent clients
SERVE_ITERS, SERVE_ROUNDS, SERVE_BATCH = 15, 5, 8
WAV_HEADER_BYTES = 44  # the streaming WAV header before the first PCM byte
RESUME_RTOL = 1e-5  # a resumed step's losses against the uninterrupted run's
# vocoder GAN training: the CLI's batch, 2 epochs of 3 steps over 1-second items
GAN_BATCH, GAN_ITEMS, GAN_SECONDS = 16, 48, 1.0
# preprocessing (phase 18): a tone-speak corpus, the CLI's alignment batch, the export's batch
PP_UTTS, PP_BATCH, EXPORT_BATCH = 32, 4, 8
PP_WORDS = ("the quick brown fox jumps over a lazy dog while curious cats watch from sunny "
            "windows in early morning light zebras hum quietly beside vivid jade boxes").split()
ALIGN_MAE_HOPS = 3.0  # tone-aligned durations against the synthesizer's (tests/test_aligner.py)
PP_EMIT_TOL, PP_MEL_TOL, PP_ENERGY_RTOL = 1e-4, 1e-4, 1e-5  # card against CPU
# data parallel (phase 19): steps a precision; the grouped step against the
# ungrouped one where the bits differ (relative to a loss, or to the model's
# largest gradient)
DP_STEPS, DP_REL_TOL, DP_TIME_ROUNDS = 2, 1e-6, 3
# tensor parallel (phase 20): steps a precision in each comparison
TP_STEPS = 2
# flash attention (phase 21): tts_medium's head dim 528 / 2 at the serving
# decoder's mel bucket 1024 and the training decoder's batch 24 x bucket 512;
# bench.py's text twice (204 phones, text bucket 256) at 5 frames a phone
FLASH_SERVE_SHAPE = (1, 2, 1024, 264)
FLASH_TRAIN_SHAPE = (24, 2, 512, 264)
FLASH_ENC_SHAPE = (1, 2, 256, 264)  # the serving encoder's at text bucket 256
FLASH_REPEAT, FLASH_FRAMES = 2, 5
K5_SHAPES = (("", FLASH_SERVE_SHAPE), ("_train", FLASH_TRAIN_SHAPE), ("_enc", FLASH_ENC_SHAPE))
# phase 22: tts_medium_tpu's head dim 512 / 2 at the same lengths; rows named *_d256
K5_D256_SHAPES = tuple((label, shape[:3] + (256,)) for label, shape in K5_SHAPES)
# phase 23: tts_medium at 4 heads (d = 132: padded to 136) and 1 head (d =
# 528: clusters of two blocks, the bf16 backward's of three), rows named
# *_d132, *_d528; the kernels of d above 272 alone at the first head dim
# above the tuned ones (clusters of two), above 1024 (clusters of four, the
# bf16 backward's of six) and above the clusters' reach of 2112 (float32)
# and 1408 (bf16): the wide kernels
K5_HEAD_CONFIGS = ((4, 132), (1, 528))
K5_ALONE_SHAPES = ((1, 1, 256, 280), (1, 1, 256, 1040), (1, 1, 256, 2184))
# the default vocoder's kernels a tts_ex by width: K1 at stage 1, K2 at stages 2 and 3
MAIN_WIDTHS = {"fused_mrf": {128: 1}, "fused_upsample_stage": {"128x64": 1, "64x32": 1}}
K5_SOURCE = "zerovox_tpu_torch/csrc/flash_attn.cu"
_K5_LIB = "jax/experimental/pallas/ops/tpu/flash_attention.py"
K5_REPLACES = {"fwd": f"zerovox_tpu/models/fs2.py:113 -> {_K5_LIB}:758",
               "dkv": f"zerovox_tpu/models/fs2.py:113 -> {_K5_LIB}:1121",
               "dq": f"zerovox_tpu/models/fs2.py:113 -> {_K5_LIB}:1456",
               "bwd": f"zerovox_tpu/models/fs2.py:113 -> {_K5_LIB}:1121, :1456"}


class PhaseFailed(SystemExit):
    """A failed check: exits 1 unless a repeated run (--repeat) records it."""

    def __init__(self, msg: str):
        super().__init__(1)
        self.msg = msg


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise PhaseFailed(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(flop: float, nbytes: float, method: str = "f32") -> tuple[float, str]:
    """(least milliseconds the card could take, what bounds it) for a kernel
    whose products run as `method`: "f32", float32 FMA on the CUDA cores
    (flop at 67 TFLOP/s), "3xtf32", three TF32 tensor-core products per
    product (3 x flop at 495 TFLOP/s), "2xtf32", two (the bf16 K1-K3 before
    their redesign, whose weights' lo halves were zero: 2 x flop at 495
    TFLOP/s), "bf16x2", two bf16 tensor-core products (the bf16 K1-K3, two
    terms an activation: 2 x flop at 989 TFLOP/s), or "bf16", one (flop at
    989 TFLOP/s)."""
    t_ops = {"3xtf32": 3 * flop / PEAK_TF32_FLOPS, "2xtf32": 2 * flop / PEAK_TF32_FLOPS,
             "bf16x2": 2 * flop / PEAK_BF16_FLOPS,
             "bf16": flop / PEAK_BF16_FLOPS}.get(method, flop / PEAK_F32_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def mrf_work(T: int, C: int, kernel_sizes, n_pairs: int) -> tuple[float, float]:
    """(FLOP, bytes of weights) of one MRF stage over T rows: each tower runs
    n_pairs x 2 convs of k taps, 2 k C^2 FLOP a row each."""
    flop = 4.0 * n_pairs * sum(kernel_sizes) * C * C * T
    weights = 4.0 * sum(2 * n_pairs * (k * C * C + C) for k in kernel_sizes)
    return flop, weights


def halo_recompute(tile: int, kernel_sizes, dils, post_halo: int = 0) -> float:
    """Rows the MRF convs of one tile compute, weighted by k, over the tile's
    rows: each conv computes the tile, conv_post's halo and the rows the
    tower's later convs still need (csrc/mrf_tc.cuh, mrf_tile)."""
    done = kept = 0
    for k in kernel_sizes:
        h = (k - 1) // 2
        ext = sum(h * d + h for d in dils)
        for d in dils:
            for e in (ext - h * d, ext - h * d - h):
                done += k * (tile + 2 * post_halo + 2 * e)
                kept += k * tile
            ext -= h * d + h
    return done / kept


def random_towers(torch, gen, C, kernel_sizes, n_pairs, dev):
    def w(*shape, fan_in):
        return (torch.randn(*shape, generator=gen) / fan_in ** 0.5).to(dev)

    return [(w(n_pairs, k, C, C, fan_in=k * C), w(n_pairs, C, fan_in=4),
             w(n_pairs, k, C, C, fan_in=k * C), w(n_pairs, C, fan_in=4)) for k in kernel_sizes]


def measure(torch, rows, name, source, replaces, shape, fn, plain, flop, nbytes, method="f32",
            library=None, **extra) -> None:
    """A kernel against its plain version on the same inputs (max abs diff
    < KERNEL_TOL), then both timed with CUDA events; appends its row, with
    the bound of its method (and the float32 bound beside a tensor-core one)
    and the time of `library`, a PyTorch call computing the same function,
    where one is given."""
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    got = fn()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != plain {tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = (got - ref).abs().max().item()
    check(err < KERNEL_TOL, f"{name}: max abs diff {err} against the plain version")
    ms, plain_ms = cuda_time_ms(fn, iters=10, warmup=2), cuda_time_ms(plain, iters=5, warmup=1)
    bound_ms, bound_by = bound(flop, nbytes, method)
    row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "gflop": flop / 1e9, "method": method, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None if library is None else cuda_time_ms(library, iters=5, warmup=1),
           **extra}
    if method != "f32":
        row["bound_f32_ms"] = bound(flop, nbytes)[0]
    print(json.dumps(row), flush=True)
    rows.append(row)


def bf16_step(t) -> float:
    """One bf16 step at the largest magnitude of t (a tensor)."""
    m = t.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def measure_bf16(torch, rows, name, source, replaces, shape, fn, f32_fn, plain, flop, nbytes,
                 method="bf16x2", max_share=BF16X2_SHARE, steps=1, library=None, f32_ref=None,
                 **extra) -> None:
    """A bf16 variant of K1-K3 (bf16 inference: bf16 tensor-core products,
    two terms an activation) against its plain version (float32 on the
    widened inputs, rounded once): within one bf16 step of its largest
    output, with at most BF16X2_SHARE of the outputs differing from plain's
    rounding. Timed beside the plain version and the float32 kernel on the
    widened inputs (f32_fn). Bound: two bf16 products a product ("bf16x2"),
    the former two TF32 products beside it; bytes at bf16 widths. K5 in bf16
    passes method "bf16" (one bf16 product a product), its own number of
    `steps` and no share (max_share None: the share is printed), and the
    PyTorch call it is held beside (`library`, timed as library_ms); with
    `f32_ref` (fn's output from the float32 kernel on the widened inputs)
    it is held to that too, within `steps` bf16 steps of its largest
    value."""
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    got = fn()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    check(got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape,
          f"{name}: {got.dtype} {tuple(got.shape)} against plain {ref.dtype} {tuple(ref.shape)}")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    share = (got != ref).float().mean().item()
    if max_share is not None:
        check(share <= max_share, f"{name}: {share:.4%} of outputs differ from plain's rounding "
                                  f"(at most {max_share:.0%})")
    err, step = (got.float() - ref.float()).abs().max().item(), bf16_step(ref)
    check(err <= steps * step,
          f"{name}: max abs diff {err} against the plain version, {steps} step(s) of {step}")
    if f32_ref is not None:
        r32 = f32_ref()
        err32, step32 = (got.float() - r32).abs().max().item(), bf16_step(r32)
        check(err32 <= steps * step32, f"{name}: max abs diff {err32} against the float32 "
                                       f"kernel, {steps} step(s) of {step32}")
        extra = {**extra, "f32_kernel_max_abs_err": err32}
        del r32
    del got, ref
    ms, plain_ms = cuda_time_ms(fn, iters=10, warmup=2), cuda_time_ms(plain, iters=5, warmup=1)
    f32_ms = cuda_time_ms(f32_fn, iters=10, warmup=2)
    bound_ms, bound_by = bound(flop, nbytes, method)
    row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "shape": shape, "max_abs_err": err, "bf16_step": step, "share_off_plain": share,
           "ms": ms, "plain_ms": plain_ms, "f32_kernel_ms": f32_ms, "gflop": flop / 1e9,
           "method": method, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None if library is None else cuda_time_ms(library, iters=5, warmup=1),
           **extra}
    if method == "bf16x2":
        row["bound_2xtf32_ms"] = bound(flop, nbytes, "2xtf32")[0]
    print(json.dumps(row), flush=True)
    rows.append(row)


def _bf(towers):
    return [tuple(t.bfloat16() for t in tw) for tw in towers]


def k1_rows(torch, rows, gen, dev, T: int, C: int, ks, dils, suffix: str = "") -> None:
    """K1 over [1, T, C] against plain, float32 and bf16 (row names carry
    `suffix`)."""
    from zerovox_tpu_torch.ops import _cuda
    from zerovox_tpu_torch.ops.mrf import fused_mrf, mrf_plain, pack_towers, tower_args, widen

    P = len(dils)
    x1 = torch.randn(1, T, C, generator=gen).to(dev)
    tw1 = random_towers(torch, gen, C, ks, P, dev)
    mrf1 = pack_towers(tw1)
    targs = tower_args(tw1, dils, ks)
    flop, wbytes = mrf_work(T, C, ks, P)
    tile = _cuda.lib("mrf").zv_mrf_tile(1, T, C, *targs)
    measure(torch, rows, "fused_mrf" + suffix, "zerovox_tpu_torch/csrc/mrf.cu",
            "zerovox_tpu/ops/pallas/mrf.py:93", f"[1,{T},{C}]",
            lambda: fused_mrf(x1, mrf1, dils, ks), lambda: mrf_plain(x1, tw1, dils),
            flop, wbytes + 8.0 * T * C, "3xtf32", tile_rows=tile,
            recompute=halo_recompute(tile, ks, dils))
    xb, twb = x1.bfloat16(), _bf(tw1)
    xw, mrfb, mrfw = xb.float(), pack_towers(twb), pack_towers(widen(twb))
    measure_bf16(torch, rows, "fused_mrf_bf16" + suffix, "zerovox_tpu_torch/csrc/mrf.cu",
                 "zerovox_tpu/ops/pallas/mrf.py:93", f"[1,{T},{C}] bf16",
                 lambda: fused_mrf(xb, mrfb, dils, ks),
                 lambda: fused_mrf(xw, mrfw, dils, ks),
                 lambda: mrf_plain(xb, twb, dils), flop, wbytes / 2 + 4.0 * T * C,
                 tile_rows=_cuda.lib("mrf").zv_mrf_bf16_tile(1, T, C, *targs))


def k2_rows(torch, rows, gen, dev, T_in: int, C_in: int, C_out: int, u: int, k: int, last: bool,
            ks, dils, suffix: str = "") -> None:
    """K2 (with conv_post when `last`) over [1, T_in, C_in] against plain,
    float32 and bf16."""
    from zerovox_tpu_torch.ops import _cuda
    from zerovox_tpu_torch.ops.mrf import pack_towers, tower_args, widen
    from zerovox_tpu_torch.ops.upsample_stage import (fused_upsample_stage, pack_upsampler,
                                                       upsample_stage_plain)

    P = len(dils)
    T_out = T_in * u
    x = torch.randn(1, T_in, C_in, generator=gen).to(dev)
    up_w = (torch.randn(k, C_in, C_out, generator=gen) / (k * C_in / u) ** 0.5).to(dev)
    up_b = (torch.randn(C_out, generator=gen) / 2).to(dev)
    up = pack_upsampler(up_w, up_b, u)
    tw = random_towers(torch, gen, C_out, ks, P, dev)
    mrf = pack_towers(tw)
    post = ((torch.randn(7, C_out, 1, generator=gen) / (7 * C_out) ** 0.5).to(dev),
            torch.zeros(1).to(dev)) if last else None
    flop, wbytes = mrf_work(T_out, C_out, ks, P)
    flop += 2.0 * T_out * C_in * C_out * k / u  # k / u taps reach each output row
    wbytes += 4.0 * (k * C_in * C_out + C_out)
    if last:
        flop += 2.0 * 7 * C_out * T_out
        wbytes += 4.0 * (7 * C_out + 1)
    out_elems = T_out * (1 if last else C_out)
    pad = (k - u) // 2
    tile = _cuda.lib("upsample_stage").zv_upsample_stage_tile(
        1, T_in, C_in, C_out, k, u, pad, 7 if last else 0, *tower_args(tw, dils, ks))
    shape = f"[1,{T_in},{C_in}]->" + (f"[1,{T_out}]" if last else f"[1,{T_out},{C_out}]")
    name = "fused_upsample_stage" + ("+post" if last else "")
    measure(torch, rows, name + suffix, "zerovox_tpu_torch/csrc/upsample_stage.cu",
            "zerovox_tpu/ops/pallas/packed.py:249", shape,
            lambda: fused_upsample_stage(x, up, pad, mrf, dils, ks, post=post),
            lambda: upsample_stage_plain(x, up_w, up_b, u, pad, tw, dils, post=post),
            flop, wbytes + 4.0 * (T_in * C_in + out_elems), "3xtf32", tile_rows=tile,
            recompute=halo_recompute(tile, ks, dils, 3 if last else 0))
    xb, twb = x.bfloat16(), _bf(tw)
    xw = xb.float()
    upb = pack_upsampler(up_w.bfloat16(), up_b.bfloat16(), u)
    upw = pack_upsampler(upb.w.float(), upb.b.float(), u)
    mrfb, mrfw = pack_towers(twb), pack_towers(widen(twb))
    postb = tuple(t.bfloat16() for t in post) if last else None
    postw = tuple(t.float() for t in postb) if last else None
    measure_bf16(torch, rows, "fused_upsample_stage_bf16" + ("+post" if last else "") + suffix,
                 "zerovox_tpu_torch/csrc/upsample_stage.cu",
                 "zerovox_tpu/ops/pallas/packed.py:249", shape + " bf16",
                 lambda: fused_upsample_stage(xb, upb, pad, mrfb, dils, ks, post=postb),
                 lambda: fused_upsample_stage(xw, upw, pad, mrfw, dils, ks, post=postw),
                 lambda: upsample_stage_plain(xb, upb.w, upb.b, u, pad, twb, dils,
                                              post=postb),
                 flop, wbytes / 2 + 2.0 * (T_in * C_in + out_elems),
                 tile_rows=_cuda.lib("upsample_stage").zv_upsample_stage_bf16_tile(
                     1, T_in, C_in, C_out, k, u, pad, 7 if last else 0, *tower_args(tw, dils, ks)))


def k3_rows(torch, rows, gen, dev, T: int, C: int, k: int, dils, suffix: str = "") -> None:
    """K3 (one tower) over [1, T, C] against plain, float32 and bf16."""
    from zerovox_tpu_torch.ops import _cuda
    from zerovox_tpu_torch.ops.mrf import pack_towers, widen
    from zerovox_tpu_torch.ops.resblock import fused_resblock1, resblock1_plain

    P = len(dils)
    x = torch.randn(1, T, C, generator=gen).to(dev)
    tower = random_towers(torch, gen, C, (k,), P, dev)[0]
    packed = pack_towers([tower])
    flop, wbytes = mrf_work(T, C, (k,), P)
    tile = _cuda.lib("resblock").zv_resblock1_tile(1, T, C, k, P, *dils, *[0] * (3 - P))
    measure(torch, rows, "fused_resblock1" + suffix, "zerovox_tpu_torch/csrc/resblock.cu",
            "zerovox_tpu/ops/pallas/resblock.py:106", f"[1,{T},{C}]",
            lambda: fused_resblock1(x, *tower, dils, packed=packed),
            lambda: resblock1_plain(x, *tower, dils), flop, wbytes + 8.0 * T * C,
            "3xtf32", tile_rows=tile, recompute=halo_recompute(tile, (k,), dils))
    xb, twb = x.bfloat16(), tuple(t.bfloat16() for t in tower)
    xw, pkb, pkw = xb.float(), pack_towers([twb]), pack_towers(widen([twb]))
    tile = _cuda.lib("resblock").zv_resblock1_bf16_tile(1, T, C, k, P, *dils, *[0] * (3 - P))
    measure_bf16(torch, rows, "fused_resblock1_bf16" + suffix, "zerovox_tpu_torch/csrc/resblock.cu",
                 "zerovox_tpu/ops/pallas/resblock.py:106", f"[1,{T},{C}] bf16",
                 lambda: fused_resblock1(xb, *twb, dils, packed=pkb),
                 lambda: fused_resblock1(xw, *pkw.towers[0], dils, packed=pkw),
                 lambda: resblock1_plain(xb, *twb, dils), flop,
                 wbytes / 2 + 4.0 * T * C, tile_rows=tile)


def kernel_phase(torch, dev, hcfg, mel_frames: int) -> list[dict]:
    """K1 and K2 against their plain versions at the main path's shapes
    (the mel bucket) and at one streamed window's (CHUNK_FRAMES plus the
    receptive-field halo each side), with the tile each kernel takes."""
    ks, dils = tuple(hcfg.resblock_kernel_sizes), tuple(hcfg.resblock_dilation_sizes[0])
    c0, rates, up_ks = hcfg.upsample_initial_channel, hcfg.upsample_rates, hcfg.upsample_kernel_sizes
    gen = torch.Generator().manual_seed(1234)
    rows = []
    window = CHUNK_FRAMES + 2 * hcfg.receptive_field_frames()
    for frames in (mel_frames, window):
        # stage 1 (K1): the MRF at C = c0 / 4 over frames * rates[0] * rates[1] rows
        C1, T1 = c0 // 4, frames * rates[0] * rates[1]
        k1_rows(torch, rows, gen, dev, T1, C1, ks, dils)
        # stages 2 and 3 (K2): upsample stages, the last with conv_post
        T_in, C_in = T1, C1
        for i in (2, 3):
            C_out = c0 // 2 ** (i + 1)
            k2_rows(torch, rows, gen, dev, T_in, C_in, C_out, rates[i], up_ks[i],
                    i == len(rates) - 1, ks, dils)
            T_in, C_in = T_in * rates[i], C_out
    return rows


def resblock_phase(torch, dev, hcfg, mel_frames: int) -> list[dict]:
    """K3 at the StyleTTS path's shapes: one ResBlock1 tower on each stage of
    the single-tower vocoder with C <= 128 (stages 1-3 at V1's widths),
    against its plain version."""
    (k,), (dils,) = hcfg.resblock_kernel_sizes, hcfg.resblock_dilation_sizes
    c0 = hcfg.upsample_initial_channel
    gen = torch.Generator().manual_seed(2345)
    rows = []
    T = mel_frames
    for i, u in enumerate(hcfg.upsample_rates):
        C, T = c0 // 2 ** (i + 1), T * u
        if C <= 128:
            k3_rows(torch, rows, gen, dev, T, C, k, tuple(dils))
    return rows


def narrow_kernel_rows(torch, dev, mel_frames: int) -> list[dict]:
    """The narrow widths (HiFi-GAN V2's last stages, a 256-channel
    single-tower vocoder's last): K1 and K3 at [1, 88192, 16] and
    [1, 176384, 8], and K2 at (16, 8) with conv_post on [1, 88192, 16] ->
    [1, 176384] (V2's last stage), at mel bucket 689, float32 and bf16.
    Row names carry `@` and the width."""
    ks, dils = (3, 7, 11), (1, 3, 5)
    gen = torch.Generator().manual_seed(3456)
    rows: list[dict] = []
    T16 = mel_frames * 8 * 8 * 2
    for C, T in ((16, T16), (8, 2 * T16)):
        k1_rows(torch, rows, gen, dev, T, C, ks, dils, f"@{C}")
        k3_rows(torch, rows, gen, dev, T, C, 3, dils, f"@{C}")
    k2_rows(torch, rows, gen, dev, T16, 16, 8, 2, 4, True, ks, dils, "@16x8")
    return rows


def se_conv_phase(torch, dev) -> list[dict]:
    """K4 forward and backward at the training path's stage-1 shape against
    se_conv_plain (its outputs; autograd's gradients for the backward), with
    F.conv2d alone (forward; dgrad + wgrad) timed beside each."""
    import torch.nn.functional as F
    from zerovox_tpu_torch.ops.se_conv import se_conv_bwd, se_conv_fwd, se_conv_plain
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    B, C, H, W = SE_SHAPE
    gen = torch.Generator().manual_seed(4321)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    x, w = rnd(B, C, H, W), rnd(C, C, 3, 3, scale=(9 * C) ** -0.5)
    s, t = (torch.rand(C, generator=gen) + 0.5).to(dev), rnd(C, scale=0.3)
    cts = (rnd(B, C, H, W), rnd(C), rnd(C), rnd(B, C))
    act_bytes, w_bytes = 4.0 * x.numel(), 4.0 * (w.numel() + 2 * C)
    conv_flop = 2.0 * B * H * W * 9 * C * C

    def compare(name, keys, got, ref) -> tuple[float, float]:
        """(max abs error of the first output, largest relative error of the
        reductions); fails past KERNEL_TOL or RED_TOL."""
        rel = 0.0
        for i, (key, a, b) in enumerate(zip(keys, got, ref)):
            check(a.shape == b.shape, f"{name} {key}: shape {tuple(a.shape)} != {tuple(b.shape)}")
            check(bool(torch.isfinite(a).all()), f"{name} {key}: non-finite")
            err = (a - b).abs().max().item()
            if i == 0:
                first = err
                check(err < KERNEL_TOL, f"{name} {key}: max abs diff {err} against the plain version")
            else:
                scale = max(b.abs().max().item(), 1e-30)
                rel = max(rel, err / scale)
                check(err <= RED_TOL * scale, f"{name} {key}: max abs diff {err}, plain max {scale}")
        return first, rel

    def row(name, replaces, errs, fn, plain, conv, flop, nbytes) -> dict:
        ms, plain_ms = cuda_time_ms(fn, iters=10, warmup=2), cuda_time_ms(plain, iters=5, warmup=1)
        conv_ms = cuda_time_ms(conv, iters=5, warmup=1)
        bound_ms, bound_by = bound(flop, nbytes, "3xtf32")
        r = {"name": name, "route": "cuda", "source": "zerovox_tpu_torch/csrc/se_conv.cu",
             "replaces": replaces, "shape": f"[{B},{C},{H},{W}]", "max_abs_err": errs[0],
             "max_rel_err_reductions": errs[1], "ms": ms, "plain_ms": plain_ms,
             "gflop": flop / 1e9, "method": "3xtf32", "bound_ms": bound_ms, "bound_by": bound_by,
             "bound_f32_ms": bound(flop, nbytes)[0], "library_ms": None, "conv2d_only_ms": conv_ms}
        print(json.dumps(r), flush=True)
        return r

    rows = []
    for relu in (True, False):  # conv1 (relu out) and conv2 passes; timed at conv1's
        got = se_conv_fwd(x, w, s, t, relu)
        torch.cuda.synchronize()
        errs = compare(f"se_conv_fwd(relu={relu})", ("y", "sum", "sq", "m"), got,
                       se_conv_plain(x, w, s, t, relu))
        del got
        if relu:
            rows.append(row("se_conv_fwd", "zerovox_tpu/ops/pallas/se_fused.py:375", errs,
                            lambda: se_conv_fwd(x, w, s, t, True),
                            lambda: se_conv_plain(x, w, s, t, True),
                            lambda: F.conv2d(x, w, padding=1),
                            conv_flop, 2 * act_bytes + w_bytes))
    for relu in (True, False):
        leaves = [a.clone().requires_grad_(True) for a in (x, w, s, t)]
        outs = se_conv_plain(*leaves, relu)
        ref = torch.autograd.grad(outs, leaves, cts, retain_graph=True)
        y = outs[0].detach()  # one y for both, so relu' agrees at y == 0

        def kernel(y=y, relu=relu):
            return se_conv_bwd(x, y, cts[0], w, s, t, cts[1], cts[2], cts[3], relu)

        got = kernel()
        torch.cuda.synchronize()
        errs = compare(f"se_conv_bwd(relu={relu})", ("dx", "dw", "ds", "dt"), got, ref)
        del got, ref
        if relu:
            u = (x * s[:, None, None] + t[:, None, None]).requires_grad_(True)
            wc = w.clone().requires_grad_(True)
            conv_out = F.conv2d(u, wc, padding=1)
            rows.append(row("se_conv_bwd", "zerovox_tpu/ops/pallas/se_fused.py:439", errs, kernel,
                            lambda: torch.autograd.grad(outs, leaves, cts, retain_graph=True),
                            lambda: torch.autograd.grad(conv_out, (u, wc), cts[0],
                                                        retain_graph=True),
                            2 * conv_flop, 4 * act_bytes + 2 * w_bytes))
            del u, wc, conv_out
        del outs, leaves, y
    rows += se_conv_bf16_rows(torch, x, w, s, t, cts, conv_flop)
    return rows


def se_conv_bf16_rows(torch, x, w, s, t, cts, conv_flop) -> list[dict]:
    """The bf16 K4 forward and backward (bf16-mixed training) on the same
    inputs rounded to bf16, against se_conv_plain / se_conv_bwd_plain: y and
    dx within BF16_ULP of the plain result's max, the float32 sums and
    gradients within BF16_RED_TOL of theirs; F.conv2d in bf16 alone beside
    each. Bound: one bf16 tensor-core product a product, against the bytes
    of x and y (forward) or x, y, dy and dx (backward), each once. Each row
    also gives the kernel's design: tile, raw windows staged ahead, blocks
    an SM and shared-memory bytes a block."""
    import torch.nn.functional as F
    from zerovox_tpu_torch.ops import _cuda
    from zerovox_tpu_torch.ops.se_conv import (se_conv_bwd_bf16, se_conv_bwd_plain,
                                               se_conv_fwd_bf16, se_conv_plain)
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    B, C, H, W = SE_SHAPE
    xb, wb, dyb = x.bfloat16(), w.bfloat16(), cts[0].bfloat16()
    act_bytes = 2.0 * xb.numel()
    fixed = 2.0 * wb.numel() + 4.0 * (2 * C)  # w in bf16, s and t (and sums) in float32

    def design(bwd: int) -> dict:
        """The kernel's design as its source sets it (zv_se_conv_bf16_design)."""
        q = [_cuda.lib("se_conv").zv_se_conv_bf16_design(bwd, k) for k in range(5)]
        check(min(q) > 0, f"zv_se_conv_bf16_design({bwd}): {q}")
        return {"tile": f"{q[0]}x{q[1]}", "stages": q[2], "blocks_per_sm": q[3],
                "smem_bytes": q[4]}

    def compare(name, keys, got, ref) -> tuple[float, float]:
        first, rel = 0.0, 0.0
        for i, (key, a, b) in enumerate(zip(keys, got, ref)):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"{name} {key}: {tuple(a.shape)} {a.dtype} != {tuple(b.shape)} {b.dtype}")
            a, b = a.float(), b.float()
            check(bool(torch.isfinite(a).all()), f"{name} {key}: non-finite")
            err, scale = (a - b).abs().max().item(), max(b.abs().max().item(), 1e-30)
            tol = BF16_ULP if i == 0 else BF16_RED_TOL
            check(err <= tol * scale, f"{name} {key}: max abs diff {err}, plain max {scale}")
            if i == 0:
                first = err
            else:
                rel = max(rel, err / scale)
        return first, rel

    def row(name, replaces, errs, fn, plain, conv, flop, nbytes) -> dict:
        ms, plain_ms = cuda_time_ms(fn, iters=10, warmup=2), cuda_time_ms(plain, iters=5, warmup=1)
        conv_ms = cuda_time_ms(conv, iters=5, warmup=1)
        bound_ms, bound_by = bound(flop, nbytes, "bf16")
        r = {"name": name, "route": "cuda", "source": "zerovox_tpu_torch/csrc/se_conv.cu",
             "replaces": replaces, "shape": f"[{B},{C},{H},{W}] bf16", "max_abs_err": errs[0],
             "max_rel_err_reductions": errs[1], "ms": ms, "plain_ms": plain_ms,
             "gflop": flop / 1e9, "method": "bf16", "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": None, "conv2d_only_ms": conv_ms,
             "design": design(int(name.startswith("se_conv_bwd")))}
        print(json.dumps(r), flush=True)
        return r

    rows = []
    for relu in (True, False):
        got = se_conv_fwd_bf16(xb, wb, s, t, relu)
        torch.cuda.synchronize()
        ref = se_conv_plain(xb, wb, s, t, relu)
        errs = compare(f"se_conv_fwd_bf16(relu={relu})", ("y", "sum", "sq", "m"), got, ref)
        if relu:
            rows.append(row("se_conv_fwd_bf16", "zerovox_tpu/ops/pallas/se_fused.py:375", errs,
                            lambda: se_conv_fwd_bf16(xb, wb, s, t, True),
                            lambda: se_conv_plain(xb, wb, s, t, True),
                            lambda: F.conv2d(xb, wb, padding=1),
                            conv_flop, 2 * act_bytes + fixed))
        args = (xb, ref[0], dyb, wb, s, t, *cts[1:], relu)  # plain's y, so relu' agrees
        got_b = se_conv_bwd_bf16(*args)
        torch.cuda.synchronize()
        errs = compare(f"se_conv_bwd_bf16(relu={relu})", ("dx", "dw", "ds", "dt"), got_b,
                       se_conv_bwd_plain(*args))
        if relu:
            u = xb.clone().requires_grad_(True)
            wc = wb.clone().requires_grad_(True)
            conv_out = F.conv2d(u, wc, padding=1)
            rows.append(row("se_conv_bwd_bf16", "zerovox_tpu/ops/pallas/se_fused.py:439", errs,
                            lambda: se_conv_bwd_bf16(*args), lambda: se_conv_bwd_plain(*args),
                            lambda: torch.autograd.grad(conv_out, (u, wc), dyb, retain_graph=True),
                            2 * conv_flop, 4 * act_bytes + fixed))
            del u, wc, conv_out
        del got, ref, got_b
    return rows


def write_corpus(root: Path, name: str, syms, n_mels: int, n_utts: int, phones: tuple[int, int],
                 seed: int) -> None:
    """A synthetic preprocessed corpus under root/name in training/data.py's
    on-disk contract: train.txt, and mel, pitch, energy, duration and
    startstop files per utterance; durations of 2-7 frames a phone."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pp = root / name
    for d in ("mel", "pitch", "energy", "duration"):
        (pp / d).mkdir(parents=True)
    lines = []
    for i in range(n_utts):
        base = f"utt{i:03d}"
        L = int(rng.integers(phones[0], phones[1] + 1))
        durations = rng.integers(2, 8, size=L).astype(np.int64)
        T = int(durations.sum())
        np.save(pp / "mel" / f"mel-{base}.npy", rng.normal(-4.0, 2.0, (T, n_mels)).astype(np.float32))
        np.save(pp / "pitch" / f"pitch-{base}.npy", rng.uniform(60, 390, L).astype(np.float32))
        np.save(pp / "energy" / f"energy-{base}.npy", rng.uniform(0.2, 45, L).astype(np.float32))
        np.save(pp / "duration" / f"duration-{base}.npy", durations)
        (pp / "mel" / f"startstop-{base}.json").write_text(json.dumps({"start_hop": 0, "end_hop": T}))
        ids = ",".join(map(str, rng.integers(1, syms.num_phones, size=L)))
        puncts = ",".join(map(str, rng.integers(0, syms.num_puncts, size=L)))
        lines.append(f"{base}.wav|{ids}|{puncts}|utterance {i}")
    (pp / "train.txt").write_text("\n".join(lines) + "\n")


def train_config(fused: bool, shallow: bool = False, base=None):
    """`base` (default ZeroVoxConfig(), tts_medium) for training, with the
    fused stage 1 or without; `shallow`: one FFT layer each side and every
    dropout rate 0."""
    import dataclasses as dc

    from zerovox_tpu_torch.config import Stats, ZeroVoxConfig

    base = ZeroVoxConfig() if base is None else base
    m = dc.replace(base.model, packed_speaker=int(fused), fused_speaker=fused)
    if shallow:
        m = dc.replace(m, encoder=dc.replace(m.encoder, fs2_layer=1, fs2_dropout=0.0, vp_dropout=0.0),
                       decoder=dc.replace(m.decoder, n_layers=1, dropout=0.0))
    return dc.replace(base, model=m, stats=Stats(**STATS))


def k4_counts():
    n = kernel_counts()
    return n["se_conv_fwd"], n["se_conv_bwd"]


def train_phase(torch, corpus_root: Path) -> dict:
    """Trainer.fit at full width over the synthetic corpus: per-step device
    time, K4 launches and losses; then the step with and without the fused
    stage 1, timed in turns on one batch."""
    import numpy as np

    from zerovox_tpu_torch.training.data import SpeechDataModule
    from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig, device_batch
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    cfg = train_config(fused=True)
    dm = SpeechDataModule([{"path": {"preprocessed_path": "train"}}], cfg.symbols(), STATS,
                          batch_size=TRAIN_BATCH, num_workers=4, seed=0, base_path=str(corpus_root))
    dm.prepare_data()
    tcfg = TrainerConfig(max_epochs=TRAIN_EPOCHS, warmup_epochs=1, log_every_n_steps=2, seed=0,
                         out_folder=str(corpus_root / "model"))
    trainer = Trainer(cfg, tcfg, steps_per_epoch=dm.steps_per_epoch())
    state = trainer.init_state()

    steps = []
    inner = trainer.train_step

    def timed_step(st, batch):
        n0 = k4_counts()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        losses = inner(st, batch)
        b.record()
        n1 = k4_counts()
        steps.append({"events": (a, b), "losses": losses, "k4": (n1[0] - n0[0], n1[1] - n0[1]),
                      "mel_bucket": batch["mel"].shape[1], "ref": tuple(batch["ref_mel"].shape)})
        return losses

    trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(dm.train_dataloader, state)
    torch.cuda.synchronize()
    fit_launches = dict(zip(("se_conv_fwd", "se_conv_bwd"), k4_counts()))
    del trainer.train_step
    out = {"steps": len(steps), "launches": fit_launches, "mel_buckets": [s["mel_bucket"] for s in steps],
           "ref_mel": list(steps[0]["ref"]) if steps else None,
           "k4_per_step": [list(s["k4"]) for s in steps],
           "step_ms": [s["events"][0].elapsed_time(s["events"][1]) for s in steps],
           "losses": [{k: float(v) for k, v in s["losses"].items()} for s in steps],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["median_step_ms"] = float(np.median(out["step_ms"][1:])) if len(steps) > 1 else None

    # the same step without the fused stage 1 (cuDNN convs), from the same weights
    batch = device_batch(next(iter(dm.train_dataloader(0))), "cuda")
    plain = Trainer(train_config(fused=False), tcfg, steps_per_epoch=dm.steps_per_epoch())
    plain_state = plain.init_state(state.model.state_dict())
    times = {"fused": [], "unfused": []}
    for label, tr, st in (("fused", trainer, state), ("unfused", plain, plain_state),
                          ("unfused", plain, plain_state), ("fused", trainer, state)):
        n0 = k4_counts()
        times[label].append(cuda_time_ms(lambda: tr.train_step(st, batch), iters=3, warmup=1))
        n1 = k4_counts()
        expect = 4 * 6 if label == "fused" else 0
        check(n1[0] - n0[0] == expect and n1[1] - n0[1] == expect,
              f"{label} steps launched K4 {n1[0] - n0[0]} + {n1[1] - n0[1]} times, not {expect} each")
    out["turns_ms"] = times
    out["fused_step_ms"] = float(np.mean(times["fused"]))
    out["unfused_step_ms"] = float(np.mean(times["unfused"]))
    out["turn_mel_bucket"] = batch["mel"].shape[1]
    out["model"] = (trainer, state, batch)
    return out


def step_grads(model, batch, spkemb_train: bool) -> tuple[dict, dict]:
    """Forward in train mode + zerovox_loss + backward -> (losses, {name:
    float64 gradient on the host}). `spkemb_train=False` keeps the speaker
    encoder's BatchNorms on their running statistics."""
    from zerovox_tpu_torch.models.zerovox import zerovox_loss

    for p in model.parameters():
        p.grad = None
    losses = zerovox_loss(model(batch, train=True, spkemb_train=spkemb_train), batch)
    losses["loss"].backward()
    return ({k: v.item() for k, v in losses.items()},
            {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()
             if p.grad is not None})


def train_cross_check(torch, dev, corpus_root: Path, base=None) -> dict:
    """One train step at reduced depth (train_config's `base`, default
    tts_medium) from the same weights and 2-utterance batch on the card and
    on the CPU, twice: with the speaker encoder's BatchNorms on batch
    statistics (the step `fit` takes) and on their running statistics.

    Every gradient is held within STEP_GRAD_TOL x its max |value| of the CPU
    run, except the speaker encoder's under batch statistics: there the
    BatchNorm backward (which takes out the gradient's mean and its
    projection on the normalized input) cancels most of the gradient at this
    point (random weights, 2 utterances), and float32 rounding leaves percents
    of a tensor's max on the CPU itself against float64. Those are held in
    aggregate, ||card - cpu64|| / ||cpu64|| over the speaker encoder's
    gradients, against a float64 CPU run, within SPK_BATCH_STATS_TOL; the
    CPU float32 run's own distances (aggregate and worst tensor) are printed
    beside the card's."""
    import numpy as np

    from zerovox_tpu_torch.models.zerovox import ZeroVox
    from zerovox_tpu_torch.training.data import SpeechDataset, collate
    from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig, device_batch

    cfg = train_config(fused=True, shallow=True, base=base)
    ds = SpeechDataset("train.txt", [{"path": {"preprocessed_path": "short"}}], cfg.symbols(),
                       STATS, base_path=str(corpus_root))
    host = collate([ds.load_item(i) for i in range(len(ds))], np.random.default_rng(6))
    check(host[1]["mel"].shape[:2] == (2, 128), f"cross-check batch mel {host[1]['mel'].shape}")
    sd = {k: v.cpu() for k, v in
          Trainer(cfg, TrainerConfig(seed=0), 1, device="cpu").init_state().model.state_dict().items()}
    card_batch, cpu_batch = device_batch(host, dev), device_batch(host, "cpu")
    f64_batch = {k: v.double() if v.is_floating_point() else v for k, v in cpu_batch.items()}

    def model(device, dtype=torch.float32):
        m = ZeroVox(cfg)
        m.load_state_dict(sd)
        return m.to(device=device, dtype=dtype).train()

    def close(name, got, want, floor) -> float:
        scale = max(want.abs().max().item(), floor)
        err = (got - want).abs().max().item() / scale
        check(err <= STEP_GRAD_TOL, f"cross-check {name}: {err} x its max |value|")
        return err

    out = {}
    for spk_train in (True, False):
        n0 = k4_counts()
        l_card, g_card = step_grads(model(dev), card_batch, spk_train)
        n1 = k4_counts()
        check(n1[0] - n0[0] == 6 and n1[1] - n0[1] == 6,
              f"the card's step launched K4 {n1[0] - n0[0]} + {n1[1] - n0[1]} times, not 6 + 6")
        l_cpu, g_cpu = step_grads(model("cpu"), cpu_batch, spk_train)
        check(g_card.keys() == g_cpu.keys(), "cross-check: gradients of other parameters")
        loss_err = {}
        for k, b in l_cpu.items():
            a = l_card[k]
            loss_err[k] = abs(a - b) / max(abs(b), 1e-30)
            check(np.isfinite(a) and loss_err[k] <= STEP_LOSS_RTOL, f"cross-check {k}: card {a}, cpu {b}")
        # a gradient that is exactly zero (the attention key biases: softmax is
        # shift-invariant) is held against 1e-3 x the model's largest instead
        # of its own float noise
        floor = 1e-3 * max(g.abs().max().item() for g in g_cpu.values())
        spk = [n for n in g_cpu if n.startswith("_spkemb.")]
        held = [n for n in g_cpu if not (spk_train and n in spk)]
        res = {"loss": l_cpu["loss"], "loss_rel_err": loss_err, "n_grads": len(g_cpu),
               "worst_grad_rel_err": max(close(n, g_card[n], g_cpu[n], floor) for n in held)}
        if spk_train:
            _, g64 = step_grads(model("cpu", torch.float64), f64_batch, True)

            def l2_err(g):
                return (sum(((g[n] - g64[n]) ** 2).sum().item() for n in spk)
                        / sum((g64[n] ** 2).sum().item() for n in spk)) ** 0.5

            def worst_err(g):
                return max((g[n] - g64[n]).abs().max().item()
                           / max(g64[n].abs().max().item(), floor) for n in spk)

            res["spkemb_l2_rel_err"] = {"card": l2_err(g_card), "cpu_f32": l2_err(g_cpu)}
            res["spkemb_worst_rel_err"] = {"card": worst_err(g_card), "cpu_f32": worst_err(g_cpu)}
            check(res["spkemb_l2_rel_err"]["card"] <= SPK_BATCH_STATS_TOL,
                  f"cross-check: speaker-encoder gradients {res['spkemb_l2_rel_err']} from float64")
        out["batch_stats" if spk_train else "running_stats"] = res
    return out


def single_tower_hifigan():
    """HiFi-GAN V1's widths (512 channels, rates 8,8,2,2) with one ResBlock1
    tower (k 3, dilations 1,3,5): the shape that routes to K3."""
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig

    return HifiGanConfig(resblock="1", upsample_initial_channel=512, upsample_rates=(8, 8, 2, 2),
                         upsample_kernel_sizes=(16, 16, 4, 4), resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3, 5),))


def kernel_counts() -> dict:
    from zerovox_tpu_torch.ops.mrf import fused_mrf
    from zerovox_tpu_torch.ops.resblock import fused_resblock1
    from zerovox_tpu_torch.ops.se_conv import (se_conv_bwd, se_conv_bwd_bf16, se_conv_fwd,
                                               se_conv_fwd_bf16)
    from zerovox_tpu_torch.ops.upsample_stage import fused_upsample_stage

    counts = {f.__name__: f.launches for f in (fused_mrf, fused_upsample_stage, fused_resblock1,
                                               se_conv_fwd, se_conv_bwd, se_conv_fwd_bf16,
                                               se_conv_bwd_bf16)}
    counts.update({f"{f.__name__}_bf16": f.launches_bf16
                   for f in (fused_mrf, fused_upsample_stage, fused_resblock1)})
    counts.update(k5_counts())
    return counts


def k5_counts() -> dict:
    """K5's launches: forward, dK/dV and dQ, float32 and bf16."""
    from zerovox_tpu_torch.ops.flash_attention import KERNELS

    out = {f.__name__: f.launches for f in KERNELS}
    out.update({f"{f.__name__}_bf16": f.launches_bf16 for f in KERNELS})
    return out


def k4_bf16_counts():
    n = kernel_counts()
    return n["se_conv_fwd_bf16"], n["se_conv_bwd_bf16"]


def zero_counts() -> None:
    import zerovox_tpu_torch.ops.mrf as a
    import zerovox_tpu_torch.ops.resblock as b
    import zerovox_tpu_torch.ops.se_conv as c
    import zerovox_tpu_torch.ops.upsample_stage as d

    a.fused_mrf.launches = b.fused_resblock1.launches = d.fused_upsample_stage.launches = 0
    a.fused_mrf.launches_bf16 = b.fused_resblock1.launches_bf16 = 0
    d.fused_upsample_stage.launches_bf16 = 0
    c.se_conv_fwd.launches = c.se_conv_bwd.launches = 0
    c.se_conv_fwd_bf16.launches = c.se_conv_bwd_bf16.launches = 0
    for f in (a.fused_mrf, b.fused_resblock1, d.fused_upsample_stage):
        f.launches_at.clear()


def zero_k5_counts() -> None:
    """K5's counts, apart from zero_counts: phases 1-20 leave them at 0
    (ZEROVOX_ATTN unset), which main checks before phase 21."""
    from zerovox_tpu_torch.ops.flash_attention import KERNELS

    for f in KERNELS:
        f.launches = f.launches_bf16 = 0


def batch_inputs(engine, spk_wavs):
    """BATCH_TEXTS with FRAMES_PER_PHONE frames a phone and one speaker
    embedding per row."""
    import numpy as np
    import torch

    durs = [np.full(len(engine.text2phonemeids(t)[0]), FRAMES_PER_PHONE, np.int32)
            for t in BATCH_TEXTS]
    spks = torch.cat([engine.speaker_embed(w) for w in spk_wavs])
    return durs, spks


def check_batch(rows, durs, hop, what: str) -> None:
    import numpy as np

    check(len(rows) == len(durs), f"{what}: {len(rows)} rows for {len(durs)} texts")
    for i, ((w, n), d) in enumerate(zip(rows, durs)):
        check(n == int(d.sum()) and w.shape == (n * hop,),
              f"{what} row {i}: {n} frames, wav {w.shape}, durations sum {int(d.sum())}")
        check(bool(np.isfinite(w).all()), f"{what} row {i}: non-finite")


def styletts_phase(torch, card: str, refwav, sr: int, profile_dir) -> dict:
    """Phase 8: speaker_embed -> tts_ex -> tts_stream -> tts_batch on the
    StyleTTS decoder with the single-tower vocoder at full width; launch
    counts around that run; RTF, first chunk, stage times; the card against
    the CPU on SHORT_TEXT and on one tts_batch of 2 rows."""
    import dataclasses as dc

    import numpy as np

    from zerovox_tpu_torch.config import ZeroVoxConfig
    from zerovox_tpu_torch.ops.resblock import fused_resblock1
    from zerovox_tpu_torch.synthesize import (MEL_BUCKETS, VOCODER_ALL_BATCHES, ZeroVoxTTS,
                                              pick_bucket)
    from zerovox_tpu_torch.utils.profiling import RtfStats, cuda_time_ms

    base = ZeroVoxConfig()  # configs/tts_medium_styledec.yaml, built in code (no pyyaml here)
    cfg = dc.replace(base, model=dc.replace(
        base.model, decoder=dc.replace(base.model.decoder, kind="styletts")))
    hcfg = single_tower_hifigan()
    engine = ZeroVoxTTS.from_random(cfg, hcfg, seed=0)
    hop = cfg.audio.hop_size
    ids, puncts = engine.text2phonemeids(TEXT)
    dur = np.full(len(ids), FRAMES_PER_PHONE, dtype=np.int32)
    n_frames = int(dur.sum())
    bucket = pick_bucket(n_frames, MEL_BUCKETS)
    rng = np.random.default_rng(8)
    spk_wavs = [refwav] + [rng.normal(size=2 * sr).astype(np.float32) * s for s in (0.05, 0.2, 0.3)]

    zero_counts()
    spk = engine.speaker_embed(refwav)
    wav, _, n, mel = engine.tts_ex(TEXT, spk, duration=dur)
    per_tts_ex = fused_resblock1.launches
    chunks = list(engine.tts_stream(TEXT, spk, duration=dur))
    after_stream = fused_resblock1.launches
    durs, spks = batch_inputs(engine, spk_wavs)
    batch = engine.tts_batch(list(BATCH_TEXTS), spks, durations=durs)
    torch.cuda.synchronize()
    counts = kernel_counts()
    print(f"launches: tts_ex {per_tts_ex} K3; speaker_embed + tts_ex + tts_stream ({len(chunks)} "
          f"chunks) + tts_batch (B={len(batch)}) {counts}")
    check(per_tts_ex == 3, f"tts_ex launched K3 {per_tts_ex} times, not 3")
    check(after_stream - per_tts_ex == 3 * len(chunks),
          f"tts_stream launched K3 {after_stream - per_tts_ex} times for {len(chunks)} windows")
    batch_k3 = 3 if VOCODER_ALL_BATCHES else 0
    check(counts["fused_resblock1"] - after_stream == batch_k3,
          f"tts_batch at B=4 launched K3 {counts['fused_resblock1'] - after_stream} times, "
          f"not {batch_k3}")
    check(all(v == 0 for k, v in counts.items() if k != "fused_resblock1"),
          f"the StyleTTS path launched another kernel: {counts}")
    check(n == n_frames and wav.shape == (n_frames * hop,), f"wav {wav.shape}, {n} frames")
    check(bool(np.isfinite(wav).all()) and bool(np.isfinite(mel).all()), "non-finite wav or mel")
    streamed = np.concatenate(chunks)
    check(streamed.shape == wav.shape, f"stream {streamed.shape} != tts {wav.shape}")
    stream_err = float(np.max(np.abs(streamed - wav)))
    peak = float(np.max(np.abs(wav)))
    check(stream_err < STREAM_TOL * min(peak, 1.0), f"stream differs from tts by {stream_err}")
    check_batch(batch, durs, hop, "tts_batch")
    print(f"wav: {wav.shape[0]} samples, peak {peak:.6g}; stream max abs diff {stream_err:.3g}; "
          f"tts_batch rows {[r[1] for r in batch]} frames")

    enc, _, _ = engine._encode(ids, puncts, spk, dur)
    mel_b = engine._decode(enc, spk, bucket)
    stages = {
        "encode": cuda_time_ms(lambda: engine._encode(ids, puncts, spk, dur), iters=10),
        "decode": cuda_time_ms(lambda: engine._decode(enc, spk, bucket), iters=10),
        "vocode": cuda_time_ms(lambda: engine._vocode(mel_b), iters=10),
    }
    batch_ms = cuda_time_ms(lambda: engine.tts_batch(list(BATCH_TEXTS), spks, durations=durs),
                            iters=3, warmup=1)
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
    out = {"stage_ms": stages, "tts_batch_b4_ms": batch_ms, "rtf": stats.mean_rtf,
           "first_chunk_p50_ms": lat.p50_first_chunk_ms, "voice_s": wav.shape[0] / sr,
           "bucket": bucket, "launches": counts, "card": card}
    print(json.dumps({"styletts_path": out}), flush=True)
    if profile_dir is not None:
        profile_calls(torch, lambda: engine.tts_ex(TEXT, spk, duration=dur), 3, profile_dir,
                      "styletts_path")
        for name, fn in (("encode", lambda: engine._encode(ids, puncts, spk, dur)),
                         ("decode", lambda: engine._decode(enc, spk, bucket)),
                         ("vocode", lambda: engine._vocode(mel_b))):
            profile_calls(torch, fn, 3, profile_dir, f"styletts_{name}")

    # the same weights on the CPU (plain versions)
    sd, meldec_sd = engine.state_dicts()
    cpu = ZeroVoxTTS(cfg, sd, hcfg, meldec_sd, device="cpu")
    d_short = np.full(len(engine.text2phonemeids(SHORT_TEXT)[0]), FRAMES_PER_PHONE, np.int32)
    w_card, _, n_card = engine.tts(SHORT_TEXT, spk, duration=d_short)
    w_cpu, _, n_cpu = cpu.tts(SHORT_TEXT, spk.cpu(), duration=d_short)
    check(n_card == n_cpu and w_card.shape == w_cpu.shape, f"card {w_card.shape}, cpu {w_cpu.shape}")
    errs = {"tts": float(np.max(np.abs(w_card - w_cpu)))}
    peaks = {"tts": float(np.max(np.abs(w_cpu)))}
    pair = [SHORT_TEXT, BATCH_TEXTS[3]]
    pair_durs = [d_short, durs[3]]
    b_card = engine.tts_batch(pair, spks[:2], durations=pair_durs)
    b_cpu = cpu.tts_batch(pair, spks[:2].cpu(), durations=pair_durs)
    check_batch(b_cpu, pair_durs, hop, "tts_batch on the CPU")
    errs["tts_batch"] = max(float(np.max(np.abs(a[0] - b[0]))) for a, b in zip(b_card, b_cpu))
    peaks["tts_batch"] = min(float(np.max(np.abs(b[0]))) for b in b_cpu)
    print(f"card vs cpu: max abs diff {errs}, peaks {peaks}")
    for k in errs:
        check(peaks[k] > 0 and errs[k] < WAV_TOL * min(peaks[k], 1.0),
              f"card {k} differs from the CPU run by {errs[k]} (peak {peaks[k]})")
    out["cpu_err"], out["cpu_peak"] = errs, peaks
    return out


def default_batch_phase(torch, dev, card: str, refwav, sr: int) -> dict:
    """Phase 9: the default engine's tts_batch at B=4 (K2 twice, K1 as the
    engine's VOCODER_ALL_BATCHES says), then the batch rule at B=4 and 8."""
    import numpy as np

    from zerovox_tpu_torch.ops.mrf import fused_mrf
    from zerovox_tpu_torch.ops.upsample_stage import fused_upsample_stage
    from zerovox_tpu_torch.synthesize import (MEL_BUCKETS, VOCODER_ALL_BATCHES, ZeroVoxTTS,
                                              pick_bucket)
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    engine = ZeroVoxTTS.from_random(seed=0)
    rng = np.random.default_rng(9)
    spk_wavs = [refwav] + [rng.normal(size=2 * sr).astype(np.float32) * s for s in (0.05, 0.2, 0.3)]
    durs, spks = batch_inputs(engine, spk_wavs)
    zero_counts()
    rows = engine.tts_batch(list(BATCH_TEXTS), spks, durations=durs)
    torch.cuda.synchronize()
    counts = kernel_counts()
    check_batch(rows, durs, engine.cfg.audio.hop_size, "default tts_batch")
    k1 = 1 if VOCODER_ALL_BATCHES else 0
    check(fused_upsample_stage.launches == 2 and fused_mrf.launches == k1
          and counts["fused_resblock1"] == 0,
          f"the default engine's tts_batch at B=4 launched {counts}, not K2 twice and K1 {k1}x")
    batch_ms = cuda_time_ms(lambda: engine.tts_batch(list(BATCH_TEXTS), spks, durations=durs),
                            iters=3, warmup=1)
    T_mel = pick_bucket(max(int(d.sum()) for d in durs), MEL_BUCKETS)
    rule = batch_rule(torch, dev, T_mel)
    out = {"launches": counts, "tts_batch_b4_ms": batch_ms, "rows": [r[1] for r in rows],
           "batch_rule": rule, "engine_all_batches": VOCODER_ALL_BATCHES, "card": card}
    print(json.dumps({"default_batch": out}), flush=True)
    return out


def batch_rule(torch, dev, T_mel: int) -> dict:
    """K1 (stage 1 of the default vocoder) and K3 (stages 1-3 of the
    single-tower one, summed) at B = 4 and 8 against their plain stages on
    the same inputs, each checked (< KERNEL_TOL) and timed in turns (plain,
    kernel, kernel, plain). The engine's VOCODER_ALL_BATCHES should be on
    only where both kernels win at both sizes."""
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.ops.mrf import fused_mrf, mrf_plain, pack_towers
    from zerovox_tpu_torch.ops.resblock import fused_resblock1, resblock1_plain
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    gen = torch.Generator().manual_seed(3456)
    res = {}
    for name, hcfg in (("fused_mrf", HifiGanConfig()), ("fused_resblock1", single_tower_hifigan())):
        ks, dils = tuple(hcfg.resblock_kernel_sizes), tuple(hcfg.resblock_dilation_sizes[0])
        c0, T = hcfg.upsample_initial_channel, T_mel
        stages = []
        for i, u in enumerate(hcfg.upsample_rates):
            C, T = c0 // 2 ** (i + 1), T * u
            if C <= 128 and (name == "fused_resblock1" or i == 1):
                stages.append((T, C))
        for B in (4, 8):
            calls = []
            for T, C in stages:
                x = torch.randn(B, T, C, generator=gen).to(dev)
                towers = random_towers(torch, gen, C, ks, len(dils), dev)
                packed = pack_towers(towers)
                if name == "fused_mrf":
                    kern = lambda x=x, pk=packed: fused_mrf(x, pk, dils, ks)  # noqa: E731
                    plain = lambda x=x, tw=towers: mrf_plain(x, tw, dils)  # noqa: E731
                else:
                    kern = lambda x=x, tw=towers, pk=packed: fused_resblock1(  # noqa: E731
                        x, *tw[0], dils, packed=pk)
                    plain = lambda x=x, tw=towers: resblock1_plain(x, *tw[0], dils)  # noqa: E731
                err = (kern() - plain()).abs().max().item()
                check(err < KERNEL_TOL, f"{name} at B={B}, [{T},{C}]: max abs diff {err}")
                calls.append((kern, plain))
            turns = {"plain": [], "kernel": []}
            for label in ("plain", "kernel", "kernel", "plain"):
                i = 0 if label == "kernel" else 1
                turns[label].append(sum(cuda_time_ms(c[i], iters=5, warmup=1) for c in calls))
            res[f"{name}_b{B}"] = {"stages": [f"[{B},{T},{C}]" for T, C in stages],
                                   "turns_ms": turns,
                                   "kernel_wins": max(turns["kernel"]) < min(turns["plain"])}
            del calls
    res["both_win_at_4_and_8"] = all(v["kernel_wins"] for v in res.values())
    return res


def grad_phase(torch, dev, card: str) -> dict:
    """Phase 11: the kernel route refuses autograd on the card, and the
    nn.Modules' route gives the CPU's gradients."""
    import numpy as np

    from zerovox_tpu_torch.models.hifigan import Generator, HifiGanConfig
    from zerovox_tpu_torch.synthesize import random_init_

    # HiFi-GAN V1's widths and towers, two of its four stages: stage 0 at
    # C=256 plain, stage 1 at C=128 the MRF kernel's stage
    cfg = HifiGanConfig(upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16))
    rng = np.random.default_rng(10)
    mel = torch.tensor(rng.normal(size=(1, 32, cfg.num_mels)).astype(np.float32))
    ct = torch.tensor(rng.normal(size=(1, 32 * cfg.total_upsample)).astype(np.float32))
    n0 = kernel_counts()
    for hcfg in (cfg, single_tower_hifigan()):
        gen = Generator(hcfg, use_pallas=True).to(dev)
        try:
            gen(mel.to(dev))
        except RuntimeError as e:
            check("no backward" in str(e), f"use_pallas=True under grad raised {e}")
        else:
            fail("Generator(use_pallas=True) under grad returned instead of raising")
    check(kernel_counts() == n0, f"the refused calls launched kernels: {kernel_counts()} vs {n0}")

    ref = Generator(cfg)
    random_init_(ref, torch.Generator().manual_seed(10))
    with torch.no_grad():
        for prm in ref.parameters():
            if prm.dim() == 1:
                prm.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(prm.numel()))

    def grads(device):
        g = Generator(cfg).to(device)
        g.load_state_dict(ref.state_dict())
        x = mel.to(device).requires_grad_(True)
        (g(x) * ct.to(device)).sum().backward()
        out = {n: p.grad.detach().cpu() for n, p in g.named_parameters()}
        out["mel"] = x.grad.detach().cpu()
        return out

    card_g, cpu_g = grads(dev), grads("cpu")
    check(card_g.keys() == cpu_g.keys() and all(v is not None for v in card_g.values()),
          "the card's Generator gave other gradients")
    worst = max(((card_g[n] - cpu_g[n]).abs().max().item() / cpu_g[n].abs().max().item(), n)
                for n in cpu_g)
    check(worst[0] <= STEP_GRAD_TOL, f"vocoder gradient {worst[1]}: {worst[0]} x its max |value|")
    out = {"n_grads": len(cpu_g), "worst_grad_rel_err": worst[0], "worst": worst[1], "card": card}
    print(json.dumps({"vocoder_grads": out}), flush=True)
    return out


def _post(host: str, port: int, payload: dict) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection(host, port, timeout=600)
    try:
        conn.request("POST", "/tts", json.dumps(payload), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _stream(host: str, port: int, payload: dict) -> tuple[float, bytes]:
    """POST a streaming /tts: (seconds to the first PCM byte, whole body)."""
    conn = http.client.HTTPConnection(host, port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/tts", json.dumps({**payload, "stream": True}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            fail(f"streaming /tts answered {resp.status}: {resp.read()[:200]}")
        got, first = b"", None
        while True:
            piece = resp.read1(65536)
            if not piece:
                check(first is not None, f"the stream carried no audio: {len(got)} bytes")
                return first, got
            got += piece
            if first is None and len(got) > WAV_HEADER_BYTES:
                first = time.perf_counter() - t0
    finally:
        conn.close()


def _wav_pcm(body: bytes):
    import numpy as np

    with wave.open(io.BytesIO(body)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


class _RecordingEngine:
    """The engine as the server sees it, recording each tts_batch window the
    dispatch thread forms (the calling thread, a label the caller sets, the
    texts and embeddings, the kernels launched and the call's wall ms) and
    each stream's wall ms to its first chunk on the dispatch thread."""

    def __init__(self, engine):
        self.engine, self.cfg, self.windows, self.label = engine, engine.cfg, [], None
        self.stream_first_ms = []

    def tts_batch(self, texts, spkembs):
        import numpy as np

        n0, t0 = kernel_counts(), time.perf_counter()
        outs = self.engine.tts_batch(texts, spkembs)
        ms, n1 = 1e3 * (time.perf_counter() - t0), kernel_counts()
        self.windows.append({"thread": threading.current_thread().name, "label": self.label,
                             "texts": list(texts), "spk": np.array(spkembs), "ms": ms,
                             "launches": {k: n1[k] - n0[k] for k in n1}})
        return outs

    def tts_stream_text(self, text, spkemb, chunk_frames: int = 96):
        t0 = time.perf_counter()
        for i, chunk in enumerate(self.engine.tts_stream_text(text, spkemb, chunk_frames)):
            if i == 0:
                self.stream_first_ms.append(1e3 * (time.perf_counter() - t0))
            yield chunk


def serving_phase(torch, card: str) -> dict:
    """Phase 10: the main-path engine at full width behind make_server over
    localhost HTTP, by scripts/bench_http.py's method: lone POST /tts
    against the direct tts (p50 of each), streaming time to the first audio
    byte against the direct tts_stream's first chunk (p50 of each), and
    rounds of 8 concurrent POSTs (BATCH_TEXTS x 2 voices). Every HTTP row
    within one int16 step + 1e-3 of a direct tts_batch of the window the
    batcher formed; one stream within one int16 step of tts_stream_text;
    K1 and K2 launched from the dispatch thread; no error in /health."""
    import numpy as np

    from zerovox_tpu_torch.serving import VoiceRegistry, make_server, serve_in_thread
    from zerovox_tpu_torch.serving.server import _pcm16_bytes
    from zerovox_tpu_torch.synthesize import VOCODER_ALL_BATCHES, ZeroVoxTTS

    engine = ZeroVoxTTS.from_random(seed=0)  # ZeroVoxConfig() and the 512-channel HiFi-GAN
    sr = engine.cfg.audio.sampling_rate
    voices = VoiceRegistry()
    for ref in ZeroVoxTTS.available_speakerrefs():
        voices.add_from_wav(ref.removesuffix(".wav"), engine, ZeroVoxTTS.get_speakerref(ref, sr))
    names = voices.names()
    check(len(names) == 5, f"bundled voices {names}")
    engine.warmup(spkemb=voices.get(None), batch_sizes=(1, 4, 8))
    for _ in engine.tts_stream(TEXT, voices.get(None)):
        pass
    rec = _RecordingEngine(engine)
    srv = make_server(rec, voices, port=0, max_batch=SERVE_BATCH, max_delay_ms=20)
    serve_in_thread(srv)
    host, port = srv.server_address[:2]
    responses = {}  # (label, text, voice) -> int16 samples
    try:
        zero_counts()
        lone_ms = []
        for i in range(SERVE_ITERS):
            rec.label = ("lone", i)
            t0 = time.perf_counter()
            status, body = _post(host, port, {"text": TEXT, "voice": names[0]})
            lone_ms.append(1e3 * (time.perf_counter() - t0))
            check(status == 200, f"/tts answered {status}: {body[:200]}")
            responses[rec.label, TEXT, names[0]] = _wav_pcm(body)
        ttfb_ms = []
        for _ in range(SERVE_ITERS):
            first, stream_body = _stream(host, port, {"text": TEXT, "voice": names[0]})
            ttfb_ms.append(1e3 * first)
        round_ms = []
        for r in range(SERVE_ROUNDS):
            rec.label = ("round", r)
            jobs = [(t, v) for v in names[:2] for t in BATCH_TEXTS]
            out = [None] * len(jobs)

            def hit(i):
                out[i] = _post(host, port, {"text": jobs[i][0], "voice": jobs[i][1]})

            threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(jobs))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            round_ms.append(1e3 * (time.perf_counter() - t0))
            for (text, voice), res in zip(jobs, out):
                check(res is not None and res[0] == 200, f"concurrent /tts failed: {res and res[:1]}")
                responses[rec.label, text, voice] = _wav_pcm(res[1])
        torch.cuda.synchronize()
        launches = kernel_counts()
        with urllib.request.urlopen(f"http://{host}:{port}/health", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown_serving()
    check(health["errors"] == 0, f"/health reports errors: {health}")

    # every HTTP row against a direct tts_batch of the window it rode in
    row_err, matched = 0.0, 0
    k1 = 1 if VOCODER_ALL_BATCHES else 0
    for w in rec.windows:
        check(w["thread"] == "zerovox-batcher", f"tts_batch ran on thread {w['thread']}")
        check(w["launches"]["fused_upsample_stage"] >= 2 and w["launches"]["fused_mrf"] >= k1,
              f"a window of {len(w['texts'])} launched {w['launches']}")
        direct = engine.tts_batch(w["texts"], w["spk"])
        for text, spk, (wav, n) in zip(w["texts"], w["spk"], direct):
            voice = [v for v in names if np.array_equal(voices.get(v)[0], spk)]
            pcm = responses.pop((w["label"], text, voice[0]))
            check(pcm.shape == wav.shape, f"HTTP row {pcm.shape}, direct {wav.shape}")
            err = float(np.max(np.abs(pcm / 32767.0 - np.clip(wav, -1, 1)), initial=0.0))
            check(err <= WAV_TOL + 1.0 / 32767, f"HTTP row of {text!r} differs by {err}")
            row_err, matched = max(row_err, err), matched + 1
    check(not responses, f"{len(responses)} HTTP rows came from no recorded window")
    streamed = np.frombuffer(stream_body[WAV_HEADER_BYTES:], np.int16).astype(np.int32)
    direct = np.frombuffer(b"".join(_pcm16_bytes(c) for c in engine.tts_stream_text(
        TEXT, voices.get(names[0]))), np.int16).astype(np.int32)
    check(streamed.shape == direct.shape, f"stream {streamed.shape}, direct {direct.shape}")
    stream_steps = int(np.max(np.abs(streamed - direct), initial=0))
    check(stream_steps <= 1, f"the HTTP stream differs from tts_stream_text by {stream_steps} steps")

    # the direct calls the HTTP numbers stand beside, on the same text and voice
    spk = voices.get(names[0])
    direct_ms, batch1_ms, first_ms = [], [], []
    for _ in range(SERVE_ITERS):
        t0 = time.perf_counter()
        engine.tts(TEXT, spk)
        direct_ms.append(1e3 * (time.perf_counter() - t0))
    for _ in range(SERVE_ITERS):
        t0 = time.perf_counter()
        engine.tts_batch([TEXT], spk)
        batch1_ms.append(1e3 * (time.perf_counter() - t0))
    for _ in range(SERVE_ITERS):
        t0 = time.perf_counter()
        gen = engine.tts_stream(TEXT, spk)
        next(gen)
        first_ms.append(1e3 * (time.perf_counter() - t0))
        for _ in gen:
            pass
    p50 = statistics.median
    rounds = [w for w in rec.windows if w["label"][0] == "round"]
    out = {
        "lone": {"http_p50_ms": p50(lone_ms), "direct_tts_p50_ms": p50(direct_ms),
                 "overhead_p50_ms": p50(lone_ms) - p50(direct_ms),
                 "direct_tts_batch_b1_p50_ms": p50(batch1_ms),
                 "dispatch_tts_batch_p50_ms": p50([w["ms"] for w in rec.windows
                                                   if w["label"][0] == "lone"])},
        "stream": {"http_first_byte_p50_ms": p50(ttfb_ms),
                   "direct_first_chunk_p50_ms": p50(first_ms),
                   "overhead_p50_ms": p50(ttfb_ms) - p50(first_ms),
                   "dispatch_first_chunk_p50_ms": p50(rec.stream_first_ms)},
        "concurrent": {"clients": 2 * len(BATCH_TEXTS), "rounds": SERVE_ROUNDS,
                       "round_p50_ms": p50(round_ms),
                       "requests_per_s": 2 * len(BATCH_TEXTS) / (p50(round_ms) / 1e3),
                       "batches_per_round": len(rounds) / SERVE_ROUNDS,
                       "mean_batch_size": health.get("mean_batch_size"),
                       "max_batch_seen": health["max_batch_seen"]},
        "windows": len(rec.windows), "rows_checked": matched, "max_row_err": row_err,
        "stream_max_step_diff": stream_steps, "launches": launches,
        "health": {k: health[k] for k in ("requests", "batches", "streams", "stream_chunks",
                                          "errors")}, "card": card}
    print(json.dumps({"serving": out}), flush=True)
    return out


def variance_bins(card_engine, cpu_engine, spk, dur, n_bins: int, dump: Path | None) -> dict:
    """Phase 12's diagnostics: the variance adaptor's pitch and energy
    predictions for TEXT on the card and on the CPU, and the bins they
    fall in (round(v x (n_bins - 1)), as both packages bucketize). A bin
    that differs flips an embedding, so the waveforms part by more than
    rounding. For each differing bin: the value's place between two bin
    centres (0.5 is the edge). `dump` receives both engines' arrays."""
    import numpy as np

    ids, puncts = card_engine.text2phonemeids(TEXT)
    n = len(ids)
    enc_card, _, _ = card_engine._encode(ids, puncts, spk, dur)
    enc_cpu, _, _ = cpu_engine._encode(ids, puncts, spk.cpu(), dur)
    out, arrays = {}, {}
    for key in ("pitch", "energy"):
        a = enc_card[key][0, :n].float().cpu().numpy()
        b = enc_cpu[key][0, :n].float().cpu().numpy()
        ba = np.clip(np.round(a * (n_bins - 1)), 0, n_bins - 1)
        bb = np.clip(np.round(b * (n_bins - 1)), 0, n_bins - 1)
        differ = np.flatnonzero(ba != bb)
        out[f"{key}_max_abs_diff"] = float(np.max(np.abs(a - b)))
        out[f"{key}_bins_differ"] = [
            {"phone": int(i), "card": float(a[i]), "cpu": float(b[i]),
             "card_bin": int(ba[i]), "cpu_bin": int(bb[i]),
             "place": float(b[i] * (n_bins - 1) - np.floor(b[i] * (n_bins - 1)))}
            for i in differ]
        # how close the nearest value came to a bin edge, in bin widths
        frac = b * (n_bins - 1) - np.floor(b * (n_bins - 1))
        out[f"{key}_nearest_edge"] = float(np.min(np.abs(frac - 0.5)))
        arrays[f"{key}_card"], arrays[f"{key}_cpu"] = a, b
    if dump is not None:
        dump.mkdir(parents=True, exist_ok=True)
        k = len(list(dump.glob("phase12_*.npz")))
        np.savez(dump / f"phase12_{k:02d}.npz", n_bins=n_bins, **arrays)
    return out


def checkpoint_phase(torch, dev, card: str, refwav, dump: Path | None = None) -> dict:
    """Phase 12: Trainer.fit on train_config(fused=True, shallow=True) over
    the training phase's synthetic corpus, 2 epochs of 2 steps, writing
    checkpoints/0000 and 0001.msgpack (+ .json); the last read back by
    load_native_checkpoint -> from_jax_variables equals the trained
    state_dict bitwise; save_train_state, the uninterrupted run's next step
    against restore_train_state + that step (losses 1e-5 relative); an
    engine on the checkpoint through ZeroVoxTTS.from_checkpoint (a native
    generator.msgpack vocoder dir) on the card against the CPU, main-path
    text and durations (1e-3)."""
    import dataclasses as dc

    import numpy as np

    from zerovox_tpu_torch.models.hifigan import HifiGanConfig, MelDec
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS, random_init_
    from zerovox_tpu_torch.training.checkpointing import (load_checkpoint_meta,
                                                          load_native_checkpoint,
                                                          save_native_checkpoint)
    from zerovox_tpu_torch.training.data import SpeechDataModule
    from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig, device_batch
    from zerovox_tpu_torch.weights import from_jax_variables, meldec_to_jax_variables

    cfg = train_config(fused=True, shallow=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        root = Path(tmp)
        write_corpus(root, "train", cfg.symbols(), cfg.audio.num_mels, TRAIN_UTTS, (80, 100),
                     seed=0)
        dm = SpeechDataModule([{"path": {"preprocessed_path": "train"}}], cfg.symbols(), STATS,
                              batch_size=TRAIN_BATCH, num_workers=4, seed=0, base_path=str(root))
        dm.prepare_data()
        tcfg = TrainerConfig(max_epochs=2, warmup_epochs=1, log_every_n_steps=2, seed=0,
                             out_folder=str(root / "model"))
        trainer = Trainer(cfg, tcfg, steps_per_epoch=dm.steps_per_epoch())
        zero_counts()
        state = trainer.fit(dm.train_dataloader, trainer.init_state())
        k4 = k4_counts()
        check(state.step == 4 and k4 == (24, 24), f"fit took {state.step} steps, K4 {k4}")
        ckpts = root / "model" / "checkpoints"
        files = sorted(os.listdir(ckpts))
        check(files == ["0000.msgpack", "0000.msgpack.json", "0001.msgpack", "0001.msgpack.json"],
              f"checkpoints written: {files}")
        meta = load_checkpoint_meta(ckpts / "0001.msgpack")
        check(meta["epoch"] == 1 and meta["step"] == 4 and np.isfinite(meta["loss"]),
              f"checkpoint meta {meta}")
        sd = from_jax_variables(load_native_checkpoint(ckpts / "0001.msgpack"), cfg)
        trained = state.model.state_dict()
        differ = [k for k, v in trained.items() if not k.endswith("num_batches_tracked")
                  and not torch.equal(sd[k], v.cpu())]
        check(sd.keys() == trained.keys() and not differ,
              f"the checkpoint differs from the trained weights: {differ[:3]}")

        trainer.save_train_state(state, root / "state.pt", epoch=1)
        batch = device_batch(next(iter(dm.train_dataloader(2))), dev)
        want = {k: v.item() for k, v in trainer.train_step(state, batch).items()}
        del state, trainer
        fresh = Trainer(cfg, tcfg, steps_per_epoch=dm.steps_per_epoch())
        resumed = fresh.init_state()
        check(fresh.restore_train_state(resumed, root / "state.pt") == 2, "resume epoch")
        got = {k: v.item() for k, v in fresh.train_step(resumed, batch).items()}
        resume_err = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in want)
        check(resume_err <= RESUME_RTOL, f"the resumed step's losses {got}, uninterrupted {want}")
        del fresh, resumed, batch
        torch.cuda.empty_cache()

        hcfg = HifiGanConfig()
        md = MelDec(hcfg)
        random_init_(md, torch.Generator().manual_seed(12))
        meldec_dir = root / "meldec"
        meldec_dir.mkdir()
        (meldec_dir / "config.json").write_text(json.dumps(dc.asdict(hcfg)))
        save_native_checkpoint(meldec_dir / "generator.msgpack",
                               {"params": meldec_to_jax_variables(md.state_dict(), hcfg)["params"]["generator"]})
        card_engine = ZeroVoxTTS.from_checkpoint(cfg, ckpts / "0001.msgpack", meldec_dir)
        cpu_engine = ZeroVoxTTS.from_checkpoint(cfg, ckpts / "0001.msgpack", meldec_dir,
                                                device="cpu")
    spk = card_engine.speaker_embed(refwav)
    dur = np.full(len(card_engine.text2phonemeids(TEXT)[0]), FRAMES_PER_PHONE, np.int32)
    n0 = kernel_counts()
    w_card, _, n_card = card_engine.tts(TEXT, spk, duration=dur)
    n1 = kernel_counts()
    w_cpu, _, n_cpu = cpu_engine.tts(TEXT, spk.cpu(), duration=dur)
    check(n_card == n_cpu == int(dur.sum()) and w_card.shape == w_cpu.shape,
          f"card {w_card.shape}, cpu {w_cpu.shape}")
    err, peak = float(np.max(np.abs(w_card - w_cpu))), float(np.max(np.abs(w_cpu)))
    bins = variance_bins(card_engine, cpu_engine, spk, dur, cfg.model.encoder.ve_n_bins, dump)
    print(json.dumps({"checkpoint_engine": {"cpu_err": err, "cpu_peak": peak,
                                            "bound": WAV_TOL * min(peak, 1.0), **bins}}),
          flush=True)
    check(peak > 0 and err < WAV_TOL * min(peak, 1.0),
          f"the checkpoint's engine on the card differs from the CPU by {err} (peak {peak}; "
          f"pitch bins differing {bins['pitch_bins_differ']}, energy "
          f"{bins['energy_bins_differ']})")
    out = {"steps": 4, "k4_launches": list(k4), "losses_uninterrupted": want,
           "losses_resumed": got, "resume_max_rel_err": resume_err,
           "engine_launches": {k: n1[k] - n0[k] for k in n1}, "cpu_err": err, "cpu_peak": peak,
           "card": card}
    print(json.dumps({"checkpoints": out}), flush=True)
    return out


def demo_phase(card: str) -> dict:
    """Phase 13: `python3 -m zerovox_tpu_torch.cli.demo --random-model` in
    its own process on the card: exit 0 and a WAV of the length it states."""
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        path = Path(tmp) / "demo.wav"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "zerovox_tpu_torch.cli.demo", "--random-model",
                               "--refaudio", "en_kevin.wav", "--wav-filename", str(path), TEXT],
                              cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"the demo CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        m = re.search(r"voice length: ([0-9.]+) sec", proc.stdout)
        check(m is not None and path.is_file(), f"the demo CLI wrote no wav: {proc.stdout[-1000:]}")
        with wave.open(str(path)) as w:
            seconds, rate = w.getnframes() / w.getframerate(), w.getframerate()
    check(rate == 22050 and abs(seconds - float(m.group(1))) <= 0.005,
          f"the demo wrote {seconds} s at {rate} Hz, stated {m.group(1)} s")
    out = {"wav_seconds": seconds, "stated_seconds": float(m.group(1)), "process_s": wall,
           "card": card}
    print(json.dumps({"demo_cli": out}), flush=True)
    return out


def kernel_family(name: str) -> str:
    """The family of a device kernel by its (demangled or mangled) name."""
    n = name.lower()
    if "bf::fwd_kernel" in n or "bf::bwd_kernel" in n or "bf10fwd_kernel" in n or "bf10bwd_kernel" in n:
        return "K4 bf16"  # se_conv.cu's namespace bf
    if "se_conv" in n:
        return "K4 float32 and sum passes"
    for key, fam in (("mrf_kernel", "K1"), ("stage_kernel", "K2"), ("resblock_kernel", "K3")):
        if key in n:  # mrf.cu, upsample_stage.cu, resblock.cu
            return fam + (" bf16" if "bfloat16" in n else " float32")
    if "memcpy" in n or "memset" in n:
        return "copies"
    if any(k in n for k in ("conv", "cudnn", "implicit", "wgrad", "dgrad", "fprop")):
        return "cuDNN convolutions"
    if any(k in n for k in ("gemm", "cutlass", "sm90_xmma", "ampere")):
        return "matmuls"
    if any(k in n for k in ("reduce", "norm", "softmax")):
        return "reductions and norms"
    return "elementwise and other"


def trace_split(trace_dir: Path) -> dict:
    """Device time of the Chrome trace in trace_dir (`--profile`'s), by
    kernel family, with the device's busy share of the traced window."""
    [path] = [p for p in trace_dir.iterdir() if p.suffix == ".json"]
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check(bool(kernels), f"{path.name}: no device activity in the trace")
    t0 = min(e["ts"] for e in events if "ts" in e and e.get("ph") == "X")
    t1 = max(e["ts"] + e.get("dur", 0) for e in events if "ts" in e and e.get("ph") == "X")

    split: dict[str, float] = {}
    top: dict[str, float] = {}
    for e in kernels:
        fam = "copies" if e.get("cat") != "kernel" else kernel_family(e["name"])
        split[fam] = split.get(fam, 0.0) + e["dur"] / 1e3
        top[e["name"][:90]] = top.get(e["name"][:90], 0.0) + e["dur"] / 1e3
    busy = sum(split.values())
    return {"window_ms": (t1 - t0) / 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / max((t1 - t0) / 1e3, 1e-9),
            "by_family_ms": dict(sorted(split.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])[:8])}


def cli_phase(torch, dev, card: str) -> dict:
    """Phase 14: the training CLI's `run` (what `main` runs after reading
    its YAML; the card's machine has no pyyaml) at tts_medium full width,
    batch 24, on a synthetic corpus of 48 utterances with its stats.json:
    --precision bf16-mixed --optim-dtype auto --packed-speaker 1
    --fused-speaker --data-device-cache auto --name smoke --keep-checkpoints
    1 --checkpoint-format state --profile DIR --profile-steps 2 for 2 epochs
    of 2 steps, then --resume for a third. Checks 6 + 6 bf16 K4 launches a
    step and no float32 one, finite losses, float32 master weights and
    running statistics, bf16 second moments, the device cache on, only
    checkpoints/smoke/0001 left after pruning, a trace in DIR, and the
    resumed run starting at epoch 2 at the saved step. Then the bf16-mixed
    step against the float32 step of phase 6's configuration from the same
    weights: epoch 0's losses on the same batches (MIXED_LOSS_RTOL) and the
    step's device time, in turns."""
    import numpy as np

    from zerovox_tpu_torch.cli import train as cli
    from zerovox_tpu_torch.config import ZeroVoxConfig
    from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig, device_batch
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    base = ZeroVoxConfig()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        root = Path(tmp)
        write_corpus(root, "cli", base.symbols(), base.audio.num_mels, TRAIN_UTTS, (80, 100),
                     seed=0)
        (root / "cli" / "stats.json").write_text(json.dumps(
            {"pitch": [STATS["pitch_min"], STATS["pitch_max"]],
             "energy": [STATS["energy_min"], STATS["energy_max"]]}))
        os.environ["ZEROVOX_PREPROCESSED_DATA_PATH"] = str(root)
        corpora = [{"language": "en", "path": {"preprocessed_path": "cli"}}]
        modelcfg = cli.merge_stats(base.to_dict(), corpora, str(root))
        out_folder, prof = root / "model", root / "profile"
        argv = ["-c", "modelcfg.yaml", "corpus.yaml", "--batch-size", str(TRAIN_BATCH),
                "--precision", "bf16-mixed", "--optim-dtype", "auto", "--packed-speaker", "1",
                "--fused-speaker", "--data-device-cache", "auto", "--name", "smoke",
                "--keep-checkpoints", "1", "--checkpoint-format", "state", "--profile",
                str(prof), "--profile-steps", "2", "--max-epochs", "2", "--warmup-epochs", "1",
                "--out-folder", str(out_folder)]

        steps = []
        inner = Trainer.train_step

        def counted_step(self, st, batch):
            n0, f0 = k4_bf16_counts(), k4_counts()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            losses = inner(self, st, batch)
            b.record()
            n1, f1 = k4_bf16_counts(), k4_counts()
            steps.append({"events": (a, b), "losses": losses, "step_before": st.step - 1,
                          "bf16": (n1[0] - n0[0], n1[1] - n0[1]),
                          "f32": (f1[0] - f0[0], f1[1] - f0[1])})
            return losses

        Trainer.train_step = counted_step
        try:
            zero_counts()
            out = cli.run(cli.get_args(argv), modelcfg, corpora)
            torch.cuda.synchronize()
            launches = dict(zip(("se_conv_fwd_bf16", "se_conv_bwd_bf16"), k4_bf16_counts()))
            first = list(steps)
            steps.clear()
            ckpts = out_folder / "checkpoints" / "smoke"
            kept = (sorted(os.listdir(ckpts)), sorted(os.listdir(ckpts / "state")))
            check(kept == (["0001.msgpack", "0001.msgpack.json", "state"], ["0001.pt"]),
                  f"checkpoints left after pruning: {kept}")
            split = trace_split(prof)  # the first run's trace (the resumed run adds its own)
            resumed = cli.run(cli.get_args(argv + ["--resume", "--max-epochs", "3"]), modelcfg,
                              corpora)
            torch.cuda.synchronize()
        finally:
            Trainer.train_step = inner

        state, dm = out["state"], out["datamodule"]
        check(len(first) == 4 and state.step == 4, f"the CLI took {len(first)} steps, not 4")
        check(all(r["bf16"] == (6, 6) and r["f32"] == (0, 0) for r in first + steps),
              f"K4 launches a step (bf16, f32): {[(r['bf16'], r['f32']) for r in first + steps]}")
        losses = [{k: float(v) for k, v in r["losses"].items()} for r in first + steps]
        check(all(np.isfinite(v) for d in losses for v in d.values()), f"non-finite loss {losses}")
        check(out["trainer"].mixed and all(p.dtype == torch.float32 for p in state.model.parameters()),
              "master weights not float32")
        check(all(b.dtype == torch.float32 for n, b in state.model.named_buffers()
                  if n.endswith(("running_mean", "running_var"))), "running statistics not float32")
        check(all(n.dtype == torch.bfloat16 for n in state.optimizer.nu), "nu not bf16")
        check(dm.device_cache and dm._cache is not None and dm._cache.data["mel"].is_cuda,
              "the device corpus cache is off")
        check(len(steps) == 2 and steps[0]["step_before"] == 4 and resumed["state"].step == 6,
              f"the resumed run: {len(steps)} steps from step {steps[0]['step_before'] if steps else None}")
        meta = json.loads((ckpts / "0002.msgpack.json").read_text())
        check(meta["epoch"] == 2 and meta["step"] == 6, f"resumed checkpoint meta {meta}")
        res = {"steps": len(first), "launches": launches,
               "k4_per_step": [list(r["bf16"]) for r in first],
               "step_ms": [r["events"][0].elapsed_time(r["events"][1]) for r in first],
               "resumed_step_ms": [r["events"][0].elapsed_time(r["events"][1]) for r in steps],
               "losses": losses, "device_cache_mb": dm._cache.nbytes / 1e6,
               "checkpoints_after_first_run": kept[0] + kept[1], "profile": split,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
        res["median_step_ms"] = float(np.median(res["step_ms"][1:]))
        del out, resumed, state
        torch.cuda.empty_cache()

        # the bf16-mixed step beside phase 6's float32 step, from the same weights
        cfg = cli.model_config(cli.get_args(argv), modelcfg)
        f32 = Trainer(cfg, TrainerConfig(max_epochs=2, warmup_epochs=1, seed=0,
                                         out_folder=str(root / "f32")), 2)
        mixed = Trainer(cfg, TrainerConfig(max_epochs=2, warmup_epochs=1, seed=0,
                                           precision="bf16-mixed", optim_dtype="bf16",
                                           out_folder=str(root / "bf16")), 2)
        st32 = f32.init_state()
        st16 = mixed.init_state(st32.model.state_dict())
        batches = [device_batch(b, dev) for b in dm.train_dataloader(0)]
        res["mel_buckets"] = [b["mel"].shape[1] for b in batches]
        loss0 = {"32": [], "bf16-mixed": []}
        for tr, st, key in ((f32, st32, "32"), (mixed, st16, "bf16-mixed")):
            for b in batches:
                loss0[key].append(float(tr.train_step(st, b)["loss"]))
        m32, m16 = float(np.mean(loss0["32"])), float(np.mean(loss0["bf16-mixed"]))
        check(abs(m16 - m32) <= MIXED_LOSS_RTOL * abs(m32),
              f"epoch 0 loss: bf16-mixed {m16}, float32 {m32}")
        times = {"32": [], "bf16-mixed": []}
        for tr, st, key in ((f32, st32, "32"), (mixed, st16, "bf16-mixed"),
                            (mixed, st16, "bf16-mixed"), (f32, st32, "32")):
            times[key].append(cuda_time_ms(lambda: tr.train_step(st, batches[0]), iters=3, warmup=1))
        res.update(epoch0_loss={"32": m32, "bf16-mixed": m16, "rel_diff": abs(m16 - m32) / abs(m32)},
                   turns_ms=times, f32_step_ms=float(np.mean(times["32"])),
                   bf16_step_ms=float(np.mean(times["bf16-mixed"])))
        res["speedup"] = res["f32_step_ms"] / res["bf16_step_ms"]
        # two steps of each under torch.profiler (no epoch-end work in the window)
        res["step_profiles"] = {
            key: profile_calls(torch, lambda: tr.train_step(st, batches[0]), 2,
                               BUILD / "profiles", f"train_step_{key}")
            for tr, st, key in ((f32, st32, "f32"), (mixed, st16, "bf16_mixed"))}
    print(json.dumps({"train_cli": res}), flush=True)
    return res


def bf16_stages(torch, name, e16, cpu16, spk, dur) -> dict:
    """The bf16 engine on the card against the same engine on the CPU, stage
    by stage on the short text, each stage fed the card's own input: the
    encoder's output, the decoder's mel and the vocoder's waveform (max abs
    diff beside the CPU output's peak). The vocoder (the bf16 kernels and
    cuDNN in bf16) is held to 5e-2 of its peak; the encoder and the decoder
    are reported."""
    import numpy as np

    from zerovox_tpu_torch.synthesize import MEL_BUCKETS, pick_bucket

    ids, puncts = e16.text2phonemeids(SHORT_TEXT)
    T = pick_bucket(int(dur.sum()), MEL_BUCKETS)
    enc = e16._encode(ids, puncts, spk, dur)[0]
    enc_cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in enc.items()}
    mel = e16._decode(enc, spk, T)

    def diff(card, cpu) -> dict:
        card, cpu = card.float().cpu(), cpu.float()
        return {"max_abs_diff": (card - cpu).abs().max().item(), "cpu_peak": cpu.abs().max().item()}

    out = {"encoder": diff(enc["x"], cpu16._encode(ids, puncts, spk.cpu(), dur)[0]["x"]),
           "decoder": diff(mel, cpu16._decode(enc_cpu, spk.cpu(), T)),
           "vocoder": diff(e16._vocode(mel), cpu16._vocode(mel.cpu()))}
    voc = out["vocoder"]
    tol = min(BF16_WAV_TOL, BF16_WAV_REL * voc["cpu_peak"])
    print(f"{name}: bf16 stages, card - CPU on the card's inputs: {out} (vocoder bound {tol:.6g})")
    check(voc["cpu_peak"] > 0 and voc["max_abs_diff"] <= tol,
          f"{name}: the bf16 vocoder on the card is {voc['max_abs_diff']} from the CPU's, over {tol}")
    return out


def window_dependence(torch, name, e16, e32, hcfg, bucket: int) -> dict:
    """What a streamed window changes, on the card: an op over rows [a, a+W)
    of its input against over the whole (bucket frames of seeded input), on
    the output rows whose inputs lie in the window (elements that differ,
    of how many, max abs diff). cuDNN's plain convolutions of the vocoder
    (conv_pre, the first upsampler, stage 0's first conv), bf16 and float32,
    are reported; the path's bf16 kernel at its first stage's width (K1, or
    K3 on the StyleTTS path) must give the window bitwise the whole's rows."""
    from zerovox_tpu_torch.ops.mrf import fused_mrf, pack_towers
    from zerovox_tpu_torch.ops.resblock import fused_resblock1

    gen = torch.Generator().manual_seed(1515)
    dev = next(e16._meldec.parameters()).device
    k0, s0 = hcfg.upsample_kernel_sizes[0], hcfg.upsample_rates[0]
    a, W = 101, CHUNK_FRAMES + 2 * 40  # a window's first frame and length (frames)

    def rows(fn, x, axis, scale, margin) -> dict:
        """fn over frames [a, a+W) of x (time on `axis`, `scale` output rows
        an input row) against over all of x, away from the window's edges by
        `margin` output rows."""
        full, win = fn(x), fn(x.narrow(axis, a, W).contiguous())
        lo, n = margin, W * scale - 2 * margin
        f, w = full.narrow(axis, a * scale + lo, n), win.narrow(axis, lo, n)
        return {"differ": int((f != w).sum()), "of": f.numel(),
                "max_abs_diff": (f.float() - w.float()).abs().max().item()}

    out = {}
    with torch.inference_mode():
        for prec, eng in (("bf16", e16), ("f32", e32)):
            g = eng._meldec.generator
            dt = next(g.parameters()).dtype
            mel = torch.randn(1, g.conv_pre.in_channels, bucket, generator=gen).to(dev, dt)
            c0 = g.ups[0].in_channels
            h = torch.randn(1, c0, bucket, generator=gen).to(dev, dt)
            h0 = torch.randn(1, c0 // 2, bucket * s0, generator=gen).to(dev, dt)
            out[f"cudnn_{prec}"] = {
                "conv_pre": rows(g.conv_pre, mel, 2, 1, 8),
                "ups0": rows(g.ups[0], h, 2, s0, 2 * k0),
                "stage0_conv": rows(g.resblocks[0].convs1[0], h0, 2, 1, 8)}
        C = hcfg.upsample_initial_channel // 4
        T1 = bucket * s0 * hcfg.upsample_rates[1]
        x = torch.randn(1, T1, C, generator=gen).to(dev).bfloat16()
        ks, dils = tuple(hcfg.resblock_kernel_sizes), tuple(hcfg.resblock_dilation_sizes[0])
        towers = [tuple(t.bfloat16() for t in tw)
                  for tw in random_towers(torch, gen, C, ks, len(dils), dev)]
        halo = max((k - 1) // 2 * sum(d + 1 for d in dils) for k in ks)
        scale = T1 // bucket
        packed = pack_towers(towers)
        label = "fused_mrf_bf16" if len(ks) > 1 else "fused_resblock1_bf16"

        def kernel(frames):
            """The kernel over rows of x grouped `scale` to a frame."""
            t = frames.reshape(1, -1, C)
            y = (fused_mrf(t, packed, dils, ks) if len(ks) > 1
                 else fused_resblock1(t, *towers[0], dils, packed=packed))
            return y.reshape(1, -1, scale * C)

        # one frame of margin a side: more rows than the receptive field's halo
        check(halo <= scale, f"{name}: kernel halo {halo} rows over one frame ({scale} rows)")
        kern = rows(kernel, x.reshape(1, bucket, scale * C), 1, 1, 1)
        del x, towers, packed
    out[label] = kern
    print(f"{name}: window against whole, on the card: {out}")
    check(kern["differ"] == 0, f"{name}: {label} over a window differs from over the whole: {kern}")
    return out


def time_engine(torch, engine, spk, dur, spks, durs, sr: int) -> dict:
    """Stage times at the path's bucket (CUDA events), RTF over 25 tts_ex
    after 10 warm-up, first-chunk p50 over 15 tts_stream after 4, and
    tts_batch at B=4 (forced durations)."""
    from zerovox_tpu_torch.synthesize import MEL_BUCKETS, pick_bucket
    from zerovox_tpu_torch.utils.profiling import RtfStats, cuda_time_ms

    ids, puncts = engine.text2phonemeids(TEXT)
    bucket = pick_bucket(int(dur.sum()), MEL_BUCKETS)
    enc, _, _ = engine._encode(ids, puncts, spk, dur)
    mel_b = engine._decode(enc, spk, bucket)
    stages = {
        "encode": cuda_time_ms(lambda: engine._encode(ids, puncts, spk, dur), iters=10),
        "decode": cuda_time_ms(lambda: engine._decode(enc, spk, bucket), iters=10),
        "vocode": cuda_time_ms(lambda: engine._vocode(mel_b), iters=10),
    }
    batch_ms = cuda_time_ms(lambda: engine.tts_batch(list(BATCH_TEXTS), spks, durations=durs),
                            iters=3, warmup=1)
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
        lat.add(w.shape[0] / sr, time.perf_counter() - t0, first_chunk_s=first)
    return {"rtf": stats.mean_rtf, "first_chunk_p50_ms": lat.p50_first_chunk_ms,
            "stage_ms": stages, "tts_batch_b4_ms": batch_ms}


def bf16_path(torch, name, cfg, hcfg, per_call: dict, refwav, sr: int, card: str,
              profile_dir) -> dict:
    """One path of phase 15 (see the module docstring); per_call: the bf16
    kernels' launches a tts_ex. With profile_dir, torch.profiler splits of
    the float32 and the bf16 tts_ex."""
    import numpy as np

    from zerovox_tpu_torch.synthesize import (MEL_BUCKETS, VOCODER_ALL_BATCHES, ZeroVoxTTS,
                                              pick_bucket)

    engines = {p: ZeroVoxTTS.from_random(cfg, hcfg, seed=0, precision=p) for p in ("f32", "bf16")}
    e16, e32 = engines["bf16"], engines["f32"]
    hop = cfg.audio.hop_size
    ids = e16.text2phonemeids(TEXT)[0]
    dur = np.full(len(ids), FRAMES_PER_PHONE, dtype=np.int32)
    n_frames = int(dur.sum())
    rng = np.random.default_rng(15)
    spk_wavs = [refwav] + [rng.normal(size=2 * sr).astype(np.float32) * s for s in (0.05, 0.2, 0.3)]

    zero_counts()
    spk = e16.speaker_embed(refwav)
    wav, _, n, mel = e16.tts_ex(TEXT, spk, duration=dur)
    torch.cuda.synchronize()
    after_ex = kernel_counts()
    chunks = list(e16.tts_stream(TEXT, spk, duration=dur))
    torch.cuda.synchronize()
    after_stream = kernel_counts()
    durs, spks = batch_inputs(e16, spk_wavs)
    batch = e16.tts_batch(list(BATCH_TEXTS), spks, durations=durs)
    torch.cuda.synchronize()
    counts = kernel_counts()
    want_batch = {k: v if VOCODER_ALL_BATCHES or k.startswith("fused_upsample") else 0
                  for k, v in per_call.items()}
    print(f"{name} bf16 launches: tts_ex {after_ex}; speaker_embed + tts_ex + tts_stream "
          f"({len(chunks)} chunks) + tts_batch (B={len(batch)}) {counts}")
    for k in counts:
        check(after_ex[k] == per_call.get(k, 0),
              f"{name}: bf16 tts_ex launched {after_ex}, not {per_call}")
        check(after_stream[k] - after_ex[k] == len(chunks) * per_call.get(k, 0),
              f"{name}: bf16 tts_stream of {len(chunks)} windows launched {after_stream}")
        check(counts[k] - after_stream[k] == want_batch.get(k, 0),
              f"{name}: bf16 tts_batch at B=4 launched {counts}, not {want_batch}")
    check(spk.dtype == torch.bfloat16 and bool(torch.isfinite(spk.float()).all()),
          f"{name}: bf16 speaker embedding {spk.dtype}")
    check(n == n_frames and wav.shape == (n_frames * hop,) and wav.dtype == np.float32,
          f"{name}: bf16 wav {wav.shape} {wav.dtype}, {n} frames")
    check(bool(np.isfinite(wav).all()) and mel.dtype == np.float32 and bool(np.isfinite(mel).all()),
          f"{name}: non-finite bf16 wav or mel")
    streamed = np.concatenate(chunks)
    peak = float(np.max(np.abs(wav)))
    stream_err = float(np.max(np.abs(streamed - wav))) if streamed.shape == wav.shape else math.inf
    # a few bf16 steps of the peak, not 1e-4: cuDNN's bf16 convolutions (the
    # upsamplers, stage 0) give a few of a window's elements other bits than
    # the whole's, one bf16 step each, and later stages carry them; the bf16
    # kernels give none (window_dependence below; on the CPU the bf16 stream
    # is under one step of the peak, tests/test_torch_bf16_infer.py)
    stream_tol = max(STREAM_TOL * min(peak, 1.0),
                     BF16_STREAM_STEPS * bf16_step(torch.from_numpy(wav)))
    print(f"{name}: bf16 stream max abs diff {stream_err:.6g} (bound {stream_tol:.6g})")
    check(streamed.dtype == np.float32 and stream_err <= stream_tol,
          f"{name}: bf16 stream {streamed.shape} {streamed.dtype} differs from tts by {stream_err}")
    check_batch(batch, durs, hop, f"{name} bf16 tts_batch")
    windows = window_dependence(torch, name, e16, e32, hcfg, pick_bucket(n_frames, MEL_BUCKETS))

    # the card's float32 engine on the same weights (its own speaker embedding)
    spk32 = e32.speaker_embed(refwav)
    w32, _, _, _ = e32.tts_ex(TEXT, spk32, duration=dur)
    f32_err, peak32 = float(np.max(np.abs(wav - w32))), float(np.max(np.abs(w32)))
    # the short text on the card and on the CPU (plain versions), bf16 and float32
    sd, msd = e32.state_dicts()
    cpu16 = ZeroVoxTTS(cfg, sd, hcfg, msd, device="cpu", precision="bf16")
    d_short = np.full(len(e16.text2phonemeids(SHORT_TEXT)[0]), FRAMES_PER_PHONE, np.int32)
    short = {}
    for where, eng, s in (("card_bf16", e16, spk), ("card_f32", e32, spk32),
                          ("cpu_bf16", cpu16, spk.cpu()),
                          ("cpu_f32", ZeroVoxTTS(cfg, sd, hcfg, msd, device="cpu"), spk32.cpu())):
        short[where] = eng.tts(SHORT_TEXT, s, duration=d_short)[0]
        del eng
    check(len({w.shape for w in short.values()}) == 1,
          f"{name}: short-text shapes {[w.shape for w in short.values()]}")

    def gap(a, b):
        return float(np.max(np.abs(short[a] - short[b])))

    gaps = {"card_bf16-card_f32": gap("card_bf16", "card_f32"),
            "card_bf16-cpu_bf16": gap("card_bf16", "cpu_bf16"),
            "cpu_bf16-cpu_f32": gap("cpu_bf16", "cpu_f32"),
            "card_f32-cpu_f32": gap("card_f32", "cpu_f32")}
    peak_short = float(np.max(np.abs(short["cpu_f32"])))
    parts = bf16_stages(torch, name, e16, cpu16, spk, d_short)
    del cpu16
    # the whole engine: 5e-2 of the peak on the main path; on the StyleTTS
    # path half the peak (a silent or unrelated waveform fails), since its
    # decoder's bf16 InstanceNorms amplify rounding, in the JAX package too
    # (tests/test_torch_bf16_infer.py prints the JAX package's own bf16 -
    # float32 distance beside the port's); bf16_stages holds each stage
    check(peak32 > 0 and peak_short > 0, f"{name}: silent float32 waveform")
    if name == "main":
        tol_text, tol_short = (min(BF16_WAV_TOL, BF16_WAV_REL * p) for p in (peak32, peak_short))
    else:
        tol_text, tol_short = STYLETTS_BF16_REL * peak32, STYLETTS_BF16_REL * peak_short
    print(f"{name}: bf16 peak {peak:.6g}, stream diff {stream_err:.3g}; {TEXT[:20]}...: card bf16 "
          f"- card f32 {f32_err:.6g} (peak {peak32:.6g}, bound {tol_text:.6g}); "
          f"{SHORT_TEXT!r}: {gaps} (peak {peak_short:.6g}, bound {tol_short:.6g})")
    check(f32_err < tol_text, f"{name}: bf16 waveform {f32_err} from float32's, over {tol_text}")
    check(gaps["card_bf16-card_f32"] < tol_short and gaps["card_bf16-cpu_bf16"] < tol_short,
          f"{name}: short-text gaps {gaps} over {tol_short}")
    check(gaps["card_f32-cpu_f32"] < WAV_TOL * min(peak_short, 1.0),
          f"{name}: float32 card - cpu {gaps['card_f32-cpu_f32']} (peak {peak_short})")

    # bf16 and float32 in turns
    _, spks32 = batch_inputs(e32, spk_wavs)
    args = {"bf16": (spk, spks), "f32": (spk32, spks32)}
    turns = {"f32": [], "bf16": []}
    for prec in ("f32", "bf16", "bf16", "f32"):
        s, ss = args[prec]
        turns[prec].append(time_engine(torch, engines[prec], s, dur, ss, durs, sr))
    if profile_dir is not None:
        for prec in ("f32", "bf16"):
            s = args[prec][0]
            profile_calls(torch, lambda e=engines[prec], s=s: e.tts_ex(TEXT, s, duration=dur), 3,
                          profile_dir, f"{name}_path_{prec}")
    out = {"launches": counts, "per_tts_ex": after_ex, "wav_peak": peak,
           "card_bf16_minus_card_f32": f32_err, "card_f32_peak": peak32,
           "text_bound": tol_text, "short_text_gaps": gaps, "short_text_peak": peak_short,
           "short_text_bound": tol_short, "stages": parts, "stream_max_diff": stream_err,
           "stream_bound": stream_tol, "windows": windows, "turns": turns, "card": card}
    print(json.dumps({f"bf16_{name}": out}), flush=True)
    out["engine"], out["spk"] = e16, spk
    return out


def bf16_phase(torch, dev, card: str, refwav, sr: int, bucket: int, profile_dir) -> dict:
    """Phase 15: bf16 inference (see the module docstring); bucket: the main
    path's mel bucket."""
    import dataclasses as dc

    import numpy as np

    from zerovox_tpu_torch.config import ZeroVoxConfig
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.ops.mrf import fused_mrf, mrf_plain, pack_towers
    from zerovox_tpu_torch.ops.se_conv import se_conv_fwd, se_conv_fwd_bf16
    from zerovox_tpu_torch.serving import VoiceRegistry, make_server, serve_in_thread
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    base = ZeroVoxConfig()
    sty = dc.replace(base, model=dc.replace(
        base.model, decoder=dc.replace(base.model.decoder, kind="styletts")))
    res = {"styletts": bf16_path(torch, "styletts", sty, single_tower_hifigan(),
                                 {"fused_resblock1_bf16": 3}, refwav, sr, card, profile_dir)}
    res["styletts"].pop("engine"), res["styletts"].pop("spk")
    torch.cuda.empty_cache()
    main = bf16_path(torch, "main", base, HifiGanConfig(),
                     {"fused_mrf_bf16": 1, "fused_upsample_stage_bf16": 2}, refwav, sr, card,
                     profile_dir)
    res["main"] = main
    e16, spk = main.pop("engine"), main.pop("spk")

    # one POST /tts to the bf16 engine: random weights predict ~0 frames a
    # phone, so a duration bias of 1.5 (exp(1.5) - 1 ~ 3.5 frames) makes the
    # row audible; the direct tts_batch after it runs the same weights
    with torch.no_grad():
        e16._model._phoneme_encoder._variance_adaptor.duration_predictor.linear_layer.bias.fill_(1.5)
    voices = VoiceRegistry()
    voices.add("ref", spk)
    srv = make_server(e16, voices, port=0, max_batch=SERVE_BATCH, max_delay_ms=20)
    serve_in_thread(srv)
    host, port = srv.server_address[:2]
    try:
        zero_counts()
        status, body = _post(host, port, {"text": TEXT, "voice": "ref"})
        torch.cuda.synchronize()
        http_counts = kernel_counts()
    finally:
        srv.shutdown_serving()
    check(status == 200, f"bf16 /tts answered {status}: {body[:200]}")
    pcm = _wav_pcm(body)
    (direct, n), = e16.tts_batch([TEXT], voices.get("ref"))
    check(direct.dtype == np.float32 and n > 0 and pcm.shape == direct.shape,
          f"bf16 HTTP row {pcm.shape}, direct {direct.shape} {direct.dtype}, {n} frames")
    http_err = float(np.max(np.abs(pcm / 32767.0 - np.clip(direct, -1, 1))))
    check(http_err <= WAV_TOL + 1.0 / 32767, f"bf16 HTTP row differs by {http_err}")
    check(http_counts["fused_mrf_bf16"] >= 1 and http_counts["fused_upsample_stage_bf16"] >= 2
          and http_counts["fused_mrf"] == http_counts["fused_upsample_stage"] == 0,
          f"the bf16 server launched {http_counts}")
    res["http"] = {"frames": n, "max_row_err": http_err, "launches": http_counts}
    del e16, spk, main
    torch.cuda.empty_cache()

    # the bf16 K1 at B=4 (stage 1 at the main path's bucket) against its plain
    # stage, in turns; the route (VOCODER_ALL_BATCHES) is not changed here
    gen = torch.Generator().manual_seed(5678)
    hcfg = HifiGanConfig()
    ks, dils = tuple(hcfg.resblock_kernel_sizes), tuple(hcfg.resblock_dilation_sizes[0])
    T = bucket * hcfg.upsample_rates[0] * hcfg.upsample_rates[1]
    C = hcfg.upsample_initial_channel // 4
    x = torch.randn(4, T, C, generator=gen).to(dev).bfloat16()
    towers = [tuple(t.bfloat16() for t in tw) for tw in random_towers(torch, gen, C, ks, len(dils), dev)]
    packed = pack_towers(towers)
    ref = mrf_plain(x, towers, dils)
    err, step = (fused_mrf(x, packed, dils, ks).float() - ref.float()).abs().max(), bf16_step(ref)
    check(err.item() <= step, f"bf16 K1 at B=4: {err.item()} from plain, one step {step}")
    del ref
    turns = {"plain": [], "kernel": []}
    for label in ("plain", "kernel", "kernel", "plain"):
        fn = ((lambda: fused_mrf(x, packed, dils, ks)) if label == "kernel"
              else (lambda: mrf_plain(x, towers, dils)))
        turns[label].append(cuda_time_ms(fn, iters=5, warmup=1))
    res["k1_bf16_b4"] = {"shape": f"[4,{T},{C}]", "ms": turns, "max_abs_err": err.item()}
    del x, towers, packed

    # a fused-speaker model in bf16: stage 1 of the speaker encoder on the bf16 K4
    cfg = train_config(fused=True)
    spk_e = {p: ZeroVoxTTS.from_random(cfg, single_tower_hifigan(), seed=0, precision=p)
             for p in ("f32", "bf16")}
    zero_counts()
    s16 = spk_e["bf16"].speaker_embed(refwav)
    torch.cuda.synchronize()
    n16, n32 = se_conv_fwd_bf16.launches, se_conv_fwd.launches
    s32 = spk_e["f32"].speaker_embed(refwav)
    blocks = cfg.model.resnet.layers[0]
    spk_err = (s16.float() - s32).abs().max().item()
    check(n16 == 2 * blocks and n32 == 0,
          f"bf16 speaker_embed launched the bf16 K4 {n16}x and the float32 one {n32}x")
    check(bool(torch.isfinite(s16.float()).all()) and spk_err < BF16_WAV_TOL,
          f"bf16 fused speaker embedding {spk_err} from float32's")
    res["fused_speaker"] = {"k4_bf16_launches": n16, "max_abs_diff_f32": spk_err}
    del spk_e
    res["card"] = card
    print(json.dumps({"bf16_phase": {k: v for k, v in res.items() if k not in ("main", "styletts")}}),
          flush=True)
    return res


def hifigan_v2():
    """HiFi-GAN V2 (jik876/hifi-gan config_v2.json): 128 initial channels,
    rates 8,8,2,2, upsample kernels 16,16,4,4, ResBlock1 towers 3/7/11 x
    dilations 1,3,5. K1 runs stages 0 and 1 (C = 64, 32), K2 stages 2 and 3
    ((32, 16), and (16, 8) with conv_post)."""
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig

    return HifiGanConfig(resblock="1", upsample_rates=(8, 8, 2, 2),
                         upsample_kernel_sizes=(16, 16, 4, 4), upsample_initial_channel=128,
                         resblock_kernel_sizes=(3, 7, 11),
                         resblock_dilation_sizes=((1, 3, 5),) * 3)


def hifigan_v3():
    """HiFi-GAN V3 (jik876/hifi-gan config_v3.json): ResBlock2 towers 3/5/7 x
    dilations (1, 2), (2, 6), (3, 12) at 256 initial channels, rates 8,8,4
    (hop 256), upsample kernels 16,16,8. No kernel fuses ResBlock2 (the JAX
    package's `mrf_fusable` needs ResBlock1): every stage runs nn.Modules."""
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig

    return HifiGanConfig(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                         upsample_initial_channel=256, resblock_kernel_sizes=(3, 5, 7),
                         resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))


def tts_medium_tpu():
    """configs/tts_medium_tpu.yaml in code (the card's machine has no pyyaml):
    tts_medium with the punctuation embedding folded additively into the
    phone embedding (punct_emb_dim 0), so d_model is 512 and each of the two
    attention heads is 256 wide."""
    import dataclasses as dc

    from zerovox_tpu_torch.config import ZeroVoxConfig

    base = ZeroVoxConfig()
    return dc.replace(base, model=dc.replace(base.model, emb_dim=512, punct_emb_dim=0))


def single_tower_256():
    """One ResBlock1 tower (k 3, dilations 1,3,5) at 256 initial channels,
    rates 8,8,2,2: K3 runs all four stages (C = 128, 64, 32, 16)."""
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig

    return HifiGanConfig(resblock="1", upsample_initial_channel=256, upsample_rates=(8, 8, 2, 2),
                         upsample_kernel_sizes=(16, 16, 4, 4), resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3, 5),))


def widths_launched() -> dict:
    """Each of K1, K2, K3's launches (both dtypes) by the width it ran at
    (K2's as "CinxCout")."""
    from zerovox_tpu_torch.ops.mrf import fused_mrf
    from zerovox_tpu_torch.ops.resblock import fused_resblock1
    from zerovox_tpu_torch.ops.upsample_stage import fused_upsample_stage

    return {f.__name__: {"x".join(map(str, w)) if isinstance(w, tuple) else w: n
                         for w, n in f.launches_at.items()}
            for f in (fused_mrf, fused_upsample_stage, fused_resblock1)}


def narrow_path(torch, card: str, name: str, hcfg, want: dict, refwav, sr: int,
                profile_dir, cfg=None) -> dict:
    """One vocoder of phase 16 behind the default acoustic model (or `cfg`'s:
    phase 22's tts_medium_tpu) at full width (seed 0, bench.py's text with
    forced durations, bucket 689): speaker_embed (its [1, 1, d_model]
    embedding) -> tts_ex -> tts_stream with the launches by width read
    around it (`want`: each kernel's widths a tts_ex, once each; {}: none of
    K1-K5 in either precision); the
    engine's vocoder on the card against the same weights' nn.Modules on the
    card and the whole engine against the CPU (1e-3); RTF and first-chunk
    p50; then the same engine in bf16: its bf16 launches a tts_ex, and its
    waveform within min(5e-2, 5e-2 x peak) of the float32 engine's."""
    import numpy as np

    from zerovox_tpu_torch.config import ZeroVoxConfig
    from zerovox_tpu_torch.synthesize import MEL_BUCKETS, ZeroVoxTTS, pick_bucket
    from zerovox_tpu_torch.utils.profiling import RtfStats, cuda_time_ms

    cfg = ZeroVoxConfig() if cfg is None else cfg
    engine = ZeroVoxTTS.from_random(cfg, hcfg, seed=0)
    hop = cfg.audio.hop_size
    ids, puncts = engine.text2phonemeids(TEXT)
    dur = np.full(len(ids), FRAMES_PER_PHONE, dtype=np.int32)
    n_frames = int(dur.sum())
    bucket = pick_bucket(n_frames, MEL_BUCKETS)
    zero_counts()
    spk = engine.speaker_embed(refwav)
    wav, _, n, _ = engine.tts_ex(TEXT, spk, duration=dur)
    torch.cuda.synchronize()
    per_call = widths_launched()
    chunks = list(engine.tts_stream(TEXT, spk, duration=dur))
    torch.cuda.synchronize()
    counts, at = kernel_counts(), widths_launched()
    halo = hcfg.receptive_field_frames()
    print(f"{name}: launches by width: tts_ex {per_call}; + tts_stream ({len(chunks)} windows, "
          f"halo {halo} frames) {at}")
    check(tuple(spk.shape) == (1, 1, cfg.model.emb_size) and bool(torch.isfinite(spk).all()),
          f"{name}: speaker embedding {tuple(spk.shape)}, d_model {cfg.model.emb_size}")
    check({k: v for k, v in per_call.items() if v} == want,
          f"{name}: tts_ex launched {per_call}, not {want}")
    check(all(at[k] == {w: (1 + len(chunks)) * c for w, c in ws.items()} for k, ws in want.items()),
          f"{name}: tts_stream's {len(chunks)} windows launched {at}")
    check(all(v == 0 for k, v in counts.items() if k not in want),
          f"{name}: another kernel launched: {counts}")
    check(n == n_frames and wav.shape == (n_frames * hop,) and bool(np.isfinite(wav).all()),
          f"{name}: wav {wav.shape}, {n} frames, finite {bool(np.isfinite(wav).all())}")
    streamed = np.concatenate(chunks)
    stream_err = float(np.max(np.abs(streamed - wav)))
    peak = float(np.max(np.abs(wav)))
    check(streamed.shape == wav.shape and stream_err < STREAM_TOL * min(peak, 1.0),
          f"{name}: stream {streamed.shape} differs from tts by {stream_err}")

    # the vocoder's kernels against the same weights' nn.Modules, on the card
    enc, _, _ = engine._encode(ids, puncts, spk, dur)
    mel_b = engine._decode(enc, spk, bucket)
    gen = engine._meldec.generator
    w_kernels = engine._vocode(mel_b)
    gen.use_pallas = False
    try:
        w_modules = engine._vocode(mel_b)
        modules_ms = cuda_time_ms(lambda: engine._vocode(mel_b), iters=10)
    finally:
        gen.use_pallas = True
    vocode_ms = cuda_time_ms(lambda: engine._vocode(mel_b), iters=10)
    mod_err = (w_kernels - w_modules).abs().max().item()
    mod_peak = w_modules.abs().max().item()
    check(mod_err < WAV_TOL * min(mod_peak, 1.0),
          f"{name}: the kernels' waveform differs from the nn.Modules' by {mod_err}")

    # the same weights on the CPU (plain versions), on the short text
    sd, meldec_sd = engine.state_dicts()
    cpu = ZeroVoxTTS(cfg, sd, hcfg, meldec_sd, device="cpu")
    d_short = np.full(len(engine.text2phonemeids(SHORT_TEXT)[0]), FRAMES_PER_PHONE, np.int32)
    w_card, _, _ = engine.tts(SHORT_TEXT, spk, duration=d_short)
    w_cpu, _, _ = cpu.tts(SHORT_TEXT, spk.cpu(), duration=d_short)
    cpu_err, cpu_peak = float(np.max(np.abs(w_card - w_cpu))), float(np.max(np.abs(w_cpu)))
    check(w_card.shape == w_cpu.shape and cpu_peak > 0 and cpu_err < WAV_TOL * min(cpu_peak, 1.0),
          f"{name}: card differs from the CPU run by {cpu_err} (peak {cpu_peak})")
    del cpu

    stats = RtfStats(warmup=10)
    for _ in range(25):
        t0 = time.perf_counter()
        w, _, _, _ = engine.tts_ex(TEXT, spk, duration=dur)
        stats.add(w.shape[0] / sr, time.perf_counter() - t0)
    lat = RtfStats(warmup=4)
    for _ in range(15):
        t0 = time.perf_counter()
        g = engine.tts_stream(TEXT, spk, duration=dur)
        next(g)
        first = time.perf_counter() - t0
        for _ in g:
            pass
        lat.add(wav.shape[0] / sr, time.perf_counter() - t0, first_chunk_s=first)
    if profile_dir is not None:
        profile_calls(torch, lambda: engine.tts_ex(TEXT, spk, duration=dur), 3, profile_dir,
                      f"narrow_{name}")
    del engine
    torch.cuda.empty_cache()

    # bf16 inference on the same weights: the bf16 kernels at the same widths
    e16 = ZeroVoxTTS.from_random(cfg, hcfg, seed=0, precision="bf16")
    spk16 = e16.speaker_embed(refwav)
    zero_counts()
    w16, _, _, _ = e16.tts_ex(TEXT, spk16, duration=dur)
    torch.cuda.synchronize()
    counts16, at16 = kernel_counts(), widths_launched()
    check({k: v for k, v in at16.items() if v} == want and all(counts16[k] == 0 for k in want)
          and bool(np.isfinite(w16).all()) and w16.shape == wav.shape,
          f"{name} bf16: launches {counts16} {at16}, wav {w16.shape}")
    # held to the float32 engine of the same seed at phase 15's main-path
    # bound: the bf16 weights packed and padded at these widths, end to end
    bf16_err = float(np.max(np.abs(w16 - wav)))
    bf16_tol = min(BF16_WAV_TOL, BF16_WAV_REL * peak)
    print(f"{name} bf16: - float32 {bf16_err:.6g} (peak {peak:.6g}, bound {bf16_tol:.6g})")
    check(bf16_err < bf16_tol, f"{name} bf16: waveform {bf16_err} from float32's, over {bf16_tol}")
    del e16
    torch.cuda.empty_cache()
    out = {"vocoder": name, "d_model": cfg.model.emb_size, "halo_frames": halo,
           "bucket": bucket, "launches_per_tts_ex": per_call,
           "launches": counts, "launches_at": at, "stream_windows": len(chunks),
           "bf16_launches_per_tts_ex": counts16, "bf16_err": bf16_err, "bf16_bound": bf16_tol,
           "modules_err": mod_err, "modules_peak": mod_peak,
           "cpu_err": cpu_err, "cpu_peak": cpu_peak, "stream_err": stream_err,
           "vocode_ms": vocode_ms, "vocode_modules_ms": modules_ms, "rtf": stats.mean_rtf,
           "first_chunk_p50_ms": lat.p50_first_chunk_ms, "voice_s": wav.shape[0] / sr,
           "card": card}
    print(json.dumps({"narrow_path": out}), flush=True)
    return out


def narrow_phase(torch, card: str, refwav, sr: int, profile_dir) -> dict:
    """Phase 16: HiFi-GAN V2, the 256-channel single-tower vocoder, then
    HiFi-GAN V3 (ResBlock2: no kernel)."""
    v2 = narrow_path(torch, card, "hifigan_v2", hifigan_v2(),
                     {"fused_mrf": {64: 1, 32: 1},
                      "fused_upsample_stage": {"32x16": 1, "16x8": 1}}, refwav, sr, profile_dir)
    single = narrow_path(torch, card, "single_tower_256", single_tower_256(),
                         {"fused_resblock1": {128: 1, 64: 1, 32: 1, 16: 1}}, refwav, sr,
                         profile_dir)
    v3 = narrow_path(torch, card, "hifigan_v3", hifigan_v3(), {}, refwav, sr, profile_dir)
    return {"hifigan_v2": v2, "single_tower_256": single, "hifigan_v3": v3}


def write_vocoder_corpus(root: Path, n_items: int, seconds: float, seed: int = 0) -> None:
    """A preprocess dir for the vocoder trainer (`train.txt`, `wavs/`,
    `mel/`): harmonic tones with a glide, an envelope and noise, their mels
    by the port's MelFrontend (22050 Hz, hop 256, 80 bins), from `seed`."""
    import numpy as np

    from zerovox_tpu_torch.dsp.audio import save_wav
    from zerovox_tpu_torch.dsp.mels import MelFrontend

    rng = np.random.default_rng(seed)
    frontend = MelFrontend(device="cpu")
    (root / "wavs").mkdir(parents=True)
    (root / "mel").mkdir()
    sr, lines = 22050, []
    for i in range(n_items):
        n = int(seconds * sr) // 256 * 256
        t = np.arange(n) / sr
        f0 = rng.uniform(90.0, 250.0) * (1.0 + 0.1 * t / seconds)
        phase = 2 * np.pi * np.cumsum(f0) / sr
        wav = sum(np.sin(h * phase + rng.uniform(0, 2 * np.pi)) / h for h in range(1, 9))
        wav = wav * np.sin(np.pi * t / seconds) ** 2 + 0.05 * rng.normal(size=n)
        wav = (0.5 * wav / np.max(np.abs(wav))).astype(np.float32)
        save_wav(root / "wavs" / f"v{i:03d}.wav", wav, sr)
        mel, _ = frontend(wav)
        np.save(root / "mel" / f"mel-v{i:03d}.npy", mel.T.numpy())
        lines.append(f"v{i:03d}.wav|x")
    (root / "train.txt").write_text("\n".join(lines) + "\n")


def gan_phase(torch, dev, card: str, refwav, profile_dir) -> dict:
    """Phase 17: vocoder GAN training (see the module docstring)."""
    import numpy as np

    from zerovox_tpu_torch.cli import train_vocoder
    from zerovox_tpu_torch.config import ZeroVoxConfig
    from zerovox_tpu_torch.dsp.griffinlim import GriffinLim
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.ops.pqmf import PQMF
    from zerovox_tpu_torch.synthesize import MEL_BUCKETS, ZeroVoxTTS, pick_bucket
    from zerovox_tpu_torch.training.checkpointing import save_native_checkpoint
    from zerovox_tpu_torch.training.vocoder import (VocoderDataConfig, VocoderDataset,
                                                    VocoderTrainer, VocoderTrainerConfig,
                                                    card_round_gap, to_device_batch)
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms
    from zerovox_tpu_torch.weights import to_jax_variables

    res: dict = {"card": card}
    BUILD.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        root = Path(tmp)
        pp = root / "pp"
        write_vocoder_corpus(pp, GAN_ITEMS, GAN_SECONDS)
        common = ["--data", str(pp), "--checkpoint-every-n-epochs", "1"]
        # resume and split are held to 1e-5: cuDNN picks deterministic algorithms
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            zero_counts()
            t0 = time.perf_counter()
            train_vocoder.main(common + ["--out-folder", str(root / "run"), "--max-epochs", "2"])
            torch.cuda.synchronize()
            res["fit_2_epochs_s"] = time.perf_counter() - t0
            check(all(v == 0 for v in kernel_counts().values()),
                  f"the GAN trainer launched a fused kernel: {kernel_counts()}")
            full = json.loads((root / "run" / "losses.json").read_text())
            check([r["epoch"] for r in full] == [0, 1]
                  and all(np.isfinite(v) for r in full for v in r.values()),
                  f"losses.json: {full}")
            ckpts = sorted(p.name for p in (root / "run" / "checkpoints").glob("*.pt"))
            check(ckpts == ["vocoder-0000.pt", "vocoder-0001.pt"]
                  and (root / "run" / "generator.msgpack").exists(), f"checkpoints {ckpts}")
            train_vocoder.main(common + ["--out-folder", str(root / "resumed"), "--max-epochs", "2",
                                         "--checkpoint",
                                         str(root / "run" / "checkpoints" / "vocoder-0000.pt")])
            again = json.loads((root / "resumed" / "losses.json").read_text())
            check([r["epoch"] for r in again] == [1], f"resumed losses.json: {again}")
            resume_rel = max(abs(again[0][k] - v) / max(abs(v), 1e-12)
                             for k, v in full[1].items() if k != "epoch")
            check(resume_rel < RESUME_RTOL,
                  f"resumed epoch 1 {again[0]} against the uninterrupted {full[1]}")
            res.update(losses=full, resume_max_rel=resume_rel)
            print(f"gan: 2 epochs x {GAN_ITEMS // GAN_BATCH} steps at batch {GAN_BATCH} in "
                  f"{res['fit_2_epochs_s']:.1f} s; losses {full}; resume max rel {resume_rel:.3g}")

            # the first round, fused against split and float32 against bf16-mixed
            gcfg, dcfg = HifiGanConfig(), VocoderDataConfig()
            batch = to_device_batch(next(VocoderDataset([str(pp)], dcfg, seed=1)
                                         .batches(GAN_BATCH)), dev)
            spe = GAN_ITEMS // GAN_BATCH

            def trainer(split=False, precision="32"):
                tr = VocoderTrainer(gcfg, dcfg, VocoderTrainerConfig(
                    batch_size=GAN_BATCH, split_step=split, precision=precision), spe)
                return tr, tr.init_state()

            firsts = {}
            for key, kw in (("fused", {}), ("split", {"split": True})):
                tr, st = trainer(**kw)
                firsts[key] = {k: float(v) for k, v in tr.train_step(st, batch).items()}
                del tr, st
            split_rel = max(abs(firsts["split"][k] - v) / max(abs(v), 1e-12)
                            for k, v in firsts["fused"].items())
            check(split_rel < RESUME_RTOL, f"split round {firsts['split']} against fused "
                  f"{firsts['fused']}")
            res.update(first_round=firsts["fused"], split_max_rel=split_rel)
        finally:
            torch.backends.cudnn.deterministic = deterministic

        tr32, st32 = trainer()
        tr16, st16 = trainer(precision="bf16-mixed")
        l32 = {k: float(v) for k, v in tr32.train_step(st32, batch).items()}
        l16 = [{k: float(v) for k, v in tr16.train_step(st16, batch).items()} for _ in range(3)]
        check(all(np.isfinite(v) for d in l16 for v in d.values()), f"bf16-mixed losses {l16}")
        mixed_rel = abs(l16[0]["g_total"] - l32["g_total"]) / abs(l32["g_total"])
        check(mixed_rel < MIXED_LOSS_RTOL,
              f"bf16-mixed first loss {l16[0]['g_total']} against float32 {l32['g_total']}")
        turns = {"32": [], "bf16-mixed": []}
        for _ in range(3):
            turns["32"].append(cuda_time_ms(lambda: tr32.train_step(st32, batch), iters=3,
                                            warmup=1))
            turns["bf16-mixed"].append(cuda_time_ms(lambda: tr16.train_step(st16, batch), iters=3,
                                                    warmup=1))
        res.update(bf16_losses=l16, bf16_first_rel=mixed_rel,
                   step_ms_turns=turns,
                   step_ms_median={k: statistics.median(v) for k, v in turns.items()})
        print(json.dumps({"gan_step_ms": res["step_ms_median"], "turns": turns,
                          "batch": GAN_BATCH, "card": card}), flush=True)
        if profile_dir is not None:
            res["profile"] = profile_calls(torch, lambda: tr32.train_step(st32, batch), 2,
                                           profile_dir, "gan_step")
        del tr32, st32, tr16, st16
        torch.cuda.empty_cache()
        res["bench"] = {p: train_vocoder.main(common + ["--out-folder", str(root / "bench"),
                                                        "--bench", "--bench-steps", "8",
                                                        "--precision", p])
                        for p in ("32", "bf16-mixed")}

        # one GAN round at small widths, the card against the CPU in float64
        # (card_round_gap; tests/test_torch_gpu.py holds it at other data)
        small = HifiGanConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3),))
        sdcfg = VocoderDataConfig(segment_frames=8)
        sb = next(VocoderDataset([str(pp)], sdcfg, seed=2).batches(2))
        loss_rel, grad_rel = card_round_gap(
            small, sdcfg, VocoderTrainerConfig(batch_size=2, mpd_periods=(2, 3), msd_scales=2),
            sb, seed=7, device=dev)
        check(loss_rel < STEP_LOSS_RTOL and grad_rel < STEP_GRAD_TOL,
              f"small GAN round: card against CPU losses {loss_rel}, gradients {grad_rel}")
        res.update(small_round_loss_rel=loss_rel, small_round_grad_rel=grad_rel)

        # PQMF and Griffin-Lim, the card against the CPU
        t = np.arange(22050) / 22050
        x = np.stack([np.sin(2 * np.pi * 440 * t), 0.3 * np.sin(2 * np.pi * 3100 * t)])
        x = torch.tensor(x, dtype=torch.float32)
        pq = PQMF(4)
        bands_cpu, bands_card = pq.analysis(x), pq.analysis(x.to(dev))
        syn_cpu, syn_card = pq.synthesis(bands_cpu), pq.synthesis(bands_card)
        pqmf_err = max(((a.cpu() - b).abs().max() / b.abs().max()).item()
                       for a, b in ((bands_card, bands_cpu), (syn_card, syn_cpu)))
        check(pqmf_err < 1e-5, f"PQMF card against CPU: {pqmf_err} of the max")
        frontend_mel = VocoderDataset([str(pp)], dcfg).items[0][0]  # [T, 80]
        gl_err = float(np.max(np.abs(GriffinLim(n_iter=2, device=dev)(frontend_mel)
                                     - GriffinLim(n_iter=2, device="cpu")(frontend_mel))))
        check(gl_err < 1e-4, f"Griffin-Lim (2 rounds) card against CPU: {gl_err}")
        gl32 = GriffinLim(n_iter=32)  # the card by default
        check(gl32.device.type == "cuda", f"GriffinLim's default device is {gl32.device}")
        mel_dev = torch.tensor(frontend_mel, device=dev)
        res.update(pqmf_rel=pqmf_err, griffinlim_2_err=gl_err,
                   griffinlim_32_ms=cuda_time_ms(lambda: gl32.invert(mel_dev), iters=5),
                   griffinlim_frames=frontend_mel.shape[0])
        t0 = time.perf_counter()
        GriffinLim(n_iter=32, device="cpu")(frontend_mel)
        res["griffinlim_32_cpu_ms"] = 1e3 * (time.perf_counter() - t0)

        # the trained generator as an engine's vocoder: K1 and K2 on the card
        cfg = ZeroVoxConfig()
        ckpt = root / "acoustic.msgpack"
        save_native_checkpoint(ckpt, to_jax_variables(
            ZeroVoxTTS.from_random(cfg, seed=0, device="cpu").state_dicts()[0], cfg))
        engine = ZeroVoxTTS.from_checkpoint(cfg, ckpt, meldec_model=str(root / "run"))
        ids, puncts = engine.text2phonemeids(TEXT)
        dur = np.full(len(ids), FRAMES_PER_PHONE, dtype=np.int32)
        zero_counts()
        spk = engine.speaker_embed(refwav)
        wav, _, n, _ = engine.tts_ex(TEXT, spk, duration=dur)
        torch.cuda.synchronize()
        at = widths_launched()
        want = {"fused_mrf": {128: 1}, "fused_upsample_stage": {"128x64": 1, "64x32": 1},
                "fused_resblock1": {}}
        check(at == want and bool(np.isfinite(wav).all()),
              f"trained vocoder's tts_ex launched {at}; finite {bool(np.isfinite(wav).all())}")
        mel_b = engine._decode(engine._encode(ids, puncts, spk, dur)[0], spk,
                               pick_bucket(int(dur.sum()), MEL_BUCKETS))
        w_k = engine._vocode(mel_b)
        engine._meldec.generator.use_pallas = False
        w_m = engine._vocode(mel_b)
        trained_err, trained_peak = (w_k - w_m).abs().max().item(), w_m.abs().max().item()
        check(trained_err < WAV_TOL * min(trained_peak, 1.0),
              f"trained vocoder: kernels against nn.Modules {trained_err} (peak {trained_peak})")
        res.update(trained_launches=at, trained_err=trained_err, trained_peak=trained_peak)
        del engine
    torch.cuda.empty_cache()
    print(json.dumps({"gan_phase": {k: v for k, v in res.items() if k != "losses"}}), flush=True)
    return res


def tone_texts(n: int, seed: int) -> list[str]:
    """n tone-speak transcripts of 3-5 words, drawn from a seeded rng."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(PP_WORDS, size=int(rng.integers(3, 6)))) for _ in range(n)]


def take_rows(batch: dict, k: int) -> dict:
    """The first k rows of a data-module batch dict (arrays and lists)."""
    return {key: (v[:k] if hasattr(v, "__len__") and not isinstance(v, str) else 0)
            for key, v in batch.items()}


def flat_paths(tree, prefix: str = "") -> list[str]:
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k in tree for p in flat_paths(tree[k], prefix + ("." if prefix else "") + str(k))]


def preprocess_phase(torch, dev, card: str) -> dict:
    """Phase 18: the native CTC library built with g++; a tone-speak corpus
    of PP_UTTS utterances (22050 Hz, seed 0); `cli.preprocess.run` with
    tts_medium's audio and model limits and --aligner tone on the card and
    again with --device cpu (the files equal, the floats within their
    bounds); durations against the synthesizer's; forced_align_torch on the
    card against the native Viterbi; `cli.stats.run`; Trainer.fit for 2
    steps at batch EXPORT_BATCH on phase 6's configuration over the corpus;
    `export_items` with the trained checkpoint's engine (V1, random weights
    from seed 12) and its K1/K2 launches, two items against a CPU engine's
    `export_batch`; `edit_meldec` add and remove (bitwise), `dump_ckpt`'s
    names against the converter's; stage times card and CPU."""
    import contextlib
    import dataclasses as dc
    import itertools

    import numpy as np

    from zerovox_tpu_torch import native
    from zerovox_tpu_torch.cli import dump_ckpt, edit_meldec
    from zerovox_tpu_torch.cli import preprocess as pcli
    from zerovox_tpu_torch.cli import stats as pstats
    from zerovox_tpu_torch.cli.export_hifigan import export_batch, export_items
    from zerovox_tpu_torch.config import ZeroVoxConfig
    from zerovox_tpu_torch.dsp.audio import load_wav
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig, MelDec
    from zerovox_tpu_torch.preprocess.ctc_align import forced_align, forced_align_torch
    from zerovox_tpu_torch.preprocess.tone_ctc import ToneCTCAligner
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS, random_init_
    from zerovox_tpu_torch.text.normalize import zerovox_normalize
    from zerovox_tpu_torch.training.checkpointing import (load_native_checkpoint,
                                                          save_native_checkpoint)
    from zerovox_tpu_torch.training.data import SpeechDataModule
    from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig
    from zerovox_tpu_torch.utils.synthvoice import char_duration, make_corpus
    from zerovox_tpu_torch.weights import (from_jax_variables, meldec_to_jax_variables,
                                           to_jax_variables)

    t_phase = time.perf_counter()
    found = native.lib_path("ctc_align").exists()
    t0 = time.perf_counter()
    lib = native.build("ctc_align")
    print(f"native ctc_align: {lib} "
          f"({'found built' if found else f'g++ {time.perf_counter() - t0:.2f} s'})")

    base = ZeroVoxConfig()  # configs/tts_medium.yaml
    modelcfg = {"audio": dc.asdict(base.audio),
                "model": {k: getattr(base.model, k) for k in
                          ("max_txt_len", "min_mel_len", "max_mel_len", "phones", "puncts")}}
    sr, hop = base.audio.sampling_rate, base.audio.hop_size
    out = {"card": card}
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        root = Path(tmp)
        texts = tone_texts(PP_UTTS, 0)
        make_corpus(root / "corpus", texts, sample_rate=sr, seed=0)
        cc = {"dataset": "LJSpeech", "language": "en",
              "path": {"corpus_path": str(root / "corpus"), "preprocessed_path": "tone"}}

        # ---- preprocessing on the card, then on the CPU, then on the card again:
        # the first run in the process pays cuDNN's and cuFFT's set-up and a cuFFT
        # plan per new length, the second finds them made
        runs, dirs = {}, {}
        for run in ("cuda", "cpu", "cuda_again"):
            device = run.removesuffix("_again")
            args = pcli.get_args(["modelcfg", "corpus", "--aligner", "tone", "-m", "0.5",
                                  "-b", str(PP_BATCH), "--device", device])
            with contextlib.redirect_stdout(io.StringIO()):
                runs[run] = pcli.run(args, modelcfg, [cc], base_path=str(root / run))
            dirs[run] = root / run / "tone"
            r = runs[run]
            out[f"preprocess_{run}"] = {
                "jobs": r["jobs"], "kept": r["kept"], "seconds": r["seconds"],
                "utterances_per_s": r["jobs"] / r["seconds"],
                "stage_ms_per_utterance": {k: 1e3 * v / r["jobs"]
                                           for k, v in r["stage_seconds"].items()}}
        card_dir, cpu_dir = dirs["cuda"], dirs["cpu"]
        kept = runs["cuda"]["kept"]
        check(kept >= PP_UTTS // 2 and kept == runs["cpu"]["kept"],
              f"kept {kept} of {PP_UTTS} on the card, {runs['cpu']['kept']} on the CPU")
        train_txt = (card_dir / "train.txt").read_text()
        check(train_txt == (cpu_dir / "train.txt").read_text(), "train.txt differs card vs CPU")
        check(train_txt == (dirs["cuda_again"] / "train.txt").read_text(),
              "train.txt differs between the card's two runs")
        bases = [os.path.splitext(ln.split("|")[0])[0] for ln in train_txt.splitlines() if ln]
        mel_err = energy_err = 0.0
        errors, per_utt = [], []
        for line, b in zip(train_txt.splitlines(), bases):
            for rel in (f"wavs/{b}.wav.txt", f"mel/startstop-{b}.json"):
                check((card_dir / rel).read_bytes() == (cpu_dir / rel).read_bytes(),
                      f"{rel} differs card vs CPU")
            for rel in (f"duration/duration-{b}.npy", f"pitch/pitch-{b}.npy"):
                check(np.array_equal(np.load(card_dir / rel), np.load(cpu_dir / rel)),
                      f"{rel} differs card vs CPU")
            m_card, m_cpu = (np.load(d / "mel" / f"mel-{b}.npy") for d in (card_dir, cpu_dir))
            check(m_card.shape == m_cpu.shape, f"mel-{b}: {m_card.shape} vs {m_cpu.shape}")
            mel_err = max(mel_err, float(np.max(np.abs(m_card - m_cpu))))
            e_card, e_cpu = (np.load(d / "energy" / f"energy-{b}.npy") for d in (card_dir, cpu_dir))
            energy_err = max(energy_err, float(np.max(np.abs(e_card - e_cpu) / np.abs(e_cpu))))
            dur = np.load(card_dir / "duration" / f"duration-{b}.npy")
            chars = [modelcfg["model"]["phones"][int(i)] for i in line.split("|")[1].split(",")]
            e = [abs(float(d) - char_duration(c) * sr / hop) for c, d in zip(chars[1:-1], dur[1:-1])]
            errors += e
            per_utt.append(float(np.mean(e)))
        check(mel_err <= PP_MEL_TOL, f"mels card vs CPU {mel_err} > {PP_MEL_TOL}")
        check(energy_err <= PP_ENERGY_RTOL, f"energies card vs CPU {energy_err} relative")
        align_mae = float(np.mean(errors))
        check(align_mae <= ALIGN_MAE_HOPS,
              f"durations off the synthesizer's by {align_mae} hops on average")
        s_card, s_cpu = (json.loads((d / "stats.json").read_text()) for d in (card_dir, cpu_dir))
        check(s_card["pitch"] == s_cpu["pitch"] and np.allclose(s_card["energy"], s_cpu["energy"],
                                                                 rtol=PP_ENERGY_RTOL, atol=0),
              f"stats.json card {s_card} vs CPU {s_cpu}")
        out.update({"kept": kept, "mel_max_abs_diff": mel_err,
                    "energy_max_rel_diff": energy_err, "duration_mae_hops": align_mae,
                    "duration_mae_hops_per_utterance_max": max(per_utt)})

        # ---- the tone CTC emissions card vs CPU, and the Viterbi on the card
        al_card, al_cpu = ToneCTCAligner(device=dev), ToneCTCAligner(device="cpu")
        wavs = [load_wav(root / "corpus" / "wavs" / f"tone{i:03d}.wav", target_sr=16000)[0]
                for i in range(PP_UTTS)]
        n = max(len(w) for w in wavs[:PP_BATCH])
        batch = np.stack([np.pad(w, (0, n - len(w))) for w in wavs[:PP_BATCH]])
        emit_err = float(np.max(np.abs(al_card.emissions(batch) - al_cpu.emissions(batch))))
        check(emit_err <= PP_EMIT_TOL, f"tone CTC emissions card vs CPU {emit_err}")
        d = al_card.dictionary
        differ, ms = 0, []
        for w, text in zip(wavs, texts):
            em = al_card.emissions_device(w[None])[0]
            targets = np.asarray([d[c] for word in zerovox_normalize(text, "en")[1].split(" ")
                                  for c in word], np.int64)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, _ = forced_align_torch(em, targets)
            tok = tok.cpu().numpy()
            ms.append(1e3 * (time.perf_counter() - t0))
            want, _ = forced_align(em.cpu().numpy(), targets)
            differ += int(not np.array_equal(tok, want))
        check(differ == 0, f"forced_align_torch on the card differs from the native path on "
                           f"{differ} of {len(wavs)} utterances")
        out.update({"emissions_max_abs_diff": emit_err,
                    "forced_align_torch_ms_per_utterance": float(np.median(ms))})

        # ---- stats
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            [st] = pstats.run(modelcfg, [("tone", [cc])], base=str(root / "cuda"))
        check(st["speakers"] == 1 and st["hours"] > 0, f"stats {st}")
        print(buf.getvalue().splitlines()[-1])
        out["stats"] = st

        # ---- 2 train steps at batch EXPORT_BATCH on phase 6's configuration
        stats = {"pitch_min": s_card["pitch"][0], "pitch_max": s_card["pitch"][1],
                 "energy_min": s_card["energy"][0], "energy_max": s_card["energy"][1]}
        cfg = train_config(fused=True)
        dm = SpeechDataModule([cc], cfg.symbols(), stats, batch_size=EXPORT_BATCH,
                              num_workers=4, seed=0, base_path=str(root / "cuda"))
        dm.prepare_data()
        tcfg = TrainerConfig(max_epochs=1, warmup_epochs=1, log_every_n_steps=1, seed=0,
                             out_folder=str(root / "model"))
        trainer = Trainer(cfg, tcfg, steps_per_epoch=2)
        losses = []
        inner = trainer.train_step
        trainer.train_step = lambda st, b: losses.append(inner(st, b)) or losses[-1]
        zero_counts()
        state = trainer.fit(lambda epoch: itertools.islice(dm.train_dataloader(epoch), 2),
                            trainer.init_state())
        k4 = k4_counts()
        losses = [{k: float(v) for k, v in step.items()} for step in losses]
        check(state.step == 2 and k4 == (12, 12), f"fit took {state.step} steps, K4 {k4}")
        check(all(np.isfinite(v) for step in losses for v in step.values()),
              f"non-finite losses {losses}")
        out.update({"train_losses": [step["loss"] for step in losses], "train_k4": list(k4)})
        del trainer, state
        torch.cuda.empty_cache()

        # ---- export on the card with the trained checkpoint, two items against the CPU
        ckpt = root / "model" / "checkpoints" / "0000.msgpack"
        hcfg = HifiGanConfig()
        md = MelDec(hcfg)
        random_init_(md, torch.Generator().manual_seed(12))
        meldec_dir = root / "meldec"
        meldec_dir.mkdir()
        (meldec_dir / "config.json").write_text(json.dumps(dc.asdict(hcfg)))
        save_native_checkpoint(meldec_dir / "generator.msgpack",
                               {"params": meldec_to_jax_variables(md.state_dict(), hcfg)["params"]["generator"]})
        gen = {k[len("generator."):]: v for k, v in md.state_dict().items()
               if k.startswith("generator.")}
        torch.save({"generator": gen}, meldec_dir / "generator.ckpt")
        engine = ZeroVoxTTS.from_checkpoint(cfg, ckpt, meldec_dir)
        exp_cfg = {**modelcfg, "stats": stats}
        n0 = kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        items = list(export_items([cc], exp_cfg, engine, batch_size=EXPORT_BATCH,
                                  num_workers=4, base_path=str(root / "cuda")))
        export_s = time.perf_counter() - t0
        n1 = kernel_counts()
        launched = {k: n1[k] - n0[k] for k in ("fused_mrf", "fused_upsample_stage")}
        n_batches = -(-kept // EXPORT_BATCH)
        check(len(items) == kept and {it.basename for it in items} == set(bases),
              f"exported {len(items)} items of {kept}")
        check(launched["fused_mrf"] == n_batches and launched["fused_upsample_stage"] == 2 * n_batches,
              f"the export launched {launched} over {n_batches} batches of {EXPORT_BATCH}")
        check(all(np.isfinite(it.synth_wav).all() and len(it.synth_wav) == it.mel.shape[0] * hop
                  for it in items), "non-finite or misshapen exported waveforms")

        cpu_engine = ZeroVoxTTS.from_checkpoint(cfg, ckpt, meldec_dir, device="cpu")
        dm_cpu = SpeechDataModule([cc], cfg.symbols(), stats, batch_size=EXPORT_BATCH,
                                  num_workers=4, base_path=str(root / "cuda"), drop_last=False)
        dm_cpu.prepare_data()
        x, y = next(iter(dm_cpu.train_dataloader()))
        by_name = {it.basename: it for it in items}
        wav_err = 0.0
        for it in export_batch(cpu_engine, take_rows(x, 2), take_rows(y, 2), hop):
            card_it = by_name[it.basename]
            check(card_it.synth_wav.shape == it.synth_wav.shape, f"{it.basename}: shapes differ")
            check(np.array_equal(card_it.orig_wav, it.orig_wav), f"{it.basename}: original wav")
            wav_err = max(wav_err, float(np.max(np.abs(card_it.synth_wav - it.synth_wav))))
        check(wav_err <= WAV_TOL, f"exported waveforms card vs CPU {wav_err}")
        out.update({"export_items": len(items), "export_s": export_s,
                    "export_items_per_s": len(items) / export_s, "export_launches": launched,
                    "export_cpu_max_abs_diff": wav_err})
        del engine, cpu_engine
        torch.cuda.empty_cache()

        # ---- checkpoint tools on the trained checkpoint
        edited = root / "edited.msgpack"
        shutil.copy(ckpt, edited)
        with contextlib.redirect_stdout(io.StringIO()):
            edit_meldec.main([str(edited), "--meldec", str(meldec_dir)])
        tree = load_native_checkpoint(edited)
        check("meldec" in tree and len(flat_paths(tree["meldec"])) > 10,
              "edit_meldec added no vocoder")
        with contextlib.redirect_stdout(io.StringIO()):
            edit_meldec.main([str(edited)])
        check(edited.read_bytes() == ckpt.read_bytes(),
              "edit_meldec add + remove did not give back the original bytes")
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            dump_ckpt.main([str(ckpt)])
        dumped = [ln.split("  ")[0] for ln in buf.getvalue().splitlines()]
        sd = from_jax_variables(load_native_checkpoint(ckpt), cfg)
        want = flat_paths(to_jax_variables(sd, cfg))
        n_sd = len([k for k in sd if not k.endswith("num_batches_tracked")])
        check(sorted(dumped) == sorted(want) and len(dumped) == n_sd,
              f"dump_ckpt lists {len(dumped)} names, the converter {len(want)} ({n_sd} tensors)")
        out["dump_ckpt_names"] = len(dumped)

    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"preprocessing": out}), flush=True)
    return out


@contextlib.contextmanager
def deterministic_algorithms(torch, on: bool):
    """Run-to-run bits (`on`), as K4's: cuDNN's deterministic algorithms and
    torch's (index_put_'s and the scatters' backward without atomics); off,
    the defaults the trainers run with."""
    before = torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before[0]
        torch.use_deterministic_algorithms(before[1], warn_only=True)


def nondeterminism_trace(torch, cfg, tcfg, batch, names: list) -> dict:
    """Two ungrouped trainers from one seed, DP_STEPS steps each, with the
    defaults the trainers run with (atomics allowed): for every step the
    losses' gap, the leaves whose gradients differ most (each gap over the
    model's largest gradient and over the leaf's own; and the leaves whose
    gap is largest against their own largest gradient), and after each
    optimizer step the leaves whose weights differ most, in units of the
    step's learning rate. Where two runs part, this names the leaf."""
    from zerovox_tpu_torch.training.trainer import Trainer

    runs = []
    for _ in range(2):
        tr = Trainer(cfg, tcfg, steps_per_epoch=1)
        st = tr.init_state()
        steps = []
        for _ in range(DP_STEPS):
            lr = tr.schedule(st.step)
            losses = tr.train_step(st, batch)
            steps.append(({k: float(v) for k, v in losses.items()},
                          [p.grad.clone() for p in st.model.parameters()],
                          [p.detach().clone() for p in st.model.parameters()], lr))
        runs.append(steps)
        del tr, st
    out = []
    for (la, ga, wa, lr), (lb, gb, wb, _) in zip(*runs):
        top = max(g.abs().max().item() for g in gb)
        gaps = [(n, (x - y).abs().max().item(), y.abs().max().item())
                for n, x, y in zip(names, ga, gb)]
        grad = sorted(gaps, key=lambda r: -r[1])[:5]
        by_leaf = sorted(gaps, key=lambda r: -r[1] / max(r[2], 1e-30))[:3]
        weight = sorted(((n, (x - y).abs().max().item()) for n, x, y in zip(names, wa, wb)),
                        key=lambda r: -r[1])[:5]
        out.append({
            "loss_rel": {k: abs(la[k] - v) / max(abs(v), 1e-30) for k, v in lb.items()},
            "grad_leaves_differing": sum(not torch.equal(x, y) for x, y in zip(ga, gb)),
            "grad_top": top,
            "grad_worst": [{"leaf": n, "gap_over_top": d / max(top, 1e-30),
                            "gap_over_leaf": d / max(m, 1e-30), "leaf_max": m}
                           for n, d, m in grad],
            "grad_worst_over_leaf": [{"leaf": n, "gap_over_leaf": d / max(m, 1e-30),
                                      "leaf_max": m, "gap_over_top": d / max(top, 1e-30)}
                                     for n, d, m in by_leaf],
            "weight_leaves_differing": sum(not torch.equal(x, y) for x, y in zip(wa, wb)),
            "lr": lr,
            "weight_worst_in_lr": [{"leaf": n, "gap": d / lr if lr else None} for n, d in weight]})
    del runs
    torch.cuda.empty_cache()
    return {"steps": out}


def dp_step_check(torch, cfg, mesh, batch, precision: str, profile_dir=None) -> dict:
    """Phase 19a for one precision: 2 steps of the trainer without a group,
    with the world-1 NCCL group (K4's launches read around them) and without
    again, each from the same seed's weights; every step's losses and
    gradients compared; then the step's time without and with the group,
    DP_TIME_ROUNDS rounds of turns (medians), and with `profile_dir` a
    device split of each."""
    from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    mixed = precision == "bf16-mixed"
    tcfg = TrainerConfig(max_epochs=1, warmup_epochs=1, seed=0, precision=precision,
                         optim_dtype="bf16" if mixed else "f32")
    fwd, bwd = ("se_conv_fwd_bf16", "se_conv_bwd_bf16") if mixed else ("se_conv_fwd", "se_conv_bwd")
    runs, k4 = {}, []
    for label, m in (("plain", None), ("group", mesh), ("plain_again", None)):
        tr = Trainer(cfg, tcfg, steps_per_epoch=1, mesh=m)
        st = tr.init_state()
        steps = []
        for _ in range(DP_STEPS):
            if label == "group":
                zero_counts()
            losses = tr.train_step(st, batch)
            steps.append(({k: v.clone() for k, v in losses.items()},
                          [p.grad.clone() for p in st.model.parameters()]))
            if label == "group":
                torch.cuda.synchronize()
                n = kernel_counts()
                k4.append([n[fwd], n[bwd]])
        runs[label] = (tr, st, steps)
    check(k4 == [[6, 6]] * DP_STEPS, f"{precision}: the grouped steps launched K4 {k4}, not 6 + 6 a step")

    names = [n for n, _ in runs["plain"][1].model.named_parameters()]

    def gaps(a, b) -> dict:
        """Losses relative to each; gradients relative to the model's
        largest (a per-tensor ratio is noise on the gradients that are zero
        up to rounding, such as the attention key biases')."""
        loss = max(abs(float(a[0][k]) - float(b[0][k])) / max(abs(float(b[0][k])), 1e-30)
                   for k in b[0])
        diffs = [(x - y).abs().max().item() for x, y in zip(a[1], b[1])]
        top = max(y.abs().max().item() for y in b[1])
        same = all(torch.equal(a[0][k], b[0][k]) for k in b[0]) and all(
            torch.equal(x, y) for x, y in zip(a[1], b[1]))
        worst = max(range(len(diffs)), key=diffs.__getitem__)
        return {"bitwise": same, "loss_rel": loss, "grad_rel": max(diffs) / max(top, 1e-30),
                "worst": names[worst] if diffs[worst] else None}

    plain = runs["plain"][2]
    group_gap = [gaps(g, p) for g, p in zip(runs["group"][2], plain)]
    control = [gaps(g, p) for g, p in zip(runs["plain_again"][2], plain)]
    print(json.dumps({"dp_step_gaps": {"precision": precision, "group_vs_plain": group_gap,
                                       "plain_vs_plain": control}}), flush=True)
    for i, (g, c) in enumerate(zip(group_gap, control)):
        check(g["bitwise"] or max(g["loss_rel"], g["grad_rel"]) <= DP_REL_TOL,
              f"{precision} step {i}: the grouped step differs from the ungrouped one by {g} "
              f"(the ungrouped step from itself: {c})")
    with deterministic_algorithms(torch, False):
        nondet = nondeterminism_trace(torch, cfg, tcfg, batch, names)
    print(json.dumps({"dp_nondeterministic": {"precision": precision, **nondet}}), flush=True)
    times = {"plain": [], "group": []}
    profiles = {}
    with deterministic_algorithms(torch, False):  # timed as the trainers run by default
        for label in ("plain", "group", "group", "plain") * DP_TIME_ROUNDS:
            tr, st, _ = runs[label]
            times[label].append(cuda_time_ms(lambda: tr.train_step(st, batch), iters=3,
                                             warmup=1))
        if profile_dir is not None:
            for label in ("plain", "group"):
                tr, st, _ = runs[label]
                profiles[label] = profile_calls(torch, lambda: tr.train_step(st, batch), 3,
                                                profile_dir, f"dp_step_{precision}_{label}")
    del runs
    torch.cuda.empty_cache()
    return {"k4_per_step": k4, "group_vs_plain": group_gap, "plain_vs_plain": control,
            "nondeterministic": nondet,
            "losses": [{k: float(v) for k, v in s[0].items()} for s in plain],
            "step_ms": times, "plain_ms": statistics.median(times["plain"]),
            "group_ms": statistics.median(times["group"]), "profiles": profiles}


def parallel_phase(torch, dev, card: str, refwav, sr: int, profile_dir=None) -> dict:
    """Phase 19: data parallelism on the card's one H100 (a world-1 NCCL
    group through a file store), tts_batch through a one-device serving
    mesh, the vocoder trainer's resume from the JAX trainer's .msgpack
    layout, and the kernel build cache in two child processes."""
    import numpy as np
    import torch.distributed as dist

    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.ops import _cuda
    from zerovox_tpu_torch.ops.mrf import fused_mrf
    from zerovox_tpu_torch.ops.upsample_stage import fused_upsample_stage
    from zerovox_tpu_torch.parallel.mesh import MeshConfig, initialize_distributed, make_mesh
    from zerovox_tpu_torch.synthesize import VOCODER_ALL_BATCHES, ZeroVoxTTS
    from zerovox_tpu_torch.training.data import SpeechDataModule
    from zerovox_tpu_torch.training.trainer import device_batch
    from zerovox_tpu_torch.training.vocoder import (VocoderDataConfig, VocoderTrainer,
                                                    VocoderTrainerConfig)
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    out = {"card": card}
    BUILD.mkdir(exist_ok=True)
    with deterministic_algorithms(torch, True):
        with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
            tmp = Path(tmp)
            # (a) the data-parallel step at phase 6's configuration, batch 24
            cfg = train_config(fused=True)
            write_corpus(tmp, "train", cfg.symbols(), cfg.audio.num_mels, TRAIN_BATCH, (80, 100),
                         seed=0)
            dm = SpeechDataModule([{"path": {"preprocessed_path": "train"}}], cfg.symbols(), STATS,
                                  batch_size=TRAIN_BATCH, num_workers=4, seed=0,
                                  base_path=str(tmp))
            dm.prepare_data()
            batch = device_batch(next(iter(dm.train_dataloader(0))), dev)
            initialize_distributed(coordinator_address=f"file://{tmp}/store", num_processes=1,
                                   process_id=0, device=dev)
            try:
                mesh = make_mesh(MeshConfig(data=1))
                check(mesh.group is not None and mesh.world == 1 and dist.get_backend() == "nccl",
                      f"the group: {dist.get_backend()}, world {mesh.world}")
                out["dp_step"] = {p: dp_step_check(torch, cfg, mesh, batch, p, profile_dir)
                                  for p in ("32", "bf16-mixed")}
            finally:
                dist.destroy_process_group()
            del batch, dm

            # (b) tts_batch at B=4 through a one-device serving mesh
            engine = ZeroVoxTTS.from_random(seed=0)
            sd, md = engine.state_dicts()
            meshed = ZeroVoxTTS(engine.cfg, sd, engine._meldec_cfg, md,
                                mesh=make_mesh(MeshConfig(data=1), devices=[dev]))
            rng = np.random.default_rng(9)
            spk_wavs = [refwav] + [rng.normal(size=2 * sr).astype(np.float32) * s
                                   for s in (0.05, 0.2, 0.3)]
            durs, spks = batch_inputs(engine, spk_wavs)
            zero_counts()
            rows = meshed.tts_batch(list(BATCH_TEXTS), spks, durations=durs)
            torch.cuda.synchronize()
            counts = kernel_counts()
            check_batch(rows, durs, engine.cfg.audio.hop_size, "mesh tts_batch")
            k1 = 1 if VOCODER_ALL_BATCHES else 0
            check(fused_upsample_stage.launches == 2 and fused_mrf.launches == k1
                  and counts["fused_resblock1"] == 0,
                  f"the mesh's tts_batch at B=4 launched {counts}, not K2 twice and K1 {k1}x")
            ref = engine.tts_batch(list(BATCH_TEXTS), spks, durations=durs)
            same = [n == m and np.array_equal(w, r) for (w, n), (r, m) in zip(rows, ref)]
            check(all(same), f"the mesh's rows differ from the engine's: bitwise {same}, max diff "
                             f"{max(float(np.abs(w - r).max()) for (w, _), (r, _) in zip(rows, ref))}")
            ms = {"engine": [], "mesh": []}
            with deterministic_algorithms(torch, False):
                for label, e in (("engine", engine), ("mesh", meshed), ("mesh", meshed),
                                 ("engine", engine)):
                    ms[label].append(cuda_time_ms(
                        lambda: e.tts_batch(list(BATCH_TEXTS), spks, durations=durs), iters=3,
                        warmup=1))
            if profile_dir is not None:
                for label, e in (("engine", engine), ("mesh", meshed)):
                    profile_calls(torch, lambda: e.tts_batch(list(BATCH_TEXTS), spks,
                                                             durations=durs),
                                  3, profile_dir, f"tts_batch_b4_{label}")
            out["serving_mesh"] = {"launches": {"fused_mrf": counts["fused_mrf"],
                                                "fused_upsample_stage":
                                                    counts["fused_upsample_stage"]},
                                   "bitwise_rows": same, "tts_batch_b4_ms": ms}
            del engine, meshed
            torch.cuda.empty_cache()

            # (c) the vocoder trainer resumed from the JAX trainer's .msgpack and from its .pt
            gcfg = HifiGanConfig(upsample_initial_channel=32)
            tcfg = VocoderTrainerConfig(batch_size=4, mpd_periods=(2, 3), msd_scales=2,
                                        out_folder=str(tmp / "voc"))
            vt = VocoderTrainer(gcfg, VocoderDataConfig(), tcfg, steps_per_epoch=1)
            g = torch.Generator().manual_seed(0)
            vbatch = {"mel": (torch.randn(4, 32, 80, generator=g) - 4.0).to(dev),
                      "wav": (torch.randn(4, 32 * 256, generator=g) * 0.1).to(dev)}
            st = vt.init_state()
            vt.train_step(st, vbatch)
            files = {"pt": vt.save_state(st, tcfg.out_folder, 0),
                     "msgpack": vt.save_jax_state(st, tcfg.out_folder, 0)}
            rounds = {}
            for kind, path in files.items():
                st2 = vt.init_state(torch.Generator().manual_seed(1))  # other weights, replaced
                check(vt.restore_state(st2, path) == 1, f"{kind}: not resumed at epoch 1")
                losses = vt.train_step(st2, vbatch)
                rounds[kind] = ({k: v.clone() for k, v in losses.items()},
                                [p.detach().clone() for net in (st2.gen, st2.mpd, st2.msd)
                                 for p in net.parameters()])
            (la, pa), (lb, pb) = rounds["msgpack"], rounds["pt"]
            resume_same = (all(torch.equal(la[k], lb[k]) for k in lb)
                           and all(torch.equal(a, b) for a, b in zip(pa, pb)))
            check(resume_same, "the .msgpack resume's round differs from the .pt resume's")
            out["vocoder_resume"] = {
                "bitwise": resume_same, "losses": {k: float(v) for k, v in la.items()},
                "msgpack_mb": os.path.getsize(files["msgpack"]) / 1e6,
                "pt_mb": os.path.getsize(files["pt"]) / 1e6}
            del vt, st, st2, rounds
            torch.cuda.empty_cache()

            # (d) the kernel build cache: two processes on one fresh directory
            code = ("import json; from zerovox_tpu_torch.ops import _cuda; "
                    "from zerovox_tpu_torch.utils import compile_cache as cc; "
                    "_cuda.ensure_built(); print(cc.format_cache_stats()); "
                    "print(json.dumps(cc.cache_stats()))")
            env = {**os.environ, "ZEROVOX_COMPILE_CACHE": str(tmp / "kernel_cache")}
            runs = []
            for _ in range(2):
                t0 = time.perf_counter()
                proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                                      capture_output=True, text=True, timeout=900)
                check(proc.returncode == 0, f"the compile-cache child failed: {proc.stderr[-2000:]}")
                line, stats = proc.stdout.strip().splitlines()[-2:]
                print(f"compile cache child {len(runs) + 1}: {line}", flush=True)
                runs.append({"line": line, "stats": json.loads(stats),
                             "wall_s": time.perf_counter() - t0})
            n = len(_cuda.SIGNATURES)
            first, second = runs[0]["stats"], runs[1]["stats"]
            check(first["misses"] == n and first["hits"] == 0 and first["backend_compile_sec"] > 0,
                  f"the first process: {runs[0]['line']}")
            check(second["hits"] == n and second["misses"] == 0 and second["saved_sec"] > 0,
                  f"the second process: {runs[1]['line']}")
            out["compile_cache"] = runs
    print(json.dumps({"parallel": out}), flush=True)
    return out


def split_emulation(torch, model, m: int) -> int:
    """The model axis's arithmetic in one process: every layer that
    `param_sharding_rules` splits computes its m blocks' products and
    concatenates them (column-parallel) or sums them in block order and
    then adds its bias (row-parallel), as the ranks and their all-reduces
    do; a block's input enters through one view node, so its gradient is
    the sum of the blocks' before it meets the input's other uses (the
    backward all-reduce). Attention's fc and the FFN's w_2 take their
    partner's blocks as they are (parallel/tensor.py's pairing). The
    parameters keep their objects and names. Returns the layers replaced."""
    import torch.nn as nn
    import torch.nn.functional as F

    from zerovox_tpu_torch.parallel.mesh import param_sharding_rules

    class Blocks(nn.Module):
        def __init__(self, layer, axis: int, split_input: bool):
            super().__init__()
            self.weight, self.bias = layer.weight, layer.bias
            self.axis, self.split_input = axis, split_input
            self.conv = ({"padding": layer.padding, "dilation": layer.dilation,
                          "stride": layer.stride} if isinstance(layer, nn.Conv1d) else None)

        def product(self, x, w, b):
            if self.conv is None:
                return F.linear(x, w, b)
            return F.conv1d(x.transpose(1, 2), w, b, **self.conv).transpose(1, 2)

        def forward(self, x):
            w = self.weight.to(x.dtype)
            b = None if self.bias is None else self.bias.to(x.dtype)
            if self.axis == 0:
                x = x.view_as(x)
                bs = [None] * m if b is None else b.chunk(m)
                return torch.cat([self.product(x, wi, bi) for wi, bi in zip(w.chunk(m, 0), bs)],
                                 dim=-1)
            if not self.split_input:
                x = x.view_as(x)
            n = x.shape[-1] // m
            y = None
            for i, wi in enumerate(w.chunk(m, 1)):
                p = self.product(x.narrow(-1, i * n, n), wi, None)
                y = p if y is None else y + p
            return y if b is None else y + b

    rules = param_sharding_rules(model, m)
    modules = dict(model.named_modules())
    for name, axis in rules.items():
        if axis is None:
            continue
        path = name.removesuffix(".weight")
        parent_name, _, child = path.rpartition(".")
        parent = modules[parent_name]
        fed = ((child == "w_2" and hasattr(parent, "w_1"))
               or (child == "fc" and hasattr(parent, "w_vs") and parent.n_head % m == 0))
        parent._modules[child] = Blocks(modules[path], axis, fed)
    return sum(a is not None for a in rules.values())


def tp_gaps(torch, a: dict, b: dict) -> dict:
    """Step `a` against step `b` from the same state: losses relative to
    each; gradients relative to the model's largest; weights relative to
    the largest weight over the elements whose gradient in `b` is above
    DP_REL_TOL of the largest (below it Adam's update, g / (sqrt(nu) +
    eps), takes the sign of rounding), and the largest gap anywhere in
    units of the step's learning rate; running statistics relative to each
    buffer's largest value."""
    loss = max(abs(a["losses"][k] - v) / max(abs(v), 1e-30) for k, v in b["losses"].items())
    top = max(v.abs().max().item() for v in b["grads"].values())
    grad = {n: (a["grads"][n] - v).abs().max().item() for n, v in b["grads"].items()}
    wtop = max(v.abs().max().item() for v in b["weights"].values())
    weight, anywhere, undetermined = {}, 0.0, 0
    for n, v in b["weights"].items():
        d = (a["weights"][n] - v).abs()
        determined = b["grads"][n].abs() > DP_REL_TOL * top
        undetermined += int((~determined).sum())
        anywhere = max(anywhere, d.max().item())
        weight[n] = (d * determined).max().item()
    bn = {n: (a["buffers"][n] - v).abs().max().item() / max(v.abs().max().item(), 1e-30)
          for n, v in b["buffers"].items()}
    worst, wworst, bworst = max(grad, key=grad.get), max(weight, key=weight.get), max(bn, key=bn.get)
    same = (all(a["losses"][k] == v for k, v in b["losses"].items())
            and all(torch.equal(a["grads"][n], v) for n, v in b["grads"].items())
            and all(torch.equal(a["weights"][n], v) for n, v in b["weights"].items()))
    return {"bitwise": same, "loss_rel": loss, "grad_rel": grad[worst] / max(top, 1e-30),
            "grad_worst": worst, "weight_rel": weight[wworst] / max(wtop, 1e-30),
            "weight_worst": wworst, "weight_anywhere_in_lr": anywhere / b["lr"],
            "undetermined_elements": undetermined, "bn_rel": bn[bworst], "bn_worst": bworst}


def tp_dist(a: dict, b: dict, names: list) -> float:
    """||a - b|| / ||b|| over the named gradients."""
    num = sum(float(((a[n] - b[n]) ** 2).sum()) for n in names)
    return (num / max(sum(float((b[n] ** 2).sum()) for n in names), 1e-30)) ** 0.5


def tp_rank(rank: int, host_batch, out_dir: str, mesh) -> None:
    """Phase 20 on one of the two ranks of the 1 x 2 mesh (see
    tensor_parallel_phase); rank 0 also runs the one-process references,
    each step restored from the 1 x 2 run's train state before it (written
    whole by `save_train_state`), so every step is compared from one
    state. Writes out_dir/tp{rank}.json."""
    import torch
    import torch.distributed as dist

    from zerovox_tpu_torch.device import use_full_f32
    from zerovox_tpu_torch.models.zerovox import ZeroVox
    from zerovox_tpu_torch.parallel.mesh import param_sharding_rules
    from zerovox_tpu_torch.parallel.tensor import gather_shards, sharded_axes
    from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig, device_batch
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    use_full_f32()
    dev = mesh.devices[0]
    cfg = train_config(fused=True)
    batch = device_batch(host_batch, dev)
    state_file = os.path.join(out_dir, "tp_state.pt")
    out = {"rank": rank, "coords": [mesh.data_index, mesh.model_index],
           "backend": dist.get_backend(), "device": str(dev)}
    with torch.device("meta"):
        whole = ZeroVox(cfg)
    rule = param_sharding_rules(whole, 2)
    n_whole = sum(p.numel() for p in whole.parameters())
    n_split = sum(p.numel() for n, p in whole.named_parameters() if rule[n] is not None)
    n_bias = sum(whole.get_submodule(n.removesuffix(".weight")).bias.numel()
                 for n, a in rule.items() if a == 0)
    del whole

    def trainer(precision, on_mesh=False):
        tr = Trainer(cfg, TrainerConfig(max_epochs=1, warmup_epochs=1, seed=0,
                                        precision=precision),
                     steps_per_epoch=1, device=None if on_mesh else dev,
                     mesh=mesh if on_mesh else None)
        return tr, tr.init_state()

    def record(tr, st, losses, lr) -> dict:
        """The step's losses and running statistics, and its gradients and
        weights gathered whole, on the host."""
        names = [n for n, _ in st.model.named_parameters()]
        params = [p for _, p in st.model.named_parameters()]
        grads, weights = [p.grad for p in params], [p.detach() for p in params]
        if tr.tensor_parallel:
            axes = sharded_axes(st.model)
            ax = [axes.get(n) for n in names]
            grads, weights = gather_shards(grads, ax, mesh), gather_shards(weights, ax, mesh)

        def host(ts):
            return {n: t.to("cpu", torch.float32, copy=True) for n, t in ts}

        return {"losses": {k: float(v) for k, v in losses.items()}, "lr": lr,
                "grads": host(zip(names, grads)), "weights": host(zip(names, weights)),
                "buffers": host((n, b) for n, b in st.model.named_buffers() if "running" in n)}

    for precision in ("32", "bf16-mixed"):
        mixed = precision == "bf16-mixed"
        fwd, bwd = (("se_conv_fwd_bf16", "se_conv_bwd_bf16") if mixed
                    else ("se_conv_fwd", "se_conv_bwd"))
        res = {}
        t0 = time.perf_counter()
        # (b)-(d) under the trainers' default algorithms: K4's launches and
        # the replicated parameters, both ranks, each step; the peak memory
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr, st = trainer(precision, on_mesh=True)
        res["elements"] = {"whole": n_whole, "rule_split": n_split, "column_biases": n_bias,
                           "expected": n_whole - n_split // 2 - n_bias // 2,
                           "held": sum(p.numel() for p in st.model.parameters())}
        axes = sharded_axes(st.model)
        k4, equal = [], []
        for _ in range(TP_STEPS):
            zero_counts()
            tr.train_step(st, batch)
            torch.cuda.synchronize()
            n = kernel_counts()
            k4.append([n[fwd], n[bwd]])
            flat = torch.cat([p.detach().reshape(-1) for n, p in st.model.named_parameters()
                              if n not in axes])
            theirs = flat.clone()
            dist.broadcast(theirs, src=dist.get_global_rank(mesh.group, 1), group=mesh.group)
            same = torch.tensor([float(torch.equal(flat, theirs))], device=dev)
            dist.all_reduce(same, op=dist.ReduceOp.MIN)
            equal.append(bool(same.item()))
        res.update(k4_per_step=k4, replicated_bitwise_default_algorithms=equal,
                   replicated_elements=int(flat.numel()),
                   peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
        del flat, theirs
        # the step's ms in turns: the 1 x 2 step (both ranks, warm) and one
        # process's data-only step (rank 0 alone after one warm-up step;
        # rank 1 at a barrier)
        one = trainer(precision) if rank == 0 else None
        if rank == 0:
            one[0].train_step(one[1], batch)
        times = {"tp": [], "plain": []}
        for label in ("tp", "plain", "plain", "tp"):
            if label == "tp":
                ms = cuda_time_ms(lambda: tr.train_step(st, batch), iters=1, warmup=0)
            else:
                ms = (cuda_time_ms(lambda: one[0].train_step(one[1], batch), iters=1, warmup=0)
                      if rank == 0 else None)
                dist.barrier()
            times[label].append(ms)
        if rank == 0:
            res.update(step_ms=times, tp_ms=statistics.median(times["tp"]),
                       plain_ms=statistics.median(times["plain"]))
        del tr, st, one
        torch.cuda.empty_cache()
        t1 = time.perf_counter()

        # (a) deterministic algorithms: each 1 x 2 step against one process's
        # data-only step and its split emulation from the same state (and,
        # in bf16-mixed, a float32 step from it: bf16's own distance)
        with deterministic_algorithms(torch, True):
            tr, st = trainer(precision, on_mesh=True)
            refs = {}
            if rank == 0:
                refs = {"plain": trainer(precision), "emulated": trainer(precision)}
                if mixed:
                    refs["plain32"] = trainer("32")
                res["emulated_layers"] = split_emulation(torch, refs["emulated"][1].model, 2)
            steps = []
            for _ in range(TP_STEPS):
                tr.save_train_state(st, state_file, 0)  # gathered whole; rank 0 writes
                dist.barrier()
                lr = tr.schedule(st.step)
                rec = {"tp": record(tr, st, tr.train_step(st, batch), lr)}
                if rank == 0:
                    for label, (rt, rs) in refs.items():
                        rt.restore_train_state(rs, state_file)
                        rec[label] = record(rt, rs, rt.train_step(rs, batch), lr)
                    got = {"tp_vs_plain": tp_gaps(torch, rec["tp"], rec["plain"]),
                           "emulated_vs_plain": tp_gaps(torch, rec["emulated"], rec["plain"]),
                           "tp_vs_emulated": tp_gaps(torch, rec["tp"], rec["emulated"]),
                           "losses": rec["tp"]["losses"], "plain_losses": rec["plain"]["losses"]}
                    if mixed:  # the CPU test's bf16 measures (tests/test_torch_parallel.py)
                        names = list(rec["plain"]["grads"])
                        spk = [n for n in names if n.startswith("_spkemb.")]
                        for key, group in (("grad_spk", spk),
                                           ("grad_rest", [n for n in names if n not in spk])):
                            got[key] = {"tp": tp_dist(rec["tp"]["grads"], rec["plain"]["grads"],
                                                      group),
                                        "bf16_vs_f32": tp_dist(rec["plain"]["grads"],
                                                               rec["plain32"]["grads"], group)}
                        got["bf16_vs_f32"] = tp_gaps(torch, rec["plain"], rec["plain32"])
                    steps.append(got)
                del rec
                dist.barrier()
            res["steps"] = steps
            res["seconds"] = {"default_algorithms": t1 - t0,
                              "deterministic": time.perf_counter() - t1}
            del tr, st, refs
            torch.cuda.empty_cache()
        out[precision] = res
        dist.barrier()
    with open(os.path.join(out_dir, f"tp{rank}.json"), "w") as f:
        json.dump(out, f)


def tensor_parallel_phase(torch, dev, card: str) -> dict:
    """Phase 20: the data x model mesh on the card's one H100, as two gloo
    ranks on cuda:0 forming a 1 x 2 mesh (NCCL refuses two ranks on one
    device): phase 6's configuration and batch, TP_STEPS steps in float32
    and in bf16-mixed. See the module docstring."""
    from zerovox_tpu_torch.parallel.mesh import MeshConfig, indexed_device, spawn
    from zerovox_tpu_torch.training.data import SpeechDataModule

    BUILD.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    dev = indexed_device(dev)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        tmp = Path(tmp)
        cfg = train_config(fused=True)
        write_corpus(tmp, "train", cfg.symbols(), cfg.audio.num_mels, TRAIN_BATCH, (80, 100),
                     seed=0)
        dm = SpeechDataModule([{"path": {"preprocessed_path": "train"}}], cfg.symbols(), STATS,
                              batch_size=TRAIN_BATCH, num_workers=0, seed=0, base_path=str(tmp))
        dm.prepare_data()
        host_batch = next(iter(dm.train_dataloader(0)))
        torch.cuda.empty_cache()
        try:
            spawn(tp_rank, 2, host_batch, str(tmp), devices=[str(dev)] * 2, backend="gloo",
                  mesh=MeshConfig(data=1, model=2))
        except Exception as e:  # a rank raised: its traceback is in the message
            fail(f"the tensor-parallel ranks failed: {str(e)[-3000:]}")
        ranks = [json.loads((tmp / f"tp{r}.json").read_text()) for r in range(2)]
    out = {"card": card, "ranks": ranks, "phase_s": time.perf_counter() - t0,
           "note": "two ranks share one card: the step ms are no speed result"}
    print(json.dumps({"tensor_parallel": out}), flush=True)
    check([r["coords"] for r in ranks] == [[0, 0], [0, 1]] and all(
        r["backend"] == "gloo" and r["device"] == str(dev) for r in ranks),
        f"the ranks: {[(r['coords'], r['backend'], r['device']) for r in ranks]}")
    for precision in ("32", "bf16-mixed"):
        r0, r1 = ranks[0][precision], ranks[1][precision]
        for r in (r0, r1):
            check(r["k4_per_step"] == [[6, 6]] * TP_STEPS,
                  f"{precision}: a rank launched K4 {r['k4_per_step']}, not 6 + 6 a step")
            e = r["elements"]
            check(e["held"] == e["expected"],
                  f"{precision}: a rank holds {e['held']} parameter elements, its rule gives {e}")
            check(all(r["replicated_bitwise_default_algorithms"]),
                  f"{precision}: the replicated parameters part across the ranks under the "
                  f"default algorithms: {r['replicated_bitwise_default_algorithms']}")
        e = r0["elements"]
        print(f"tensor parallel {precision}: each rank holds {e['held']:,} of {e['whole']:,} "
              f"parameter elements ({e['held'] / e['whole']:.1%}); peak {r0['peak_mib']:.0f} / "
              f"{r1['peak_mib']:.0f} MiB; step {r0['tp_ms']:.1f} ms on the 1 x 2 mesh against "
              f"{r0['plain_ms']:.1f} ms in one process (two ranks share the card: no speed "
              f"result); {card}", flush=True)
        for i, st in enumerate(r0["steps"]):
            tp, em, same = st["tp_vs_plain"], st["emulated_vs_plain"], st["tp_vs_emulated"]
            if precision == "32":
                # against the one process that sums in the ranks' order: phase
                # 19's bound; against the data-only step: that bound widened to
                # what the reassociation itself measures
                for key in ("loss_rel", "grad_rel", "weight_rel"):
                    check(same["bitwise"] or same[key] <= DP_REL_TOL,
                          f"32 step {i}: the 1 x 2 step differs from its one-process "
                          f"emulation: {key} {same[key]} > {DP_REL_TOL} ({same})")
                    check(tp[key] <= max(DP_REL_TOL, 2 * em[key]),
                          f"32 step {i}: the 1 x 2 step differs from the data-only step: "
                          f"{key} {tp[key]}, the reassociation {em[key]} ({tp})")
                continue
            # the CPU test's bf16 bounds; the running statistics' 5e-2 widened
            # to 1.5 x bf16's own distance from float32 where that is larger,
            # as the gradient groups are held
            own = st["bf16_vs_f32"]["bn_rel"]
            check(tp["loss_rel"] <= MIXED_LOSS_RTOL
                  and tp["bn_rel"] <= max(MIXED_LOSS_RTOL, 1.5 * own),
                  f"bf16-mixed step {i}: losses {tp['loss_rel']}, running statistics "
                  f"{tp['bn_rel']} ({tp['bn_worst']}; bf16's own {own})")
            for k in ("grad_spk", "grad_rest"):
                check(st[k]["tp"] <= 1.5 * st[k]["bf16_vs_f32"],
                      f"bf16-mixed step {i}: {k} {st[k]['tp']} from the data-only step, over "
                      f"1.5 x the bf16 step's own distance from float32 {st[k]['bf16_vs_f32']}")
    return out


def set_attention(kind: str | None) -> None:
    """ZEROVOX_ATTN for the model's next forward: "flash", or None (unset:
    the einsum path)."""
    if kind is None:
        os.environ.pop("ZEROVOX_ATTN", None)
    else:
        os.environ["ZEROVOX_ATTN"] = kind


def k5_bytes(shape, esize: int, tensors: int, row_vectors: int) -> float:
    """Bytes K5 must move at [B, h, L, d]: `tensors` of the shape in and
    out, `row_vectors` float32 [B, h, L] (lse, D), the int32 segment ids."""
    B, h, L, d = shape
    return tensors * B * h * L * d * esize + row_vectors * B * h * L * 4 + B * L * 4


def sdpa_backend(torch, F, q, k, v, mask, scale) -> str:
    """The backend that scaled_dot_product_attention's default dispatch
    takes for these inputs: the first of flash, efficient, cuDNN and math
    whose forced output equals the default's bitwise ("unknown" if none)."""
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel
    except ImportError:
        return "unknown"
    ref = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    for backend in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"):
        if not hasattr(SDPBackend, backend):
            continue
        try:
            with sdpa_kernel([getattr(SDPBackend, backend)]):
                out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
        except RuntimeError:
            continue
        if torch.equal(out, ref):
            return backend.lower()
    return "unknown"


def k5_rows(torch, dev, shapes=K5_SHAPES, suffix: str = "", seed: int = 21,
            bwd_labels=("_train",)) -> list[dict]:
    """Phase 21's kernel rows (phase 22's with its `shapes` at d = 256,
    phase 23's at d = 132, 528, 280 and 1040; names ending in `suffix`):
    K5's forward at the serving decoder's, the training decoder's and the
    serving encoder's shapes, and its backward (dK/dV, dQ, both) at the
    shapes labelled in `bwd_labels` (the training shape), float32 and bf16,
    each against its plain version (the backward against autograd of the
    plain version), with scaled_dot_product_attention on the boolean segment
    mask timed beside it (or the error with which it refused the shape);
    the forward's rows carry its layout (query rows a block, key groups)
    and its kernel's registers and spill bytes, the whole backward's rows
    the SDPA backend that ran and its gradients' largest distance from
    plain's. A head dim that is not a multiple of 8 runs as the model runs
    it: zero-padded by `pad_head_dim` inside each timed call, outputs
    sliced back; a head dim above 272 runs the cluster kernels (rows with
    the cluster's ranks and parts, the bf16 ones also held to the float32
    kernel on the widened inputs) or the wide kernels, whose rows
    carry the work they do over the bound's (`recompute`) and their
    registers. Inputs from `seed`, views of [B, L, h, d] tensors as the model
    passes them; segment ids with per-row valid lengths from the seed."""
    import numpy as np
    import torch.nn.functional as F

    from zerovox_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(seed)
    rows: list[dict] = []

    def padded(kernel, d):
        """kernel on [B, h, L, d] tensors as flash_attention runs it: the
        tensor arguments padded, each output sliced back to d"""
        def run(*args):
            n = 6 if kernel is not fa.flash_fwd else 3  # q, k, v (, o, lse, do)
            ts = [a for a in args[:n] if a.dim() == 4]
            pads = iter(fa.pad_head_dim(*ts))
            args = [next(pads) if (i < n and a.dim() == 4) else a for i, a in enumerate(args)]
            out = kernel(*args)
            outs = out if isinstance(out, tuple) else (out,)
            outs = tuple(o[..., :d] if o.dim() == 4 else o for o in outs)
            return outs if isinstance(out, tuple) else outs[0]
        return run if d % fa.HEAD_DIM_MULTIPLE else kernel

    def library_or_refusal(lib):
        """(lib, {}) where SDPA takes the inputs, else (None, its refusal)"""
        try:
            lib()
            torch.cuda.synchronize()
            return lib, {}
        except RuntimeError as e:
            return None, {"library_refused": str(e).splitlines()[0][:200]}

    def inputs(shape):
        B, h, L, d = shape

        def t():
            x = rng.normal(size=(B, L, h, d)).astype(np.float32)
            return torch.from_numpy(x).to(dev).transpose(1, 2)

        n = rng.integers(L // 2, L + 1, size=B)
        n[0] = L
        seg = torch.from_numpy((np.arange(L)[None] >= n[:, None]).astype(np.int32)).to(dev)
        return t(), t(), t(), seg, t(), [int(v) for v in n]

    def grads_of(f, q, k, v, seg, scale, do):
        """(a function returning f's three gradients by autograd, its leaves)"""
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        o = f(qg, kg, vg, seg, scale)
        return lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True)

    for label, shape in shapes:
        B, h, L, d = shape
        q, k, v, seg, do, lengths = inputs(shape)
        scale = 1.0 / math.sqrt(d)
        mask = seg[:, None, :, None] == seg[:, None, None, :]
        paths = {dt: fa.head_dim_path(d, dt) for dt in (torch.float32, torch.bfloat16)}
        tuned = paths[torch.bfloat16]["path"] == "tuned"
        fwd, bwd_dkv, bwd_dq, bwd = (padded(f, d) for f in (fa.flash_fwd, fa.flash_bwd_dkv,
                                                             fa.flash_bwd_dq, fa.flash_bwd))

        def sdpa(q, k, v, seg, scale):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)

        def layout(dtype, part):
            path = paths[dtype]
            if path["path"] == "tuned":
                return {**fa.fwd_layout(B, h, L, dtype), **path} if part == "fwd" else path
            if path["path"] == "cluster":  # above 272: clusters splitting the head dim
                rows = fa.fwd_tile(B, h * path["ranks"], L)  # the rule over every block
                more = {"tile_rows": rows, "key_groups": fa.FWD_PAIRS // (rows // 16)} \
                    if part == "fwd" else {}
                regs = fa.cluster_registers(rows, dtype)[part] if part != "bwd" else {}
                return {**path, "recompute": path["recompute"][part], **more, **regs}
            regs = fa.wide_registers()[f"{part}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"] \
                if part != "bwd" else {}
            return {**path, "recompute": path["recompute"][part], **regs}

        fwd_flop = 4.0 * B * h * L * L * d
        for bf in (False, True):
            qx, kx, vx, dox = (x.to(torch.bfloat16) if bf else x for x in (q, k, v, do))
            name = f"flash_fwd{label}" + ("_bf16" if bf else "") + suffix
            extra = {**layout(qx.dtype, "fwd"), "valid_lengths": lengths[:4]}
            fn = lambda: fwd(qx, kx, vx, seg, scale)[0]  # noqa: E731
            plain = lambda: fa.flash_attention_plain(qx, kx, vx, seg, scale)  # noqa: E731
            lib, refused = library_or_refusal(lambda: sdpa(qx, kx, vx, seg, scale))
            extra.update(refused)
            nbytes = k5_bytes(shape, 2 if bf else 4, 4, 1)
            if bf:
                w = [x.float() for x in (qx, kx, vx)]
                f32 = lambda: fwd(*w, seg, scale)[0]  # noqa: E731
                measure_bf16(torch, rows, name, K5_SOURCE, K5_REPLACES["fwd"], list(shape), fn,
                             f32, plain, fwd_flop, nbytes, method="bf16", max_share=None,
                             steps=1, library=lib,
                             f32_ref=f32 if extra["path"] == "cluster" else None, **extra)
            else:
                measure(torch, rows, name, K5_SOURCE, K5_REPLACES["fwd"], list(shape), fn, plain,
                        fwd_flop, nbytes, method="3xtf32", library=lib, **extra)
            if label not in bwd_labels:
                continue
            # the backward at the training shape: each kernel and both
            o, lse = fwd(qx, kx, vx, seg, scale)
            plain_g = grads_of(fa.flash_attention_plain, qx, kx, vx, seg, scale, dox)
            lib_g, refused = library_or_refusal(grads_of(sdpa, qx, kx, vx, seg, scale, dox))
            yardstick = refused if lib_g is None else {
                "library_backend": sdpa_backend(torch, F, qx, kx, vx, mask, scale),
                "library_max_abs_err": max((a.float() - b.float()).abs().max().item()
                                           for a, b in zip(lib_g(), plain_g()))}
            tag = label if label != "_train" else ""
            for part, flop, tensors, kernel, pick in (
                    ("dkv", 8.0, 6, lambda: bwd_dkv(qx, kx, vx, o, lse, dox, seg, scale),
                     lambda g: g[1:]),
                    ("dq", 6.0, 5, lambda: (bwd_dq(qx, kx, vx, o, lse, dox, seg, scale),),
                     lambda g: g[:1]),
                    ("", 10.0, 7, lambda: bwd(qx, kx, vx, o, lse, dox, seg, scale),
                     lambda g: g)):
                name = ("flash_bwd" + (f"_{part}" if part else "") + tag + ("_bf16" if bf else "")
                        + suffix)
                fn = lambda kernel=kernel: torch.stack(kernel())  # noqa: E731
                plain = lambda pick=pick: torch.stack(pick(plain_g()))  # noqa: E731
                lib = lib_g if not part else None
                flop_b = flop * B * h * L * L * d
                nbytes = k5_bytes(shape, 2 if bf else 4, tensors, 2)
                more = {**layout(qx.dtype, part or "bwd"), **({} if part else yardstick)}
                if bf:
                    w = [x.float() for x in (qx, kx, vx, o, lse, dox)]
                    w[4] = lse
                    f32 = {"dkv": lambda: bwd_dkv(*w, seg, scale),
                           "dq": lambda: (bwd_dq(*w, seg, scale),),
                           "": lambda: bwd(*w, seg, scale)}[part]
                    measure_bf16(torch, rows, name, K5_SOURCE, K5_REPLACES[part or "bwd"],
                                 list(shape), fn, f32, plain, flop_b, nbytes, method="bf16",
                                 max_share=None, steps=2, library=lib,
                                 f32_ref=lambda f32=f32: torch.stack(f32()),
                                 valid_lengths=lengths[:4],
                                 **({"kernels": fa.bwd_bf16_registers()} if tuned else {}), **more)
                else:
                    measure(torch, rows, name, K5_SOURCE, K5_REPLACES[part or "bwd"],
                            list(shape), fn, plain, flop_b, nbytes, method="3xtf32",
                            library=lib, valid_lengths=lengths[:4], **more)
            del o, lse, plain_g, lib_g
        del q, k, v, do, mask
        torch.cuda.empty_cache()
    return rows


def flash_serving(torch, card: str, refwav, sr: int, cfg=None, full: bool = True) -> dict:
    """Phase 21's serving run (phase 22's with `cfg`, tts_medium_tpu; phase
    23's with tts_medium at 4 and 1 heads and not `full`: tts_ex only, no
    stream, batch or turns): the main-path engine at full width (seed 0)
    on bench.py's text twice (204 phones, text bucket 256) at FLASH_FRAMES
    frames a phone (mel bucket 1024): tts_ex under ZEROVOX_ATTN=flash (K5's
    forward 10 times: 4 encoder and 6 decoder layers) against the same
    engine on the einsum path (no K5) and a CPU run of the port under flash,
    within WAV_TOL; the bf16 engine under flash (the bf16 K5, 10 times)
    within phase 15's bound of the card's float32; tts_stream (against the
    einsum path's stream) and tts_batch at B = 2 (against the einsum
    path's) under flash within WAV_TOL, 10 launches each; RTF and the
    encode and decode stages' device ms, flash against einsum in turns."""
    import numpy as np

    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.synthesize import MEL_BUCKETS, TEXT_BUCKETS, ZeroVoxTTS, pick_bucket
    from zerovox_tpu_torch.utils.profiling import RtfStats, cuda_time_ms

    engine = ZeroVoxTTS.from_random(cfg, HifiGanConfig(), seed=0)
    text = " ".join([TEXT] * FLASH_REPEAT)
    ids, puncts = engine.text2phonemeids(text)
    n = len(ids)
    dur = np.full(n, FLASH_FRAMES, dtype=np.int32)
    text_b, mel_b = pick_bucket(n, TEXT_BUCKETS), pick_bucket(n * FLASH_FRAMES, MEL_BUCKETS)
    check(text_b == 256 and mel_b == 1024, f"flash text: {n} phones, buckets {text_b}, {mel_b}")
    spk = engine.speaker_embed(refwav)
    layers = engine.cfg.model.encoder.fs2_layer + engine.cfg.model.decoder.n_layers

    def run(eng, kind, spk):
        set_attention(kind)
        zero_k5_counts()
        wav = eng.tts_ex(text, spk, duration=dur)[0]
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        return wav, k5_counts()

    want_f32 = {k: 0 for k in k5_counts()}
    want_f32["flash_fwd"] = layers
    wav_f, n_f = run(engine, "flash", spk)
    check(n_f == want_f32, f"flash tts_ex launched K5 {n_f}, not the forward {layers} times")
    wav_e, n_e = run(engine, None, spk)
    check(not any(n_e.values()), f"the einsum tts_ex launched K5: {n_e}")
    peak = float(np.max(np.abs(wav_e)))
    check(wav_f.shape == wav_e.shape == (n * FLASH_FRAMES * engine.cfg.audio.hop_size,)
          and bool(np.isfinite(wav_f).all()), f"flash wav {wav_f.shape}, einsum {wav_e.shape}")
    err_e = float(np.max(np.abs(wav_f - wav_e)))
    check(peak > 0 and err_e < WAV_TOL * min(peak, 1.0),
          f"flash tts_ex differs from einsum by {err_e} (peak {peak})")
    sd, meldec_sd = engine.state_dicts()
    cpu = ZeroVoxTTS(engine.cfg, sd, HifiGanConfig(), meldec_sd, device="cpu")
    wav_c, _ = run(cpu, "flash", spk.cpu())
    err_c = float(np.max(np.abs(wav_f - wav_c)))
    check(err_c < WAV_TOL * min(peak, 1.0), f"flash tts_ex differs from the CPU by {err_c}")
    del cpu
    e16 = ZeroVoxTTS(engine.cfg, sd, HifiGanConfig(), meldec_sd, precision="bf16")
    wav_16, n_16 = run(e16, "flash", spk)
    want_16 = {k: 0 for k in k5_counts()}
    want_16["flash_fwd_bf16"] = layers
    check(n_16 == want_16, f"the bf16 flash tts_ex launched K5 {n_16}")
    err_16, tol_16 = float(np.max(np.abs(wav_16 - wav_f))), min(BF16_WAV_TOL, BF16_WAV_REL * peak)
    check(bool(np.isfinite(wav_16).all()) and err_16 <= tol_16,
          f"bf16 flash tts_ex {err_16} from the card's float32 (bound {tol_16})")
    del e16
    m = engine.cfg.model
    out = {"card": card, "d_model": m.emb_size, "head_dim": m.emb_size // m.decoder.n_head,
           "phones": n, "text_bucket": text_b, "mel_bucket": mel_b,
           "layers": {"encoder": m.encoder.fs2_layer, "decoder": m.decoder.n_layers},
           "launches": n_f, "launches_bf16": n_16, "wav_peak": peak,
           "flash_vs_einsum_max_abs": err_e, "flash_vs_cpu_max_abs": err_c,
           "bf16_vs_f32_max_abs": err_16, "bf16_bound": tol_16}
    if not full:
        set_attention(None)
        print(json.dumps({"flash_serving": out}), flush=True)
        return out

    # tts_stream and tts_batch (B = 2) under flash: one encode and one decode each
    set_attention("flash")
    zero_k5_counts()
    streamed = np.concatenate(list(engine.tts_stream(text, spk, duration=dur)))
    torch.cuda.synchronize()
    n_s = k5_counts()
    zero_k5_counts()
    rows = engine.tts_batch([text, text], torch.cat([spk, spk]), durations=[dur, dur])
    torch.cuda.synchronize()
    n_b = k5_counts()
    set_attention(None)
    # against the einsum path's stream: the same vocoder windows
    streamed_e = np.concatenate(list(engine.tts_stream(text, spk, duration=dur)))
    err_s = float(np.max(np.abs(streamed - streamed_e))) \
        if streamed.shape == streamed_e.shape == wav_f.shape else math.inf
    check(n_s == want_f32 and err_s < WAV_TOL * min(peak, 1.0),
          f"flash tts_stream: K5 {n_s}, {err_s} from the einsum stream")
    rows_e = engine.tts_batch([text, text], torch.cat([spk, spk]), durations=[dur, dur])
    err_b = max(float(np.max(np.abs(w - we))) if w.shape == we.shape == wav_f.shape else math.inf
                for (w, _), (we, _) in zip(rows, rows_e))
    check(n_b == want_f32 and err_b < WAV_TOL * min(peak, 1.0),
          f"flash tts_batch at B=2: K5 {n_b}, rows {err_b} from the einsum path's")

    enc, _, _ = engine._encode(ids, puncts, spk, dur)
    turns = {"flash": [], "einsum": []}
    for kind in ("flash", "einsum", "einsum", "flash"):
        set_attention(kind if kind == "flash" else None)
        stats = RtfStats(warmup=2)
        for _ in range(8):
            t0 = time.perf_counter()
            w, _, _, _ = engine.tts_ex(text, spk, duration=dur)
            stats.add(w.shape[0] / sr, time.perf_counter() - t0)
        turns[kind].append({
            "rtf": stats.mean_rtf,
            "encode_ms": cuda_time_ms(lambda: engine._encode(ids, puncts, spk, dur), iters=10),
            "decode_ms": cuda_time_ms(lambda: engine._decode(enc, spk, mel_b), iters=10)})
    set_attention(None)
    out.update({"stream_vs_einsum_stream": err_s, "batch2_vs_einsum_batch2": err_b,
                "turns": turns})
    print(json.dumps({"flash_serving": out}), flush=True)
    return out


def grad_gap(a: dict, b: dict, names) -> float:
    """||a - b|| / ||b|| over the named gradients."""
    num = sum(((a[n].double() - b[n].double()) ** 2).sum().item() for n in names)
    return (num / max(sum((b[n].double() ** 2).sum().item() for n in names), 1e-300)) ** 0.5


def flash_training(torch, card: str, base=None, timed=("32", "bf16-mixed")) -> dict:
    """Phase 21's training run (phase 22's on `base`, tts_medium_tpu, timing
    only float32): phase 6's configuration and corpus (tts_medium,
    the fused stage 1, batch 24, mel bucket 512, text bucket 128: the encoder
    stays on the einsum path), one forward_backward from the same weights and
    batch (the same dropout masks) under flash and under einsum, in float32
    and in bf16-mixed (the CLI's default): K5's forward, dK/dV and dQ 6 times
    each (the decoder's layers) under flash and never under einsum; float32
    losses within STEP_LOSS_RTOL and gradients within STEP_GRAD_TOL x each
    tensor's max (the speaker encoder's, under batch statistics, in
    aggregate within SPK_BATCH_STATS_TOL, as phase 7); bf16-mixed losses
    within MIXED_LOSS_RTOL of float32 einsum and its gradients no further
    from float32 einsum's than 1.5 x the bf16-mixed einsum step's. A remat
    step under flash re-runs the forward (12 + 6 + 6). Then train_step's
    device ms and peak memory, flash against einsum in turns, each precision
    in `timed`."""
    import dataclasses as dc

    import numpy as np

    from zerovox_tpu_torch.training.data import SpeechDataModule
    from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig, device_batch
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    cfg = train_config(fused=True, base=base)
    out = {"card": card, "d_model": cfg.model.emb_size,
           "head_dim": cfg.model.emb_size // cfg.model.decoder.n_head}
    BUILD.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        root = Path(tmp)
        write_corpus(root, "train", cfg.symbols(), cfg.audio.num_mels, TRAIN_UTTS, (80, 100), seed=0)
        dm = SpeechDataModule([{"path": {"preprocessed_path": "train"}}], cfg.symbols(), STATS,
                              batch_size=TRAIN_BATCH, num_workers=4, seed=0, base_path=str(root))
        dm.prepare_data()
        batch = device_batch(next(iter(dm.train_dataloader(0))), "cuda")
        text_b, mel_b = batch["phoneme"].shape[1], batch["mel"].shape[1]
        check(mel_b == 512 and batch["mel"].shape[0] == TRAIN_BATCH,
              f"flash training batch: mel {tuple(batch['mel'].shape)}")
        per_step = cfg.model.decoder.n_layers + (
            cfg.model.encoder.fs2_layer if text_b % 128 == 0 and text_b >= 256 else 0)

        def tcfg(precision):
            return TrainerConfig(max_epochs=1, warmup_epochs=1, seed=0, precision=precision,
                                 out_folder=str(root / "model"))

        sd = Trainer(cfg, tcfg("32"), steps_per_epoch=2).init_state().model.state_dict()

        def step(trainer, state, kind):
            set_attention(kind)
            zero_k5_counts()
            losses = trainer.forward_backward(state, batch)
            torch.cuda.synchronize()
            grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()
                     if p.grad is not None}
            return {k: v.item() for k, v in losses.items()}, grads, k5_counts()

        def want(kind, suffix, fwd=per_step):
            n = {k: 0 for k in k5_counts()}
            if kind == "flash":
                n.update({f"flash_fwd{suffix}": fwd, f"flash_bwd_dkv{suffix}": per_step,
                          f"flash_bwd_dq{suffix}": per_step})
            return n

        trainers, runs = {}, {}
        for precision, suffix in (("32", ""), ("bf16-mixed", "_bf16")):
            trainer = Trainer(cfg, tcfg(precision), steps_per_epoch=2)
            state = trainer.init_state(sd)
            trainers[precision] = (trainer, state)
            for kind in ("flash", "einsum"):
                losses, grads, n = step(trainer, state, kind if kind == "flash" else None)
                check(n == want(kind, suffix), f"{precision} {kind} step launched K5 {n}")
                check(all(np.isfinite(v) for v in losses.values()), f"{precision} {kind}: {losses}")
                runs[(precision, kind)] = (losses, grads, n)

        # float32: flash against einsum
        (l_f, g_f, n_f), (l_e, g_e, _) = runs[("32", "flash")], runs[("32", "einsum")]
        loss_err = {k: abs(l_f[k] - l_e[k]) / max(abs(l_e[k]), 1e-30) for k in l_e}
        check(max(loss_err.values()) <= STEP_LOSS_RTOL, f"flash f32 losses {l_f} vs einsum {l_e}")
        check(g_f.keys() == g_e.keys(), "flash and einsum steps differ in their gradients")
        floor = 1e-3 * max(g.abs().max().item() for g in g_e.values())
        spk = [k for k in g_e if k.startswith("_spkemb.")]
        worst = {k: (g_f[k] - g_e[k]).abs().max().item() / max(g_e[k].abs().max().item(), floor)
                 for k in g_e}
        held = {k: v for k, v in worst.items() if k not in spk}
        bad = {k: v for k, v in held.items() if v > STEP_GRAD_TOL}
        check(not bad, f"flash f32 gradients off einsum's: {dict(list(bad.items())[:5])}")
        spk_gap = grad_gap(g_f, g_e, spk)
        check(spk_gap <= SPK_BATCH_STATS_TOL, f"flash f32 speaker-encoder gradients {spk_gap}")
        out["f32"] = {"losses_flash": l_f, "losses_einsum": l_e, "loss_rel_err": loss_err,
                      "worst_grad_rel_err": max(held.values()),
                      "worst_grad": max(held, key=held.get), "spkemb_l2_rel_err": spk_gap,
                      "spkemb_worst_rel_err": max(worst[k] for k in spk), "launches": n_f}

        # bf16-mixed: each against float32 einsum
        (l_fb, g_fb, n_fb), (l_eb, g_eb, _) = (runs[("bf16-mixed", "flash")],
                                               runs[("bf16-mixed", "einsum")])
        names = list(g_e)
        gap_f, gap_e = grad_gap(g_fb, g_e, names), grad_gap(g_eb, g_e, names)
        loss_err16 = {k: abs(l_fb[k] - l_e[k]) / max(abs(l_e[k]), 1e-30) for k in l_e}
        check(max(loss_err16.values()) <= MIXED_LOSS_RTOL, f"bf16 flash losses {l_fb} vs {l_e}")
        check(gap_f <= 1.5 * gap_e, f"bf16 flash gradients {gap_f} from float32, einsum's {gap_e}")
        out["bf16_mixed"] = {"losses_flash": l_fb, "losses_einsum": l_eb,
                             "loss_rel_err_vs_f32": loss_err16, "grad_gap_flash_vs_f32": gap_f,
                             "grad_gap_einsum_vs_f32": gap_e, "launches": n_fb}
        del runs

        # remat: the recomputation re-runs K5's forward
        rcfg = dc.replace(cfg, model=dc.replace(cfg.model, remat=True))
        rtrainer = Trainer(rcfg, tcfg("32"), steps_per_epoch=2)
        l_r, g_r, n_r = step(rtrainer, rtrainer.init_state(sd), "flash")
        check(n_r == want("flash", "", fwd=2 * per_step), f"the remat flash step launched K5 {n_r}")
        remat_err = max((g_r[k] - g_f[k]).abs().max().item()
                        / max(g_f[k].abs().max().item(), floor) for k in g_f if k not in spk)
        check(abs(l_r["loss"] - l_f["loss"]) <= STEP_LOSS_RTOL * abs(l_f["loss"])
              and remat_err <= STEP_GRAD_TOL, f"remat flash step: {l_r} vs {l_f}, {remat_err}")
        out["remat"] = {"launches": n_r, "loss": l_r["loss"], "worst_grad_rel_err": remat_err}
        del rtrainer, g_r, g_f, g_e, g_fb, g_eb

        # train_step in turns: device ms and peak memory
        for precision in timed:
            trainer, state = trainers[precision]
            turns = {"flash": [], "einsum": []}
            for kind in ("flash", "einsum", "einsum", "flash"):
                set_attention(kind if kind == "flash" else None)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_time_ms(lambda: trainer.train_step(state, batch), iters=3, warmup=1)
                turns[kind].append({"ms": ms, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
            out[f"step_turns_{precision}"] = turns
        set_attention(None)
        out.update({"text_bucket": text_b, "mel_bucket": mel_b, "batch": TRAIN_BATCH,
                    "k5_per_step": per_step})
        del trainers
    torch.cuda.empty_cache()
    print(json.dumps({"flash_training": out}), flush=True)
    return out


def flash_phase(torch, dev, card: str, refwav, sr: int) -> dict:
    """Phase 21: K5's rows, then its serving and training paths; the rows'
    launches are those paths' counts (the float32 and bf16 forward from
    tts_ex at bucket 1024, the training rows from the float32 and bf16-mixed
    steps)."""
    t0 = time.perf_counter()
    rows = k5_rows(torch, dev)
    serve = flash_serving(torch, card, refwav, sr)
    train = flash_training(torch, card)
    k5_row_launches(rows, serve, train)
    return {"rows": rows, "serving": serve, "training": train,
            "phase_s": time.perf_counter() - t0}


def k5_row_launches(rows, serve: dict, train: dict, suffix: str = "") -> None:
    """Each K5 row's launches from a flash_serving and a flash_training run
    (rows named as k5_rows names them, ending in `suffix`)."""
    for row in rows:
        name = row["name"].removesuffix(suffix)
        bf = name.endswith("_bf16")
        dtype = "_bf16" if bf else ""
        if "_alone" in name:  # a kernel-only row: its kernel's launches on the path, none here
            name = name.replace("_alone", "_train" if name.startswith("flash_fwd") else "")
            row["launches_at_shape"] = 0
        if name.startswith("flash_fwd") and "_train" not in name:
            row["launches"] = serve["launches_bf16" if bf else "launches"][f"flash_fwd{dtype}"]
            # of them at this row's shape: the encoder's layers or the decoder's
            row["launches_at_shape"] = serve["layers"]["encoder" if "_enc" in name else "decoder"]
            continue
        counts = train["bf16_mixed" if bf else "f32"]["launches"]
        kernel = name.removesuffix("_bf16").replace("_train", "")
        # a whole backward pass ("flash_bwd") launches dK/dV and dQ once each
        row["launches"] = counts[("flash_bwd_dq" if kernel == "flash_bwd" else kernel) + dtype]


def model_turns(torch, card: str, refwav, sr: int) -> dict:
    """Phase 22 (b): the tts_medium_tpu engine (d_model 512) against phase
    4's tts_medium engine (528), both with the default vocoder from seed 0,
    in turns (512, 528, 528, 512) on bench.py's text and forced durations:
    time_engine's encode, decode and vocode device ms at bucket 689, RTF,
    first-chunk p50 and tts_batch at B=4."""
    import numpy as np

    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS

    engines = {"512": ZeroVoxTTS.from_random(tts_medium_tpu(), HifiGanConfig(), seed=0),
               "528": ZeroVoxTTS.from_random(seed=0)}
    rng = np.random.default_rng(15)
    spk_wavs = [refwav] + [rng.normal(size=2 * sr).astype(np.float32) * s for s in (0.05, 0.2, 0.3)]
    args = {}
    for name, e in engines.items():
        dur = np.full(len(e.text2phonemeids(TEXT)[0]), FRAMES_PER_PHONE, np.int32)
        durs, spks = batch_inputs(e, spk_wavs)
        args[name] = (e.speaker_embed(refwav), dur, spks, durs)
    turns = {"512": [], "528": []}
    for name in ("512", "528", "528", "512"):
        turns[name].append(time_engine(torch, engines[name], *args[name], sr))
    out = {"card": card, "turns": turns}
    print(json.dumps({"tts_medium_tpu_vs_tts_medium": out}), flush=True)
    del engines, args
    torch.cuda.empty_cache()
    return out


def medium_tpu_training(torch, dev, card: str) -> dict:
    """Phase 22 (d): tts_medium_tpu's float32 train_step with the fused stage
    1 at batch 24, mel bucket 512 (phase 6's corpus): finite losses, 6 + 6
    K4 launches a step; its device ms and peak memory in turns with
    tts_medium's step (512, 528, 528, 512; peak memory with both models
    resident, and the step's own rise above what was resident); one step
    at train_cross_check's reduced depth on the card against the CPU (phase
    7's bounds); then flash_training on tts_medium_tpu (K5 at [24, 2, 512,
    256]; its turns, flash against einsum, in float32 only)."""
    import numpy as np

    from zerovox_tpu_torch.training.data import SpeechDataModule
    from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig, device_batch
    from zerovox_tpu_torch.utils.profiling import cuda_time_ms

    cfgs = {"512": train_config(fused=True, base=tts_medium_tpu()), "528": train_config(fused=True)}
    cfg = cfgs["512"]
    out = {"card": card}
    BUILD.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        root = Path(tmp)
        write_corpus(root, "train", cfg.symbols(), cfg.audio.num_mels, TRAIN_UTTS, (80, 100), seed=0)
        write_corpus(root, "short", cfg.symbols(), cfg.audio.num_mels, 2, (16, 16), seed=1)
        dm = SpeechDataModule([{"path": {"preprocessed_path": "train"}}], cfg.symbols(), STATS,
                              batch_size=TRAIN_BATCH, num_workers=4, seed=0, base_path=str(root))
        dm.prepare_data()
        batch = device_batch(next(iter(dm.train_dataloader(0))), "cuda")
        check(tuple(batch["mel"].shape[:2]) == (TRAIN_BATCH, 512),
              f"tts_medium_tpu training batch: mel {tuple(batch['mel'].shape)}")
        tcfg = TrainerConfig(max_epochs=1, warmup_epochs=1, seed=0, out_folder=str(root / "model"))
        runs = {}
        for name, c in cfgs.items():
            trainer = Trainer(c, tcfg, steps_per_epoch=dm.steps_per_epoch())
            state = trainer.init_state()
            zero_counts()
            losses = {k: float(v) for k, v in trainer.train_step(state, batch).items()}
            torch.cuda.synchronize()
            check(k4_counts() == (6, 6), f"the {name} step launched K4 {k4_counts()}, not 6 + 6")
            check(all(np.isfinite(v) for v in losses.values()), f"the {name} step's losses {losses}")
            runs[name] = (trainer, state)
            out[f"losses_{name}"] = losses
        turns = {"512": [], "528": []}
        for name in ("512", "528", "528", "512"):
            trainer, state = runs[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            n0 = k4_counts()
            ms = cuda_time_ms(lambda: trainer.train_step(state, batch), iters=3, warmup=1)
            n1 = k4_counts()
            check(n1[0] - n0[0] == 4 * 6 and n1[1] - n0[1] == 4 * 6,
                  f"{name} steps launched K4 {n1[0] - n0[0]} + {n1[1] - n0[1]} times, not 24 each")
            peak = torch.cuda.max_memory_allocated()
            turns[name].append({"ms": ms, "peak_mem_gb": peak / 1e9,
                                "step_mem_gb": (peak - resident) / 1e9})
        out["step_turns_f32"] = turns
        del runs, trainer, state, batch
        torch.cuda.empty_cache()
        out["cross_check"] = train_cross_check(torch, dev, root, base=tts_medium_tpu())
    print(json.dumps({"tts_medium_tpu_training": out}), flush=True)
    out["flash"] = flash_training(torch, card, base=tts_medium_tpu(), timed=("32",))
    return out


def medium_tpu_phase(torch, dev, card: str, refwav, sr: int) -> dict:
    """Phase 22: tts_medium_tpu on the card (see the module docstring): K5's
    rows at d = 256 (named *_d256, their launches from (c) and (d)), then
    (a) serving on the einsum path, (b) 512 against 528 in turns, (c)
    serving under flash, (d) training."""
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig

    t0 = time.perf_counter()
    cfg = tts_medium_tpu()
    m = cfg.model
    check(m.emb_size == 512 and m.emb_size // m.encoder.fs2_head == 256
          and m.emb_size // m.decoder.n_head == 256,
          f"tts_medium_tpu: d_model {m.emb_size}, heads {m.encoder.fs2_head}, {m.decoder.n_head}")
    rows = k5_rows(torch, dev, K5_D256_SHAPES, suffix="_d256")
    zero_k5_counts()  # (a) holds every kernel's count at 0 but K1's and K2's
    serve = narrow_path(torch, card, "tts_medium_tpu", HifiGanConfig(), MAIN_WIDTHS, refwav, sr,
                        None, cfg=cfg)
    turns = model_turns(torch, card, refwav, sr)
    flash = flash_serving(torch, card, refwav, sr, cfg)
    train = medium_tpu_training(torch, dev, card)
    k5_row_launches(rows, flash, train["flash"], suffix="_d256")
    out = {"rows": rows, "serving": serve, "turns": turns, "flash_serving": flash,
           "training": train, "phase_s": time.perf_counter() - t0}
    print(json.dumps({"tts_medium_tpu_phase_s": out["phase_s"], "card": card}), flush=True)
    return out


def tts_medium_heads(heads: int):
    """tts_medium (ZeroVoxConfig()) with `heads` attention heads in the
    encoder and the decoder: each head 528 / heads wide."""
    import dataclasses as dc

    from zerovox_tpu_torch.config import ZeroVoxConfig

    m = ZeroVoxConfig().model
    return dc.replace(ZeroVoxConfig(), model=dc.replace(
        m, encoder=dc.replace(m.encoder, fs2_head=heads), decoder=dc.replace(m.decoder, n_head=heads)))


def any_dim_phase(torch, dev, card: str, refwav, sr: int) -> dict:
    """Phase 23 (see the module docstring): for tts_medium at 4 heads (d =
    132, padded to 136 onto the tuned kernels) and at 1 head (d = 528: the
    cluster kernels, float32 and bf16), K5's rows at the
    phase-21 shapes (named *_d132, *_d528),
    flash serving (tts_ex only) and flash training (float32 turns, and
    bf16-mixed at d = 528);
    then the kernels of d above 272 alone at K5_ALONE_SHAPES (forward and
    backward, *_alone_d280, *_alone_d1040, *_alone_d2184), whose launches
    are the d = 528 run's."""
    t0 = time.perf_counter()
    rows, out = [], {}
    for heads, d in K5_HEAD_CONFIGS:
        cfg = tts_medium_heads(heads)
        m = cfg.model
        check(m.emb_size // m.encoder.fs2_head == d and m.emb_size // m.decoder.n_head == d,
              f"tts_medium at {heads} heads: d_model {m.emb_size}")
        shapes = tuple((label, (shape[0], heads, shape[2], d)) for label, shape in K5_SHAPES)
        r = k5_rows(torch, dev, shapes, suffix=f"_d{d}", seed=23)
        serve = flash_serving(torch, card, refwav, sr, cfg, full=False)
        train = flash_training(torch, card, base=cfg,
                               timed=("32", "bf16-mixed") if d == 528 else ("32",))
        k5_row_launches(r, serve, train, suffix=f"_d{d}")
        rows += r
        out[f"d{d}"] = {"heads": heads, "serving": serve, "training": train}
    for shape in K5_ALONE_SHAPES:
        suffix = f"_d{shape[3]}"
        r = k5_rows(torch, dev, (("_alone", shape),), suffix=suffix, seed=23,
                    bwd_labels=("_alone",))
        k5_row_launches(r, out["d528"]["serving"], out["d528"]["training"], suffix=suffix)
        rows += r
    out.update({"rows": rows, "phase_s": time.perf_counter() - t0})
    print(json.dumps({"any_dim_phase_s": out["phase_s"], "card": card}), flush=True)
    return out


def profile_calls(torch, fn, calls: int, out: Path, label: str) -> dict:
    """torch.profiler over `calls` calls of fn: device time by kernel, the
    device's busy share of the window (the union of the kernels' and
    copies' intervals) and K4's device time, the table written to
    out/profile_<label>.txt."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()

    # device activity (kernels and copies); the busy time is the union of
    # their intervals in the trace (cuDNN's training convolutions overlap)
    dev_events = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation]
    summed_s = sum(e.self_device_time_total for e in dev_events) / 1e6
    out.mkdir(parents=True, exist_ok=True)
    trace = out / f"trace_{label}.json"
    prof.export_chrome_trace(str(trace))
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0))
                   for e in json.loads(trace.read_text())["traceEvents"]
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    trace.unlink()
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    busy_s = busy_us / 1e6
    k4_s = sum(e.self_device_time_total for e in dev_events
               if kernel_family(e.key).startswith("K4")) / 1e6
    families: dict[str, float] = {}
    for e in dev_events:
        fam = kernel_family(e.key)
        families[fam] = families.get(fam, 0.0) + e.self_device_time_total / 1e3 / calls
    table = avgs.table(sort_by="self_cuda_time_total", row_limit=40)
    (out / f"profile_{label}.txt").write_text(f"{card_line()}\n{table}\n")
    res = {"label": label, "calls": calls, "wall_ms": 1e3 * wall, "device_busy_ms": 1e3 * busy_s,
           "device_busy_share": busy_s / wall, "device_kernel_ms_summed": 1e3 * summed_s,
           "k4_device_ms": 1e3 * k4_s,
           "device_ms_per_call_by_family": dict(sorted(families.items(), key=lambda kv: -kv[1]))}
    print(json.dumps({"profile": res}), flush=True)
    return res


def arg_value(flag: str, default=None):
    return sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv else default


def only_phases(torch, dev, card: str, kind: str, count: int) -> None:
    """`--only N[,M] --repeat R [--dump DIR]`: after phases 1-2, run phases
    12, 18, 19, 20, 21, 22 and/or 23 alone, R times each. A repeat's failed check is recorded with
    its message and the run goes on; a summary line lists them, and the
    exit code is 1 if any repeat failed."""
    import numpy as np

    from zerovox_tpu_torch.config import ZeroVoxConfig

    BUILD.mkdir(exist_ok=True)
    sr = ZeroVoxConfig().audio.sampling_rate
    refwav = np.random.default_rng(0).normal(size=2 * sr).astype(np.float32) * 0.1
    dump = Path(arg_value("--dump")) if "--dump" in sys.argv else None
    profile_dir = Path(arg_value("--profile")) if "--profile" in sys.argv else None
    runs = {12: ("checkpoints", lambda: checkpoint_phase(torch, dev, card, refwav, dump)),
            18: ("preprocessing and tools", lambda: preprocess_phase(torch, dev, card)),
            19: ("data parallel, serving mesh, resume, compile cache",
                 lambda: parallel_phase(torch, dev, card, refwav, sr, profile_dir)),
            20: ("tensor parallel", lambda: tensor_parallel_phase(torch, dev, card)),
            21: ("flash attention", lambda: flash_phase(torch, dev, card, refwav, sr)),
            22: ("tts_medium_tpu", lambda: medium_tpu_phase(torch, dev, card, refwav, sr)),
            23: ("every head dim", lambda: any_dim_phase(torch, dev, card, refwav, sr))}
    wanted = [int(v) for v in arg_value("--only").split(",")]
    check(all(n in runs for n in wanted), f"--only takes phases {sorted(runs)}")
    repeat = int(arg_value("--repeat", 1))
    failures = []
    for n in wanted:
        for i in range(repeat):
            phase(f"{runs[n][0]} (phase {n}, repeat {i + 1} of {repeat})")
            try:
                runs[n][1]()
            except PhaseFailed as e:
                failures.append({"phase": n, "repeat": i + 1, "check": e.msg})
            torch.cuda.empty_cache()
    print(json.dumps({"only": wanted, "repeat": repeat, "failures": failures, "card": card}))
    if failures:
        sys.exit(1)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


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
    set_attention(None)  # phases 1-20 on the einsum path; phase 21 sets flash where it runs it
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
            if "entry function" in ln or "registers" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}")

    if "--only" in sys.argv:
        only_phases(torch, dev, card, kind, count)
        return

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
    rows += resblock_phase(torch, dev, single_tower_hifigan(), bucket)
    rows += narrow_kernel_rows(torch, dev, bucket)
    rows += se_conv_phase(torch, dev)

    # ---- 4. the main path at full width
    phase("main path")
    refwav = np.random.default_rng(0).normal(size=2 * sr).astype(np.float32) * 0.1
    dur = np.full(n_phones, FRAMES_PER_PHONE, dtype=np.int32)
    zero_counts()
    spk = engine.speaker_embed(refwav)
    wav, _, n, mel = engine.tts_ex(TEXT, spk, duration=dur)
    per_call = (fused_mrf.launches, fused_upsample_stage.launches)
    chunks = list(engine.tts_stream(TEXT, spk, duration=dur))
    torch.cuda.synchronize()
    launches = {"fused_mrf": fused_mrf.launches, "fused_upsample_stage": fused_upsample_stage.launches}
    check(k4_counts() == (0, 0) and kernel_counts()["fused_resblock1"] == 0,
          f"the serving path launched K3 or K4: {kernel_counts()}")
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
        if row["name"].removesuffix("+post") in launches:
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
        profile_calls(torch, lambda: engine.tts_ex(TEXT, spk, duration=dur), 3,
                      Path(sys.argv[sys.argv.index("--profile") + 1]), "main_path")

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

    # ---- 6. the training path at full width
    phase("training path")
    del engine, cpu
    torch.cuda.empty_cache()
    BUILD.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        corpus = Path(tmp)
        syms = train_config(fused=True).symbols()
        n_mels = train_config(fused=True).audio.num_mels
        write_corpus(corpus, "train", syms, n_mels, TRAIN_UTTS, (80, 100), seed=0)
        write_corpus(corpus, "short", syms, n_mels, 2, (16, 16), seed=1)
        zero_counts()
        train = train_phase(torch, corpus)
        k4 = train["launches"]
        trainer, state, batch = train.pop("model")
        steps = train["steps"]
        check(steps >= 6, f"fit took {steps} steps")
        check(all(n == [6, 6] for n in train["k4_per_step"]),
              f"K4 launches per step {train['k4_per_step']}, not 6 + 6")
        check(all(np.isfinite(v) for d in train["losses"] for v in d.values()), "non-finite loss")
        print(f"training: {steps} steps at batch {TRAIN_BATCH}, mel buckets {train['mel_buckets']}, "
              f"K4 launches {k4} ({k4['se_conv_fwd'] // steps} + {k4['se_conv_bwd'] // steps} a step)")
        print("losses: " + ", ".join(f"{d['loss']:.6g}" for d in train["losses"]) + " (all finite)")
        k4_ms = {r["name"]: r["ms"] for r in rows if r["name"] in k4}
        stage1_ms = 6 * (k4_ms["se_conv_fwd"] + k4_ms["se_conv_bwd"])
        train["stage1_k4_ms_est"] = stage1_ms
        train["stage1_share_est"] = stage1_ms / train["fused_step_ms"]
        train["card"] = card
        print(json.dumps({"train": train}), flush=True)
        for row in rows:
            if row["name"] in k4:
                row["launches"] = k4[row["name"]]
        if "--profile" in sys.argv:
            profile_calls(torch, lambda: trainer.train_step(state, batch), 2,
                          Path(sys.argv[sys.argv.index("--profile") + 1]), "train_step")
        del trainer, state, batch
        torch.cuda.empty_cache()

        # ---- 7. one train step on the card and on the CPU
        phase("training cross-check")
        xc = train_cross_check(torch, dev, corpus)
        print(json.dumps({"train_cross_check": xc}), flush=True)

    # ---- 8. the StyleTTS-decoder path with the single-tower vocoder (K3)
    phase("styletts path")
    profile_dir = Path(sys.argv[sys.argv.index("--profile") + 1]) if "--profile" in sys.argv else None
    sty = styletts_phase(torch, card, refwav, sr, profile_dir)
    for row in rows:
        if row["name"] == "fused_resblock1":
            row["launches"] = sty["launches"]["fused_resblock1"]
    torch.cuda.empty_cache()

    # ---- 9. the default engine's tts_batch at B=4, and the batch rule at B=4 and 8
    phase("default batch")
    default_batch_phase(torch, dev, card, refwav, sr)
    torch.cuda.empty_cache()

    # ---- 10. the main path behind the HTTP server
    phase("serving")
    serving_phase(torch, card)
    torch.cuda.empty_cache()

    # ---- 11. the vocoder's gradients
    phase("vocoder gradients")
    grad_phase(torch, dev, card)

    # ---- 12. checkpoints: fit writes them, resume, an engine on one
    phase("checkpoints")
    checkpoint_phase(torch, dev, card, refwav)
    torch.cuda.empty_cache()

    # ---- 13. the demo CLI in its own process
    phase("demo cli")
    demo_phase(card)

    # ---- 14. the training CLI at its defaults: bf16-mixed with the bf16 K4
    phase("training cli")
    tc = cli_phase(torch, dev, card)
    for row in rows:
        if row["name"] in tc["launches"]:
            row["launches"] = tc["launches"][row["name"]]

    # ---- 15. bf16 inference on both paths
    phase("bf16 inference")
    bf = bf16_phase(torch, dev, card, refwav, sr, bucket, profile_dir)
    for row in rows:
        key = row["name"].removesuffix("+post")
        if key in ("fused_mrf_bf16", "fused_upsample_stage_bf16"):
            row["launches"] = bf["main"]["launches"][key]
        elif key == "fused_resblock1_bf16":
            row["launches"] = bf["styletts"]["launches"][key]

    # ---- 16. narrow vocoders on the main path: HiFi-GAN V2, a 256-channel single tower
    phase("narrow vocoders")
    nar = narrow_phase(torch, card, refwav, sr, profile_dir)
    for row in rows:
        if "@" not in row["name"]:
            continue
        base, width = row["name"].split("@")
        kernel = base.removesuffix("+post").removesuffix("_bf16")
        path = nar["single_tower_256" if kernel == "fused_resblock1" else "hifigan_v2"]
        counts = path["bf16_launches_per_tts_ex"] if "_bf16" in base else path["launches"]
        row["launches"] = counts[kernel + ("_bf16" if "_bf16" in base else "")]
        key = width if "x" in width else int(width)
        row["launches_at_width"] = path["launches_at"][kernel].get(key, 0) \
            if "_bf16" not in base else None

    # ---- 17. vocoder GAN training at full width; PQMF, Griffin-Lim; the trained vocoder served
    phase("vocoder training")
    gan_phase(torch, dev, card, refwav, profile_dir)

    # ---- 18. preprocessing on the card, the corpus and checkpoint tools
    phase("preprocessing and tools")
    preprocess_phase(torch, dev, card)
    torch.cuda.empty_cache()

    # ---- 19. data parallel (world-1 NCCL), the serving mesh, the JAX vocoder resume, the cache
    phase("data parallel, serving mesh, resume, compile cache")
    parallel_phase(torch, dev, card, refwav, sr, profile_dir)
    torch.cuda.empty_cache()

    # ---- 20. tensor parallel: a 1 x 2 data x model mesh, two gloo ranks on the card
    phase("tensor parallel")
    tensor_parallel_phase(torch, dev, card)

    # ---- 21. flash attention: K5 on the serving and training paths under ZEROVOX_ATTN=flash
    check(not any(k5_counts().values()), f"phases 1-20 launched K5: {k5_counts()}")
    phase("flash attention")
    rows += flash_phase(torch, dev, card, refwav, sr)["rows"]
    torch.cuda.empty_cache()

    # ---- 22. tts_medium_tpu (d_model 512: K5 at d = 256) on the serving and training paths
    phase("tts_medium_tpu")
    rows += medium_tpu_phase(torch, dev, card, refwav, sr)["rows"]
    torch.cuda.empty_cache()

    # ---- 23. every head dim: tts_medium at 4 heads (d = 132) and 1 head (d = 528) under flash
    phase("every head dim")
    rows += any_dim_phase(torch, dev, card, refwav, sr)["rows"]

    # ---- results
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
