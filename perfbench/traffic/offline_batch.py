"""Offline rendering: `ZeroVoxTTS.tts_batch` called back to back on a job's
texts, `batch` at a time in the job's order (not sorted by length), with
durations predicted (the speculative bucket, the host sync and any redo
in the window).

Parameters (the cell's `params`):
  batch           texts a call
  job_texts       the job's length; the window cycles through it
  text            {median, sigma, min, max}: lognormal characters a text
  voices, zipf_s  the bundled reference wavs, chosen with Zipf skew
  (before the window, one call of each text and mel bucket pair the job's
  calls reach, by the reference's text frontend and the bucket rule)
  check_rows      how many rendered rows the check holds to the reference

audio_rate is the seconds of audio the window's calls completed over the
window's seconds: calls run until `--seconds` has passed, and the window
ends when the last of them has.
"""

from __future__ import annotations

import time

import numpy as np

from reference.synth import MEL_BUCKETS, SPEC_FRAMES_PER_PHONE, TEXT_BUCKETS, pick_bucket
from reference.text import Symbols, ZeroVoxNormalizer, text_ids
from synth import Checker, build_engine, load_voices, sample_indices, zipf_choice
from textgen import lognormal_sizes, sentence


def make_job(p: dict, rng: np.random.Generator):
    """The job's texts and voices: the same sizes in the same order for
    every seed (drawn once from the job's length); the seed draws the
    words and the voices."""
    n, t = p["job_texts"], p["text"]
    fixed = np.random.default_rng([n, 0])
    sizes = fixed.permutation(lognormal_sizes(n, t["median"], t["sigma"], t["min"], t["max"]))
    texts = [sentence(rng, int(s)) for s in sizes]
    return texts, zipf_choice(rng, len(p["voices"]), p["zipf_s"], n).tolist()


def run(run) -> None:
    import torch

    p = run.params()
    texts, who = make_job(p, np.random.default_rng([run.seed, 1]))
    run.mark("start")
    voices = load_voices(p["voices"])
    engine = build_engine(run, texts, voices, who)
    run.mark("engine")
    spk = [engine.speaker_embed(w).float() for w in voices]
    run.mark("voices")
    B = p["batch"]
    n_calls = len(texts) // B

    def call(i: int):
        rows = [(i * B + j) % len(texts) for j in range(B)]
        return rows, engine.tts_batch([texts[r] for r in rows], torch.cat([spk[who[r]] for r in rows]))

    engine._meldec.forward = run.span("vocoder", engine._meldec.forward)
    engine._model.encode = run.span("acoustic", engine._model.encode)
    engine._model.decode = run.span("acoustic", engine._model.decode)
    vocoded = []  # (B, T) of each vocoder call in the window

    def shapes(fn):
        def wrapped(mel, *a, **k):
            vocoded.append(tuple(mel.shape[:2]))
            return fn(mel, *a, **k)
        return wrapped

    engine._meldec.forward = shapes(engine._meldec.forward)
    m = run.cfg["model"]
    sym, norm = Symbols(m["phones"], m["puncts"]), ZeroVoxNormalizer(run.cfg["lang"][0])
    phones = [len(text_ids(t.strip(), sym, norm)[0]) for t in texts]
    first_of: dict[tuple, int] = {}
    for i in range(n_calls):
        n = max(phones[i * B:(i + 1) * B])
        key = (pick_bucket(n, TEXT_BUCKETS),
               pick_bucket(min(SPEC_FRAMES_PER_PHONE * n + 16, m["max_mel_len"]), MEL_BUCKETS))
        first_of.setdefault(key, i)
    for i in sorted(first_of.values()):
        call(i)
    vocoded.clear()
    done = []  # (rows, outputs) of each call in the window
    with run.window():
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < run.seconds:
            done.append(call(i % n_calls))
            i += 1
    run.read_memory_peak()

    sr = engine.cfg.audio.sampling_rate
    hop = engine.cfg.audio.hop_size
    frames = [n for _, outs in done for _, n in outs]
    audio_s = sum(len(w) for _, outs in done for w, _ in outs) / sr
    run.attempted = len(done) * B
    run.failed = sum(1 for _, outs in done for w, n in outs if n <= 0 or len(w) != n * hop)
    run.e2e["audio_rate"] = audio_s / run.window_s
    run.values.update(audio_s=audio_s, utterance_frames=frames,
                      phones=[phones[r] for rows, _ in done for r in rows],
                      vocoded=list(vocoded))
    run.log(calls=len(done), warmup_calls=len(first_of), rows=run.attempted, audio_s=audio_s, window_s=run.window_s,
            audio_rate=run.e2e["audio_rate"], mean_frames=float(np.mean(frames)),
            capped_rows=sum(1 for n in frames if n >= m["max_mel_len"]),
            vocoded_frames=sum(b * t for b, t in vocoded),
            padding_share=1.0 - sum(frames) / max(1, sum(b * t for b, t in vocoded)))

    del engine, spk
    run.free()
    check(run, texts, who, done, voices)


def check(run, texts, who, done, voices, tf32: bool = False):
    p = run.params()
    rng = np.random.default_rng([run.seed, 3])
    flat = [(c, j) for c, (rows, _) in enumerate(done) for j in range(len(rows))]
    lengths = [len(done[c][1][j][0]) for c, j in flat]
    checker = Checker(run, voices, tf32=tf32)
    picked: dict[int, list[int]] = {}
    for k in sample_indices(rng, lengths, p["check_rows"]):
        c, j = flat[k]
        picked.setdefault(c, []).append(j)
    for c, js in picked.items():
        rows, outs = done[c]
        checker.batch([texts[r] for r in rows], [who[r] for r in rows], js,
                      [outs[j][0] for j in js])
    checker.finish()
    run.check("failed_rows", run.failed, 0)
