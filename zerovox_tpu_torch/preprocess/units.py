"""Acoustic-unit self-labeling for untranscribed speech (numpy).

A copy of the JAX package's `preprocess/units.py`. Where no speech
recognizer's weights are at hand, transcripts for recorded wavs come from
discrete acoustic units: k-means over log-mel frames (the unit-discovery
recipe behind HuBERT-style pseudo-labels), mapped onto the romanized
character alphabet:

  * `fit_units` — k-means (k<=26) over pooled log-mel frames of a wav set
    at the aligner's 16 kHz / hop-320 frame contract;
  * `transcribe` — frame -> nearest-unit -> letter, with an energy gate
    for silence, a median smoother, and run-length collapsing; silences
    become spaces;
  * `ClusterAligner` (preprocess/aligner.py) emits CTC log-probs from the
    SAME centroids, so the forced-alignment pipeline (preprocess/pipeline.py)
    runs unmodified on the pseudo-transcripts.
"""

from __future__ import annotations

import numpy as np

from zerovox_tpu_torch.dsp.mels import mel_filterbank

UNIT_SAMPLE_RATE = 16000
UNIT_HOP = 320
UNIT_WIN = 400
UNIT_FFT = 512
UNIT_MELS = 40
UNIT_LETTERS = "abcdefghijklmnopqrstuvwxyz"

_SIL_REL_DB = -35.0  # frames this far under the wav's peak RMS are silence


def unit_features(wav: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """16 kHz wav -> (log-mel [T, UNIT_MELS], frame RMS [T]).

    Pure numpy (no jit): preprocessing labeling runs on the host next to
    multiprocessing pools, and these wavs are short.
    """
    n = (len(wav) // UNIT_HOP) * UNIT_HOP
    if n < UNIT_WIN:
        return np.zeros((0, UNIT_MELS), np.float32), np.zeros(0, np.float32)
    frames_n = 1 + (n - UNIT_WIN) // UNIT_HOP
    idx = np.arange(UNIT_WIN)[None, :] + UNIT_HOP * np.arange(frames_n)[:, None]
    frames = wav[idx].astype(np.float64)
    rms = np.sqrt((frames**2).mean(axis=1)).astype(np.float32)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(UNIT_WIN) / UNIT_WIN)
    spec = np.abs(np.fft.rfft(frames * win, n=UNIT_FFT, axis=1))
    fb = mel_filterbank(UNIT_SAMPLE_RATE, UNIT_FFT, UNIT_MELS, 50.0, 7600.0)
    mel = np.log(np.maximum(spec @ fb.T, 1e-5))
    # per-utterance mean/var normalization: units should capture spectral
    # shape, not the recording's loudness/channel
    mel = (mel - mel.mean(axis=0)) / (mel.std(axis=0) + 1e-5)
    return mel.astype(np.float32), rms


def voiced_mask(rms: np.ndarray) -> np.ndarray:
    peak = float(rms.max()) if rms.size else 0.0
    if peak <= 0:
        return np.zeros_like(rms, dtype=bool)
    return rms > peak * 10 ** (_SIL_REL_DB / 20.0)


def fit_units(feature_list: list[np.ndarray], k: int = 26, seed: int = 0,
              iters: int = 25) -> np.ndarray:
    """k-means (k-means++ init, Lloyd iterations) -> centroids [k, D]."""
    X = np.concatenate([f for f in feature_list if len(f)], axis=0)
    rng = np.random.default_rng(seed)
    # k-means++ seeding
    centroids = [X[rng.integers(len(X))]]
    d2 = ((X - centroids[0]) ** 2).sum(axis=1)
    for _ in range(1, k):
        p = d2 / d2.sum()
        centroids.append(X[rng.choice(len(X), p=p)])
        d2 = np.minimum(d2, ((X - centroids[-1]) ** 2).sum(axis=1))
    C = np.stack(centroids)
    for _ in range(iters):
        # assign in chunks to bound memory
        labels = np.empty(len(X), np.int32)
        for i in range(0, len(X), 65536):
            x = X[i : i + 65536]
            d = ((x[:, None, :] - C[None]) ** 2).sum(axis=2)
            labels[i : i + len(x)] = d.argmin(axis=1)
        for j in range(k):
            sel = labels == j
            if sel.any():
                C[j] = X[sel].mean(axis=0)
            else:  # dead centroid: reseed at the worst-served point
                far = ((X - C[labels]) ** 2).sum(axis=1).argmax()
                C[j] = X[far]
    return C.astype(np.float32)


def assign_units(mel: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    d = ((mel[:, None, :] - centroids[None]) ** 2).sum(axis=2)
    return d.argmin(axis=1).astype(np.int32)


def _median3(x: np.ndarray) -> np.ndarray:
    if len(x) < 3:
        return x
    y = x.copy()
    a, b, c = x[:-2], x[1:-1], x[2:]
    y[1:-1] = np.maximum(np.minimum(a, b),
                         np.minimum(np.maximum(a, b), c))
    return y


def transcribe(wav: np.ndarray, centroids: np.ndarray,
               min_run: int = 2, space_gap: int = 8) -> str:
    """16 kHz wav -> pseudo-transcript over UNIT_LETTERS.

    Silence gaps >= `space_gap` frames become single spaces; unit runs
    shorter than `min_run` frames are absorbed into the previous run
    (de-noising the frame classifier without breaking monotonicity).
    """
    mel, rms = unit_features(wav)
    if len(mel) == 0:
        return ""
    units = _median3(assign_units(mel, centroids))
    voiced = voiced_mask(rms)

    out: list[str] = []

    def emit(ch):
        # adjacent identical letters merge (a dropped short run between two
        # runs of the same unit would otherwise leave "aa", which CTC can
        # only align through an improbable mid-speech blank)
        if not out or out[-1] != ch:
            out.append(ch)

    run_char, run_len = None, 0
    silence = 0
    for t in range(len(units)):
        if not voiced[t]:
            silence += 1
            continue
        c = UNIT_LETTERS[int(units[t]) % len(UNIT_LETTERS)]
        if silence >= space_gap and out:
            if run_char is not None and run_len >= min_run:
                emit(run_char)
            run_char, run_len = None, 0
            if out and out[-1] != " ":
                out.append(" ")
        silence = 0
        if c == run_char:
            run_len += 1
        else:
            if run_char is not None and run_len >= min_run:
                emit(run_char)
            # short runs are dropped (absorbed into neighbors by the
            # aligner's silence/duration distribution)
            run_char, run_len = c, 1
    if run_char is not None and run_len >= min_run:
        emit(run_char)
    return "".join(out).strip()


def save_units(path: str, centroids: np.ndarray) -> None:
    np.savez(path, centroids=centroids,
             sample_rate=UNIT_SAMPLE_RATE, hop=UNIT_HOP)


def load_units(path: str) -> np.ndarray:
    with np.load(path) as z:
        assert int(z["sample_rate"]) == UNIT_SAMPLE_RATE
        assert int(z["hop"]) == UNIT_HOP
        return z["centroids"].astype(np.float32)


def segment_wav(wav: np.ndarray, sr: int, min_s: float = 2.5,
                max_s: float = 12.0, gap_s: float = 0.12) -> list[tuple[int, int]]:
    """Split at silences into utterance-sized (start, end) sample spans.

    Greedy: accumulate speech until >= min_s and a silence gap >= gap_s
    appears (or max_s forces a cut at the quietest recent frame).
    """
    hop = int(sr * 0.02)
    n = len(wav) // hop
    rms = np.sqrt((wav[: n * hop].reshape(n, hop) ** 2).mean(axis=1))
    voiced = voiced_mask(rms)
    gap_frames = max(1, int(gap_s / 0.02))
    min_f, max_f = int(min_s / 0.02), int(max_s / 0.02)

    spans = []
    start = 0
    t = 0
    while t < n:
        length = t - start
        is_gap = not voiced[max(0, t - gap_frames) : t + 1].any()
        if (length >= min_f and is_gap) or length >= max_f:
            spans.append((start * hop, t * hop))
            start = t
        t += 1
    if n - start >= min_f // 2:
        spans.append((start * hop, len(wav)))
    elif spans:
        spans[-1] = (spans[-1][0], len(wav))
    return spans
