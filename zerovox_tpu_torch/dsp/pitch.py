"""Frame-level fundamental-frequency (F0) estimation.

Replaces the reference's pyworld DIO+StoneMask pipeline
(reference utils/preprocess.py:179-187) with a self-contained, vectorized
YIN-style estimator (difference function via FFT autocorrelation, cumulative
mean normalization, absolute threshold, parabolic interpolation). Output
contract matches pyworld: one F0 value per hop-aligned frame, 0.0 where
unvoiced, so downstream phoneme-level averaging and interpolation
(utils/preprocess.py:222-265) behave identically.
"""

from __future__ import annotations

import numpy as np


def estimate_f0(
    audio: np.ndarray,
    sampling_rate: int,
    hop_size: int,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    frame_length: int | None = None,
    threshold: float = 0.15,
) -> np.ndarray:
    """Return F0 [num_frames] in Hz (0 = unvoiced); num_frames = len(audio)//hop + 1
    (pyworld.dio frame-count convention for frame_period = hop/sr*1000)."""
    x = np.asarray(audio, dtype=np.float64)
    num_frames = len(x) // hop_size + 1

    tau_min = max(2, int(sampling_rate / f0_ceil))
    tau_max = int(sampling_rate / f0_floor)
    if frame_length is None:
        frame_length = 2 * tau_max  # window must cover two periods of f0_floor

    # frame the signal centered on each hop
    half = frame_length // 2
    xp = np.pad(x, (half, half + frame_length), mode="constant")
    starts = np.arange(num_frames) * hop_size
    idx = starts[:, None] + np.arange(frame_length)[None, :]
    frames = xp[idx]  # [F, W]

    # difference function d(tau) via autocorrelation:
    # d(t) = r(0) + sum_{j<W-t} x_{j+t}^2 - 2*ac(t)
    W = frame_length
    nfft = 1 << int(np.ceil(np.log2(2 * W)))
    fft = np.fft.rfft(frames, nfft, axis=1)
    ac = np.fft.irfft(fft * np.conj(fft), nfft, axis=1)[:, : tau_max + 1]  # [F, tau]

    sq = frames**2
    # cumsum of squared samples from the end: energy of x[tau:] and x[:W-tau]
    c = np.concatenate([np.zeros((len(frames), 1)), np.cumsum(sq, axis=1)], axis=1)  # [F, W+1]
    taus = np.arange(tau_max + 1)
    e_head = c[:, W - taus]  # energy of x[:W-tau]
    e_tail = c[:, [W]] - c[:, taus]  # energy of x[tau:]
    d = e_head + e_tail - 2 * ac  # [F, tau]
    d = np.maximum(d, 0.0)

    # cumulative mean normalized difference function
    with np.errstate(divide="ignore", invalid="ignore"):
        cum = np.cumsum(d[:, 1:], axis=1)
        cmndf = d[:, 1:] * np.arange(1, tau_max + 1)[None, :] / np.maximum(cum, 1e-12)
    cmndf = np.concatenate([np.ones((len(frames), 1)), cmndf], axis=1)  # [F, tau+1]

    # first tau >= tau_min below threshold; else global min
    search = cmndf[:, : tau_max + 1].copy()
    search[:, :tau_min] = np.inf
    below = search < threshold
    first_below = np.argmax(below, axis=1)
    has_below = below.any(axis=1)
    best = np.where(has_below, first_below, np.argmin(search, axis=1))

    # refine: within a dip, walk to the local minimum after the first
    # crossing. Low F0s have wide dips — the first sub-threshold tau can sit
    # 10+ taus before the true minimum, biasing estimates sharp — so the
    # search window is as wide as possible without reaching the next dip
    # (dips are >= tau_min apart).
    win = max(8, tau_min - 2)
    cols = np.clip(best[:, None] + np.arange(win)[None, :], 0, tau_max)
    local = np.take_along_axis(cmndf, cols, axis=1)
    best = cols[np.arange(len(frames)), np.argmin(local, axis=1)]

    # parabolic interpolation around best tau
    b = np.clip(best, 1, tau_max - 1)
    y0 = np.take_along_axis(cmndf, (b - 1)[:, None], 1)[:, 0]
    y1 = np.take_along_axis(cmndf, b[:, None], 1)[:, 0]
    y2 = np.take_along_axis(cmndf, (b + 1)[:, None], 1)[:, 0]
    denom = y0 - 2 * y1 + y2
    delta = np.where(np.abs(denom) > 1e-12, 0.5 * (y0 - y2) / np.maximum(np.abs(denom), 1e-12) * np.sign(denom), 0.0)
    delta = np.clip(delta, -0.5, 0.5)
    tau_refined = b + delta

    f0 = sampling_rate / np.maximum(tau_refined, 1e-6)

    # voicing decision: dip depth + minimal energy
    dip = np.take_along_axis(cmndf, best[:, None], 1)[:, 0]
    frame_rms = np.sqrt(np.mean(frames**2, axis=1))
    voiced = (dip < max(threshold, 0.3)) & (frame_rms > 1e-4) & (f0 >= f0_floor) & (f0 <= f0_ceil)

    return np.where(voiced, f0, 0.0).astype(np.float64)


def interpolate_f0(pitch: np.ndarray) -> np.ndarray:
    """Linear interpolation over unvoiced (zero) gaps, edge-filled
    (reference utils/preprocess.py:222-232 semantics)."""
    pitch = np.asarray(pitch, dtype=np.float64)
    nonzero = np.flatnonzero(pitch != 0)
    if nonzero.size == 0:
        return pitch
    return np.interp(
        np.arange(len(pitch)),
        nonzero,
        pitch[nonzero],
        left=pitch[nonzero[0]],
        right=pitch[nonzero[-1]],
    )


def phoneme_level_average(values: np.ndarray, durations) -> np.ndarray:
    """Mean of `values` over each phoneme's duration span
    (reference utils/preprocess.py:238-265 semantics, including the edge
    handling when a span runs past the end of the signal)."""
    values = np.asarray(values)
    out = np.zeros(len(durations), dtype=values.dtype)
    pos = 0
    n = len(values)
    for i, d in enumerate(durations):
        d = int(d)
        if d > 0 and pos + d < n:
            out[i] = np.mean(values[pos : pos + d])
        else:
            out[i] = values[pos] if pos < n else values[-1]
        pos += d
    return out
