"""Host-side audio utilities: wav IO, resampling, silence trimming, and
preprocessing's hop thresholds and loudness normalization.

The reference's librosa calls (reference zerovox/tts/synthesize.py:113-126)
and its ffmpeg loudness chain (utils/preprocess.py:155-161) as
self-contained numpy/scipy code, a copy of the JAX package's `dsp/audio.py`.
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np
import scipy.io.wavfile
import scipy.signal


def load_wav(path, target_sr: int | None = None) -> tuple[np.ndarray, int]:
    """Load a wav file as float32 mono in [-1, 1], optionally resampled."""
    sr, audio = scipy.io.wavfile.read(path)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 32768.0
    elif audio.dtype == np.int32:
        audio = audio.astype(np.float32) / 2147483648.0
    elif audio.dtype == np.uint8:
        audio = (audio.astype(np.float32) - 128.0) / 128.0
    else:
        audio = audio.astype(np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if target_sr is not None and target_sr != sr:
        audio = resample(audio, sr, target_sr)
        sr = target_sr
    return audio, sr


def save_wav(path, audio: np.ndarray, sampling_rate: int) -> None:
    """Write float audio in [-1, 1] as 16-bit PCM (reference scaling: *32760)."""
    wav = (np.asarray(audio, dtype=np.float32) * 32760).astype("int16")
    scipy.io.wavfile.write(path, sampling_rate, wav)


def resample(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (higher quality than FFT resample for speech)."""
    if sr == target_sr:
        return audio.astype(np.float32)
    g = np.gcd(int(sr), int(target_sr))
    return scipy.signal.resample_poly(audio, target_sr // g, sr // g).astype(np.float32)


def _rms_frames(y: np.ndarray, frame_length: int = 2048, hop_length: int = 512) -> np.ndarray:
    """Center-padded frame-wise RMS (librosa.feature.rms semantics)."""
    pad = frame_length // 2
    yp = np.pad(y, (pad, pad), mode="constant")
    n_frames = 1 + (len(yp) - frame_length) // hop_length
    if n_frames <= 0:
        return np.zeros(0, dtype=np.float32)
    idx = (np.arange(n_frames) * hop_length)[:, None] + np.arange(frame_length)[None, :]
    frames = yp[idx]
    return np.sqrt(np.mean(frames**2, axis=1))


def trim_silence(
    audio: np.ndarray,
    top_db: float = 40.0,
    frame_length: int = 2048,
    hop_length: int = 512,
) -> tuple[np.ndarray, tuple[int, int]]:
    """Trim leading/trailing silence (librosa.effects.trim semantics).

    Frames whose power is more than `top_db` dB below the peak power are
    considered silent. Used before speaker-embedding extraction (reference
    zerovox/tts/synthesize.py:126).
    """
    rms = _rms_frames(audio, frame_length, hop_length)
    if rms.size == 0:
        return audio, (0, len(audio))
    power = rms**2
    ref = np.max(power)
    if ref <= 0:
        return audio, (0, len(audio))
    db = 10.0 * np.log10(np.maximum(power / ref, 1e-20))
    non_silent = np.flatnonzero(db > -top_db)
    if non_silent.size == 0:
        return audio, (0, len(audio))
    start = int(non_silent[0]) * hop_length
    end = min(len(audio), int(non_silent[-1] + 1) * hop_length)
    return audio[start:end], (start, end)


def first_and_last_hop_above_threshold(
    audio: np.ndarray, hop_size: int, threshold: float
) -> tuple[int, int]:
    """First/last hop index containing a sample above `threshold`
    (reference utils/preprocess.py:93-123, vectorized)."""
    num_hops = max(0, (len(audio) - 1) // hop_size)
    if num_hops == 0:
        return 0, -1
    trimmed = np.abs(audio[: num_hops * hop_size]).reshape(num_hops, hop_size)
    mask = (trimmed > threshold).any(axis=1)
    # last partial hop
    if len(audio) > num_hops * hop_size:
        pass  # reference ignores the tail beyond the last full hop boundary
    nz = np.flatnonzero(mask)
    if nz.size == 0:
        return 0, num_hops - 1
    return int(nz[0]), int(nz[-1])


def _k_weighting_coeffs(fs: float) -> tuple[np.ndarray, np.ndarray]:
    """ITU-R BS.1770-4 K-weighting pre-filter as two biquads for any sample
    rate. The spec tabulates coefficients at 48 kHz only; for other rates the
    biquads are re-derived from the analog prototypes behind those tables
    (the standard practice, e.g. pyloudnorm): a +4 dB high-shelf modelling
    head diffraction and the RLB revised low-frequency B-curve high-pass.
    At fs=48000 this reproduces the spec's Table 1/2 coefficients to ~1e-6.
    Returns (sos_shelf, sos_highpass) second-order sections."""
    # stage 1: spherical-head high shelf
    db, f0, q = 3.999843853973347, 1681.974450955533, 0.7071752369554196
    K = np.tan(np.pi * f0 / fs)
    Vh = 10.0 ** (db / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / q + K * K
    b = np.array([
        (Vh + Vb * K / q + K * K) / a0,
        2.0 * (K * K - Vh) / a0,
        (Vh - Vb * K / q + K * K) / a0,
    ])
    a = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / q + K * K) / a0])
    shelf = np.concatenate([b, a])

    # stage 2: RLB high-pass
    f0, q = 38.13547087602444, 0.5003270373238773
    K = np.tan(np.pi * f0 / fs)
    a0 = 1.0 + K / q + K * K
    b = np.array([1.0, -2.0, 1.0])
    a = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / q + K * K) / a0])
    hp = np.concatenate([b, a])
    return shelf, hp


def measure_lufs(audio: np.ndarray, sampling_rate: int) -> float:
    """Integrated loudness (LUFS) of mono audio per ITU-R BS.1770-4:
    K-weighting -> mean square over 400 ms blocks with 75% overlap ->
    absolute gate at -70 LUFS -> relative gate 10 LU below the gated mean.
    A full-scale 1 kHz sine reads -3.01 LUFS (spec annex 1 conformance
    point; validated in tests/test_dsp.py at several sample rates).
    Returns -inf for silence/empty input."""
    x = np.asarray(audio, dtype=np.float64)
    block = int(round(0.400 * sampling_rate))
    if x.size < block or block == 0:
        return float("-inf")

    shelf, hp = _k_weighting_coeffs(sampling_rate)
    xw = scipy.signal.sosfilt(np.stack([shelf, hp]), x)

    hop = block // 4  # 75% overlap
    n_blocks = 1 + (len(xw) - block) // hop
    starts = np.arange(n_blocks) * hop
    # mean square per block via cumulative sum (O(n))
    csum = np.concatenate([[0.0], np.cumsum(xw * xw)])
    ms = (csum[starts + block] - csum[starts]) / block

    with np.errstate(divide="ignore"):
        l_blocks = -0.691 + 10.0 * np.log10(np.maximum(ms, 1e-30))
    abs_gated = ms[l_blocks > -70.0]
    if abs_gated.size == 0:
        return float("-inf")
    rel_thresh = -0.691 + 10.0 * np.log10(abs_gated.mean()) - 10.0
    gated = ms[(l_blocks > -70.0) & (l_blocks > rel_thresh)]
    if gated.size == 0:
        return float("-inf")
    return float(-0.691 + 10.0 * np.log10(gated.mean()))


def loudness_normalize(
    audio: np.ndarray,
    sampling_rate: int,
    target_lufs: float = -14.0,
    compress: bool = True,
) -> np.ndarray:
    """Approximate `ffmpeg acompressor,loudnorm=I=-14` for environments
    without ffmpeg (reference utils/preprocess.py:155-161): a gentle
    envelope compressor followed by a BS.1770-4 integrated-loudness gain to
    `target_lufs` (linear-gain mode, what loudnorm does on its second pass),
    with a -0.1 dBFS true-peak-ish safety clamp.
    """
    x = np.asarray(audio, dtype=np.float64)
    if x.size == 0:
        return audio.astype(np.float32)

    if compress:
        # gentle compressor: ratio 2:1 above -18 dBFS on the envelope
        env = np.abs(scipy.signal.lfilter([1 - 0.999], [1, -0.999], np.abs(x)))
        thr = 10 ** (-18 / 20)
        gain = np.where(env > thr, (thr / np.maximum(env, 1e-9)) ** 0.5, 1.0)
        x = x * gain

    lufs = measure_lufs(x, sampling_rate)
    if not np.isfinite(lufs):
        return x.astype(np.float32)
    y = x * (10 ** ((target_lufs - lufs) / 20))
    peak = np.max(np.abs(y))
    if peak > 0.99:
        y = y * (0.99 / peak)
    return y.astype(np.float32)


def ffmpeg_loudnorm_resample(in_path, out_path, target_sr: int) -> bool:
    """Run the reference's exact ffmpeg filter chain when ffmpeg is present
    (reference utils/preprocess.py:155-161). Returns False when unavailable."""
    if shutil.which("ffmpeg") is None:
        return False
    cmd = [
        "ffmpeg", "-y", "-v", "quiet",
        "-i", str(in_path),
        "-filter", f"acompressor,loudnorm=I=-14.0,aresample={target_sr}",
        "-ac", "1",
        str(out_path),
    ]
    return subprocess.run(cmd).returncode == 0
