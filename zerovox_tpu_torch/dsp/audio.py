"""Host-side audio utilities of synthesis: wav IO, resampling, silence trimming.

The reference's librosa calls (reference zerovox/tts/synthesize.py:113-126)
as self-contained numpy/scipy code, the same as the JAX package's
`dsp/audio.py`. Its loudness tools belong to preprocessing, a later slice.
"""

from __future__ import annotations

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
