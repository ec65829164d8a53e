"""Log-mel spectrogram frontend in PyTorch.

The counterpart of the JAX package's `dsp/mels.py`: reflect-pad by
(fft_size - hop_size) / 2 on both sides -> framed periodic-hann STFT
(center=False) -> magnitude -> Slaney mel filterbank -> log(clip(., 1e-5)),
plus the frame energy (L2 norm of the magnitude spectrum). The filterbank
is Slaney-scale and Slaney-normalized (librosa's default).
"""

from __future__ import annotations

import numpy as np
import torch

from zerovox_tpu_torch.device import resolve_device


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


def mel_filterbank(sampling_rate: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float | None) -> np.ndarray:
    """Slaney-scale, area-normalized triangular filterbank [n_mels, 1 + n_fft // 2]."""
    if fmax is None:
        fmax = sampling_rate / 2.0
    fftfreqs = np.linspace(0.0, sampling_rate / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                                          n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic hann window."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


class MelFrontend:
    """Audio -> (log-mel [n_mels, T], energy [T]) on a given device.

    `device` None means the CUDA card (raising without one); pass
    device="cpu" to run on the CPU. `dtype` is the arithmetic's (the
    filterbank and window are the float32 ones either way)."""

    def __init__(self, sampling_rate: int = 22050, fft_size: int = 1024, hop_size: int = 256,
                 win_length: int = 1024, num_mels: int = 80, fmin: float = 0,
                 fmax: float | None = 8000, device=None, dtype=torch.float32):
        if win_length > fft_size:
            raise ValueError("win_length must not exceed fft_size")
        self.fft_size = fft_size
        self.hop_size = hop_size
        self.device = resolve_device(device)
        self.dtype = dtype
        self._mel_basis = torch.tensor(
            mel_filterbank(sampling_rate, fft_size, num_mels, fmin, fmax),
            device=self.device).to(dtype)
        win = hann_window(win_length)
        if win_length < fft_size:  # center-pad the window to fft_size
            lpad = (fft_size - win_length) // 2
            win = np.pad(win, (lpad, fft_size - win_length - lpad))
        self._window = torch.tensor(win, device=self.device).to(dtype)
        self._pad = (fft_size - hop_size) // 2

    def num_frames(self, num_samples: int) -> int:
        return max(0, 1 + (num_samples + 2 * self._pad - self.fft_size) // self.hop_size)

    def __call__(self, audio: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """audio [N] float in [-1, 1] -> (mel [n_mels, T], energy [T]) on the device."""
        audio = np.pad(np.asarray(audio, dtype=np.float32), (self._pad, self._pad),
                       mode="reflect")
        x = torch.tensor(audio, device=self.device).to(self.dtype)
        frames = x.unfold(0, self.fft_size, self.hop_size) * self._window[None, :]
        mags = torch.abs(torch.fft.rfft(frames, n=self.fft_size, dim=-1)).T  # [F, T]
        mel = torch.log(torch.clamp(self._mel_basis @ mags, min=1e-5))
        energy = torch.linalg.vector_norm(mags, dim=0)
        return mel, energy


_frontend_cache: dict[tuple, MelFrontend] = {}


def get_mel_from_wav(audio: np.ndarray, sampling_rate: int, fft_size: int, hop_size: int,
                     win_length: int, num_mels: int, fmin: float, fmax: float | None,
                     device=None) -> tuple[np.ndarray, np.ndarray]:
    """The reference's `get_mel_from_wav`: numpy audio in, (mel [num_mels,
    T], energy [T]) as float32 numpy out, computed on `device` (None: the
    card). Frontends are cached per (configuration, device). The JAX
    package pads to a length bucket to bound its compiled programs and
    slices back; the frames it keeps are these.

    The STFT runs in float64: preprocessing writes each training target
    once, and at quiet bins the log amplifies a float32 FFT's rounding to
    ~8e-5 of the exact log-mel (XLA's, pocketfft's and cuFFT's each, in
    their own directions); in float64 the card and the CPU write the same
    targets, and the JAX package's float32 rounding is all that separates
    them from its files."""
    if np.min(audio) < -1.0:
        print(f"WARNING: get_mel_from_wav: audio min value < -1.0 : {np.min(audio)}")
    if np.max(audio) > 1.0:
        print(f"WARNING: get_mel_from_wav: audio max value >  1.0 : {np.max(audio)}")
    device = resolve_device(device)
    key = (sampling_rate, fft_size, hop_size, win_length, num_mels, fmin, fmax, str(device))
    fe = _frontend_cache.get(key)
    if fe is None:
        fe = MelFrontend(sampling_rate, fft_size, hop_size, win_length, num_mels, fmin, fmax,
                         device=device, dtype=torch.float64)
        _frontend_cache[key] = fe
    mel, energy = fe(audio)
    return mel.float().cpu().numpy(), energy.float().cpu().numpy()
