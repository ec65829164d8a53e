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
    """Audio -> (log-mel [n_mels, T], energy [T]) on a given device."""

    def __init__(self, sampling_rate: int = 22050, fft_size: int = 1024, hop_size: int = 256,
                 win_length: int = 1024, num_mels: int = 80, fmin: float = 0,
                 fmax: float | None = 8000, device="cpu"):
        if win_length > fft_size:
            raise ValueError("win_length must not exceed fft_size")
        self.fft_size = fft_size
        self.hop_size = hop_size
        self.device = torch.device(device)
        self._mel_basis = torch.tensor(
            mel_filterbank(sampling_rate, fft_size, num_mels, fmin, fmax), device=self.device)
        win = hann_window(win_length)
        if win_length < fft_size:  # center-pad the window to fft_size
            lpad = (fft_size - win_length) // 2
            win = np.pad(win, (lpad, fft_size - win_length - lpad))
        self._window = torch.tensor(win, device=self.device)
        self._pad = (fft_size - hop_size) // 2

    def num_frames(self, num_samples: int) -> int:
        return max(0, 1 + (num_samples + 2 * self._pad - self.fft_size) // self.hop_size)

    def __call__(self, audio: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """audio [N] float in [-1, 1] -> (mel [n_mels, T], energy [T]) on the device."""
        audio = np.pad(np.asarray(audio, dtype=np.float32), (self._pad, self._pad),
                       mode="reflect")
        x = torch.tensor(audio, device=self.device)
        frames = x.unfold(0, self.fft_size, self.hop_size) * self._window[None, :]
        mags = torch.abs(torch.fft.rfft(frames, n=self.fft_size, dim=-1)).T  # [F, T]
        mel = torch.log(torch.clamp(self._mel_basis @ mags, min=1e-5))
        energy = torch.linalg.vector_norm(mags, dim=0)
        return mel, energy
