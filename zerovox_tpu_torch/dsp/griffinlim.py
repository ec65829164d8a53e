"""Griffin-Lim mel inversion.

The PyTorch counterpart of the JAX package's `dsp/griffinlim.py`: an
audible rendering of a log-mel without a trained vocoder. Log-mel ->
linear magnitudes through the column-normalized transposed filterbank ->
`n_iter` Griffin-Lim projections from zero phase (inverse STFT with
window-squared normalization, forward STFT, keep the phase) -> peak
normalized to 0.9. The FFTs are torch.fft (cuFFT on the card) and the
overlap-add is `index_add_`. Not a TPU kernel: no kernel of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from zerovox_tpu_torch.device import resolve_device
from zerovox_tpu_torch.dsp.mels import hann_window, mel_filterbank


class GriffinLim:
    """mel [T, n_mels] (log-compressed, as the model emits) -> wav [N]."""

    def __init__(self, sampling_rate: int = 22050, fft_size: int = 1024, hop_size: int = 256,
                 win_length: int = 1024, num_mels: int = 80, fmin: float = 0,
                 fmax: float | None = 8000, n_iter: int = 32, power: float = 1.0,
                 device=None):
        """`device` None means the CUDA card (raising without one); pass
        device="cpu" to run on the CPU."""
        self.fft_size = fft_size
        self.hop_size = hop_size
        self.n_iter = n_iter
        self.power = power
        self.device = resolve_device(device)
        fb = mel_filterbank(sampling_rate, fft_size, num_mels, fmin, fmax)
        # transposed inverse with column normalization: each fft bin's mel
        # weights sum to ~1, so magnitudes land at the right scale
        col = fb.sum(axis=0, keepdims=True)
        self._fb_inv = torch.tensor((fb / np.maximum(col, 1e-8)).T, device=self.device)
        win = hann_window(win_length)
        if win_length < fft_size:
            lpad = (fft_size - win_length) // 2
            win = np.pad(win, (lpad, fft_size - win_length - lpad))
        self._window = torch.tensor(win, device=self.device)

    @torch.no_grad()
    def invert(self, mel: torch.Tensor) -> torch.Tensor:
        """log-mel [T, n_mels] on the device -> wav [N] float32 on the device."""
        fft, hop, win = self.fft_size, self.hop_size, self._window
        mag = torch.clamp(torch.exp(mel) @ self._fb_inv.T, min=0.0) ** self.power  # [T, bins]
        T = mag.shape[0]
        n = (T - 1) * hop + fft
        idx = (torch.arange(T, device=mel.device)[:, None] * hop
               + torch.arange(fft, device=mel.device)[None, :]).reshape(-1)
        wsum = torch.zeros(n, device=mel.device).index_add_(0, idx, (win ** 2).repeat(T))
        wsum = torch.clamp(wsum, min=1e-8)

        def istft(spec):
            frames = torch.fft.irfft(spec, n=fft, dim=-1) * win[None]
            return torch.zeros(n, device=mel.device).index_add_(0, idx, frames.reshape(-1)) / wsum

        def stft(y):
            return torch.fft.rfft(y.unfold(0, fft, hop) * win[None], n=fft, dim=-1)

        spec = mag.to(torch.complex64)  # zero phase
        for _ in range(self.n_iter):
            s = stft(istft(spec))
            spec = mag * (s / torch.clamp(torch.abs(s), min=1e-8))
        y = istft(spec)
        return (y / torch.clamp(torch.max(torch.abs(y)), min=1e-8) * 0.9).float()

    def __call__(self, mel) -> np.ndarray:
        """mel [T, n_mels] log-mel (numpy or tensor) -> wav float32 numpy
        (peak-normalized)."""
        m = torch.tensor(np.asarray(mel, dtype=np.float32)) if not torch.is_tensor(mel) else mel
        m = m.to(self.device, torch.float32)
        return self.invert(m).cpu().numpy()
