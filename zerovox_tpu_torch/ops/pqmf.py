"""Pseudo-QMF multiband filter bank.

The PyTorch counterpart of the JAX package's `ops/pqmf.py`: legacy
multi-band MelGAN-family vocoders emit N subband signals that PQMF
synthesis recombines into the full-band waveform (`MelDec(subbands=N)`).
The filters are the standard near-perfect-reconstruction cosine-modulated
bank on a Kaiser-windowed sinc prototype, designed in numpy; analysis is
one conv and a decimation, synthesis a zero-stuffed upsample and one conv
(cuDNN on the card). Not a TPU kernel: no kernel of its own.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _design_prototype(taps: int, cutoff_ratio: float, beta: float) -> np.ndarray:
    """Kaiser-windowed sinc lowpass prototype h[n], n = 0..taps."""
    n = np.arange(taps + 1)
    arg = cutoff_ratio * (n - 0.5 * taps)
    h_i = np.where(np.abs(arg) < 1e-9, cutoff_ratio,
                   np.sin(np.pi * arg) / (np.pi * (n - 0.5 * taps + 1e-12)))
    if taps % 2 == 0:  # the center tap exactly
        h_i[taps // 2] = cutoff_ratio
    return h_i * np.kaiser(taps + 1, beta)


class PQMF:
    """N-band pseudo-QMF analysis and synthesis (defaults: the common
    multi-band MelGAN configuration, 4 bands, 62 taps, cutoff 0.142, Kaiser
    beta 9). The filters follow the input's device and dtype."""

    def __init__(self, subbands: int = 4, taps: int = 62, cutoff_ratio: float = 0.142,
                 beta: float = 9.0):
        self.subbands = subbands
        self.taps = taps
        h = _design_prototype(taps, cutoff_ratio, beta)
        k = np.arange(subbands)[:, None]
        n = np.arange(taps + 1)[None, :]
        phase = (2 * k + 1) * np.pi / (2 * subbands) * (n - taps / 2)
        # conv weights (out, in, k): analysis [S, 1, taps + 1], synthesis [1, S, taps + 1]
        self._analysis = torch.tensor((2 * h * np.cos(phase + (-1) ** k * np.pi / 4))[:, None],
                                      dtype=torch.float32)
        self._synthesis = torch.tensor((2 * h * np.cos(phase - (-1) ** k * np.pi / 4))[None],
                                       dtype=torch.float32)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, T // subbands, subbands]."""
        w = self._analysis.to(x.device, x.dtype)
        y = F.conv1d(x[:, None], w, padding=self.taps // 2)
        return y[:, :, ::self.subbands].transpose(1, 2)

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, subbands] (or [B, subbands, T]) -> [B, T * subbands]."""
        S = self.subbands
        if x.shape[1] == S and x.shape[2] != S:
            x = x.transpose(1, 2)
        B, T, _ = x.shape
        # zero-stuffed upsample by S, scaled by S, then the synthesis filter
        up = x.new_zeros(B, S, T * S)
        up[:, :, ::S] = x.transpose(1, 2) * S
        w = self._synthesis.to(x.device, x.dtype)
        return F.conv1d(up, w, padding=self.taps // 2)[:, 0]
