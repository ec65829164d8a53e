"""The bundled CTC alignment model for tone-speak corpora, in PyTorch.

The reference aligns with torchaudio's pretrained MMS_FA wav2vec2 CTC bundle
(utils/preprocess.py:333-342). The repository ships, instead, a small CTC
model trained on the deterministic tone-speak voice (utils/synthvoice.py),
where every character has a known acoustic signature and exact boundaries:
the JAX package's `preprocess/tone_ctc.py` with its weights
`tone_ctc_weights.npz`, of which this package keeps a copy. The net is
two Conv1d(96, k=5, p=2) + ReLU and a Linear to the 28 CTC classes, over
per-utterance normalized 16 kHz log-mels at hop 320 (MMS_FA's frame rate),
computed on the device; weights come through `weights.tone_ctc_from_flax`.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from zerovox_tpu_torch.device import resolve_device, use_full_f32
from zerovox_tpu_torch.dsp.mels import MelFrontend
from zerovox_tpu_torch.preprocess.aligner import DEFAULT_LABELS, AlignerBase

WEIGHTS_FILE = os.path.join(os.path.dirname(__file__), "tone_ctc_weights.npz")

SAMPLE_RATE = 16000
HOP = 320
NUM_MELS = 40


class ToneCTCNet(nn.Module):
    """mel [B, T, M] -> per-frame CTC logits [B, T, C]."""

    def __init__(self, num_mels: int = NUM_MELS, num_classes: int = len(DEFAULT_LABELS),
                 hidden: int = 96):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv1d(num_mels, hidden, 5, padding=2),
                                    nn.Conv1d(hidden, hidden, 5, padding=2)])
        self.dense = nn.Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        for conv in self.convs:
            x = torch.relu(conv(x))
        return self.dense(x.transpose(1, 2))


def make_frontend(device=None) -> MelFrontend:
    """16 kHz log-mel at the MMS_FA frame rate (hop 320 -> 50 fps), in
    float64 as preprocessing's mel (dsp.mels.get_mel_from_wav): a float32
    FFT's rounding, amplified by the log at quiet bins, would put the card's
    emissions ~1e-4 from the CPU's."""
    return MelFrontend(sampling_rate=SAMPLE_RATE, fft_size=512, hop_size=HOP, win_length=400,
                       num_mels=NUM_MELS, fmin=0, fmax=8000, device=device, dtype=torch.float64)


def extract_features(frontend: MelFrontend, wav: np.ndarray, hop: int = HOP) -> torch.Tensor:
    """Per-utterance mean/var-normalized log-mel [T, M] in float32 on the
    frontend's device, T = len(wav) // hop."""
    mel, _ = frontend(np.asarray(wav, np.float32))
    mel = mel.T[: len(wav) // hop]
    return ((mel - mel.mean()) / (mel.std(correction=0) + 1e-5)).float()


def load_params(path=WEIGHTS_FILE) -> dict:
    """The flax params tree {"Conv1d_0": {"kernel", "bias"}, ...} of the npz."""
    params: dict = {}
    with np.load(path) as z:
        for key in z.files:
            module, name = key.split("/")
            params.setdefault(module, {})[name] = z[key]
    return params


class ToneCTCAligner(AlignerBase):
    """Emissions from the bundled tone-speak CTC model (16 kHz, hop 320) on
    `device` (None: the CUDA card, raising without one)."""

    sample_rate = SAMPLE_RATE
    hop_size = HOP

    def __init__(self, weights_path: str = WEIGHTS_FILE, device=None):
        from zerovox_tpu_torch.weights import tone_ctc_from_flax

        super().__init__(DEFAULT_LABELS)
        if not os.path.exists(weights_path):
            raise FileNotFoundError(f"tone CTC weights not found at {weights_path}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_full_f32()
        self._net = ToneCTCNet()
        self._net.load_state_dict(tone_ctc_from_flax(load_params(weights_path)))
        self._net.eval().to(self.device)
        self._frontend = make_frontend(self.device)

    def features(self, wav: np.ndarray) -> torch.Tensor:
        """wav [n] -> normalized log-mel [T, M] on the device (T = n // hop)."""
        return extract_features(self._frontend, wav, self.hop_size)

    def emissions(self, wav_batch: np.ndarray) -> np.ndarray:
        """[B, n] wavs -> [B, n // hop, 28] log-probabilities (numpy)."""
        return self.emissions_device(wav_batch).cpu().numpy()

    def emissions_device(self, wav_batch: np.ndarray) -> torch.Tensor:
        """`emissions`, left on the device."""
        T = wav_batch.shape[1] // self.hop_size
        mels = torch.zeros((len(wav_batch), T, NUM_MELS), device=self.device)
        for b, w in enumerate(wav_batch):
            f = self.features(w)[:T]
            mels[b, : len(f)] = f
        with torch.inference_mode():
            return torch.log_softmax(self._net(mels), dim=-1)
