"""Alignment acoustic models: per-frame CTC emissions over the romanized
character alphabet.

The reference uses torchaudio's MMS_FA bundle (a wav2vec2 CTC model at 16 kHz,
hop 320; utils/preprocess.py:333-342). This module defines the same contract
as a pluggable interface, as the JAX package's `preprocess/aligner.py` does:

  * ``Wav2Vec2Aligner`` — any HF wav2vec2-CTC checkpoint (e.g. a local
    download of MMS-FA) through `transformers`, run on the device.
  * ``ToneCTCAligner`` (preprocess/tone_ctc.py) — the bundled tone-speak
    CTC model, on the device.
  * ``ClusterAligner`` — emissions from discovered acoustic units (numpy).
  * ``EnergyPseudoAligner`` — a dependency-free fallback that fabricates
    emissions from signal energy so the *full preprocessing pipeline*
    (normalize -> align -> durations/puncts -> features) runs end-to-end in
    tests. Alignments are energy-uniform, not phonetic — fine for pipeline
    validation, not for production corpora.

All expose: labels (index -> char), dictionary (char -> index),
sample_rate, hop_size, and ``emissions(batch_wavs) -> [B, T, C] log-probs``.
"""

from __future__ import annotations

import numpy as np

# MMS_FA-style labels: blank then the uroman alphabet (star omitted, as the
# reference loads the bundle with_star=False / star=None)
DEFAULT_LABELS = ("-",) + tuple("abcdefghijklmnopqrstuvwxyz") + ("'",)


class AlignerBase:
    sample_rate: int = 16000
    hop_size: int = 320

    def __init__(self, labels=DEFAULT_LABELS):
        self.labels = tuple(labels)
        self.dictionary = {c: i for i, c in enumerate(self.labels)}
        self.blank = 0

    def emissions(self, wav_batch: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class EnergyPseudoAligner(AlignerBase):
    """Fallback emissions: voiced frames spread probability uniformly over the
    transcript's characters in order via a soft monotonic ramp; silent frames
    prefer blank. Produces plausible monotonic alignments for pipeline tests."""

    def __init__(self, labels=DEFAULT_LABELS):
        super().__init__(labels)
        self._transcripts: list[str] | None = None

    def set_transcripts(self, transcripts: list[str]):
        """The pseudo aligner needs the targets to fabricate emissions."""
        self._transcripts = [t.replace(" ", "") for t in transcripts]

    def emissions(self, wav_batch: np.ndarray) -> np.ndarray:
        B, n = wav_batch.shape
        T = n // self.hop_size
        C = len(self.labels)
        out = np.full((B, T, C), -12.0, dtype=np.float32)

        for b in range(B):
            wav = wav_batch[b]
            frames = wav[: T * self.hop_size].reshape(T, self.hop_size)
            energy = np.sqrt((frames**2).mean(axis=1))
            active = energy > max(1e-4, 0.05 * energy.max() if energy.max() > 0 else 1)

            tchars = self._transcripts[b] if self._transcripts else ""
            n_act = int(active.sum())
            if tchars and n_act > 0:
                # map active frames onto transcript positions monotonically
                act_idx = np.flatnonzero(active)
                pos = np.minimum((np.arange(n_act) * len(tchars)) // n_act, len(tchars) - 1)
                for f, p in zip(act_idx, pos):
                    c = self.dictionary.get(tchars[p], self.blank)
                    out[b, f, c] = -0.05
                out[b, ~active, self.blank] = -0.05
            else:
                out[b, :, self.blank] = -0.05

        # normalize to log-probabilities
        out = out - np.log(np.exp(out).sum(axis=-1, keepdims=True))
        return out


class ClusterAligner(AlignerBase):
    """CTC emissions from discovered acoustic units (preprocess/units.py).

    For self-labeled corpora: the pseudo-transcript is the collapsed
    nearest-unit sequence, and emissions here score each frame against the
    SAME k-means centroids (log-softmax of -||f - c||^2 / tau over the
    letters, with silence probability from the frame's RMS gate), so the
    pipeline's Viterbi forced alignment (preprocess/ctc_align.py)
    reconstructs honest frame-level unit boundaries. This is the
    zero-egress equivalent of the reference's MMS_FA alignment
    (utils/preprocess.py:333-342) for wavs that have no transcripts."""

    def __init__(self, units_path: str, tau: float = 2.0):
        from zerovox_tpu_torch.preprocess.units import (UNIT_HOP, UNIT_LETTERS,
                                                        UNIT_SAMPLE_RATE, load_units)

        labels = ("-",) + tuple(UNIT_LETTERS)
        super().__init__(labels)
        self.sample_rate = UNIT_SAMPLE_RATE
        self.hop_size = UNIT_HOP
        self._centroids = load_units(units_path)
        self._tau = tau

    def emissions(self, wav_batch: np.ndarray) -> np.ndarray:
        from zerovox_tpu_torch.preprocess.units import unit_features, voiced_mask

        B = wav_batch.shape[0]
        T = wav_batch.shape[1] // self.hop_size
        C = len(self.labels)
        out = np.full((B, T, C), -30.0, dtype=np.float32)
        for b in range(B):
            mel, rms = unit_features(wav_batch[b])
            t = min(T, len(mel))
            if t == 0:
                out[b, :, self.blank] = 0.0
                continue
            d2 = ((mel[:t, None, :] - self._centroids[None]) ** 2).sum(axis=2)
            scores = -d2 / self._tau  # [t, k]
            voiced = voiced_mask(rms[:t])
            # blank competes at the frame's best-unit score on silent
            # frames and stays far below it on voiced frames
            blank = np.where(voiced, scores.max(axis=1) - 8.0,
                             scores.max(axis=1) + 8.0)
            out[b, :t, 1 : 1 + scores.shape[1]] = scores
            out[b, :t, self.blank] = blank
            if t < T:
                out[b, t:, self.blank] = 0.0
        out = out - np.log(np.exp(out - out.max(-1, keepdims=True)).sum(-1, keepdims=True)) - out.max(-1, keepdims=True)
        return out


class Wav2Vec2Aligner(AlignerBase):  # pragma: no cover - needs local weights
    """HF wav2vec2-CTC emissions (e.g. MMS-FA) through transformers, on
    `device` (None: the CUDA card)."""

    def __init__(self, model_name_or_path: str, labels=None, device=None):
        import torch
        from transformers import AutoProcessor, Wav2Vec2ForCTC

        from zerovox_tpu_torch.device import resolve_device, use_full_f32

        self._torch = torch
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_full_f32()
        self.model = Wav2Vec2ForCTC.from_pretrained(model_name_or_path)
        self.model.eval().to(self.device)
        try:
            processor = AutoProcessor.from_pretrained(model_name_or_path)
            vocab = processor.tokenizer.get_vocab()
            inv = {v: k for k, v in vocab.items()}
            labels = labels or tuple(inv[i] for i in range(len(inv)))
        except (OSError, ValueError, KeyError):
            labels = labels or DEFAULT_LABELS
        super().__init__(labels)

    def emissions(self, wav_batch: np.ndarray) -> np.ndarray:
        torch = self._torch
        with torch.inference_mode():
            x = torch.from_numpy(wav_batch.astype(np.float32)).to(self.device)
            return torch.log_softmax(self.model(x).logits.float(), dim=-1).cpu().numpy()


def make_aligner(spec: str | None = None, device=None) -> AlignerBase:
    """Resolve an aligner spec. Never falls back silently: corpora aligned
    with the energy-ramp pseudo aligner get non-phonetic duration targets
    that corrupt all downstream training, so 'pseudo' must be explicit and
    a requested model that cannot load is a hard error (the reference always
    uses a real CTC model, utils/preprocess.py:333-342).

    Specs: 'pseudo' | 'tone' (built-in tone-speak CTC, for synthetic
    corpora/tests) | 'cluster:<units.npz>' (discovered acoustic units for
    self-labeled corpora, preprocess/units.py) | any HF wav2vec2-CTC
    checkpoint path/name. `device` (None: the CUDA card) is where the tone
    and wav2vec2 models run; the pseudo and cluster aligners are numpy.
    """
    if spec is None:
        raise ValueError(
            "no alignment model specified. Pass --aligner <wav2vec2-ctc "
            "checkpoint path> for real corpora, --aligner tone for synthetic "
            "tone-speak corpora, --aligner cluster:<units.npz> for "
            "self-labeled corpora, or --aligner pseudo to explicitly accept "
            "NON-PHONETIC energy-ramp alignments (pipeline testing only).")
    if spec == "pseudo":
        print("warning: using EnergyPseudoAligner — alignments are "
              "energy-uniform, NOT phonetic; do not train production "
              "models on this corpus")
        return EnergyPseudoAligner()
    if spec == "tone":
        from zerovox_tpu_torch.preprocess.tone_ctc import ToneCTCAligner

        return ToneCTCAligner(device=device)
    if spec.startswith("cluster:"):
        return ClusterAligner(spec.split(":", 1)[1])
    try:
        return Wav2Vec2Aligner(spec, device=device)
    except Exception as e:
        raise RuntimeError(
            f"could not load alignment model '{spec}': {e}. Refusing to "
            f"fall back to the pseudo aligner; pass --aligner pseudo "
            f"explicitly if you really want fabricated alignments.") from e
