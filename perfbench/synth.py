"""What the synthesis kinds share: the engine built from a configuration
file and seeded weights, the voices, the sample of answers drawn for the
check, and the check itself against the plain reference.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.io.wavfile
import torch

from reference.model import plain_f32, round_durations
from reference.synth import (MEL_BUCKETS, SPEC_FRAMES_PER_PHONE, ReferenceTTS, pick_bucket,
                             stream_pieces)

DATA = Path(__file__).resolve().parent / "data"


def program_configs(cfg: dict, options: dict | None = None):
    """The port's configuration objects for a configuration file, with a
    cell's model options (the port's switches that leave the model's
    function as it is)."""
    from zerovox_tpu_torch.config import ZeroVoxConfig
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig

    d = {k: cfg[k] for k in ("audio", "model", "training")}
    d["lang"] = cfg["lang"]
    m = dict(d["model"])
    m.update(options or {})
    d["model"] = m
    return ZeroVoxConfig.from_dict(d), HifiGanConfig.from_dict(cfg["vocoder"])


def build_engine(run, texts, voices, who):
    """The port's engine on the run's device with the seed's weights, its
    durations calibrated over the cell's texts in their voices."""
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS

    cfg, vcfg = program_configs(run.cfg, run.params().get("program_options"))
    sd, vsd = run.weights(texts, voices, who)
    engine = ZeroVoxTTS(cfg, sd, vcfg, vsd, language=run.cfg["lang"][0], device=run.device,
                        precision=run.cfg["precision"])
    del sd, vsd
    return engine


def load_voices(names) -> list[np.ndarray]:
    """The bundled reference wavs (22.05 kHz 16-bit mono) as float32 in [-1, 1]."""
    out = []
    for n in names:
        sr, a = scipy.io.wavfile.read(DATA / n)
        if sr != 22050 or a.dtype != np.int16:
            raise ValueError(f"{n}: expected 22050 Hz int16, got {sr} Hz {a.dtype}")
        out.append(a.astype(np.float32) / 32768.0)
    return out


def zipf_choice(rng: np.random.Generator, n_items: int, s: float, size: int) -> np.ndarray:
    p = 1.0 / np.arange(1, n_items + 1) ** s
    return rng.choice(n_items, size=size, p=p / p.sum())


def sample_indices(rng: np.random.Generator, lengths, k: int) -> list[int]:
    """k indices drawn from the seed, the longest always among them."""
    n = len(lengths)
    if n == 0:
        return []
    longest = int(np.argmax(lengths))
    rest = [i for i in rng.permutation(n).tolist() if i != longest][: max(0, k - 1)]
    return [longest] + rest


class Checker:
    """Holds served waveforms to the reference, after the program is freed.

    The reference is built from the same seed's weights, made anew; it
    derives its own ids, speaker embeddings, durations and buckets. The
    numbers compared: `wave_gap`, the largest absolute sample difference
    over the answers whose length the reference matched (edge roundings
    allowed, reference/synth.py), and `length_mismatch`, the answers whose
    length it could not match."""

    def __init__(self, run, voices: list[np.ndarray], tf32: bool = False):
        plain_f32(tf32)
        self.run = run
        sd, vsd = run.weights()
        self.ref = ReferenceTTS(run.cfg, sd, vsd, run.device)
        self.spk = [self.ref.speaker(w) for w in voices]
        self.eps = float(run.workload["limits"]["edge_eps"])
        self.worst = (0.0, None)
        self.unmatched = []
        self.edges = 0
        self.compared = 0

    def batch(self, texts: list[str], voices: list[int], rows: list[int], got: list[np.ndarray]):
        """One tts_batch call: all its texts and voices; rows to hold to the
        program's waveforms `got` (one each)."""
        ids = [self.ref.ids(t) for t in texts]
        spk = torch.cat([self.spk[v] for v in voices])
        x, log_d, pad, _, _ = self.ref.encode(ids, spk)
        T = self.ref.window_bucket(ids, round_durations(log_d, pad))
        L = x.shape[1]
        for r, w in zip(rows, got):
            self._one(ids[r], L, spk[r:r + 1], T, w, None, texts[r])

    def stream(self, text: str, voice: int, pieces: list[np.ndarray], chunk: int):
        """One streamed text: each sentence piece rendered alone at its own
        buckets and streamed in the program's windows."""
        spk = self.spk[voice]
        mine = [self.ref.ids(p) for p in stream_pieces(text, self.ref.max_txt)]
        mine = [i for i in mine if i[0]]
        if len(mine) != len(pieces):
            self.unmatched.append(text)
            return
        for ids, got in zip(mine, pieces):
            n = len(ids[0])
            x, log_d, pad, _, _ = self.ref.encode([ids], spk)
            mel_len = self.ref.mel_len(round_durations(log_d, pad), True)
            T = pick_bucket(min(SPEC_FRAMES_PER_PHONE * n + 16, self.ref.max_mel), MEL_BUCKETS)
            T = T if mel_len <= T else pick_bucket(mel_len, MEL_BUCKETS)
            self._one(ids, x.shape[1], spk, T, got, chunk, text)

    def _one(self, ids, L, spk, T, got, chunk, text):
        gap, matched, edges = self.ref.hold(ids, L, spk, T, np.asarray(got, np.float32),
                                            self.eps, chunk)
        self.compared += 1
        self.edges += edges
        if not matched:
            self.unmatched.append(text)
        elif gap > self.worst[0]:
            self.worst = (gap, {"phones": len(ids[0]), "T": T, "chunk": chunk,
                                "samples": len(got), "edges_taken": edges})

    def finish(self) -> None:
        run = self.run
        run.log(check_compared=self.compared, edge_phones_taken=self.edges,
                unmatched=len(self.unmatched), wave_gap=self.worst[0], worst=self.worst[1],
                unmatched_texts=self.unmatched[:3])
        run.check("wave_gap", self.worst[0], run.limit("wave_gap"))
        run.check("length_mismatch", len(self.unmatched), 0)
        if self.compared == 0:
            run.check("compared", 0, -1)
