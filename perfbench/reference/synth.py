"""The reference's synthesis: text -> ids -> encoder and variance adaptor ->
rounded durations -> decoder at the mel bucket -> vocoder, all plain.

The buckets are part of what the program computes (the StyleTTS decoder's
InstanceNorms see the whole mel bucket, and the vocoder sees the zeros up to
the bucket's end), so the reference works out the same buckets from its own
ids and durations, by the port's documented rule: a batch's text bucket is
that of its longest row; its mel bucket is the speculative one, 12 frames a
phone of its longest row plus 16, or, when a row's duration sum is longer,
that sum's bucket. A stream is vocoded as the port documents its chunked
streaming (`streaming.py`): windows of the chunk plus a receptive-field halo
on each side, the first anchored at frame 0, each chunk cut from its window.

Three roundings turn continuous predictions into discrete choices: a phone's
duration (round(exp(log d) - 1)) and its pitch and energy bins
(round(v * (bins - 1))). Where a value lies within `eps` of a rounding
edge, the program and the reference may round it apart by one without
either being wrong. `hold` then also tries the other rounding at such
phones (durations only in the direction the program's length says) and
keeps the closest render; nowhere else does it depart from its own.
"""

from __future__ import annotations

import itertools
import math
import re

import numpy as np
import torch
import torch.nn.functional as F

from .model import MelDec, ZeroVox, log_mel, round_durations, trim_silence
from .text import Symbols, ZeroVoxNormalizer, text_ids

TEXT_BUCKETS = (16, 32, 64, 96, 128, 192, 256, 384, 512)
MEL_BUCKETS = (96, 176, 344, 512, 689, 1024, 1408, 1750)
SPEC_FRAMES_PER_PHONE = 12
SENTENCE_SPLIT = re.compile(r"(?<=[.!?;:])\s+")


def pick_bucket(n: int, buckets) -> int:
    for b in buckets:
        if b >= n:
            return b
    return ((n + 127) // 128) * 128


def stream_pieces(text: str, max_txt_len: int) -> list[str]:
    """A streamed text's sentences (and clauses past max_txt_len characters)."""
    pieces = []
    for s in SENTENCE_SPLIT.split(text.strip()):
        s = s.strip()
        if not s:
            continue
        while len(s) > max_txt_len:
            cut = s.rfind(",", 0, max_txt_len)
            cut = cut if cut > 0 else max_txt_len
            pieces.append(s[:cut + 1])
            s = s[cut + 1:].strip()
        pieces.append(s)
    return pieces


def halo_frames(h: dict) -> int:
    """HiFi-GAN's receptive field in mel frames on each side (the port's
    conservative count: conv_pre, each upsampler's overlap and each
    ResBlock1 tower, conv_post)."""
    halo, up = 3.0, 1.0
    for r, k in zip(h["upsample_rates"], h["upsample_kernel_sizes"]):
        up *= r
        halo += (k - r) / 2 / up * 2
        for ks, dils in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]):
            halo += (sum((ks - 1) * d for d in dils) + len(dils) * (ks - 1)) / up
    return int(math.ceil(halo + 3.0 / up))


def other_rounding(v: np.ndarray) -> np.ndarray:
    """For each value, the step (+1 or -1) from its rounding to the other
    one of the two integers around it."""
    r = np.round(v)
    return np.where(r >= v, -1, 1).astype(int)


def near_edge(v: np.ndarray, eps: float) -> np.ndarray:
    """Indices whose value lies within eps of k + 1/2."""
    return np.flatnonzero(np.abs(v - np.floor(v) - 0.5) < eps)


class ReferenceTTS:
    """The plain model on `device` with the benchmark's weights."""

    def __init__(self, cfg: dict, state_dict: dict, vocoder_state_dict: dict, device):
        m = cfg["model"]
        self.cfg = cfg
        self.device = device
        self.hop = cfg["audio"]["hop_size"]
        self.max_mel = m["max_mel_len"]
        self.max_txt = m["max_txt_len"]
        self.n_bins = m["encoder"]["ve_n_bins"]
        self.symbols = Symbols(m["phones"], m["puncts"])
        self.normalizer = ZeroVoxNormalizer(cfg["lang"][0])
        with torch.device("meta"):
            self.model = ZeroVox(cfg).eval()
            self.vocoder = MelDec(cfg["vocoder"]).eval()
        self.model.load_state_dict(state_dict, assign=True)
        self.vocoder.load_state_dict(vocoder_state_dict, assign=True)
        self.halo = halo_frames(cfg["vocoder"])
        self.up = int(np.prod(cfg["vocoder"]["upsample_rates"]))

    def ids(self, text: str):
        return text_ids(text.strip(), self.symbols, self.normalizer)

    @torch.no_grad()
    def speaker(self, wav: np.ndarray) -> torch.Tensor:
        mel = log_mel(trim_silence(np.asarray(wav, np.float32)), self.cfg["audio"], self.device)
        return self.model._spkemb(mel[None])

    @torch.no_grad()
    def encode(self, ids: list, spk: torch.Tensor, L: int | None = None, flips=None):
        """Rows of (phones, puncts) at text bucket L (that of the longest by
        default), one speaker row each ([B, 1, D]) -> (x, log_duration, pad
        mask, pitch, energy); `flips` moves row 0's pitch and energy bins."""
        L = L or pick_bucket(max(len(p) for p, _ in ids), TEXT_BUCKETS)
        ph = np.zeros((len(ids), L), np.int64)
        pu = np.zeros((len(ids), L), np.int64)
        pad = np.ones((len(ids), L), bool)
        for i, (p, q) in enumerate(ids):
            ph[i, :len(p)], pu[i, :len(p)], pad[i, :len(p)] = p, q, False
        dev = self.device
        pad_t = torch.from_numpy(pad).to(dev)
        x, log_d, pitch, energy = self.model.encode(
            torch.from_numpy(ph).to(dev), torch.from_numpy(pu).to(dev), spk, pad_t, flips=flips)
        return x, log_d, pad_t, pitch, energy

    @torch.no_grad()
    def render(self, x, durations, spk, T: int, chunk: int | None = None) -> np.ndarray:
        """One row [1, L, D] with its durations [1, L] at mel bucket T ->
        its waveform over its mel length (float32 numpy): vocoded whole, or
        with `chunk`, streamed in windows of chunk + 2 halo frames."""
        mel, mel_len = self.model.decode(x, durations, spk, T)
        if chunk is None:
            n = max(min(int(mel_len[0]), self.max_mel), 0)
            return self.vocoder(mel)[0, : n * self.hop].float().cpu().numpy()
        n = max(min(int(durations.sum()), self.max_mel), 1)
        window = chunk + 2 * self.halo
        padded = F.pad(mel, (0, 0, self.halo, window))
        out, pos = [], 0
        while pos < n:
            end = min(pos + chunk, n)
            start, start_s = (self.halo, 0) if pos == 0 else (pos, self.halo * self.up)
            wav = self.vocoder(padded[:, start:start + window])[0]
            out.append(wav[start_s:start_s + (end - pos) * self.up])
            pos = end
        return torch.cat(out).float().cpu().numpy()

    def mel_len(self, durations, stream: bool) -> int:
        n = min(int(durations.sum()), self.max_mel)
        return max(n, 1) if stream else n

    def window_bucket(self, ids: list, durations: torch.Tensor) -> int:
        """The mel bucket of a batch: speculative from its longest text, or
        its longest duration sum's when that is longer."""
        max_n = max(len(p) for p, _ in ids)
        T = pick_bucket(min(SPEC_FRAMES_PER_PHONE * max_n + 16, self.max_mel), MEL_BUCKETS)
        eff = min(int(durations.sum(dim=1).max()), self.max_mel)
        return T if eff <= T else pick_bucket(eff, MEL_BUCKETS)

    def hold(self, ids, L: int, spk, T: int, got: np.ndarray, eps: float,
             chunk: int | None = None, max_trials: int = 16):
        """Hold one answer of the program (one row's waveform, or a stream
        piece's chunks joined) to the reference's render of the same row at
        the same buckets, trying the other rounding at edge phones (module
        docstring). Returns (gap, matched, edges): the largest absolute
        sample difference of the closest render of the program's length,
        whether any render had that length, and how many edge phones the
        closest one took the other rounding at."""
        x, log_d, pad, pitch, energy = self.encode([ids], spk, L)
        n = len(ids[0])
        dur = round_durations(log_d, pad)
        delta = (len(got) - self.mel_len(dur, chunk is not None) * self.hop)
        if delta % self.hop:
            return math.inf, False, 0
        delta //= self.hop
        frames = (torch.exp(log_d[0, :n].double()) - 1.0).cpu().numpy()
        cands = [int(i) for i in near_edge(frames, eps)
                 if frames[i] > 0 and other_rounding(frames[i:i + 1])[0] == np.sign(delta)]
        if len(cands) < abs(delta):
            return math.inf, False, 0
        bins = {}
        for name, v in (("pitch", pitch), ("energy", energy)):
            scaled = (v[0, :n].double() * (self.n_bins - 1)).cpu().numpy()
            inside = [int(i) for i in near_edge(scaled, eps) if 0 < scaled[i] < self.n_bins - 1]
            bins.update({(name, i): int(other_rounding(scaled[i:i + 1])[0]) for i in inside})
        bin_trials = [()] + [(k,) for k in bins] + ([tuple(bins)] if len(bins) > 1 else [])
        best, taken = math.inf, 0
        trials = itertools.product(itertools.combinations(cands, abs(delta)), bin_trials)
        for dur_flips, bin_flips in itertools.islice(trials, max_trials):
            d2 = dur.clone()
            for i in dur_flips:
                d2[0, i] += int(np.sign(delta))
            x2 = x
            if bin_flips:
                flips = {"pitch": {}, "energy": {}}
                for name, i in bin_flips:
                    flips[name][i] = bins[(name, i)]
                x2 = self.encode([ids], spk, L, flips)[0]
            w = self.render(x2, d2, spk, T, chunk)
            if w.shape == got.shape:
                gap = float(np.max(np.abs(w - got))) if w.size else 0.0
                if gap < best:
                    best, taken = gap, len(dur_flips) + len(bin_flips)
        return best, math.isfinite(best), taken
