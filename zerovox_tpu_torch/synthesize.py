"""ZeroVoxTTS: the synthesis API of the PyTorch package.

The counterpart of the JAX package's `synthesize.py`, on PyTorch and CUDA:

  * text and mel lengths are padded to static buckets (the same buckets as
    the JAX package, so both run the same shapes);
  * synthesis is three stages: `encode` (phoneme encoder + variance
    predictors), `decode` (length regulation into a mel bucket + mel
    decoder) and the vocoder. The mel bucket is chosen speculatively from
    the phone count so decode and vocode are queued before the one host
    sync on the duration sum; when the speculation was too small the
    exact bucket is redone;
  * `tts_stream` yields audio chunk by chunk (streaming.py);
  * `tts_batch` synthesizes several utterances, one speaker each, padded to
    shared buckets (the serving layer's call, `serving/`);
  * `load_model` reads a model directory (`modelcfg.yaml` and the newest
    upstream `.ckpt` or native `.msgpack` checkpoint) or a hub name from
    the local hub cache (`hub.py`); `from_checkpoint` does everything after
    the YAML parse, so it runs where pyyaml is not installed.

The StyleTTS decoder's InstanceNorms see the whole mel bucket, so its mel
depends on the bucket: every path picks the same bucket as the JAX package
(a `tts_batch` row is decoded at the batch's bucket, not at its own).

Entry points run on the CUDA card unless the caller passes device="cpu";
without a card they raise. With `mesh=` (`parallel.make_mesh`, one
process's devices on a `data` axis, and optionally a `model` axis) the
engine keeps one replica of both models on each device of the `data` axis
(the first of each model row) and `tts_batch` shards its rows over them,
as the JAX package's serving mesh does (its weights replicated over
`model`, its rows split over `data`): B is padded up to a multiple of the
data axis with fully masked rows, each shard's decode and vocode are queued
on its own device from the one host thread, and the rows are gathered on
the host without the pad. The single-utterance paths run on the first
device. The engine runs float32 with TF32 off, or, with
`precision="bf16"` (or `ZEROVOX_PRECISION=bf16` when `precision` is None),
the JAX package's bf16 inference: every floating parameter and buffer of
both models in bf16, bf16 inputs to the speaker encoder, encode, decode and
the vocoder (whose kernels take their bf16 variants), and float32 out of
the vocoder; mels and waveforms reach the host as float32.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import time
from pathlib import Path

import numpy as np
import torch

from zerovox_tpu_torch import hub
from zerovox_tpu_torch.config import ZeroVoxConfig
from zerovox_tpu_torch.device import resolve_device, use_full_f32
from zerovox_tpu_torch.dsp.audio import load_wav, trim_silence
from zerovox_tpu_torch.dsp.mels import MelFrontend
from zerovox_tpu_torch.models.hifigan import HifiGanConfig, MelDec
from zerovox_tpu_torch.models.zerovox import ZeroVox
from zerovox_tpu_torch.parallel.mesh import indexed_device, replicate
from zerovox_tpu_torch.streaming import ChunkStreamer, stream_vocode
from zerovox_tpu_torch.symbols import Symbols
from zerovox_tpu_torch.text.normalize import ZeroVoxNormalizer
from zerovox_tpu_torch.text.tokenizer import transcript2phonemids
from zerovox_tpu_torch.utils.profiling import StageTimer

DEFAULT_REFAUDIO = "en_kevin.wav"

TEXT_BUCKETS = (16, 32, 64, 96, 128, 192, 256, 384, 512)
MEL_BUCKETS = (96, 176, 344, 512, 689, 1024, 1408, 1750)

# Whether the vocoder sends batches of more than one row through K1 and K3
# too (Generator's `pallas_all_batches`); K2 takes every batch size either
# way. On: on an H100 both kernels beat their plain stages at B=4 and B=8
# (chip_smoke.py phase 9; times in PERF.md), unlike on the TPU, where the JAX
# package keeps them to batch 1.
VOCODER_ALL_BATCHES = True

PRECISIONS = {"f32": torch.float32, "bf16": torch.bfloat16}

_SENTENCE_SPLIT = re.compile(r"(?<=[.!?;:])\s+")


def pick_bucket(n: int, buckets) -> int:
    for b in buckets:
        if b >= n:
            return b
    return ((n + 127) // 128) * 128  # beyond the largest bucket: 128-grid


def random_init_(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights: LeCun-normal for weight matrices and kernels,
    unit-variance/sqrt(dim) embeddings, zero biases, identity norms, weight
    norm gains of 1."""
    with torch.no_grad():
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                if isinstance(mod, torch.nn.Embedding):
                    p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
                elif name == "weight_g":  # weight norm: unit-norm rows of v
                    p.fill_(1.0)
                elif p.dim() < 2:
                    p.fill_(1.0 if name == "weight" else 0.0)
                else:
                    if isinstance(mod, torch.nn.ConvTranspose1d):  # (in, out, k)
                        fan_in = p.shape[0] * p.shape[2]
                    else:
                        fan_in = p[0].numel()
                    p.normal_(0.0, fan_in ** -0.5, generator=gen)


class ZeroVoxTTS:
    """End-to-end zero-shot TTS engine."""

    # generous upper bound on frames per phone for the speculative mel bucket
    _SPEC_FRAMES_PER_PHONE = 12

    def __init__(self, cfg: ZeroVoxConfig, state_dict: dict, meldec_cfg: HifiGanConfig,
                 meldec_state_dict: dict, language: str | None = None, verbose: bool = False,
                 meldec_model: str = "", device=None, precision: str | None = None, mesh=None):
        """`state_dict`: models.zerovox.ZeroVox weights (upstream key names);
        `meldec_state_dict`: models.hifigan.MelDec weights; `precision`:
        "f32" or "bf16" (None: `ZEROVOX_PRECISION`, default "f32"); `mesh`:
        a serving mesh, whose first device is the engine's `device`."""
        self.precision = precision or os.environ.get("ZEROVOX_PRECISION", "f32")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {tuple(PRECISIONS)}, got {self.precision!r}")
        self._dtype = PRECISIONS[self.precision]
        self.device = _engine_device(device, mesh)
        if self.device.type == "cuda":
            use_full_f32()
        self.cfg = cfg
        self._verbose = verbose
        self._meldec_model = meldec_model
        self._symbols = Symbols(phones=cfg.model.phones, puncts=cfg.model.puncts)
        self._normalizer = ZeroVoxNormalizer(language or cfg.langs[0])

        # bf16: every floating parameter and buffer (BatchNorm statistics and
        # the vocoder's mean/scale included) cast after the float32 load,
        # integer buffers left as they are, as the JAX package casts
        self._model = ZeroVox(cfg)
        self._model.load_state_dict(state_dict)
        self._model.eval().to(self.device, self._dtype)
        self._meldec_cfg = meldec_cfg
        # the vocoder's stages go to the fused kernels (on the CPU, to their
        # plain versions), K1 and K3 at every batch size: VOCODER_ALL_BATCHES
        self._meldec = MelDec(meldec_cfg, use_pallas=True, pallas_all_batches=VOCODER_ALL_BATCHES)
        self._meldec.load_state_dict(meldec_state_dict)
        self._meldec.eval().to(self.device, self._dtype)
        # (device, acoustic model, vocoder): one a device of the mesh's data axis
        self._replicas = ([(self.device, self._model, self._meldec)] if mesh is None else
                          list(zip(mesh.data_devices, replicate(self._model, mesh),
                                   replicate(self._meldec, mesh))))

        a = cfg.audio
        self._hop_length = a.hop_size
        self._frontend = MelFrontend(a.sampling_rate, a.fft_size, a.hop_size, a.win_length,
                                     a.num_mels, a.fmin, a.fmax, device=self.device)

    # ------------------------------------------------------------ public API

    @property
    def normalizer(self):
        return self._normalizer

    @property
    def language(self) -> str:
        return self._normalizer.language

    @language.setter
    def language(self, value: str):
        if value != self._normalizer.language:
            self._normalizer = ZeroVoxNormalizer(value)

    @property
    def meldec_model(self) -> str:
        return self._meldec_model

    @staticmethod
    def available_speakerrefs() -> list[str]:
        """Speaker reference wavs: the *.wav files of the bundled refaudio
        directory and of `ZEROVOX_REFAUDIO_DIR`."""
        speakers = []
        for d in ZeroVoxTTS._refaudio_dirs():
            if os.path.isdir(d):
                speakers.extend(f for f in os.listdir(d) if f.endswith(".wav"))
        return sorted(set(speakers), key=str.casefold)

    @staticmethod
    def _refaudio_dirs() -> list[str]:
        dirs = []
        if os.getenv("ZEROVOX_REFAUDIO_DIR"):
            dirs.append(os.getenv("ZEROVOX_REFAUDIO_DIR"))
        dirs.append(str(Path(__file__).parent / "refaudio"))
        return dirs

    @staticmethod
    def get_speakerref(speakerref: str, sampling_rate: int) -> np.ndarray:
        """A reference wav by path, or by name from the refaudio directories,
        resampled to `sampling_rate`."""
        if os.path.isfile(speakerref):
            return load_wav(speakerref, target_sr=sampling_rate)[0]
        for d in ZeroVoxTTS._refaudio_dirs():
            p = os.path.join(d, speakerref)
            if os.path.isfile(p):
                return load_wav(p, target_sr=sampling_rate)[0]
        raise FileNotFoundError(f"speaker reference wav not found: {speakerref}")

    def state_dicts(self) -> tuple[dict, dict]:
        """(acoustic model, vocoder) state_dicts on the CPU, floating
        tensors as float32 (a bf16 engine's bf16 values, widened)."""
        def cpu(sd):
            return {k: v.detach().cpu().float() if v.is_floating_point() else v.detach().cpu()
                    for k, v in sd.items()}
        return cpu(self._model.state_dict()), cpu(self._meldec.state_dict())

    def speaker_embed(self, wav: np.ndarray) -> torch.Tensor:
        """Reference wav -> [1, 1, emb] on the engine's device, in the
        engine's dtype (the mel is cast to it, as the JAX package casts)."""
        wav, _ = trim_silence(wav, top_db=40.0)
        mel, _ = self._frontend(wav)  # [n_mels, T]
        with torch.inference_mode():
            return self._model.speaker_embed(mel.T[None].contiguous().to(self._dtype))

    def text2phonemeids(self, text: str) -> tuple[list[int], list[int]]:
        transcript_uroman, _ = self._normalizer.normalize(text)
        phone_ids, punct_ids = transcript2phonemids(transcript_uroman, self._symbols)
        if self._verbose:
            print(f"Raw Text Sequence: {text}")
            print(f"Normalized       : {transcript_uroman}")
            print(f"Phoneme IDs      : {phone_ids}")
            print(f"Punct IDs        : {punct_ids}")
        return phone_ids, punct_ids

    # ------------------------------------------------------- synthesis core

    def _spk(self, spkemb) -> torch.Tensor:
        """A speaker embedding (tensor or array) on the device in the engine's dtype."""
        if not isinstance(spkemb, torch.Tensor):
            spkemb = torch.tensor(np.asarray(spkemb, np.float32))
        return spkemb.to(device=self.device, dtype=self._dtype)

    @staticmethod
    def _text_rows(ids):
        """Rows of (phone_ids, punct_ids) padded to the text bucket of the
        longest -> (phonemes, puncts, mask) [B, L] on the host."""
        L = pick_bucket(max(len(p) for p, _ in ids), TEXT_BUCKETS)
        phonemes = np.zeros((len(ids), L), np.int64)
        puncts = np.zeros((len(ids), L), np.int64)
        mask = np.ones((len(ids), L), bool)
        for i, (p, q) in enumerate(ids):
            phonemes[i, :len(p)] = p
            puncts[i, :len(p)] = q
            mask[i, :len(p)] = False
        return phonemes, puncts, mask

    def _run_encode(self, phonemes, puncts, mask, spk, dur=None):
        """Stage A over host arrays [B, L] (dur: forced durations or None)."""
        dev = self.device
        with torch.inference_mode():
            return self._model.encode(
                torch.from_numpy(phonemes).to(dev), torch.from_numpy(puncts).to(dev), spk,
                phoneme_mask=torch.from_numpy(mask).to(dev),
                duration_target=None if dur is None else torch.from_numpy(dur).to(dev))

    def _encode(self, phone_ids, punct_ids, spkemb, duration=None):
        """Stage A at the text bucket. Returns (encoder outputs, speculative
        mel length, forced durations or None)."""
        n = len(phone_ids)
        phonemes, puncts, mask = self._text_rows([(phone_ids, punct_ids)])
        dur = None
        if duration is not None:
            dur = np.zeros(phonemes.shape, np.int32)
            dur[0, :n] = np.asarray(duration)[:n]
        enc = self._run_encode(phonemes, puncts, mask, self._spk(spkemb), dur)
        spec_len = int(dur.sum()) if dur is not None else self._SPEC_FRAMES_PER_PHONE * n + 16
        return enc, spec_len, dur

    def _decode(self, enc, spkemb, T: int) -> torch.Tensor:
        with torch.inference_mode():
            mel, _, _ = self._model.decode(enc["x"], enc["duration_rounded"], self._spk(spkemb), T)
        return mel

    def _vocode(self, mel: torch.Tensor) -> torch.Tensor:
        """The waveform of mel, float32 on the device."""
        with torch.inference_mode():
            return self._meldec(mel).float()

    def _mel_len(self, enc, dur) -> int:
        # forced durations are known on the host; otherwise one device sync
        n = int(dur.sum()) if dur is not None else int(enc["duration_rounded"].sum())
        return max(min(n, self.cfg.model.max_mel_len), 1)

    def _synthesize(self, phone_ids, punct_ids, spkemb, duration=None,
                    timer: StageTimer | None = None, want_mel: bool = True):
        """Returns (wav [N] numpy, mel_len, log_duration, mel [n_mels, mel_len] or None)."""
        enc, spec_len, dur = self._encode(phone_ids, punct_ids, spkemb, duration)
        max_len = self.cfg.model.max_mel_len
        T_spec = pick_bucket(min(max(spec_len, 1), max_len), MEL_BUCKETS)
        mel = self._decode(enc, spkemb, T_spec)
        wav = self._vocode(mel)
        mel_len = self._mel_len(enc, dur)
        if timer:
            timer.mark("pe")
        if mel_len > T_spec:
            # speculation too small: redo at the exact bucket
            mel = self._decode(enc, spkemb, pick_bucket(mel_len, MEL_BUCKETS))
            wav = self._vocode(mel)
        if timer:
            timer.mark("dec+meldec")
        wav_np = wav[0, : mel_len * self._hop_length].cpu().numpy()
        mel_np = mel[0, :mel_len, :].T.float().cpu().numpy() if want_mel else None
        return wav_np, mel_len, enc["log_duration"].float(), mel_np

    def tts_ex(self, text: str, spkemb, duration=None, want_mel: bool = True):
        text = text.strip()
        tstart_g2p = time.time()
        phone_ids, punct_ids = self.text2phonemeids(text)
        tend_g2p = time.time()
        if not phone_ids:
            return (np.array([[0.0]], dtype=np.float32), np.array([[0]], dtype=np.int32), 0,
                    np.array([[0.0]], dtype=np.float32))
        timer = StageTimer(self.device) if self._verbose else None
        tstart_synth = time.time()
        wav, length, _, mel = self._synthesize(phone_ids, punct_ids, spkemb, duration=duration,
                                               timer=timer, want_mel=want_mel)
        if self._verbose:
            print(f"synthesis timing stats: {timer.report()}")
            print(f"tts timing stats: g2p={tend_g2p - tstart_g2p}s, "
                  f"synth={time.time() - tstart_synth}s")
        return wav, np.array([phone_ids], dtype=np.int32), length, mel

    def tts(self, text: str, spkemb, duration=None):
        wav, phoneme, length, _ = self.tts_ex(text, spkemb, duration=duration, want_mel=False)
        return wav, phoneme, length

    def tts_batch(self, texts: list[str], spkembs, durations=None) -> list[tuple[np.ndarray, int]]:
        """Batched multi-speaker synthesis: one utterance per (text, speaker
        embedding) pair, padded to the text bucket of the longest, so each
        stage runs once for the batch. `spkembs` is [B, 1, emb] (stacked
        `speaker_embed` outputs). `durations`, if given, holds one per-phone
        frame-count array per utterance: the mel lengths are then known on
        the host and the exact bucket is decoded directly. Otherwise decode
        and vocode are queued at a speculative bucket from the longest
        text, one host sync reads the duration sums, the exact bucket is
        redone only if it is larger, and the waveform is trimmed to it.

        The rows are split into one equal block a replica (one without a
        serving mesh): B is padded up to a multiple of the replicas with
        fully masked rows (mel length 0), every block's stages are queued on
        its own device before the host sync, and the bucket is the whole
        batch's. Returns [(wav, mel_len), ...]."""
        spk = self._spk(spkembs)
        if spk.shape[0] != len(texts):
            raise ValueError(f"{len(texts)} texts but {spk.shape[0]} speaker embeddings")
        ids = [self.text2phonemeids(t.strip()) for t in texts]
        max_n = max((len(p) for p, _ in ids), default=0)
        if max_n == 0:
            return [(np.zeros(1, np.float32), 0)] * len(texts)
        phonemes, puncts, mask = self._text_rows(ids)
        B, L = phonemes.shape
        dur = None if durations is None else self._forced_rows(ids, (B, L), durations)
        pad = -B % len(self._replicas)
        if pad:
            phonemes = np.concatenate([phonemes, np.zeros((pad, L), phonemes.dtype)])
            puncts = np.concatenate([puncts, np.zeros((pad, L), puncts.dtype)])
            mask = np.concatenate([mask, np.ones((pad, L), bool)])
            spk = torch.cat([spk, spk.new_zeros((pad,) + spk.shape[1:])])
            if dur is not None:
                dur = np.concatenate([dur, np.zeros((pad, L), np.int32)])
        per = (B + pad) // len(self._replicas)
        shards = []  # (device, model, meldec, speaker rows, encoder outputs) a replica
        for r, (dev, model, meldec) in enumerate(self._replicas):
            rows = slice(r * per, (r + 1) * per)
            # the device current, so the kernels' launches go to its context
            with _on(dev), torch.inference_mode():
                s_r = spk[rows].to(dev)
                enc = model.encode(
                    torch.from_numpy(phonemes[rows]).to(dev),
                    torch.from_numpy(puncts[rows]).to(dev),
                    s_r, phoneme_mask=torch.from_numpy(mask[rows]).to(dev),
                    duration_target=None if dur is None else torch.from_numpy(dur[rows]).to(dev))
            shards.append((dev, model, meldec, s_r, enc))

        def render(T: int) -> list[torch.Tensor]:
            out = []
            for dev, model, meldec, s_r, enc in shards:
                with _on(dev), torch.inference_mode():
                    mel, _, _ = model.decode(enc["x"], enc["duration_rounded"], s_r, T)
                    out.append(meldec(mel).float())
            return out

        max_len = self.cfg.model.max_mel_len
        if dur is not None:  # the mel lengths are known on the host: no sync
            mel_lens = np.minimum(dur.sum(axis=1), max_len)
            T = pick_bucket(min(int(mel_lens[:B].max()), max_len), MEL_BUCKETS)
            wavs = render(T)
        else:
            T = pick_bucket(min(self._SPEC_FRAMES_PER_PHONE * max_n + 16, max_len), MEL_BUCKETS)
            wavs = render(T)
            mel_lens = np.concatenate([enc["duration_rounded"].sum(dim=1).cpu().numpy()
                                       for *_, enc in shards])  # the one host sync
            eff_max = min(int(mel_lens[:B].max()), max_len)
            if eff_max > T:  # speculation too small: redo at the exact bucket
                T = pick_bucket(eff_max, MEL_BUCKETS)
                wavs = render(T)
            T = pick_bucket(eff_max, MEL_BUCKETS)
        wavs = [w[:, :T * self._hop_length] for w in wavs]
        wav = wavs[0] if len(wavs) == 1 else torch.cat([w.cpu() for w in wavs])
        return self._batch_postprocess(wav[:B], mel_lens[:B])

    @staticmethod
    def _forced_rows(ids, shape, durations) -> np.ndarray:
        """Per-phone durations as [B, L] rows (zeros past each text)."""
        dur = np.zeros(shape, np.int32)
        for i, (p, _) in enumerate(ids):
            d = np.asarray(durations[i], np.int32)
            if d.shape[0] != len(p):
                raise ValueError(f"durations[{i}] has {d.shape[0]} entries for {len(p)} phones")
            dur[i, :len(p)] = d
        return dur

    def _batch_postprocess(self, wav: torch.Tensor, mel_lens) -> list[tuple[np.ndarray, int]]:
        wav = wav.cpu().numpy()
        out = []
        for i in range(wav.shape[0]):
            n = int(min(mel_lens[i], self.cfg.model.max_mel_len))
            out.append((wav[i, :n * self._hop_length], n))
        return out

    def tts_stream(self, text: str, spkemb, chunk_frames: int = 96, duration=None):
        """Streaming synthesis: yields waveform chunks as they are vocoded.
        Decode and the first window are queued at the speculative bucket
        before the duration sum is read; if the speculation was too small
        the decode is redone at the exact bucket before anything is emitted."""
        phone_ids, punct_ids = self.text2phonemeids(text.strip())
        if not phone_ids:
            return
        enc, spec_len, dur = self._encode(phone_ids, punct_ids, spkemb, duration)
        max_len = self.cfg.model.max_mel_len
        T_spec = pick_bucket(min(max(spec_len, 1), max_len), MEL_BUCKETS)
        mel = self._decode(enc, spkemb, T_spec)
        streamer = ChunkStreamer(self._meldec, self._meldec_cfg, mel, chunk_frames)
        first_wav = streamer.dispatch(0)
        mel_len = self._mel_len(enc, dur)
        if mel_len > T_spec:
            mel = self._decode(enc, spkemb, pick_bucket(mel_len, MEL_BUCKETS))
            yield from stream_vocode(self._meldec, self._meldec_cfg, mel, mel_len,
                                     chunk_frames=chunk_frames)
            return
        yield from streamer.chunks(mel_len, pos=0, first_wav=first_wav)

    def tts_stream_text(self, text: str, spkemb, chunk_frames: int = 96):
        """Streaming over arbitrarily long text: split into sentences (and
        clauses past max_txt_len), each synthesized and streamed in turn."""
        pieces: list[str] = []
        for sentence in _SENTENCE_SPLIT.split(text.strip()):
            sentence = sentence.strip()
            if not sentence:
                continue
            while len(sentence) > self.cfg.model.max_txt_len:
                cut = sentence.rfind(",", 0, self.cfg.model.max_txt_len)
                cut = cut if cut > 0 else self.cfg.model.max_txt_len
                pieces.append(sentence[:cut + 1])
                sentence = sentence[cut + 1:].strip()
            pieces.append(sentence)
        for piece in pieces:
            yield from self.tts_stream(piece, spkemb, chunk_frames=chunk_frames)

    def warmup(self, texts=("This is a warmup utterance.",), spkemb=None, mel_buckets=None,
               batch_sizes=()):
        """Run the given texts (and, with `mel_buckets`, every such bucket
        through forced durations; with `batch_sizes`, `tts_batch` at each
        such size) once, so first requests find the kernels built and
        cuDNN's algorithm choices made for those shapes."""
        if spkemb is None:
            spkemb = torch.zeros((1, 1, self.cfg.model.emb_size), device=self.device,
                                 dtype=self._dtype)
        for t in texts:
            self.tts(t, spkemb)
        if mel_buckets:
            ids, _ = self.text2phonemeids(texts[0])
            n = max(len(ids), 1)
            for T in mel_buckets:
                if T > self.cfg.model.max_mel_len:
                    continue
                dur = np.full(n, max(1, T // n), dtype=np.int32)
                dur[-1] += T - int(dur.sum())
                self.tts(texts[0], spkemb, duration=dur)
        spk = self._spk(spkemb)
        for B in batch_sizes:
            self.tts_batch([texts[0]] * B, spk.expand(B, -1, -1))
        if self._verbose:
            from zerovox_tpu_torch.utils.compile_cache import format_cache_stats

            print(f"warmup done; {format_cache_stats()}")

    def summary(self, depth: int = 1) -> int:
        """Parameter counts of the acoustic model (total and, at depth 1,
        per top-level module) and of the vocoder; returns the total. The
        counts are the JAX package's: parameters, not BatchNorm statistics;
        the vocoder's mel mean and scale included."""
        total = sum(p.numel() for p in self._model.parameters())
        print(f"ZeroVox acoustic model parameters: {total:,}")
        if depth >= 1:
            for name, sub in self._model.named_children():
                print(f"  {name.lstrip('_')}: {sum(p.numel() for p in sub.parameters()):,}")
        vocoder = sum(v.numel() for v in self._meldec.state_dict().values())
        print(f"meldec (vocoder) parameters: {vocoder:,}")
        return total

    # ------------------------------------------------------------- loaders

    @classmethod
    def from_random(cls, cfg: ZeroVoxConfig | None = None,
                    meldec_cfg: HifiGanConfig | None = None, seed: int = 0,
                    language: str = "en", verbose: bool = False, device=None,
                    precision: str | None = None, mesh=None):
        """Engine with seeded random weights (benchmarks, tests, offline);
        the float32 weights, cast when `precision` is "bf16"."""
        device = _engine_device(device, mesh)
        cfg = cfg or ZeroVoxConfig()
        meldec_cfg = meldec_cfg or HifiGanConfig(num_mels=cfg.audio.num_mels,
                                                 sampling_rate=cfg.audio.sampling_rate)
        gen = torch.Generator().manual_seed(seed)
        model, meldec = ZeroVox(cfg), MelDec(meldec_cfg)
        random_init_(model, gen)
        random_init_(meldec, gen)
        return cls(cfg, model.state_dict(), meldec_cfg, meldec.state_dict(), language=language,
                   verbose=verbose, device=device, precision=precision, mesh=mesh)

    @classmethod
    def from_jax_variables(cls, cfg: ZeroVoxConfig, variables: dict, meldec_cfg: HifiGanConfig,
                           meldec_variables: dict, language: str = "en", device=None,
                           precision: str | None = None):
        """Engine on the JAX package's float32 weights (variable trees of
        numpy arrays), cast when `precision` is "bf16"."""
        from zerovox_tpu_torch.weights import from_jax_variables, meldec_from_jax_variables

        return cls(cfg, from_jax_variables(variables, cfg), meldec_cfg,
                   meldec_from_jax_variables(meldec_variables, meldec_cfg),
                   language=language, device=device, precision=precision)

    @classmethod
    def load_model(cls, modelpath, meldec_model=None, verbose: bool = False, device=None,
                   mesh=None):
        """`modelcfg.yaml` + the newest (by ctime) `checkpoints/*.ckpt`
        (upstream Lightning) or `checkpoints/*.msgpack` (native) of a local
        directory, or `modelcfg.yaml` + `checkpoint.pkl` of a hub model
        (`hub.download_model_file`). The vocoder is `meldec_model` (see
        `from_checkpoint`). Returns (modelcfg dict, engine)."""
        import yaml  # only YAML loading needs it

        device = _engine_device(device, mesh)
        if os.path.isdir(str(modelpath)):
            config_path = Path(modelpath) / "modelcfg.yaml"
            ckpts = glob.glob(os.path.join(str(modelpath), "checkpoints", "*.ckpt"))
            ckpts += glob.glob(os.path.join(str(modelpath), "checkpoints", "*.msgpack"))
            if not ckpts:
                raise FileNotFoundError(f"no checkpoints/*.ckpt or *.msgpack under {modelpath}")
            checkpoint = max(ckpts, key=os.path.getctime)
        else:
            config_path = hub.download_model_file(model=str(modelpath), relpath="modelcfg.yaml")
            checkpoint = hub.download_model_file(model=str(modelpath), relpath="checkpoint.pkl")
        if verbose:
            print("synthesize: using config    : ", config_path)
            print("synthesize: using checkpoint: ", checkpoint)
        with open(config_path) as f:
            modelcfg = yaml.load(f, Loader=yaml.FullLoader)
        cfg = ZeroVoxConfig.from_dict(modelcfg)
        return modelcfg, cls.from_checkpoint(cfg, checkpoint, meldec_model, verbose=verbose,
                                             device=device, mesh=mesh)

    @classmethod
    def from_checkpoint(cls, cfg: ZeroVoxConfig, checkpoint, meldec_model=None,
                        verbose: bool = False, device=None, mesh=None):
        """Engine on a checkpoint file: a native `.msgpack` (the JAX package's
        variable tree) or an upstream torch checkpoint. The vocoder comes
        from `meldec_model`: a directory holding `config.json` and either
        `generator.msgpack` (native; identity mel normalization) or an
        upstream `generator.ckpt`, or a hub model name; else from the
        `_meldec.*` weights the checkpoint embeds. A checkpoint's embedded
        `_meldec.mean`/`_meldec.scale` are taken beside an upstream
        generator, as the JAX package takes them."""
        from zerovox_tpu_torch.training.checkpointing import load_native_checkpoint
        from zerovox_tpu_torch.weights import from_jax_variables, upstream_state_dict

        device = _engine_device(device, mesh)
        if str(checkpoint).endswith(".msgpack"):
            state_dict = from_jax_variables(load_native_checkpoint(checkpoint), cfg)
            embedded = {}
        else:
            sd = _torch_state_dict(checkpoint)
            state_dict = upstream_state_dict(sd, ZeroVox(cfg))
            embedded = {k[len("_meldec."):]: v for k, v in sd.items() if k.startswith("_meldec.")}
        meldec_cfg, md = _load_meldec(meldec_model, embedded, verbose)
        return cls(cfg, state_dict, meldec_cfg, md, language=cfg.langs[0], verbose=verbose,
                   meldec_model=str(meldec_model or ""), device=device, mesh=mesh)


def _on(device):
    """`device` made the current CUDA device within the block (a no-op off the card)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _engine_device(device, mesh) -> torch.device:
    """The engine's device: `device` (the card when None), or with a serving
    `mesh` its first device. Raises for a mesh without a `data` axis, a
    multi-process mesh, or a `device` that is not the mesh's first."""
    if mesh is None:
        return resolve_device(device)
    if "data" not in getattr(mesh, "axis_names", ()):
        raise ValueError(f"a serving mesh needs a 'data' axis (got {getattr(mesh, 'axis_names', None)})")
    if mesh.group is not None:
        raise ValueError("a serving mesh holds one process's devices, not a process group")
    if device is not None and indexed_device(device) != mesh.devices[0]:
        raise ValueError(f"device {device} is not the mesh's first device {mesh.devices[0]}")
    return resolve_device(mesh.devices[0])


def _load_meldec(meldec_model, embedded: dict, verbose: bool) -> tuple[HifiGanConfig, dict]:
    """(config, MelDec state_dict) of `ZeroVoxTTS.from_checkpoint`'s vocoder."""
    from zerovox_tpu_torch.training.checkpointing import load_native_checkpoint
    from zerovox_tpu_torch.weights import meldec_from_jax_variables, upstream_generator_state_dict

    local = bool(meldec_model) and os.path.isdir(str(meldec_model))
    if local and (Path(meldec_model) / "generator.msgpack").exists():
        with open(Path(meldec_model) / "config.json") as f:
            meldec_cfg = HifiGanConfig.from_dict(json.load(f))
        if verbose:
            print("meldec: native checkpoint: ", Path(meldec_model) / "generator.msgpack")
        gen = load_native_checkpoint(Path(meldec_model) / "generator.msgpack")["params"]
        return meldec_cfg, meldec_from_jax_variables({"params": {"generator": gen}}, meldec_cfg)

    if meldec_model:
        if local:
            config_path = Path(meldec_model) / "config.json"
            gen_path = Path(meldec_model) / "generator.ckpt"
        else:
            config_path = hub.download_model_file(model=str(meldec_model), relpath="config.json")
            gen_path = hub.download_model_file(model=str(meldec_model), relpath="generator.ckpt")
        if verbose:
            print("meldec: using config    : ", config_path)
            print("meldec: using checkpoint: ", gen_path)
        with open(config_path) as f:
            meldec_cfg = HifiGanConfig.from_dict(json.load(f))
        gen_sd = _torch_state_dict(gen_path)
    elif embedded:
        meldec_cfg, gen_sd = HifiGanConfig(), embedded
    else:
        raise ValueError("no meldec model given and none embedded in the checkpoint")
    md = MelDec(meldec_cfg).state_dict()
    md.update(upstream_generator_state_dict(gen_sd))
    if "mean" in embedded:
        md["mean"] = torch.as_tensor(embedded["mean"], dtype=torch.float32)
        md["scale"] = torch.as_tensor(embedded["scale"], dtype=torch.float32)
    return meldec_cfg, md


def _torch_state_dict(path) -> dict:
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return ckpt["state_dict"]
    if isinstance(ckpt, dict) and "generator" in ckpt:
        return ckpt["generator"]
    return ckpt
