"""Offline corpus preprocessing: forced alignment + acoustic feature
extraction, as the JAX package's `preprocess/pipeline.py` does it.

Behavioral parity with the reference preprocessor (utils/preprocess.py):

  normalize -> length filter -> CTC align (drop below min score) ->
  silence-aware start/end hops -> alignment-hop -> target-hop conversion ->
  inter-token silence split half/half between neighbors -> punctuation ids
  attached to the preceding token -> mel-length window filter ->
  train.txt + Audacity label files; then per utterance: loudness-normalized
  resample -> F0 (+ unvoiced interpolation, phoneme-level means) ->
  log-mel + energy -> duration-sum fixup -> mel/pitch/energy/duration .npy +
  startstop.json -> corpus stats.json.

Where it runs: the aligner's emissions and the log-mel/energy frontend on
the device (None: the CUDA card; device="cpu" for the CPU); the Viterbi
(native C++), F0 (numpy YIN), loudness and the files on the host. Each
stage's seconds add up in `Preprocessor.seconds` / `AudioPreprocessor.seconds`
(emissions, alignment; resample, f0, mel, writes).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np

from zerovox_tpu_torch.dsp.audio import (
    ffmpeg_loudnorm_resample,
    first_and_last_hop_above_threshold,
    load_wav,
    loudness_normalize,
    resample,
    save_wav,
)
from zerovox_tpu_torch.dsp.mels import get_mel_from_wav
from zerovox_tpu_torch.dsp.pitch import estimate_f0, interpolate_f0, phoneme_level_average
from zerovox_tpu_torch.preprocess.aligner import AlignerBase
from zerovox_tpu_torch.preprocess.ctc_align import forced_align, merge_tokens
from zerovox_tpu_torch.symbols import Symbols
from zerovox_tpu_torch.text.normalize import zerovox_normalize

MEL_LEN_HEADROOM = 10
MIN_TXT_LEN = 5
SILENCE_THRESHOLD = 0.004


@dataclass
class AlignResult:
    phones: list
    puncts: list
    durations: list
    start_hop: int
    end_hop: int


class Preprocessor:
    """Alignment stage."""

    def __init__(self, modelcfg: dict, lang: str, min_avg_score: float = 0.9,
                 aligner: AlignerBase | None = None):
        from zerovox_tpu_torch.preprocess.aligner import make_aligner

        self._lang = lang
        self._min_avg_score = min_avg_score
        self._syms = Symbols(phones=modelcfg["model"]["phones"],
                             puncts=modelcfg["model"]["puncts"])
        self.extra_puncts: set = set()

        self._max_txt_len = modelcfg["model"]["max_txt_len"]
        self._max_mel_len = modelcfg["model"]["max_mel_len"] - MEL_LEN_HEADROOM
        self._min_mel_len = modelcfg["model"]["min_mel_len"]
        self._target_sampling_rate = modelcfg["audio"]["sampling_rate"]
        self._hop_size = modelcfg["audio"]["hop_size"]

        self._aligner = aligner if aligner is not None else make_aligner()
        self.seconds = {"emissions": 0.0, "alignment": 0.0}

    # hop-space conversion (reference utils/preprocess.py:344-353)
    def ahop2thop(self, hop: int) -> int:
        aframe = hop * self._aligner.hop_size
        tframe = aframe * self._target_sampling_rate / self._aligner.sample_rate
        return int(round(tframe / self._hop_size))

    # ------------------------------------------------------------------ align

    def normalize_jobs(self, jobs, pool=None):
        args = [(j["transcript"], self._lang) for j in jobs]
        if pool is not None:
            results = pool.starmap(zerovox_normalize, args)
        else:
            results = [zerovox_normalize(*a) for a in args]
        for (uroman, norm), job in zip(results, jobs):
            job["transcript_uroman"] = uroman
            job["transcript_normalized"] = norm

    def filter_jobs(self, jobs):
        kept = []
        for job in jobs:
            n = len(job["transcript_normalized"])
            if n < MIN_TXT_LEN:
                print(f"dropping sample {job['base_name']} because it is too short")
            elif n > self._max_txt_len:
                print(f"dropping sample {job['base_name']} because it exceeds "
                      f"max_txt_len ({self._max_txt_len})")
            else:
                kept.append(job)
        return kept

    def align_batch(self, jobs: list[dict]) -> list[tuple[dict, AlignResult]]:
        """Align one batch of jobs; returns accepted (job, result) pairs."""
        wavs = []
        for job in jobs:
            wav, _ = load_wav(job["wav_path"], target_sr=self._aligner.sample_rate)
            wavs.append(wav)
        max_len = max(len(w) for w in wavs)
        batch = np.stack([np.pad(w, (0, max_len - len(w))) for w in wavs])

        if hasattr(self._aligner, "set_transcripts"):
            self._aligner.set_transcripts([j["transcript_normalized"] for j in jobs])
        t0 = time.perf_counter()
        emissions = self._aligner.emissions(batch)
        t1 = time.perf_counter()

        out = []
        for emission, job, wav in zip(emissions, jobs, wavs):
            res = self._align_one(emission, job, wav)
            if res is not None:
                out.append((job, res))
        self.seconds["emissions"] += t1 - t0
        self.seconds["alignment"] += time.perf_counter() - t1
        return out

    def _align_one(self, emission: np.ndarray, job: dict, audio: np.ndarray) -> AlignResult | None:
        d = self._aligner.dictionary
        try:
            targets = np.asarray(
                [d[c] for word in job["transcript_normalized"].split(" ") for c in word],
                dtype=np.int64,
            )
            aligned, scores = forced_align(emission, targets, blank=self._aligner.blank)
        except (KeyError, ValueError) as e:
            print(f"{job['wav_path']}: *** dropping sample, alignment failed: {e}")
            return None

        probs = np.exp(scores)
        if len(probs) == 0:
            print(f"{job['wav_path']}: *** dropping sample because alignment failed")
            return None
        avg_score = float(np.mean(probs))
        if avg_score < self._min_avg_score:
            print(f"{job['wav_path']}: *** dropping sample because avg alignment "
                  f"score is too low: {avg_score} < {self._min_avg_score}")
            return None

        spans = merge_tokens(aligned, scores, blank=self._aligner.blank)
        if not spans:
            return None

        # extra hops at the start/end — the aligner tends to truncate phones
        start_hop_a, end_hop_th_a = first_and_last_hop_above_threshold(
            audio, self._aligner.hop_size, SILENCE_THRESHOLD)
        if spans and spans[0].start < start_hop_a:
            start_hop_a = spans[0].start

        # Batch emissions are zero-padded to the longest wav in the batch; a
        # poorly-matching transcript can make Viterbi push trailing tokens
        # into that padding (observed on self-labeled real speech,
        # scripts/exp_real_speech.py). Such spans lie beyond the true wav
        # end, so the feature stage's mel would be shorter than the aligned
        # span — drop the sample instead of writing corrupt durations.
        n_frames_true = len(audio) // self._aligner.hop_size
        if spans[-1].end > n_frames_true:
            print(f"{job['wav_path']}: *** dropping sample, alignment ran "
                  f"into batch padding ({spans[-1].end} > {n_frames_true} "
                  f"frames)")
            return None

        # convert every time marker to target hops up front
        start_hop = self.ahop2thop(start_hop_a)
        end_hop_th = self.ahop2thop(end_hop_th_a)
        starts = [self.ahop2thop(s.start) for s in spans]
        ends = [self.ahop2thop(s.end) for s in spans]

        transcript_uroman = job["transcript_uroman"]
        labels = self._aligner.labels

        durations: list[int] = []
        puncts: list[int] = []
        phones: list[int] = []
        ts_pos = 0
        last_token_start = start_hop

        for s_idx, (span, t_start, t_end) in enumerate(zip(spans, starts, ends)):
            if ts_pos >= len(transcript_uroman):
                raise Exception("alignment error: ran out of transcript_uroman!")

            token = labels[span.token]

            # collect punctuation leading up to this token
            punct = self._syms.encode_punct(Symbols.NO_PUNCT)
            while ts_pos < len(transcript_uroman) and transcript_uroman[ts_pos] != token:
                cp = transcript_uroman[ts_pos]
                if self._syms.is_punct(cp):
                    punct = max(punct, self._syms.encode_punct(cp))
                else:
                    self.extra_puncts.add(cp)
                ts_pos += 1
            if ts_pos >= len(transcript_uroman) or transcript_uroman[ts_pos] != token:
                raise Exception("alignment error: transcript_uroman mismatch!")
            ts_pos += 1

            if s_idx > 0:
                # distribute inter-token silence half/half to the neighbors
                extra_hops = t_start - last_token_start - durations[s_idx - 1]
                assert extra_hops >= 0
                extra_next = extra_hops // 2
                extra_prev = extra_hops - extra_next
                durations[s_idx - 1] += extra_prev
                t_start -= extra_next
                puncts[s_idx - 1] = punct
                last_token_start = t_start

            durations.append(t_end - t_start)
            puncts.append(0)
            phones.append(self._syms.encode_phone(token))

        if not durations:
            return None

        end_hop = max(ends[-1], end_hop_th)
        # last token absorbs trailing silence; sum(durations) == end - start
        durations[-1] = end_hop - (ends[-1] - durations[-1])
        assert min(durations) >= 0
        assert sum(durations) == end_hop - start_hop

        # trailing punctuation
        punct = self._syms.encode_punct(Symbols.NO_PUNCT)
        while ts_pos < len(transcript_uroman):
            cp = transcript_uroman[ts_pos]
            if self._syms.is_punct(cp):
                punct = max(punct, self._syms.encode_punct(cp))
            else:
                self.extra_puncts.add(cp)
            ts_pos += 1
        puncts[-1] = punct

        total_hops = end_hop - start_hop
        if not (self._min_mel_len <= total_hops <= self._max_mel_len):
            print(f"*** {job['wav_path']}: dropping sample because it exceeds mel len "
                  f"limits: {total_hops} vs [{self._min_mel_len}:{self._max_mel_len}]")
            return None

        return AlignResult(phones=phones, puncts=puncts, durations=durations,
                           start_hop=start_hop, end_hop=end_hop)

    def write_outputs(self, job: dict, res: AlignResult, out_dir: str):
        job["start_hop"] = res.start_hop
        job["end_hop"] = res.end_hop
        job["durations"] = res.durations

        with open(os.path.join(out_dir, "train.txt"), "a") as f:
            f.write(f"{job['dest_wav']}|{','.join(map(str, res.phones))}|"
                    f"{','.join(map(str, res.puncts))}|{job['transcript']}\n")

        # Audacity-style label file next to the output wav
        label_path = os.path.join(out_dir, "wavs", job["dest_wav"] + ".txt")
        with open(label_path, "w") as f:
            pos = res.start_hop
            for phone, punct, dur in zip(res.phones, res.puncts, res.durations):
                t0 = pos * self._hop_size / self._target_sampling_rate
                t1 = (pos + dur) * self._hop_size / self._target_sampling_rate
                f.write(f"{t0}\t{t1}\t{self._syms.decode_phone(phone)}\n")
                pos += dur

    def align(self, jobs, out_dir: str, batch_size: int = 4, pool=None):
        self.normalize_jobs(jobs, pool=pool)
        jobs = self.filter_jobs(jobs)
        for i in range(0, len(jobs), batch_size):
            for job, res in self.align_batch(jobs[i : i + batch_size]):
                self.write_outputs(job, res, out_dir)
        return jobs


class AudioPreprocessor:
    """Feature-extraction stage (one job at a time); the mel frontend runs
    on `device` (None: the CUDA card)."""

    def __init__(self, modelcfg: dict, verbose: bool = False, device=None):
        from zerovox_tpu_torch.device import resolve_device, use_full_f32

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_full_f32()
        self.seconds = {"resample": 0.0, "f0": 0.0, "mel": 0.0, "writes": 0.0}
        a = modelcfg["audio"]
        self._sr = a["sampling_rate"]
        self._fft_size = a["fft_size"]
        self._hop_size = a["hop_size"]
        self._win_length = a["win_length"]
        self._num_mels = a["num_mels"]
        self._fmin = a["fmin"]
        self._fmax = a["fmax"]
        self._verbose = verbose

    def process(self, job: dict):
        if "durations" not in job:
            return None

        out_dir = job["out_dir"]
        destwav = os.path.join(out_dir, "wavs", job["dest_wav"])

        t0 = time.perf_counter()
        if not ffmpeg_loudnorm_resample(job["wav_path"], destwav, self._sr):
            wav, sr = load_wav(job["wav_path"])
            wav = resample(wav, sr, self._sr)
            wav = loudness_normalize(wav, self._sr)
            save_wav(destwav, wav, self._sr)

        wav, _ = load_wav(destwav, target_sr=self._sr)
        wav = wav[job["start_hop"] * self._hop_size : job["end_hop"] * self._hop_size]
        wav = wav.astype(np.float32)
        t1 = time.perf_counter()
        self.seconds["resample"] += t1 - t0
        if wav.size == 0:
            return None

        pitch = estimate_f0(wav, self._sr, self._hop_size)
        nonzero = np.flatnonzero(pitch != 0)
        t2 = time.perf_counter()
        self.seconds["f0"] += t2 - t1
        if nonzero.size == 0:
            return None
        pitch = interpolate_f0(pitch)

        mel, energy = get_mel_from_wav(
            audio=wav, sampling_rate=self._sr, fft_size=self._fft_size,
            hop_size=self._hop_size, win_length=self._win_length,
            num_mels=self._num_mels, fmin=self._fmin, fmax=self._fmax, device=self.device)
        t3 = time.perf_counter()
        self.seconds["mel"] += t3 - t2

        durations = list(job["durations"])
        phoneme_pitches = phoneme_level_average(pitch, durations)
        phoneme_energy = phoneme_level_average(energy, durations)

        # force sum(durations) == mel frame count by adjusting the last entry
        diff = mel.shape[1] - sum(durations)
        durations[-1] += diff
        assert sum(durations) == mel.shape[1]
        if min(durations) < 0:
            print(f"{destwav}: negative duration detected: {durations} -> skipping")
            return None

        basename = os.path.splitext(os.path.basename(destwav))[0]
        np.save(os.path.join(out_dir, "duration", f"duration-{basename}.npy"),
                np.asarray(durations))
        np.save(os.path.join(out_dir, "pitch", f"pitch-{basename}.npy"), phoneme_pitches)
        np.save(os.path.join(out_dir, "energy", f"energy-{basename}.npy"), phoneme_energy)
        np.save(os.path.join(out_dir, "mel", f"mel-{basename}.npy"), mel.T)
        with open(os.path.join(out_dir, "mel", f"startstop-{basename}.json"), "w") as f:
            json.dump({"start_hop": job["start_hop"], "end_hop": job["end_hop"]}, f)
        self.seconds["writes"] += time.perf_counter() - t3

        return float(pitch.min()), float(pitch.max()), float(energy.min()), float(energy.max())


# ------------------------------------------------------------------- corpus IO


def gen_jobs_from_metadata_file(in_dir, out_dir, metadata_path, limit, book=None):
    """LJSpeech-format metadata.csv -> job dicts (reference utils/preprocess.py:581-613)."""
    jobs = []
    with open(metadata_path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            base_name = parts[0]
            if os.sep in base_name:
                base_name = os.path.basename(base_name)
            if base_name.endswith(".wav"):
                base_name = os.path.splitext(base_name)[0]
            text = parts[1] if len(parts) == 2 else parts[2]
            wav_path = os.path.join(in_dir, "wavs", f"{base_name}.wav")
            if os.path.exists(wav_path):
                dest = (book + "_" + base_name if book else base_name) + ".wav"
                jobs.append({"transcript": text, "wav_path": wav_path,
                             "dest_wav": dest, "out_dir": out_dir,
                             "base_name": base_name})
                if len(jobs) >= limit:
                    break
    print(f"{metadata_path} -> {len(jobs)} jobs")
    return jobs


def gather_jobs_from_config(config: dict, base_path: str, limit: int):
    """Single or multi-book LJSpeech corpus discovery + output dir setup."""
    import shutil

    if "LJSpeech" not in config["dataset"]:
        raise Exception(f"unknown dataset format '{config['dataset']}'")

    in_dir = config["path"]["corpus_path"]
    out_dir = os.path.join(base_path, config["path"]["preprocessed_path"])
    shutil.rmtree(out_dir, ignore_errors=True)
    for d in ["wavs", "mel", "pitch", "energy", "duration"]:
        os.makedirs(os.path.join(out_dir, d), exist_ok=True)

    metadata_path = os.path.join(in_dir, "metadata.csv")
    if os.path.isfile(metadata_path):
        return gen_jobs_from_metadata_file(in_dir, out_dir, metadata_path, limit)

    jobs = []
    for book in sorted(os.listdir(in_dir)):
        bookdir = os.path.join(in_dir, book)
        mp = os.path.join(bookdir, "metadata.csv")
        if os.path.isfile(mp):
            jobs.extend(gen_jobs_from_metadata_file(bookdir, out_dir, mp,
                                                    limit - len(jobs), book=book))
    return jobs
