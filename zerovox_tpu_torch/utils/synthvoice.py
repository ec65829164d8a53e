"""Deterministic synthetic "tone-speak" voice.

Renders romanized text as audio where every character is a fixed harmonic
tone (semitone ladder over the alphabet) with a smooth per-character
envelope, vibrato, and a noise floor. Spaces render as silence.

Why this exists: the reference ships 68 recorded speaker wavs
(zerovox/tts/refaudio/) as demo voices and uses real corpora for training;
this zero-egress build needs a generated stand-in that is

  * deterministic (same text -> same waveform),
  * *learnable* (text fully determines the mel target, so a training run
    on a tone-speak corpus must converge),
  * *alignable* (exact per-character sample boundaries are known, giving
    ground truth for forced-alignment tests), and
  * usable as out-of-box demo reference audio.

Used by: tests for CTC alignment and preprocessing, and `chip_smoke.py`'s
preprocessing phase. A numpy copy of the JAX package's module of the same
name; the waveforms are bitwise the same.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

ALPHABET = "abcdefghijklmnopqrstuvwxyz'"


@dataclasses.dataclass(frozen=True)
class VoiceSpec:
    """Synthetic speaker identity for the tone-speak renderer.

    Mirrors what distinguishes real speakers in the reference's zero-shot
    setup (ref wav -> ResNet embedding, zerovox/tts/synthesize.py:123-143):
    pitch register (`f0_scale`) and spectral timbre (`harmonic_amps` +
    `tilt`, the per-harmonic amplitude law amp(h) = harmonic_amps[h-1] *
    h**tilt) plus vibrato style. Same text + different VoiceSpec = same
    content with measurably different F0 and mel envelope — the ground
    truth for the speaker-cloning convergence experiment
    (scripts/gen_cloning_corpus.py, docs/CONVERGENCE.md)."""

    name: str = "neutral"
    f0_scale: float = 1.0
    harmonic_amps: tuple = (0.5, 0.15, 0.07)
    tilt: float = 0.0
    vibrato_rate: float = 5.0
    vibrato_depth: float = 0.01
    # optional (base_hz, octaves) exponential content ladder replacing the
    # historical linear 115 Hz ladder. A NARROW content ladder with WIDE
    # per-voice f0_scale registers mirrors real speech statistics (prosody
    # ~0.5 octave within a speaker, register ~1 octave across speakers) —
    # with the linear ladder, content spans 4.4 octaves and voice identity
    # only +-0.35, so log-min-max pitch normalization + variance-bin
    # quantization (training/data.py) nearly erases the voice signal.
    ladder: tuple | None = None


DEFAULT_VOICE = VoiceSpec()


def char_f0_voice(c: str, voice: "VoiceSpec") -> float:
    """Fundamental of character `c` in `voice` (ladder x register)."""
    idx = ALPHABET.find(c)
    if idx < 0:
        idx = len(ALPHABET)
    if voice.ladder is not None:
        base, octaves = voice.ladder
        f = base * 2.0 ** (octaves * idx / max(len(ALPHABET) - 1, 1))
    else:
        f = char_f0(c)
    return f * voice.f0_scale


def char_f0(c: str) -> float:
    """Fundamental for a character: linear ladder, 115 Hz apart.

    Linear (not semitone) spacing so adjacent characters stay separable at
    the ~40 Hz frequency resolution of a 25 ms analysis window — the CTC
    alignment model (preprocess/tone_ctc.py) must be able to identify the
    sounding character from a single mel frame.
    """
    idx = ALPHABET.find(c)
    if idx < 0:
        idx = len(ALPHABET)
    return 220.0 + 115.0 * idx


def char_duration(c: str, base: float = 0.14) -> float:
    """Deterministic per-character duration in seconds (0.75x..1.5x base)."""
    h = int(hashlib.md5(c.encode()).hexdigest(), 16) % 1000 / 1000.0
    return base * (0.75 + 0.75 * h)


def render_text_with_boundaries(
    text: str,
    sample_rate: int = 22050,
    char_dur: float = 0.14,
    edge_silence: float = 0.25,
    # keep the noise floor well under the preprocessing silence-trim
    # threshold (amplitude 0.004) so edge silence trims deterministically
    noise: float = 0.001,
    seed: int = 0,
    voice: VoiceSpec | None = None,
):
    """Render text; returns (wav[float32], boundaries).

    boundaries: list of (char, start_sample, end_sample) for every
    non-space character — exact ground truth for alignment tests.
    `voice` applies a VoiceSpec speaker identity (default: the historical
    neutral voice, bit-identical to the pre-VoiceSpec renderer).
    """
    v = voice or DEFAULT_VOICE
    rng = np.random.default_rng(seed)
    pieces = [np.zeros(int(edge_silence * sample_rate), np.float32)]
    boundaries: list[tuple[str, int, int]] = []
    cursor = len(pieces[0])

    for c in text.lower():
        if c == " ":
            seg = np.zeros(int(0.06 * sample_rate), np.float32)
        else:
            dur = char_duration(c, char_dur)
            n = int(dur * sample_rate)
            t = np.arange(n) / sample_rate
            f0 = char_f0_voice(c, v)
            vib = 1.0 + v.vibrato_depth * np.sin(2 * np.pi * v.vibrato_rate * t)
            phase = 2 * np.pi * f0 * vib * t
            seg = np.zeros(n, np.float64)
            for h, amp in enumerate(v.harmonic_amps, start=1):
                if h * f0 >= 0.45 * sample_rate:  # no aliasing harmonics
                    break
                seg += amp * (h ** v.tilt) * np.sin(h * phase)
            seg = seg.astype(np.float32)
            # smooth attack/release so character edges aren't clicks
            ramp = min(n // 4, int(0.02 * sample_rate))
            env = np.ones(n, np.float32)
            env[:ramp] = np.linspace(0, 1, ramp)
            env[-ramp:] = np.linspace(1, 0, ramp)
            seg *= 0.35 * env
            boundaries.append((c, cursor, cursor + n))
        pieces.append(seg)
        cursor += len(seg)

    pieces.append(np.zeros(int(edge_silence * sample_rate), np.float32))
    wav = np.concatenate(pieces)
    if noise > 0:
        wav = wav + rng.normal(size=wav.shape).astype(np.float32) * noise
    return wav.astype(np.float32), boundaries


def render_text(text: str, sample_rate: int = 22050, **kw) -> np.ndarray:
    wav, _ = render_text_with_boundaries(text, sample_rate, **kw)
    return wav


# --------------------------------------------------------------------------
# Formant voice: glottal-pulse-style source through vowel resonators, with
# exact instantaneous-F0 ground truth. Used for the bundled demo voices
# (scripts/gen_refaudio.py) and as the speech-shaped validation battery for
# the YIN pitch tracker (tests/test_pitch_validation.py) — the reference
# trusts pyworld DIO+StoneMask on real speech (utils/preprocess.py:179-187);
# this is the closest verifiable stand-in in a zero-egress environment.

# (F1, F2, F3) vowel formants, male-ish
VOWELS = {
    "a": (730, 1090, 2440),
    "e": (530, 1840, 2480),
    "i": (270, 2290, 3010),
    "o": (570, 840, 2410),
    "u": (300, 870, 2240),
}


def _resonator_mag(freqs: np.ndarray, fc: float, bw: float) -> np.ndarray:
    """Magnitude response of a formant resonance (Lorentzian-ish)."""
    return 1.0 / np.sqrt(1.0 + ((freqs - fc) / (bw / 2)) ** 2)


def formant_syllable(vowel: str, dur: float, f0: float, rng: np.random.Generator,
                     formant_scale: float = 1.0, sample_rate: int = 22050,
                     jitter: float = 0.01, vibrato: float = 0.015,
                     noise: float = 0.01):
    """One voiced vowel syllable; returns (wav[n], f0_inst[n]).

    f0_inst is the exact per-sample instantaneous fundamental (the phase is
    integrated from it), so frame-level pitch ground truth is known even
    with jitter + vibrato applied.
    """
    n = int(dur * sample_rate)
    t = np.arange(n) / sample_rate
    # source: harmonic stack with 1/h rolloff, vibrato + slow jitter walk
    vib = (1.0 + vibrato * np.sin(2 * np.pi * 5.5 * t)
           + jitter * rng.normal(size=n).cumsum() / n)
    f0_inst = f0 * vib
    phase = np.cumsum(2 * np.pi * f0_inst / sample_rate)
    src = np.zeros(n)
    for h in range(1, max(2, int(4000 / f0))):
        src += np.sin(h * phase) / h
    # shape the spectrum with vowel formants via FFT filtering
    spec = np.fft.rfft(src)
    freqs = np.fft.rfftfreq(n, 1 / sample_rate)
    mag = np.zeros_like(freqs)
    for fc, bw in zip((f * formant_scale for f in VOWELS[vowel]), (90, 110, 170)):
        mag += _resonator_mag(freqs, fc, bw)
    mag += 0.05  # spectral floor
    out = np.fft.irfft(spec * mag, n)
    # syllabic envelope
    env = np.clip(np.minimum(1.0, np.minimum(t / 0.04, (dur - t) / 0.08)), 0, 1)
    out = out * env
    out += noise * rng.normal(size=n) * env
    return out, f0_inst


def formant_consonant(dur: float, rng: np.random.Generator,
                      sample_rate: int = 22050) -> np.ndarray:
    """Soft high-passed noise burst (unvoiced but energetic — the hard case
    for a pitch tracker's voicing decision)."""
    n = int(dur * sample_rate)
    noise = rng.normal(size=n)
    spec = np.fft.rfft(noise)
    freqs = np.fft.rfftfreq(n, 1 / sample_rate)
    spec *= np.clip((freqs - 1500) / 3000, 0, 1)
    out = np.fft.irfft(spec, n)
    env = np.sin(np.linspace(0, np.pi, n))
    return 0.25 * out * env


def formant_voice_with_f0(f0_base: float, formant_scale: float, vowel_seq: str,
                          seed: int, sample_rate: int = 22050,
                          jitter: float = 0.01, vibrato: float = 0.015):
    """Render a full formant voice; returns (wav, f0_inst, voiced).

    f0_inst[n]: exact instantaneous F0 per sample (0 where unvoiced);
    voiced[n]: bool mask. Matches scripts/gen_refaudio.py's voice rendering
    (declination, consonant bursts, phrase pauses, 0.35 peak normalization).
    """
    rng = np.random.default_rng(seed)
    sil = np.zeros(int(0.15 * sample_rate))
    pieces, f0_pieces = [sil], [np.zeros_like(sil)]
    f0 = f0_base
    for k, v in enumerate(vowel_seq):
        dur = 0.16 + 0.10 * rng.random()
        wav_k, f0_k = formant_syllable(v, dur, f0, rng, formant_scale,
                                       sample_rate, jitter, vibrato)
        pieces.append(wav_k)
        f0_pieces.append(f0_k)
        f0 *= 0.995  # declination
        if k % 3 == 2:
            c = formant_consonant(0.05 + 0.03 * rng.random(), rng, sample_rate)
            pieces.append(c)
            f0_pieces.append(np.zeros_like(c))
        if k % 5 == 4:
            p = np.zeros(int(0.12 * sample_rate))
            pieces.append(p)
            f0_pieces.append(np.zeros_like(p))
            f0 = f0_base * (0.97 + 0.06 * rng.random())
    pieces.append(sil)
    f0_pieces.append(np.zeros_like(sil))

    wav = np.concatenate(pieces)
    wav = (wav / np.abs(wav).max() * 0.35).astype(np.float32)
    f0_inst = np.concatenate(f0_pieces).astype(np.float32)
    return wav, f0_inst, f0_inst > 0


def make_corpus(root, texts, sample_rate: int = 22050, seed: int = 0) -> str:
    """Write an LJSpeech-layout corpus (metadata.csv 'base|text' + wavs/)."""
    import os

    from zerovox_tpu_torch.dsp.audio import save_wav

    wavdir = os.path.join(str(root), "wavs")
    os.makedirs(wavdir, exist_ok=True)
    lines = []
    for i, text in enumerate(texts):
        base = f"tone{i:03d}"
        wav = render_text(text, sample_rate, seed=seed + i)
        save_wav(os.path.join(wavdir, f"{base}.wav"), wav, sample_rate)
        lines.append(f"{base}|{text}")
    with open(os.path.join(str(root), "metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(root)
