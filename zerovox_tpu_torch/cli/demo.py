"""`zerovox-torch-demo`: one-shot, interactive and benchmark synthesis.

One-shot synthesis of a text, `--interactive` REPL, `--play` audio output,
`--iter N` RTF benchmark (the average skips 10 warm-up iterations),
`--wav-filename` output, `--stream` chunked streaming and `--random-model`
for offline smoke runs, as the JAX package's `zerovox-demo`.

    zerovox-torch-demo --model <dir or hub name> --meldec-model <dir or hub name> \\
        --refaudio en_kevin.wav --wav-filename out.wav "Some text."

It runs on the CUDA card; `--infer-device cpu` runs it on the CPU. Without
a card the default raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from zerovox_tpu_torch.dsp.audio import save_wav
from zerovox_tpu_torch.hub import DEFAULT_MELDEC_MODEL_NAME
from zerovox_tpu_torch.synthesize import DEFAULT_REFAUDIO, ZeroVoxTTS


def write_wav_to_file(wav, length, filename, sample_rate=22050, hop_length=256):
    wav = wav[: length * hop_length]
    print("Writing wav to {}".format(filename))
    save_wav(filename, wav, sample_rate)


def _play(wav, sampling_rate):
    try:
        import sounddevice as sd

        sd.play((wav * 32760).astype("int16"), samplerate=sampling_rate)
        sd.wait()
    except Exception as e:  # audio hardware or the package may be missing
        print(f"(audio playback unavailable: {e})")


def _synth_once(synth, text, spkemb, modelcfg, iteration=None, total=None):
    start_time = time.time()
    wav, phoneme, length = synth.tts(text, spkemb)
    elapsed_time = time.time() - start_time

    sr = modelcfg["audio"]["sampling_rate"]
    wav_len = wav.shape[0] / sr
    rtf = wav_len / max(elapsed_time, 1e-9)
    prefix = f"[{iteration}/{total}] " if iteration is not None else ""
    print(f"{prefix}Synth time: {elapsed_time:.2f} sec, voice length: {wav_len:.2f} sec, rtf: {rtf:.2f}")
    return wav, length, rtf


def main(argv=None):
    parser = argparse.ArgumentParser(prog="zerovox-torch-demo",
                                     description="interactive zerovox demo on PyTorch")
    parser.add_argument("--threads", type=int, default=0,
                        help="CPU threads for torch (0: torch's default)")
    parser.add_argument("--infer-device", default="cuda", choices=["cuda", "cpu"],
                        help="Inference device")
    parser.add_argument("--model", help="TTS model: path to model directory or hub model name")
    parser.add_argument("--random-model", action="store_true",
                        help="use a randomly initialized model (offline smoke test)")
    parser.add_argument("--meldec-model", default=DEFAULT_MELDEC_MODEL_NAME, type=str,
                        help=f"vocoder model, default: {DEFAULT_MELDEC_MODEL_NAME}")
    parser.add_argument("--play", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("-i", "--interactive", action="store_true")
    parser.add_argument("--stream", action="store_true", help="chunked streaming synthesis")
    parser.add_argument("--refaudio", type=str, default=DEFAULT_REFAUDIO,
                        help=f"reference audio wav file, default: {DEFAULT_REFAUDIO}")
    parser.add_argument("--wav-filename", help=".wav file to produce")
    parser.add_argument("--iter", type=int, default=1, help="iterations (for benchmarking), default: 1")
    parser.add_argument("text", nargs="?")
    args = parser.parse_args(argv)

    if args.threads > 0:
        torch.set_num_threads(args.threads)

    # the kernel build cache: the first run on a machine builds the kernels,
    # later processes load them (ZEROVOX_COMPILE_CACHE=0 builds each time)
    from zerovox_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.random_model:
        synth = ZeroVoxTTS.from_random(verbose=args.verbose, device=args.infer_device)
        modelcfg = synth.cfg.to_dict()
    else:
        if not args.model:
            parser.error("--model is required (or use --random-model)")
        modelcfg, synth = ZeroVoxTTS.load_model(args.model, meldec_model=args.meldec_model,
                                                verbose=args.verbose, device=args.infer_device)

    if args.verbose:
        synth.summary(depth=1)
        print(f"computing speaker {args.refaudio} embedding...")

    try:
        refwav = ZeroVoxTTS.get_speakerref(args.refaudio, modelcfg["audio"]["sampling_rate"])
    except FileNotFoundError:
        if args.random_model:
            refwav = np.random.default_rng(0).normal(size=22050).astype(np.float32) * 0.1
            print(f"(refaudio {args.refaudio} not found; using noise reference)")
        else:
            raise
    spkemb = synth.speaker_embed(refwav)

    sr = modelcfg["audio"]["sampling_rate"]
    hop = modelcfg["audio"]["hop_size"]

    if args.text is not None:
        if args.stream:
            t0 = time.time()
            chunks = []
            for i, chunk in enumerate(synth.tts_stream_text(args.text, spkemb)):
                if i == 0:
                    print(f"first chunk after {1000 * (time.time() - t0):.1f} ms")
                chunks.append(chunk)
            wav = np.concatenate(chunks) if chunks else np.zeros(1, np.float32)
            elapsed = time.time() - t0
            print(f"streamed {wav.shape[0] / sr:.2f}s of audio in {elapsed:.2f}s")
            if args.wav_filename:
                save_wav(args.wav_filename, wav, sr)
            if args.play:
                _play(wav, sr)
            return

        rtf = []
        warmup = 10
        wav, length = None, 0
        for i in range(args.iter):
            wav, length, r = _synth_once(synth, args.text, spkemb, modelcfg,
                                         iteration=i + 1, total=args.iter)
            if args.wav_filename:
                write_wav_to_file(wav, length=length, filename=args.wav_filename,
                                  sample_rate=sr, hop_length=hop)
            if i > warmup:
                rtf.append(r)
        if args.play and wav is not None:
            _play(wav, sr)
        if rtf:
            print("Average RTF: {:.2f}".format(np.mean(rtf)))
        if args.verbose:
            from zerovox_tpu_torch.utils.compile_cache import format_cache_stats

            print(format_cache_stats())
        return

    if args.interactive:
        while True:
            try:
                cmd = input("(h for help) >")
            except EOFError:
                break
            if cmd == "h":
                print(" h          help")
                print(" q          quit")
                print("any other input will get synthesized")
            elif cmd == "q":
                break
            elif cmd.strip():
                wav, length, _ = _synth_once(synth, cmd, spkemb, modelcfg)
                if args.wav_filename:
                    write_wav_to_file(wav, length=length, filename=args.wav_filename,
                                      sample_rate=sr, hop_length=hop)
                if args.play:
                    _play(wav, sr)
    else:
        print("Nothing to synthesize. Please provide a text to synthesize or run with --interactive")


if __name__ == "__main__":
    main()
