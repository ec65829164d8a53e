"""`zerovox-torch-serve`: HTTP TTS server with dynamic micro-batching.

Concurrent requests are grouped into single `tts_batch` calls on the card
(`zerovox_tpu_torch/serving/`), voices are speaker embeddings computed once
at startup and addressed by name, and the batch sizes the batcher can form
are warmed up before the first request.

    zerovox-torch-serve --model <dir> --meldec-model <dir> --port 8000
    curl -X POST localhost:8000/tts \\
         -d '{"text": "Hello there.", "voice": "en_kevin"}' -o out.wav
    # streaming (chunked-transfer WAV, first audio after one vocoder window):
    curl -N -X POST localhost:8000/tts \\
         -d '{"text": "...", "voice": "en_kevin", "stream": true}' -o out.wav

It runs on the CUDA card; `--infer-device cpu` runs it on the CPU. Without
a card the default raises.
"""

from __future__ import annotations

import argparse
import os

from zerovox_tpu_torch.hub import DEFAULT_MELDEC_MODEL_NAME


def get_args(argv=None):
    p = argparse.ArgumentParser(
        prog="zerovox-torch-serve", description="HTTP TTS server (dynamic batching)")
    p.add_argument("--model", help="TTS model: path to model dir or hub name")
    p.add_argument("--random-model", action="store_true",
                   help="randomly initialized model (offline smoke test)")
    p.add_argument("--meldec-model", default=DEFAULT_MELDEC_MODEL_NAME,
                   help=f"vocoder model, default: {DEFAULT_MELDEC_MODEL_NAME}")
    p.add_argument("--infer-device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--voice", action="append", default=[], metavar="NAME=WAV",
                   help="register a voice from a reference wav (repeatable); "
                        "bare bundled names (see zerovox-torch-demo --refaudio) "
                        "also work. Default: all bundled reference voices")
    p.add_argument("--max-batch", type=int, default=8,
                   help="micro-batch ceiling (the largest batch warmed up)")
    p.add_argument("--max-delay-ms", type=float, default=20.0,
                   help="how long the first request of a window waits for "
                        "co-riders")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the startup warmup (first requests build the kernels)")
    p.add_argument("--verbose", action="store_true")
    return p.parse_args(argv)


def build_voices(synth, voice_args, verbose=False):
    from zerovox_tpu_torch.serving import VoiceRegistry
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS

    sr = synth.cfg.audio.sampling_rate
    reg = VoiceRegistry()
    specs = voice_args or ZeroVoxTTS.available_speakerrefs()
    for spec in specs:
        if "=" in spec:
            name, path = spec.split("=", 1)
        else:
            name, path = os.path.splitext(os.path.basename(spec))[0], spec
        wav = ZeroVoxTTS.get_speakerref(path, sr)
        if verbose:
            print(f"voice {name!r}: {len(wav) / sr:.1f}s reference")
        reg.add_from_wav(name, synth, wav)
    return reg


def main(argv=None):
    args = get_args(argv)

    from zerovox_tpu_torch.serving import make_server
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS
    from zerovox_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.random_model:
        synth = ZeroVoxTTS.from_random(verbose=args.verbose, device=args.infer_device)
    else:
        if not args.model:
            raise SystemExit("--model is required (or use --random-model)")
        _, synth = ZeroVoxTTS.load_model(args.model, meldec_model=args.meldec_model,
                                         verbose=args.verbose, device=args.infer_device)

    voices = build_voices(synth, args.voice, verbose=args.verbose)
    print(f"{len(voices.names())} voices: {', '.join(voices.names())}")

    if not args.no_warmup:
        # every batch size the batcher can emit, and the streaming window
        sizes = sorted({1, args.max_batch, max(1, args.max_batch // 2)})
        print(f"warming up tts_batch at batch sizes {sizes}...")
        synth.warmup(spkemb=voices.get(None), batch_sizes=tuple(sizes))
        for _ in synth.tts_stream("This is a warmup utterance.", voices.get(None)):
            pass

    srv = make_server(synth, voices, host=args.host, port=args.port,
                      max_batch=args.max_batch, max_delay_ms=args.max_delay_ms,
                      quiet=not args.verbose)
    host, port = srv.server_address[:2]
    print(f"serving on http://{host}:{port}  (POST /tts, GET /health, GET /voices)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        print("shutting down...")
        srv.shutdown_serving()


if __name__ == "__main__":
    main()
