"""Device milliseconds of the acoustic model (CUDA events around each
call of `ZeroVox.encode` and `ZeroVox.decode`: encoder, variance adaptor,
length regulator, StyleTTS decoder) per second of audio completed."""


def read(run):
    ms, audio = run.spans.get("acoustic"), run.values.get("audio_s")
    return ms / audio if ms and audio else None
