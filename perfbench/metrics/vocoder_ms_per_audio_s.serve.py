"""Device milliseconds of the vocoder (CUDA events around each call of the
generator's forward: batch windows and streamed windows) per second of
audio completed in the window."""


def read(run):
    ms, audio = run.spans.get("vocoder"), run.values.get("audio_s")
    return ms / audio if ms and audio else None
