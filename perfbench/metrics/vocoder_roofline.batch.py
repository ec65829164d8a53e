"""The vocoder's share of its roofline, in %: the least time the H100
could take for the window's vocoder calls at the shapes they rendered
(max of their FLOP at 495 TFLOP/s, the card's fastest float32 rate, and
their bytes at 3.35 TB/s: each input byte read once, each output byte
written once), over the device time of those calls (CUDA events)."""

from flops.zerovox import vocoder, vocoder_bytes
from harness import PEAK_BYTES_S, PEAK_FLOPS


def read(run):
    ms = run.spans.get("vocoder")
    shapes = run.values.get("vocoded")
    if not ms or not shapes:
        return None
    h = run.cfg["vocoder"]
    least = sum(max(B * vocoder(h, T) / PEAK_FLOPS, vocoder_bytes(h, B, T) / PEAK_BYTES_S)
                for B, T in shapes)
    return 100.0 * least / (ms / 1e3)
