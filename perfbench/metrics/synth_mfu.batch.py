"""The whole synthesis step's share of the H100's float32 peak, in %: the
model FLOP of the utterances the window completed (encoder and variance
adaptor at their phones, decoder and vocoder at their frames, unpadded)
over the window's seconds, against 495 TFLOP/s."""

from flops.zerovox import synthesis
from harness import PEAK_FLOPS


def read(run):
    phones, frames = run.values.get("phones"), run.values.get("utterance_frames")
    if not phones:
        return None
    f = sum(synthesis(run.cfg, n, t) for n, t in zip(phones, frames))
    return 100.0 * f / run.window_s / PEAK_FLOPS
