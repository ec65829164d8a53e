"""The train step's share of the H100's float32 peak, in %: the analytic
FLOP of the window's steps (3 x the forward of the speaker encoder,
encoder, variance adaptor and decoder at each batch's unpadded lengths)
over the window's seconds, against 495 TFLOP/s."""

from flops.zerovox import train_step
from harness import PEAK_FLOPS

REF_FRAMES = 500  # the data module's reference-mel crop


def read(run):
    batches = run.values.get("batches")
    if not batches:
        return None
    f = sum(train_step(run.cfg, ph, fr, REF_FRAMES) for ph, fr in batches)
    return 100.0 * f / run.window_s / PEAK_FLOPS
