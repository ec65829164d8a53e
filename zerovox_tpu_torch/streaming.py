"""Chunked streaming vocoding.

The mel is split into fixed-size chunks; each is vocoded in a window with a
receptive-field halo of extra frames on both sides, and the halo samples
are trimmed, so the concatenated stream equals a full-utterance render (the
generator is purely convolutional). The first audio arrives after one small
fixed-shape window instead of the whole utterance.

Window 0 starts at mel[0] with no left halo: a zero halo is not equivalent
to the full render's implicit zero padding, because conv biases make
activations nonzero over an explicit zero prefix that deeper layers read.
Past mel_len both paths see the same explicit zeros (the decoder masks the
bucket tail), so the right edge is exact except within one receptive field
of the bucket's end.

The window is sliced out of the decoder's mel on the device; only audio
chunks come back to the host. On the card each window's chunk is copied
into pinned host memory as soon as the window is queued, with an event
after it, so the host waits for that window alone and not for the next one,
which is queued before the current chunk is read.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class Window(NamedTuple):
    """A dispatched window's chunk samples: on the card, a pinned host copy
    in flight and the event recorded after it; on the CPU, the samples."""

    samples: torch.Tensor
    ready: torch.cuda.Event | None


class ChunkStreamer:
    """Fixed-window chunked vocoder over one decoded mel [1, T, n_mels]."""

    def __init__(self, meldec, meldec_cfg, mel: torch.Tensor, chunk_frames: int = 96,
                 halo_frames: int | None = None):
        if halo_frames is None:
            halo_frames = meldec_cfg.receptive_field_frames()
        self.halo = halo_frames
        self.up = meldec_cfg.total_upsample
        self.chunk = chunk_frames
        self.window = chunk_frames + 2 * halo_frames
        self._meldec = meldec
        # left halo zeros + right padding so any window start is in range
        self._mel_padded = F.pad(mel, (0, 0, self.halo, self.window))

    def dispatch(self, pos: int) -> Window:
        """Start vocoding the window of the chunk at mel position `pos` and,
        on the card, copying its chunk to the host (both asynchronous).
        pos == 0 anchors the window at mel[0] with no left halo (module
        docstring)."""
        start = self.halo if pos == 0 else pos
        start_s = 0 if pos == 0 else self.halo * self.up
        with torch.inference_mode():
            # float32 chunks whatever the vocoder's dtype (bf16 inference)
            wav = self._meldec(self._mel_padded[:, start:start + self.window]).float()
            samples = wav[0, start_s:start_s + self.chunk * self.up]
            if samples.device.type != "cuda":
                return Window(samples, None)
            host = torch.empty(samples.shape, dtype=samples.dtype, pin_memory=True)
            host.copy_(samples, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return Window(host, ready)

    @staticmethod
    def trim(window: Window, n_frames: int, up: int) -> np.ndarray:
        """The first n_frames frames (up samples each) of a window's chunk,
        once its copy has landed."""
        if window.ready is not None:
            window.ready.synchronize()
        return window.samples[:n_frames * up].numpy()

    def chunks(self, mel_len: int, pos: int = 0, first_wav: Window | None = None
               ) -> Iterator[np.ndarray]:
        """Yield chunks covering mel[pos:mel_len]. The next window is
        dispatched before the current one is read, so the card computes
        while the host waits for the current copy and yields."""
        pending_pos = pos
        pending = first_wav if first_wav is not None else self.dispatch(pos)
        while pending_pos < mel_len:
            end = min(pending_pos + self.chunk, mel_len)
            nxt = self.dispatch(end) if end < mel_len else None
            yield self.trim(pending, end - pending_pos, self.up)
            pending, pending_pos = nxt, end


def stream_vocode(meldec, meldec_cfg, mel: torch.Tensor, mel_len: int, chunk_frames: int = 96,
                  halo_frames: int | None = None) -> Iterator[np.ndarray]:
    """Yield waveform chunks covering mel[:, :mel_len]."""
    yield from ChunkStreamer(meldec, meldec_cfg, mel, chunk_frames, halo_frames).chunks(mel_len)
