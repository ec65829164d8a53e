"""Dynamic micro-batching: group concurrent TTS requests into one `tts_batch`.

Requests arrive on arbitrary threads via `submit` and resolve through
futures; a single dispatch thread drains the queue into batches bounded by
`max_batch` (the largest batch size warmed up by
`ZeroVoxTTS.warmup(batch_sizes=)`) and `max_delay_ms` (how long the first
request in a window may wait for co-riders). The card runs one padded
static-bucket `tts_batch` per window (synthesize.py), which is the whole
point: B concurrent requests cost about one batch call, not B sequential
batch-1 calls.

The engine is driven from the dispatch thread only: `ZeroVoxTTS` makes no
thread-safety promises, and a single dispatcher also keeps the card's work
serialized (one call in flight at a time keeps latency predictable). The
engine enters `torch.inference_mode` inside each call, so it holds on this
thread too, and its kernels launch on this thread's current CUDA stream.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np


@dataclass
class _Request:
    text: str
    spkemb: object  # [1, 1, emb] speaker embedding (host numpy float32)
    future: Future = field(default_factory=Future)


#: end-of-stream sentinel placed on a _StreamRequest's queue after the last
#: chunk (an Exception instance there means the stream failed at that point)
STREAM_EOS = object()


@dataclass
class _StreamRequest:
    """A streaming utterance: chunks flow through `queue` as the dispatch
    thread produces them (the HTTP handler drains and writes them, so a slow
    client socket never blocks device dispatch)."""

    text: str
    spkemb: object
    chunk_frames: int
    queue: queue.SimpleQueue = field(default_factory=queue.SimpleQueue)


@dataclass
class BatcherStats:
    """Counters exposed via the /health endpoint (all under the lock of the
    dispatch thread — read-only snapshots elsewhere)."""

    requests: int = 0
    batches: int = 0
    max_batch_seen: int = 0
    errors: int = 0
    synth_wall_s: float = 0.0
    streams: int = 0
    stream_chunks: int = 0

    def as_dict(self) -> dict:
        d = {"requests": self.requests, "batches": self.batches,
             "max_batch_seen": self.max_batch_seen, "errors": self.errors,
             "synth_wall_s": round(self.synth_wall_s, 3),
             "streams": self.streams, "stream_chunks": self.stream_chunks}
        if self.batches:
            d["mean_batch_size"] = round(self.requests / self.batches, 2)
        return d


class DynamicBatcher:
    """Queue + dispatch thread turning concurrent `submit` calls into
    `engine.tts_batch` windows."""

    _STOP = object()

    #: adaptive-window floor: a lone request never waits less than this
    MIN_DELAY_S = 0.001

    def __init__(self, engine, max_batch: int = 8, max_delay_ms: float = 20.0):
        assert max_batch >= 1
        self._engine = engine
        self._max_batch = max_batch
        self._max_delay_s = max_delay_ms / 1000.0
        # Adaptive coalescing window: when traffic is sparse (windows keep
        # closing with a single request and no co-rider arrived), waiting out
        # the full max_delay buys nothing — it is pure added latency. The
        # window halves after every single-request dispatch (floored at
        # MIN_DELAY_S) and snaps back to max_delay the moment a window
        # actually coalesces >=2 requests, so bursty traffic still batches
        # at full strength.
        self._cur_delay_s = self._max_delay_s
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self.stats = BatcherStats()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="zerovox-batcher")
        self._thread.start()

    def submit(self, text: str, spkemb) -> Future:
        """Enqueue one utterance; the future resolves to (wav, mel_len)."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        req = _Request(text=text, spkemb=spkemb)
        self._q.put(req)
        return req.future

    def submit_stream(self, text: str, spkemb,
                      chunk_frames: int = 96) -> queue.SimpleQueue:
        """Enqueue a streaming utterance; returns a queue of waveform chunks
        terminated by STREAM_EOS (or an Exception instance on failure).

        Streams advance one chunk per scheduler turn and interleave with
        batch windows (and each other) on the dispatch thread — a long
        stream never head-of-line-blocks concurrent requests, while every
        engine call still runs on the single dispatch thread."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        req = _StreamRequest(text=text, spkemb=spkemb,
                             chunk_frames=chunk_frames)
        self._q.put(req)
        return req.queue

    def close(self, timeout: float = 10.0) -> None:
        """Drain-and-stop: queued requests still complete."""
        if self._closed:
            return
        self._closed = True
        self._q.put(self._STOP)
        self._thread.join(timeout)

    # ------------------------------------------------------------------

    def _collect_window(self, first: _Request):
        """Gather up to max_batch requests within max_delay of `first`.

        Returns (batch, holdover): `holdover` is a non-batchable item pulled
        mid-window (a _StreamRequest or the stop sentinel) that the loop must
        handle after dispatching the batch, or None."""
        batch = [first]
        start = time.monotonic()
        deadline = start + self._cur_delay_s
        holdover = None
        while len(batch) < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is self._STOP or isinstance(item, _StreamRequest):
                holdover = item
                break
            batch.append(item)
            if len(batch) == 2:
                # co-riders exist: traffic is dense enough to justify the
                # full window — restore it for this and future windows
                # (never holding `first` longer than max_delay total)
                self._cur_delay_s = self._max_delay_s
                deadline = start + self._max_delay_s
        if len(batch) == 1:
            self._cur_delay_s = max(self._cur_delay_s / 2, self.MIN_DELAY_S)
        return batch, holdover

    def _dispatch(self, batch: list[_Request]) -> None:
        texts = [r.text for r in batch]
        spkembs = np.concatenate(
            [np.asarray(r.spkemb, np.float32) for r in batch], axis=0)
        t0 = time.monotonic()
        try:
            outs = self._engine.tts_batch(texts, spkembs)
        except Exception as e:  # noqa: BLE001 — forwarded to every caller
            self.stats.errors += len(batch)
            for r in batch:
                r.future.set_exception(e)
            return
        self.stats.synth_wall_s += time.monotonic() - t0
        self.stats.requests += len(batch)
        self.stats.batches += 1
        self.stats.max_batch_seen = max(self.stats.max_batch_seen, len(batch))
        for r, (wav, mel_len) in zip(batch, outs):
            r.future.set_result((wav, mel_len))

    def _step_stream(self, entry) -> bool:
        """Produce ONE chunk of an active stream; returns False when the
        stream finished (EOS or error placed on its queue)."""
        req, gen = entry
        t0 = time.monotonic()
        try:
            chunk = next(gen)
        except StopIteration:
            self.stats.synth_wall_s += time.monotonic() - t0
            self.stats.streams += 1
            req.queue.put(STREAM_EOS)
            return False
        except Exception as e:  # noqa: BLE001 — forwarded to the consumer
            self.stats.errors += 1
            req.queue.put(e)
            return False
        self.stats.synth_wall_s += time.monotonic() - t0
        self.stats.stream_chunks += 1
        req.queue.put(chunk)
        return True

    def _loop(self) -> None:
        """Cooperative scheduler: streams advance one chunk per turn and
        batch windows dispatch between chunks, so a long-running stream
        never head-of-line-blocks concurrent batch requests (and multiple
        streams round-robin). Every engine call still happens on this one
        thread, one engine call in flight at a time."""
        streams: list = []  # active (request, generator) pairs
        pending = None
        stopping = False
        while True:
            if pending is not None:
                item, pending = pending, None
            elif stopping or streams:
                # don't block while streams have work (or we're draining)
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    item = None
            else:
                item = self._q.get()
            if item is self._STOP:
                stopping = True
            elif isinstance(item, _StreamRequest):
                gen = self._engine.tts_stream_text(
                    item.text, item.spkemb, chunk_frames=item.chunk_frames)
                streams.append((item, gen))
            elif item is not None:
                batch, pending = self._collect_window(item)
                self._dispatch(batch)
            streams = [s for s in streams if self._step_stream(s)]
            if stopping and not streams and pending is None:
                return
