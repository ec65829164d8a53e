"""Open-loop serving: independent users send requests on a Poisson schedule
through the port's `DynamicBatcher` over one `ZeroVoxTTS` engine.

Parameters (the cell's `params`):
  rate            requests a second offered, fixed
  stream_share    the share of requests that stream (`submit_stream`)
  chunk_frames    a stream's chunk, in mel frames
  max_batch, max_delay_ms   the batcher's window (`cli/serve.py`'s defaults)
  text            {median, sigma, min, max}: lognormal characters a text
  voices, zipf_s  the bundled reference wavs, chosen with Zipf skew
  warmup_seconds  the same mix from another stream of the seed, before the window
  check_whole, check_streams   how many answers the check holds to the reference
  drain_seconds   how long the run waits for late answers
  window          "answered" (default): the window lasts until every
                  request due in it was answered, and the end-to-end
                  metrics are the tails; "seconds": the window closes at
                  `--seconds` and the end-to-end metric is the audio
                  completed in it a second (a rate above what the system
                  sustains); the rest is awaited after it, for the check

Every request due in the window is timed from when it was due: a whole
utterance until its waveform is in hand (its future resolved), a stream
until its first chunk is produced. One that never comes counts as missing.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from harness import quantile
from synth import Checker, build_engine, load_voices, sample_indices, zipf_choice
from textgen import exponential_gaps, lognormal_sizes, sentence


@dataclass
class Request:
    due: float
    text: str
    voice: int
    stream: bool
    sent: float = math.nan
    first: float = math.nan
    done: float = math.nan
    wav: np.ndarray | None = None
    pieces: list = field(default_factory=list)
    chunk_times: list = field(default_factory=list)  # (time, samples) of each chunk
    error: str | None = None


def make_requests(p: dict, rng: np.random.Generator, seconds: float) -> list[Request]:
    """rate x seconds requests. Every seed offers the same schedule: the
    lognormal sizes, the Poisson gaps and which requests stream, in one
    order drawn once from the request count; the seed draws the words and
    the voices (and, apart, the weights)."""
    n = max(1, int(round(p["rate"] * seconds)))
    t = p["text"]
    fixed = np.random.default_rng([n, 0])
    sizes = fixed.permutation(lognormal_sizes(n, t["median"], t["sigma"], t["min"], t["max"]))
    gaps = fixed.permutation(exponential_gaps(n, 1.0 / p["rate"]))
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    streams = np.zeros(n, bool)
    streams[: int(round(p["stream_share"] * n))] = True
    streams = fixed.permutation(streams)
    voices = zipf_choice(rng, len(p["voices"]), p["zipf_s"], n)
    return [Request(float(due[i]), sentence(rng, int(sizes[i])), int(voices[i]), bool(streams[i]))
            for i in range(n)]


class Client:
    """Sends the requests on schedule and records when each answer came,
    through wrappers on the engine instance: `tts_batch` (a window's
    members), `tts_stream_text` / `tts_stream` (a stream's pieces and the
    time its first chunk was produced)."""

    def __init__(self, engine, batcher, spk: list, chunk_frames: int):
        self.engine, self.batcher, self.spk = engine, batcher, spk
        self.chunk_frames = chunk_frames
        self.by_id: dict[int, Request] = {}
        self.calls: list[list[int]] = []
        self.cur: list = [None]
        cls = type(engine)
        orig_batch, orig_text, orig_piece = engine.tts_batch, cls.tts_stream_text, cls.tts_stream

        def tts_batch(texts, spkembs, durations=None):
            self.calls.append([id(t) for t in texts])
            return orig_batch(texts, spkembs, durations)

        def tts_stream_text(text, spkemb, chunk_frames=96):
            req = self.by_id[id(text)]
            gen = orig_text(engine, text, spkemb, chunk_frames)
            while True:
                self.cur[0] = req
                try:
                    chunk = next(gen)
                except StopIteration:
                    break
                finally:
                    self.cur[0] = None
                if math.isnan(req.first):
                    req.first = time.perf_counter()
                yield chunk
            req.done = time.perf_counter()

        def tts_stream(text, spkemb, chunk_frames=96, duration=None):
            req, piece = self.cur[0], []
            req.pieces.append(piece)
            for chunk in orig_piece(engine, text, spkemb, chunk_frames, duration):
                piece.append(chunk)
                req.chunk_times.append((time.perf_counter(), len(chunk)))
                yield chunk

        engine.tts_batch, engine.tts_stream_text, engine.tts_stream = (
            tts_batch, tts_stream_text, tts_stream)

    def send(self, reqs: list[Request], t0: float) -> None:
        for r in reqs:
            self.by_id[id(r.text)] = r
        for r in reqs:
            delay = t0 + r.due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            r.sent = time.perf_counter()
            if r.stream:
                self.batcher.submit_stream(r.text, self.spk[r.voice], self.chunk_frames)
            else:
                fut = self.batcher.submit(r.text, self.spk[r.voice])
                fut.add_done_callback(lambda f, r=r: self._done(r, f))

    @staticmethod
    def _done(r: Request, f) -> None:
        r.done = time.perf_counter()
        if f.exception() is not None:
            r.error = repr(f.exception())
        else:
            r.wav = f.result()[0]

    def start(self, reqs: list[Request], t0: float) -> threading.Thread:
        """Send on schedule from a thread of its own."""
        sender = threading.Thread(target=self.send, args=(reqs, t0), name="bench-client")
        sender.start()
        return sender

    @staticmethod
    def wait(sender: threading.Thread, reqs: list[Request], deadline: float) -> None:
        """Wait until every request was sent and answered, or the deadline passed."""
        sender.join()
        pending = [r for r in reqs if math.isnan(r.done)]
        while pending and time.perf_counter() < deadline:
            time.sleep(0.01)
            pending = [r for r in pending if math.isnan(r.done)]


def run(run) -> None:
    from zerovox_tpu_torch.serving.batcher import DynamicBatcher

    p = run.params()
    reqs = make_requests(p, np.random.default_rng([run.seed, 1]), run.seconds)
    run.mark("start")
    voices = load_voices(p["voices"])
    engine = build_engine(run, [r.text for r in reqs], voices, [r.voice for r in reqs])
    run.mark("engine")
    spk = [engine.speaker_embed(w).float().cpu().numpy() for w in voices]
    run.mark("voices")
    engine._meldec.forward = run.span("vocoder", engine._meldec.forward)
    engine._model.encode = run.span("acoustic", engine._model.encode)
    engine._model.decode = run.span("acoustic", engine._model.decode)
    batcher = DynamicBatcher(engine, max_batch=p["max_batch"], max_delay_ms=p["max_delay_ms"])
    client = Client(engine, batcher, spk, p["chunk_frames"])
    try:
        warm = make_requests(p, np.random.default_rng([run.seed, 2]), p["warmup_seconds"])
        t = time.perf_counter()
        client.wait(client.start(warm, t), warm, t + p["warmup_seconds"] + p["drain_seconds"])
        base = dict(vars(batcher.stats))
        n_calls = len(client.calls)
        on_time = p.get("window", "answered") == "seconds"
        with run.window():
            t0 = time.perf_counter()
            sender = client.start(reqs, t0)
            if on_time:
                time.sleep(max(0.0, t0 + run.seconds - time.perf_counter()))
            else:
                client.wait(sender, reqs, t0 + run.seconds + p["drain_seconds"])
            close = time.perf_counter()  # before a traced run reads its trace
            stats = {k: v - base[k] for k, v in vars(batcher.stats).items()}
        if on_time:
            client.wait(sender, reqs, close + p["drain_seconds"])
    finally:
        batcher.close()
    run.read_memory_peak()

    whole = [r for r in reqs if not r.stream]
    streams = [r for r in reqs if r.stream]
    lat = [(r.done - (t0 + r.due)) * 1e3 if r.wav is not None else math.inf for r in whole]
    first = [(r.first - (t0 + r.due)) * 1e3 if not math.isnan(r.done) and r.pieces
             else math.inf for r in streams]
    hop = engine.cfg.audio.hop_size
    sr = engine.cfg.audio.sampling_rate
    # the audio completed in the window: whole waveforms in hand, stream chunks produced
    audio_s = (sum(len(r.wav) for r in whole if r.wav is not None and r.done <= close)
               + sum(n for r in streams for t, n in r.chunk_times if t <= close)) / sr
    run.attempted = len(reqs)
    run.failed = sum(1 for x in lat + first if not math.isfinite(x))
    tails = dict(request_p95_ms=quantile(lat, 0.95), first_chunk_p95_ms=quantile(first, 0.95))
    if on_time:
        run.e2e["served_audio_rate"] = audio_s / run.window_s
    else:
        run.e2e.update(tails)
    run.counters.update(stats)
    run.values.update(audio_s=audio_s, arrivals=[(r.due, r.first - t0, r.done - t0, r.stream)
                                                 for r in reqs])
    late = [r.sent - (t0 + r.due) for r in reqs]
    run.log(requests=len(reqs), whole=len(whole), streams=len(streams), failed=run.failed,
            request_p50_ms=quantile(lat, 0.5), first_chunk_p50_ms=quantile(first, 0.5), **tails,
            sender_late_p99_ms=quantile(late, 0.99) * 1e3, sender_late_max_ms=max(late) * 1e3,
            completed_share=sum(1 for r in reqs if not math.isnan(r.done)) / len(reqs),
            done_in_window=sum(1 for r in reqs if r.done <= close),
            last_done_s=max((r.done for r in reqs if not math.isnan(r.done)), default=t0) - t0,
            audio_s=audio_s, audio_rate=audio_s / run.window_s, batcher=stats, hop=hop,
            window_s=run.window_s)

    # the check: the program's state freed first, then the reference
    calls = client.calls[n_calls:]
    del engine, batcher, client
    run.free()
    check(run, reqs, calls, voices)


def check(run, reqs: list, calls: list, voices: list, tf32: bool = False):
    p = run.params()
    rng = np.random.default_rng([run.seed, 3])
    checker = Checker(run, voices, tf32=tf32)
    by_id = {id(r.text): r for r in reqs}
    whole = [r for r in reqs if not r.stream and r.wav is not None]
    streams = [r for r in reqs if r.stream and not math.isnan(r.done)]
    for i in sample_indices(rng, [len(r.text) for r in whole], p["check_whole"]):
        r = whole[i]
        call = next(c for c in calls if id(r.text) in c)
        members = [by_id[k] for k in call]
        checker.batch([m.text for m in members], [m.voice for m in members],
                      [call.index(id(r.text))], [r.wav])
    for i in sample_indices(rng, [len(r.text) for r in streams], p["check_streams"]):
        r = streams[i]
        checker.stream(r.text, r.voice, [np.concatenate(pc) if pc else np.zeros(0, np.float32)
                                         for pc in r.pieces], p["chunk_frames"])
    checker.finish()
    run.check("missing", sum(1 for r in reqs if math.isnan(r.done) or r.error), 0)
