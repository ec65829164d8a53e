"""Per-stage timing and RTF measurement.

`RtfStats` keeps the JAX package's method (mean RTF after a warm-up; p50 of
the first-chunk latency). `StageTimer` marks host wall-clock stages and, on
a CUDA device, synchronizes before each mark so a stage's time includes its
device work. `cuda_time_ms` times device work with CUDA events.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


class StageTimer:
    """Wall-clock stage timer; `mark(name)` after each stage."""

    def __init__(self, device=None):
        self.sync = device is not None and torch.device(device).type == "cuda"
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.stages: dict[str, float] = {}

    def mark(self, name: str) -> float:
        if self.sync:
            torch.cuda.synchronize()
        now = time.perf_counter()
        dt = now - self.last
        self.stages[name] = self.stages.get(name, 0.0) + dt
        self.last = now
        return dt

    @property
    def total(self) -> float:
        return self.last - self.t0

    def report(self) -> str:
        return ", ".join(f"{k}={v:.4f}s" for k, v in self.stages.items())


@dataclass
class RtfStats:
    """RTF = synth_wall_seconds / voice_len_seconds, mean over iterations
    after warmup."""

    warmup: int = 10
    rtfs: list = field(default_factory=list)
    latencies: list = field(default_factory=list)
    _iter: int = 0

    def add(self, voice_len_s: float, elapsed_s: float, first_chunk_s: float | None = None):
        self._iter += 1
        if self._iter > self.warmup + 1:
            self.rtfs.append(elapsed_s / max(voice_len_s, 1e-9))
            if first_chunk_s is not None:
                self.latencies.append(first_chunk_s)

    @property
    def mean_rtf(self) -> float:
        return sum(self.rtfs) / len(self.rtfs) if self.rtfs else float("nan")

    @property
    def p50_first_chunk_ms(self) -> float:
        if not self.latencies:
            return float("nan")
        s = sorted(self.latencies)
        return 1000.0 * s[len(s) // 2]


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of `fn()` over `iters` launches, timed with
    CUDA events on the current stream after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
