"""Per-stage timing, RTF measurement and device traces.

`RtfStats` keeps the JAX package's method (mean RTF after a warm-up; p50 of
the first-chunk latency). `StageTimer` marks host wall-clock stages and, on
a CUDA device, synchronizes before each mark so a stage's time includes its
device work. `cuda_time_ms` times device work with CUDA events.
`device_trace(logdir)` is the torch.profiler counterpart of the JAX
package's `jax.profiler` trace context.
"""

from __future__ import annotations

import contextlib
import os
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


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler over the block (host ops, and CUDA kernels when a card
    is present). On exit, after a device synchronize, writes the Chrome
    trace `trace-<pid>-<ms>.json` (view in chrome://tracing or Perfetto) and
    the table of ops by device time `trace-<pid>-<ms>.txt` into `logdir`.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    stem = os.path.join(logdir, f"trace-{os.getpid()}-{int(time.time() * 1000)}")
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(stem + ".json")
    sort = "self_cuda_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
    with open(stem + ".txt", "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=40) + "\n")
