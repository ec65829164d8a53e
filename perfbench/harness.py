"""The benchmark's core: finds a cell's files by name, runs its traffic kind,
reads the per-layer metrics and prints the result line.

Layout under `perfbench/`, each piece found by its name in `BENCHMARK.json`:

  configs/<config>.json     a configuration: the model's sizes as run
  workloads/<cell>.json     a cell: its configuration, traffic kind and the
                            kind's parameters
  traffic/<kind>.py         a traffic kind: `run(run)` drives the program
  metrics/<metric>.py       a per-layer metric: `read(run)` -> number or None
  flops/                    the operation and byte counts of the models
  reference/                the plain reference that decides `correct`

A traffic kind builds the program, warms it, opens `run.window()`, drives
the window, closes it, reads `memory_peak_bytes`, frees the program and
then holds what the window produced to the reference (`run.check`).
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zerovox_tpu")

# float32 TF32 tensor-core peak of one H100 SXM (NVIDIA's data sheet, dense)
# and its HBM3 bandwidth: the yardstick's roofline for float32 work
PEAK_FLOPS = 495e12
PEAK_BYTES_S = 3.35e12


def process_age_s() -> float:
    """Seconds since this process started (from /proc; 0 where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def set_cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache of the program at a fixed directory
    inside the checkout, so only a cell's first run there builds."""
    cache = root / "build" / "perfbench"
    os.environ["ZEROVOX_COMPILE_CACHE"] = str(cache / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX package."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def quantile(values, q: float) -> float:
    """The q-th quantile by nearest rank (inf counts as missing)."""
    v = sorted(values)
    if not v:
        return math.nan
    return v[max(0, math.ceil(q * len(v)) - 1)]


class Run:
    """One run of one cell: its files, its arguments and what it measured."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", root: Path = ROOT, started: float | None = None):
        self.root = Path(root)
        self.bench_dir = self.root / "perfbench"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.workload = json.loads((self.bench_dir / "workloads" / f"{workload}.json").read_text())
        self.name = workload
        self.cfg = json.loads((self.bench_dir / "configs"
                               / f"{self.workload['config']}.json").read_text())
        self.seed, self.seconds, self.trace, self.device = int(seed), float(seconds), trace, device
        self.started = time.time() - process_age_s() if started is None else started
        self.e2e: dict[str, float] = {}
        self.counters: dict[str, float] = {}
        self.spans: dict[str, float] = {}  # device ms by span name (traced runs)
        self.values: dict[str, float] = {}  # quantities the metric readers take
        self.checks: list[tuple[str, float, float]] = []
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.setup_s = math.nan
        self.window_s = math.nan
        self.busy_s = None
        self.breakdown = None
        self.marks: dict[str, float] = {}
        self._events: list = []
        self._span_names: list[str] = []

    # ------------------------------------------------------------ files

    def params(self) -> dict:
        return self.workload["params"]

    def weights(self, texts=None, voices=None, who=None):
        """The seed's (acoustic, vocoder) state_dicts on the run's device;
        the duration calibration is worked out over `texts`, text i in the
        voice of the wav voices[who[i]], on the first call and reused after
        it, so the reference gets the same weights."""
        from weights import make_weights

        sd, vsd, self.calibration = make_weights(self.cfg, self.seed, self.device, texts,
                                                 self.calibration, voices, who)
        return sd, vsd

    calibration = None

    def traffic(self):
        kind = self.workload["traffic"]
        return load_module(self.bench_dir / "traffic" / f"{kind}.py", f"perfbench_traffic_{kind}")

    def mark(self, label: str) -> None:
        """Seconds since the process started at a point of the set-up."""
        self.marks[label] = round(time.time() - self.started, 3)

    def log(self, **fields) -> None:
        """A line of what the run saw (not the result line)."""
        print(json.dumps(fields, default=float), flush=True)

    # ------------------------------------------------------------ spans

    def span(self, label: str, fn):
        """fn wrapped so that, in a traced run, each call is bracketed by
        CUDA events (summed into spans[label] after the window) and a
        profiler range; untraced runs get fn itself."""
        if not self.trace:
            return fn
        import torch

        events = self._events
        self._span_names.append(label)

        def wrapped(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(f"bench.{label}"):
                a.record()
                out = fn(*args, **kwargs)
                b.record()
            if self._in_window:
                events.append((label, a, b))
            return out

        return wrapped

    _in_window = False

    # ------------------------------------------------------------ window

    @contextlib.contextmanager
    def window(self):
        """The measured window: set-up ends where it opens. In a traced run
        the profiler records it; the kind synchronizes before it closes."""
        import torch

        prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        torch.cuda.synchronize(self.device) if self.device != "cpu" else None
        self.setup_s = time.time() - self.started
        self.log(setup_s=self.setup_s, setup_marks=self.marks)
        t0 = time.perf_counter()
        self._in_window = True
        try:
            yield
        finally:
            self._in_window = False
            if self.device != "cpu":
                torch.cuda.synchronize(self.device)
            self.window_s = time.perf_counter() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
                self._read_trace(prof)
            for label, a, b in self._events:
                self.spans[label] = self.spans.get(label, 0.0) + a.elapsed_time(b)
            self._events.clear()

    def _read_trace(self, prof) -> None:
        """busy_s: the union of the device's kernel, copy and set intervals;
        the top device operations; the longest idle gaps, each named by the
        innermost host range open at its middle."""
        evs = prof.profiler.kineto_results.events()
        dev, host = [], []
        for e in evs:
            kind = str(e.device_type())
            if kind.endswith("CUDA"):
                kind_of = getattr(e, "activity_type", None)
                if e.is_user_annotation() or (kind_of and "annotation" in str(kind_of()).lower()):
                    continue
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif kind.endswith("CPU"):
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        if not dev:
            return
        dev.sort()
        by_name: dict[str, float] = {}
        busy, gaps, end = 0, [], None
        for a, b, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
            if end is not None and a > end:
                gaps.append((a - end, end, a))
            busy += max(0, b - max(a, end if end is not None else a))
            end = b if end is None else max(end, b)
        self.busy_s = busy / 1e9
        gaps.sort(reverse=True)
        host.sort()
        starts = [h[0] for h in host]
        named: dict[str, float] = {}
        for length, a, b in gaps[:200]:
            mid = (a + b) // 2
            label = "host_idle"
            # the innermost open range is the latest-starting one that covers mid
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - 5000), -1):
                if host[j][1] >= mid:
                    label = host[j][2]
                    break
            named[label] = named.get(label, 0.0) + length / 1e9
        self.breakdown = {
            "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:10]],
            "idle_gaps": [[n, s] for n, s in sorted(named.items(), key=lambda x: -x[1])[:10]],
        }

    def read_memory_peak(self) -> None:
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize(self.device)
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))

    @staticmethod
    def free() -> None:
        import torch

        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ checks

    def check(self, name: str, value: float, limit: float) -> None:
        """A number compared with its limit: correct needs value <= limit."""
        self.checks.append((name, float(value), float(limit)))

    def limit(self, name: str) -> float:
        return float(self.workload["limits"][name])

    # ------------------------------------------------------------ result

    def _metric_specs(self, section: str) -> list[dict]:
        return [m for m in self.bench[section] if self.name in m.get("workloads", [self.name])]

    def result(self) -> dict:
        import torch

        correct = bool(self.checks) and all(v <= lim for _, v, lim in self.checks)
        metrics: dict[str, dict] = {}
        if not self.trace:
            values = dict(self.e2e, setup_s=self.setup_s)
            for m in self._metric_specs("end_to_end"):
                if m["name"] in values and math.isfinite(values[m["name"]]):
                    metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        else:
            for m in self._metric_specs("per_layer"):
                reader = load_module(self.bench_dir / "metrics" / f"{m['name']}.py",
                                     "perfbench_metric_" + m["name"].replace(".", "_"))
                v = reader.read(self)
                if v is not None and math.isfinite(v):
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)
                  if self.device != "cpu" else "cpu",
                  "count": 1, "memory_peak_bytes": self.memory_peak}
        out = {"correct": correct, "attempted": self.attempted, "failed": self.failed,
               "metrics": metrics, "device": device}
        if self.trace:
            device["busy_s"] = self.busy_s if self.busy_s is not None else 0.0
            device["window_s"] = self.window_s
            if self.breakdown is not None:
                out["breakdown"] = self.breakdown
        out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in self.checks}
        return out
