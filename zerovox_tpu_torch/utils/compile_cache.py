"""The kernel build cache and its counters.

The port's counterpart of the JAX package's `utils/compile_cache.py`. The
port's compiled programs are its CUDA kernel libraries (`ops/_cuda.py`):
one nvcc build a `csrc/*.cu` source, named by a hash of the sources and the
flags, and reused while they are unchanged. `ZEROVOX_COMPILE_CACHE` places
them, as it places the JAX package's XLA cache:

  * unset: `build/zerovox_tpu_torch/` beside the package (a directory
    `.gitignore` lists, so builds stay inside the checkout);
  * a path: that directory;
  * "0": no cache; `enable_compile_cache()` returns None and the kernels
    build into a fresh temporary directory of this process, removed at
    exit. They always build: nothing falls back to the plain versions.

The counters, since the process started: `requests` (libraries looked up),
`hits` (a library found under its hash), `misses` (a library built),
`backend_compiles` and `backend_compile_sec` (nvcc processes and their wall
seconds), `saved_sec` (the build seconds a hit avoided, read from the
`.json` the build writes beside each library) and `retrieval_sec` (the
seconds `ctypes` took to load the libraries). `format_cache_stats()` is the
JAX package's one-line summary; the CLIs print it.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / "zerovox_tpu_torch"

_lock = threading.Lock()
_stats = {
    "requests": 0,
    "hits": 0,
    "misses": 0,
    "saved_sec": 0.0,
    "retrieval_sec": 0.0,
    "backend_compile_sec": 0.0,
    "backend_compiles": 0,
}
_scratch: list[str] = []  # this process's build directory under ZEROVOX_COMPILE_CACHE=0


def build_dir() -> Path:
    """Where the kernel libraries are built and looked up (see the module
    docstring); read from `ZEROVOX_COMPILE_CACHE` at each call."""
    spec = os.environ.get("ZEROVOX_COMPILE_CACHE", "")
    if spec != "0":
        return Path(spec) if spec else DEFAULT_DIR
    with _lock:
        if not _scratch:
            _scratch.append(tempfile.mkdtemp(prefix="zerovox_kernels_"))
            atexit.register(shutil.rmtree, _scratch[0], True)
        return Path(_scratch[0])


def enable_compile_cache() -> str | None:
    """The cache directory, created; None when `ZEROVOX_COMPILE_CACHE=0`."""
    if os.environ.get("ZEROVOX_COMPILE_CACHE", "") == "0":
        return None
    path = build_dir()
    path.mkdir(parents=True, exist_ok=True)
    return str(path)


def record(**deltas) -> None:
    """Add to the counters (`ops/_cuda.py` calls this)."""
    with _lock:
        for k, v in deltas.items():
            _stats[k] += v


def cache_stats() -> dict:
    """Snapshot of the counters since process start."""
    with _lock:
        return dict(_stats)


def format_cache_stats() -> str:
    s = cache_stats()
    return (f"compile cache: {s['hits']} hits / {s['misses']} misses "
            f"({s['requests']} requests); saved {s['saved_sec']:.1f}s, "
            f"cold compiles {s['backend_compiles']} "
            f"({s['backend_compile_sec']:.1f}s)")
