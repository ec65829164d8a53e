"""Native (C++) host components, loaded with ctypes.

Each `<name>.cpp` here compiles with g++ at first use into
`build/zerovox_tpu_torch/lib<name>-<hash>.so` beside the package, named by a
hash of the source and the flags, as `ops/_cuda.py` names the CUDA
libraries, and is reused while the source is unchanged. A failed build
raises with the compiler's output: there is no silent fallback, the numpy
versions are called by name where a caller wants them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parents[1] / "build" / "zerovox_tpu_torch"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def lib_path(name: str) -> Path:
    h = hashlib.sha256((_HERE / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile `<name>.cpp` unless its library is already built; returns the
    library's path. Raises RuntimeError with g++'s output if it fails."""
    out = lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(_HERE / f"{name}.cpp"), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ not found: building {name}.cpp needs a C++ compiler") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {name}.cpp:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds each install a whole file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `<name>.cpp`, building it first if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build(name)))
        return _libs[name]
