"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source compiles with nvcc into its own shared library with
a plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds). All sources build together, one nvcc process each, at the
first kernel launch of the process; libraries are named by a hash of the
sources and reused while the sources are unchanged. Output goes to
`build/zerovox_tpu_torch/` beside the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zerovox_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the exported functions (every one returns a cudaError_t)
SIGNATURES = {
    "mrf": {"zv_mrf_f32": [_P] * 4 + [_I] * 11 + [_P], "zv_mrf_tile": [_I] * 11,
            "zv_mrf_bf16": [_P] * 5 + [_I] * 11 + [_P]},
    "resblock": {"zv_resblock1_f32": [_P] * 4 + [_I] * 8 + [_P], "zv_resblock1_tile": [_I] * 8,
                 "zv_resblock1_bf16": [_P] * 4 + [_I] * 8 + [_P],
                 "zv_resblock1_bf16_tile": [_I] * 8},
    "upsample_stage": {"zv_upsample_stage_f32": [_P] * 8 + [_I] * 16 + [_P],
                       "zv_upsample_stage_tile": [_I] * 16,
                       "zv_upsample_stage_bf16": [_P] * 9 + [_I] * 16 + [_P]},
    "se_conv": {"zv_se_conv_fwd_tiles": [_I] * 3, "zv_se_conv_bwd_blocks": [_I] * 3,
                "zv_se_conv_fwd_f32": [_P] * 9 + [_I] * 4 + [_P],
                "zv_se_conv_bwd_f32": [_P] * 12 + [_I] * 4 + [_P],
                "zv_se_conv_bf16_blocks": [_I] * 4,
                "zv_se_conv_fwd_bf16": [_P] * 9 + [_I] * 4 + [_P],
                "zv_se_conv_bwd_bf16": [_P] * 12 + [_I] * 4 + [_P]},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Compile every kernel library that is missing, all nvcc processes in
    parallel. Returns {"seconds": wall time, "ptxas": {name: nvcc's -Xptxas -v
    lines}} for the libraries built by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in SIGNATURES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = Path(tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")[1])
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    ptxas = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        # ptxas's report: entry functions, registers, and the spill line of each
        ptxas[name] = [ln for ln in log.splitlines() if "ptxas" in ln or "spill" in ln]
    if errors:
        raise RuntimeError("\n".join(errors))
    return {"seconds": time.perf_counter() - t0, "ptxas": ptxas}


def ensure_built() -> dict:
    """Build the kernels once per process; returns build_all()'s report."""
    with _lock:
        if not build_info:
            build_info.update(build_all())
        return build_info


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building all kernels first if needed."""
    ensure_built()
    with _lock:
        if name not in _libs:
            so = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(so, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = so
        return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require_cuda(name: str, device, dtype, *tensors) -> None:
    """Raise unless every tensor is a contiguous `dtype` tensor on the CUDA
    device `device`."""
    for t in tensors:
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device (got {t.device})")
        if t.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes {dtype} here, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def float_kind(name: str, x) -> torch.dtype:
    """x's dtype when a kernel with float32 and bf16 variants takes it (K1,
    K2, K3); raises for any other."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {x.dtype}")
    return x.dtype

