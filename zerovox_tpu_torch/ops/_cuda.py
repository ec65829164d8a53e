"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source compiles with nvcc into its own shared library with
a plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds). All sources build together, one nvcc process each, at the
first kernel launch of the process, and every library is loaded then;
libraries are named by a hash of the sources and the flags and reused while
they are unchanged, each with a `.json` beside it holding its nvcc's wall
seconds. They live in the kernel build cache, `build/zerovox_tpu_torch/`
beside the package unless `ZEROVOX_COMPILE_CACHE` says otherwise
(`utils/compile_cache.py`, which also counts the hits, misses and seconds).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from zerovox_tpu_torch.utils import compile_cache

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the exported functions (every one returns a cudaError_t)
SIGNATURES = {
    "mrf": {"zv_mrf_f32": [_P] * 4 + [_I] * 11 + [_P], "zv_mrf_tile": [_I] * 11,
            "zv_mrf_bf16": [_P] * 5 + [_I] * 11 + [_P], "zv_mrf_bf16_tile": [_I] * 11},
    "resblock": {"zv_resblock1_f32": [_P] * 4 + [_I] * 8 + [_P], "zv_resblock1_tile": [_I] * 8,
                 "zv_resblock1_bf16": [_P] * 4 + [_I] * 8 + [_P],
                 "zv_resblock1_bf16_tile": [_I] * 8},
    "upsample_stage": {"zv_upsample_stage_f32": [_P] * 8 + [_I] * 16 + [_P],
                       "zv_upsample_stage_tile": [_I] * 16,
                       "zv_upsample_stage_bf16": [_P] * 9 + [_I] * 16 + [_P],
                       "zv_upsample_stage_bf16_tile": [_I] * 16},
    "se_conv": {"zv_se_conv_fwd_tiles": [_I] * 3, "zv_se_conv_bwd_blocks": [_I] * 3,
                "zv_se_conv_fwd_f32": [_P] * 9 + [_I] * 4 + [_P],
                "zv_se_conv_bwd_f32": [_P] * 12 + [_I] * 4 + [_P],
                "zv_se_conv_bf16_blocks": [_I] * 4, "zv_se_conv_bf16_design": [_I] * 2,
                "zv_se_conv_fwd_bf16": [_P] * 9 + [_I] * 4 + [_P],
                "zv_se_conv_bwd_bf16": [_P] * 12 + [_I] * 4 + [_P]},
    "flash_attn": {"zv_flash_fwd_f32": [_P] * 6 + [_I] * 7 + [_F, _P],
                   "zv_flash_fwd_bf16": [_P] * 6 + [_I] * 7 + [_F, _P],
                   "zv_flash_dkv_f32": [_P] * 9 + [_I] * 7 + [_F, _P],
                   "zv_flash_dkv_bf16": [_P] * 9 + [_I] * 7 + [_F, _P],
                   "zv_flash_dq_f32": [_P] * 8 + [_I] * 7 + [_F, _P],
                   "zv_flash_dq_bf16": [_P] * 8 + [_I] * 7 + [_F, _P],
                   "zv_flash_fwd_tile": [_I] * 3},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    return found


def _lib_path(name: str, build_dir: Path) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"lib{name}-{h.hexdigest()[:12]}.so"


def _nvcc_run(cmd: list[str], done: dict, name: str) -> None:
    """One nvcc process to its end: (returncode, output, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    done[name] = (proc.returncode, proc.stdout, time.perf_counter() - t0)


def build_all() -> dict:
    """Compile every kernel library that is missing from the cache, all
    nvcc processes in parallel, and count each library a hit or a miss.
    Returns {"seconds": wall time, "ptxas": {name: nvcc's -Xptxas -v lines}}
    for the libraries built by this call."""
    build_dir = compile_cache.build_dir()
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    todo, threads, done = {}, [], {}
    for name in SIGNATURES:
        out = _lib_path(name, build_dir)
        if out.exists():
            meta = Path(str(out) + ".json")
            saved = json.loads(meta.read_text())["seconds"] if meta.exists() else 0.0
            compile_cache.record(requests=1, hits=1, saved_sec=saved)
            continue
        nvcc = _nvcc()  # raises before anything is started when there is none
        fd, tmp = tempfile.mkstemp(dir=build_dir, suffix=".so.tmp")
        os.close(fd)
        todo[name] = (Path(tmp), out)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        threads.append(threading.Thread(target=_nvcc_run, args=(cmd, done, name)))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ptxas, errors = {}, []
    for name, (tmp, out) in todo.items():
        rc, log, sec = done[name]
        compile_cache.record(requests=1, misses=1, backend_compiles=1, backend_compile_sec=sec)
        if rc != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        Path(str(out) + ".json").write_text(json.dumps({"seconds": sec}))
        os.replace(tmp, out)  # the library last: a library found has its .json
        # ptxas's report: entry functions, registers, and the spill line of each
        ptxas[name] = [ln for ln in log.splitlines() if "ptxas" in ln or "spill" in ln]
    if errors:
        raise RuntimeError("\n".join(errors))
    return {"seconds": time.perf_counter() - t0, "ptxas": ptxas}


def ptxas_kernels(lines: list[str]) -> dict:
    """{entry function (mangled): {"registers", "spill_stores", "spill_loads"}}
    from nvcc's -Xptxas -v lines of one library."""
    out, cur = {}, None
    for ln in lines:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def ensure_built() -> dict:
    """Build the kernels and load every library, once per process; returns
    build_all()'s report."""
    with _lock:
        if not build_info:
            info = build_all()
            build_dir = compile_cache.build_dir()
            t0 = time.perf_counter()
            for name, sigs in SIGNATURES.items():
                so = ctypes.CDLL(str(_lib_path(name, build_dir)))
                for fn, argtypes in sigs.items():
                    f = getattr(so, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                _libs[name] = so
            compile_cache.record(retrieval_sec=time.perf_counter() - t0)
            build_info.update(info)
        return build_info


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building all kernels first if needed."""
    ensure_built()
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

