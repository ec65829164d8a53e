"""The kernel build cache (`utils/compile_cache.py`, `ops/_cuda.py`) on the
CPU, as tests/test_compile_cache.py holds the JAX package's: a miss, then a
hit, counted; the summary line in the JAX package's format; "0" and the
default directory.

There is no nvcc here, so a stub stands in for it on PATH: it builds, with
the C compiler, a library that exports every function `ops/_cuda.py` binds
(each returning 0), where nvcc would build the kernels.
"""

import json
import os
import stat
import sys
from pathlib import Path

import pytest

from zerovox_tpu.utils import compile_cache as jax_cc

from zerovox_tpu_torch.ops import _cuda
from zerovox_tpu_torch.utils import compile_cache as cc

STUB = """#!{python}
import subprocess, sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
print("ptxas info    : Compiling entry function 'stub' for 'sm_90a'")
sys.exit(subprocess.call(["cc", "-shared", "-fPIC", "-o", out, {c_file!r}]))
"""


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """nvcc on PATH as the stub; a fresh process state of `_cuda`."""
    c_file = tmp_path / "stub.c"
    c_file.write_text("".join(f"int {fn}(void) {{ return 0; }}\n"
                              for sigs in _cuda.SIGNATURES.values() for fn in sigs))
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(STUB.format(python=sys.executable, c_file=str(c_file)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_cuda, "build_info", {})
    monkeypatch.setattr(_cuda, "_libs", {})
    return tmp_path


def _delta(before: dict) -> dict:
    now = cc.cache_stats()
    return {k: now[k] - before[k] for k in now}


def test_cache_stats_count_miss_then_hit(stub_nvcc, monkeypatch):
    cache = stub_nvcc / "cache"
    monkeypatch.setenv("ZEROVOX_COMPILE_CACHE", str(cache))
    assert cc.enable_compile_cache() == str(cache)
    n = len(_cuda.SIGNATURES)

    before = cc.cache_stats()
    info = _cuda.ensure_built()
    miss = _delta(before)
    assert miss["requests"] == miss["misses"] == miss["backend_compiles"] == n
    assert miss["hits"] == 0 and miss["saved_sec"] == 0
    assert miss["backend_compile_sec"] > 0 and miss["retrieval_sec"] > 0
    assert sorted(info["ptxas"]) == sorted(_cuda.SIGNATURES)
    assert _cuda.lib("mrf").zv_mrf_tile(*[0] * 11) == 0  # the stub's export, bound
    sidecars = sorted(cache.glob("*.so.json"))
    assert len(sidecars) == n and len(list(cache.glob("*.so"))) == n
    built_sec = sum(json.loads(p.read_text())["seconds"] for p in sidecars)

    # a new process's state: every library found under its hash
    monkeypatch.setattr(_cuda, "build_info", {})
    monkeypatch.setattr(_cuda, "_libs", {})
    before = cc.cache_stats()
    info = _cuda.ensure_built()
    hit = _delta(before)
    assert hit["requests"] == hit["hits"] == n
    assert hit["misses"] == hit["backend_compiles"] == 0 and hit["backend_compile_sec"] == 0
    assert hit["saved_sec"] == pytest.approx(built_sec, rel=1e-12) and hit["saved_sec"] > 0
    assert hit["retrieval_sec"] > 0 and info["ptxas"] == {}

    line = cc.format_cache_stats()
    assert "hits" in line and "misses" in line and "cold compiles" in line


def test_format_is_the_jax_line(monkeypatch):
    stats = {"requests": 8, "hits": 4, "misses": 4, "saved_sec": 7.25, "retrieval_sec": 0.01,
             "backend_compile_sec": 6.5, "backend_compiles": 4}
    monkeypatch.setattr(cc, "_stats", dict(stats))
    monkeypatch.setattr(jax_cc, "_stats", dict(stats))
    assert cc.format_cache_stats() == jax_cc.format_cache_stats()
    assert cc.format_cache_stats() == ("compile cache: 4 hits / 4 misses (8 requests); "
                                       "saved 7.2s, cold compiles 4 (6.5s)")


def test_cache_disabled_returns_none_and_builds_in_a_temporary_dir(stub_nvcc, monkeypatch):
    monkeypatch.setenv("ZEROVOX_COMPILE_CACHE", "0")
    monkeypatch.setattr(cc, "_scratch", [])
    assert cc.enable_compile_cache() is None
    where = cc.build_dir()
    assert where.is_dir() and where == cc.build_dir()  # one directory a process
    assert cc.DEFAULT_DIR not in where.parents and where != cc.DEFAULT_DIR
    before = cc.cache_stats()
    _cuda.ensure_built()  # the kernels still build: there is no fallback
    assert _delta(before)["misses"] == len(_cuda.SIGNATURES)
    assert len(list(where.glob("*.so"))) == len(_cuda.SIGNATURES)


def test_default_dir_is_under_build(monkeypatch, tmp_path):
    monkeypatch.delenv("ZEROVOX_COMPILE_CACHE", raising=False)
    repo = Path(__file__).resolve().parent.parent
    assert cc.build_dir() == repo / "build" / "zerovox_tpu_torch"
    assert "build/" in (repo / ".gitignore").read_text().split()
    monkeypatch.setenv("ZEROVOX_COMPILE_CACHE", str(tmp_path / "moved"))
    assert cc.build_dir() == tmp_path / "moved"
    assert cc.enable_compile_cache() == str(tmp_path / "moved") and (tmp_path / "moved").is_dir()
