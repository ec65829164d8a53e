"""The benchmark of zerovox_tpu_torch (the PyTorch/CUDA port) on NVIDIA GPUs.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json (perfbench/workloads/<cell>.json) for
`--seconds` of measured window and prints, as its last line of standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics),
`device` and, traced, `breakdown`, then `checks`: each number compared with
the reference beside its limit (also the last lines of standard error).
It exits non-zero, printing no result, without a CUDA device, with fewer
devices than the cell asks for, or when jax, flax or the JAX package were
loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

STARTED = time.time()

# the benchmark's modules, and the checkout's root where the program lives
sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # set-up runs from the process's start (interpreter start-up included)
    started = min(STARTED, time.time() - harness.process_age_s())
    harness.set_cache_env()

    import torch

    run = harness.Run(args.workload, args.seed, args.seconds, bool(args.trace),
                      started=started)
    chips = int(run.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run.traffic().run(run)
    bad = harness.forbidden_modules()
    if bad:
        print(f"error: modules of jax, flax or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    out = run.result()
    for name, v, lim in run.checks:
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
