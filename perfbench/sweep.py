"""The rate sweep that fixes a serving cell's rate.

    python3 perfbench/sweep.py --workload tts_medium.serve.over --rates 16 20 24 28 \
        --seconds 30 --seed 1

runs the cell's open loop at each rate, one run a rate in this process, the
window open until every request due in it was answered, and prints one
JSON line a rate: the share of the requests due up to a second before the
window's end that were answered by its end, the median latency of the
requests due in the window's last third over that of its first third (a
queue that grows reads above 1), the tails and the dispatch thread's busy
share. The knee is the highest rate whose share is at least 98 % and whose
queue does not grow. A cell below the knee runs at 0.8 x knee and is judged
on its tails; one above it closes its window on time and is judged on the
audio it completes (the workload's `window`).
Runs on the CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

import harness  # noqa: E402


def summary(run) -> dict:
    rows = run.values["arrivals"]
    T = run.seconds
    # requests due up to a second before the window's end, answered by its end
    due_in = [r for r in rows if r[0] < T - 1.0]
    answered = [r for r in due_in if not math.isnan(r[2]) and r[2] <= T]

    def med(lo, hi):
        lat = [(r[1] if r[3] else r[2]) - r[0] for r in rows if lo <= r[0] < hi]
        lat = [x for x in lat if not math.isnan(x)]
        return statistics.median(lat) if lat else math.inf

    return {"rate": run.params()["rate"], "answered_share": len(answered) / len(due_in),
            "growth": med(2 * T / 3, T) / med(0, T / 3),
            **{k: run.e2e[k] for k in ("request_p95_ms", "first_chunk_p95_ms")},
            "dispatch_busy": run.counters["synth_wall_s"] / run.window_s,
            "rows_a_batch": run.counters["requests"] / max(1, run.counters["batches"]),
            "correct": all(v <= lim for _, v, lim in run.checks)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="tts_medium.serve.over")
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    harness.set_cache_env()
    for rate in args.rates:
        run = harness.Run(args.workload, args.seed, args.seconds, False)
        run.workload["params"].update(rate=rate, window="answered")
        run.traffic().run(run)
        print(json.dumps({"sweep": args.workload, **summary(run)}), flush=True)
        harness.Run.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
