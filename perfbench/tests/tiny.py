"""A copy of the benchmark with tiny widths and short mixes, for CPU tests.

`tiny_root(dst)` copies BENCHMARK.json and perfbench/ into dst and
shrinks every configuration and cell there, so a test can drive whole
runs on the CPU (`harness.Run(..., device="cpu", root=dst)`).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_MODEL = {
    "emb_dim": 24, "punct_emb_dim": 8,
    "encoder": {"fs2_layer": 1, "fs2_head": 2, "fs2_dropout": 0.2, "vp_filter_size": 16,
                "vp_kernel_size": 3, "vp_dropout": 0.5, "ve_n_bins": 16},
    "resnet": {"layers": [1, 1, 1, 1], "num_filters": [32, 8, 8, 8], "encoder_type": "ASP"},
}
TINY_DECODER = {"n_layers": 1, "n_head": 2, "conv_filter_size": 32}
TINY_PARAMS = {
    "open_loop_serve": {"rate": 4.0, "warmup_seconds": 1.0, "drain_seconds": 60.0,
                        "text": {"median": 30, "sigma": 0.4, "min": 15, "max": 60},
                        "check_whole": 32, "check_streams": 8},
    "offline_batch": {"batch": 4, "job_texts": 16,
                      "text": {"median": 40, "sigma": 0.4, "min": 15, "max": 80}, "check_rows": 4},
    "train_steps": {"batch": 4, "corpus_items": 16, "mel_frames": [40, 120]},
}


def tiny_root(dst) -> Path:
    dst = Path(dst)
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (dst / "perfbench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        m = cfg["model"]
        m.update({k: v for k, v in TINY_MODEL.items() if k not in ("encoder", "resnet")})
        m["encoder"], m["resnet"] = TINY_MODEL["encoder"], TINY_MODEL["resnet"]
        m["decoder"].update(TINY_DECODER)
        cfg["vocoder"]["upsample_initial_channel"] = 64
        f.write_text(json.dumps(cfg))
    for f in (dst / "perfbench" / "workloads").glob("*.json"):
        w = json.loads(f.read_text())
        w["params"].update(TINY_PARAMS[w["traffic"]])
        f.write_text(json.dumps(w))
    return dst
