"""BENCHMARK.json against the benchmark's contract: keys, the characters of
names and units, bounds, and a file under perfbench/ for every
configuration, cell and per-layer metric it names."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


def test_run_seconds_fits_the_full_check():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    assert (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert one_line(c["source"]) and c["source"].startswith("https://")
        assert c["file"].startswith("perfbench/") and (REPO / c["file"]).is_file()
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    names = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        f = REPO / "perfbench" / "workloads" / f"{w['name']}.json"
        data = json.loads(f.read_text())
        assert data["config"] == w["config"] and data["chips"] == w["chips"]
        assert (REPO / "perfbench" / "traffic" / f"{data['traffic']}.py").is_file()
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_metric_names_units_keys():
    seen = set()
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in _metrics():
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])
        assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_reports_setup_another_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        layers = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layers
        for m in layers:  # each moves an end-to-end metric its cells report
            assert w["name"] in e2e[m["moves"]].get("workloads", [w["name"]])


@pytest.mark.parametrize("layer", sorted({m["layer"] for m in BENCH["per_layer"]}))
def test_layers_named_in_perf_md(layer):
    assert f"| {layer} |" in (REPO / "PERF.md").read_text()


def test_mfu_beside_rooflines():
    rooflines = [m for m in BENCH["per_layer"] if m["name"].split(".")[0].endswith("_roofline")]
    for r in rooflines:
        assert r["unit"] == "%"
        assert any("mfu" in m["name"] and m["moves"] == r["moves"]
                   and set(r["workloads"]) <= set(m["workloads"]) for m in BENCH["per_layer"])
