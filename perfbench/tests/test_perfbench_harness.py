"""The harness on the CPU at tiny widths: whole runs of each kind, the
result line, the import rule, cells found by name, and the check coming
out false when the timed path is broken underneath. Card-only cases are
marked `gpu` and skip here."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path[:0] = [str(BENCH), str(BENCH / "tests"), str(REPO)]

import harness  # noqa: E402
from tiny import tiny_root  # noqa: E402

SEED = 2**31 + 977


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def drive(root, cell, seconds=2.0, seed=SEED):
    run = harness.Run(cell, seed, seconds, False, device="cpu", root=root)
    run.traffic().run(run)
    return run, run.result()


CELLS = ("tts_medium.serve.over", "tts_medium_styledec.batch", "tts_medium.train")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_with_its_metrics(root, cell):
    run, out = drive(root, cell)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"], name
    assert harness.forbidden_modules() == []


def _alter_rows(monkeypatch, how):
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS

    orig = ZeroVoxTTS.tts_batch

    def broken(self, texts, spkembs, durations=None):
        if how == "half":  # half of the batch left out: the rest's answers handed back
            h = max(1, len(texts) // 2)
            out = orig(self, texts[:h], spkembs[:h], durations)
            return [out[i % h] for i in range(len(texts))]
        out = orig(self, texts, spkembs, durations)
        for w, _ in out:  # an answer altered where it is produced
            w[len(w) // 2] += 0.25
        return out

    monkeypatch.setattr(ZeroVoxTTS, "tts_batch", broken)
    orig_stream = ZeroVoxTTS.tts_stream

    def broken_stream(self, *a, **k):
        for i, c in enumerate(orig_stream(self, *a, **k)):
            yield c + 0.25 if i == 0 and how == "alter" else c

    monkeypatch.setattr(ZeroVoxTTS, "tts_stream", broken_stream)


@pytest.mark.parametrize("cell", CELLS[:2])
@pytest.mark.parametrize("how", ("alter", "half"))
def test_broken_synthesis_is_not_correct(root, monkeypatch, cell, how):
    _alter_rows(monkeypatch, how)
    _, out = drive(root, cell, seconds=3.0)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("how", ("unchanged", "half"))
def test_broken_training_is_not_correct(root, monkeypatch, how):
    from zerovox_tpu_torch.training.optim import AdamW
    from zerovox_tpu_torch.training.trainer import Trainer

    if how == "unchanged":  # a step that returns its state unchanged
        monkeypatch.setattr(AdamW, "step", lambda self, lr: None)
    else:  # half of the batch left out, the mean taken over the rest
        orig = Trainer.train_step

        def half(self, state, batch):
            h = batch["phoneme"].shape[0] // 2
            return orig(self, state, {k: v[:h] for k, v in batch.items()})

        monkeypatch.setattr(Trainer, "train_step", half)
    _, out = drive(root, "tts_medium.train")
    assert out["correct"] is False, out["checks"]


def test_extra_cell_found_by_name(root, tmp_path):
    """A cell added as a data file (and its BENCHMARK.json entry) runs
    with no code file edited."""
    import shutil

    new = tmp_path / "copy"
    shutil.copytree(root, new)
    w = json.loads((new / "perfbench" / "workloads" / "tts_medium_styledec.batch.json").read_text())
    w["config"] = "tts_medium"
    w["params"]["batch"] = 2
    (new / "perfbench" / "workloads" / "tts_medium.batch2.json").write_text(json.dumps(w))
    b = json.loads((new / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "tts_medium.batch2", "config": "tts_medium",
                           "traffic": "offline_batch", "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if m["name"] == "audio_rate":
            m["workloads"].append("tts_medium.batch2")
    (new / "BENCHMARK.json").write_text(json.dumps(b))
    _, out = drive(new, "tts_medium.batch2")
    assert set(out["metrics"]) == {"audio_rate", "setup_s"} and out["correct"] is True


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "tts_medium.serve.over",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=REPO, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        bad = _imports(f) & {"jax", "jaxlib", "flax", "zerovox_tpu", "zerovox_tpu_torch"}
        assert not bad, (f, bad)


def test_no_jax_loaded_by_a_run():
    """A whole tiny run in a fresh process loads neither jax nor the JAX
    package (top-level names compared whole: zerovox_tpu_torch is the port)."""
    code = (
        "import sys, json, tempfile\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(BENCH / 'tests')!r}, {str(REPO)!r}]\n"
        "import harness, tiny\n"
        "root = tiny.tiny_root(tempfile.mkdtemp())\n"
        f"run = harness.Run('tts_medium_styledec.batch', {SEED}, 1.0, False, device='cpu', root=root)\n"
        "run.traffic().run(run)\n"
        "print(json.dumps({'bad': harness.forbidden_modules(),"
        " 'port': 'zerovox_tpu_torch' in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last == {"bad": [], "port": True}


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "zerovox_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "zerovox_tpu.ops", object())
    assert harness.forbidden_modules() == ["zerovox_tpu.ops"]


def test_quantile():
    assert harness.quantile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 0.95) == 10
    assert harness.quantile(list(range(1, 101)), 0.95) == 95
    assert harness.quantile([1.0, float("inf")], 0.5) == 1.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cuda, cell, monkeypatch):
    """The reference in TF32 in the program's place fails the check, on
    three seeds, at tiny widths."""
    import control

    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH_DIR", root / "perfbench")
    for seed in (1, 2, 3):
        run = harness.Run(cell, seed, 3.0, False, root=root)
        {"open_loop_serve": control.serve, "offline_batch": control.batch,
         "train_steps": control.train}[run.workload["traffic"]](run, 3.0)
        assert not all(v <= lim for _, v, lim in run.checks), run.checks
