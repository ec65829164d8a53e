"""scripts/bench_k4_breakdown.py builds copies of K4's source with phases
taken out (or the bf16 forward's design changed) by text substitution: each
substitution must match `csrc/se_conv.cu` exactly once, float32 and bf16, so
that a source that drifts fails here and not on the card. Text only: no
nvcc, no card."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _script():
    spec = importlib.util.spec_from_file_location("bench_k4_breakdown",
                                                  ROOT / "scripts" / "bench_k4_breakdown.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = _script()
SUBS = [(name, old) for name, subs in SCRIPT.VARIANTS.items() for old, _ in subs]


@pytest.mark.parametrize("name,old", SUBS, ids=[f"{n}:{o[:24]}" for n, o in SUBS])
def test_substitution_occurs_once(name, old):
    assert SCRIPT.SOURCE.read_text().count(old) == 1, f"{name}: {old!r}"


def test_every_variant_applies_and_changes_the_source():
    src = SCRIPT.SOURCE.read_text()
    for name, subs in SCRIPT.VARIANTS.items():
        out = SCRIPT.variant_source(src, subs)
        assert (out != src) == bool(subs), name
    # both precisions lose the same phases
    assert any("conv_row(U, Bs" in old for old, _ in SCRIPT.VARIANTS["no_conv_mma"])
    assert any("TH * 2" in old for old, _ in SCRIPT.VARIANTS["no_wgrad"])
    assert any("TH * 4" in old for old, _ in SCRIPT.VARIANTS["no_wgrad"])
