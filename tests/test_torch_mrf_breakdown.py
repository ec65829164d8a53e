"""scripts/bench_mrf_breakdown.py builds copies of the bf16 K1, K2 and K3's
sources with a part of the tile's GEMMs taken out, by text substitution:
each substitution of this tree's design (bf16x2) must match its file in
`zerovox_tpu_torch/csrc/` exactly once, so that a source that drifts fails
here and not on the card. Text only: no nvcc, no card."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "zerovox_tpu_torch" / "csrc"


def _script():
    spec = importlib.util.spec_from_file_location("bench_mrf_breakdown",
                                                  ROOT / "scripts" / "bench_mrf_breakdown.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = _script()
DESIGN = SCRIPT.DESIGNS["bf16x2"]
SUBS = [(name, f, old) for name, subs in DESIGN.items() for f, old, _ in subs]


def test_this_tree_is_the_bf16x2_design():
    assert SCRIPT.design_of(ROOT) == "bf16x2"
    assert {"kernel", "no_mma", "no_split", "no_bfetch"} <= set(DESIGN)


@pytest.mark.parametrize("name,fname,old", SUBS, ids=[f"{n}:{f}:{o[:24]}" for n, f, o in SUBS])
def test_substitution_occurs_once(name, fname, old):
    assert (CSRC / fname).read_text().count(old) == 1, f"{name}: {old!r}"


def test_every_variant_applies_and_changes_the_sources():
    src = {p.name: p.read_text() for p in CSRC.glob("*.cu*")}
    for name, subs in DESIGN.items():
        out = SCRIPT.variant_sources(CSRC, subs)
        changed = {f for f in src if out[f] != src[f]}
        assert changed == {f for f, _, _ in subs}, name
    # the split is taken out wherever it happens: conv1's A loads, conv1's
    # epilogue and K2's staging of its input
    assert {f for f, _, _ in DESIGN["no_split"]} == {"mrf_bf16.cuh", "upsample_stage.cu"}
    assert len(DESIGN["no_split"]) == 3


def test_k3_bf16_runs_on_the_substituted_tile():
    """K3's bf16 kernel is built and timed with K1 and K2 (at the
    single-tower vocoder's stage shapes), and runs on mrf_bf16.cuh's tile,
    so that the bf16x2 substitutions reach it: the MMAs, conv1's split at
    the load and conv2's split in conv1's epilogue, and both of its B
    sources (L2, and the staged copy)."""
    assert "resblock" in SCRIPT.SOURCES
    assert SCRIPT.K3_SHAPES == ((44096, 128), (88192, 64), (176384, 32))
    src = (CSRC / "resblock.cu").read_text()
    assert '#include "mrf_bf16.cuh"' in src
    assert "zv::bf16x2::mrf_tile<C, NW>(" in src and "zv::bf16x2::StagedWeights<NW>" in src
    fetches = [old for f, old, _ in DESIGN["no_bfetch"]]
    assert fetches == ["return __ldg(w + i);", "return s[i];"]
