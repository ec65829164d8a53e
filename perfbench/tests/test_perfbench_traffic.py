"""The traffic generators: deterministic per seed, the stated distributions,
and the same sizes for every seed."""

import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH / "traffic"), str(BENCH.parent)]

import textgen  # noqa: E402

SEEDS = (0, 7, 2**31 + 11, 3 * 2**40 + 5)


def serve_params():
    import json

    return json.loads((BENCH / "workloads" / "tts_medium.serve.over.json").read_text())["params"]


@pytest.mark.parametrize("seed", SEEDS)
def test_serve_requests_deterministic(seed):
    import open_loop_serve as kind

    p = serve_params()
    a = kind.make_requests(p, np.random.default_rng([seed, 1]), 10.0)
    b = kind.make_requests(p, np.random.default_rng([seed, 1]), 10.0)
    assert [(r.due, r.text, r.voice, r.stream) for r in a] == \
        [(r.due, r.text, r.voice, r.stream) for r in b]


def test_serve_requests_same_schedule_every_seed():
    """Every seed offers the same arrivals, sizes and streams; the seed
    draws the words and voices."""
    import open_loop_serve as kind

    p = serve_params()
    mixes = [kind.make_requests(p, np.random.default_rng([s, 1]), 30.0) for s in SEEDS]
    n = round(p["rate"] * 30.0)
    for reqs in mixes:
        assert len(reqs) == n
        assert sum(r.stream for r in reqs) == round(p["stream_share"] * n)
        assert [(r.due, r.stream) for r in reqs] == [(r.due, r.stream) for r in mixes[0]]
        # each text hits its size within a word
        assert all(abs(len(a.text) - len(b.text)) <= 30 for a, b in zip(reqs, mixes[0]))
    assert mixes[0][0].due == 0.0
    assert [r.text for r in mixes[0]] != [r.text for r in mixes[1]]
    gaps = np.diff([r.due for r in mixes[0]])
    every = textgen.exponential_gaps(n, 1.0 / p["rate"])
    assert max(np.min(np.abs(every - x)) for x in gaps) < 1e-9
    assert np.mean(gaps) == pytest.approx(1.0 / p["rate"], rel=0.1)


def test_lognormal_sizes():
    s = textgen.lognormal_sizes(2001, 90, 0.6, 15, 400)
    assert np.median(s) == 90
    assert s.min() >= 15 and s.max() <= 400
    assert list(s) == sorted(s)
    g = textgen.exponential_gaps(1000, 0.05)
    assert g.sum() == pytest.approx(50.0)
    # an exponential's quartiles: ln(4/3) and ln 4 of the mean
    q1, q3 = np.quantile(g, [0.25, 0.75])
    assert q1 / 0.05 == pytest.approx(np.log(4 / 3), rel=0.05)
    assert q3 / 0.05 == pytest.approx(np.log(4), rel=0.05)


@pytest.mark.parametrize("n", (15, 40, 90, 140, 400))
def test_sentences_lengths_and_frontend(n):
    from reference.text import Symbols, ZeroVoxNormalizer, text_ids

    rng = np.random.default_rng(n)
    sym, norm = Symbols("'-abcdefghijklmnopqrstuvwxyz", " ,.;:-!?\""), ZeroVoxNormalizer("en")
    for _ in range(20):
        t = textgen.sentence(rng, n)
        assert n - 1 <= len(t) <= n + 30
        assert t[-1] in ".?!"
        phones, puncts = text_ids(t, sym, norm)
        assert len(phones) > 0 and len(phones) == len(puncts)


def test_batch_job_and_corpus_deterministic():
    import json

    import offline_batch
    import train_steps

    bp = json.loads((BENCH / "workloads" / "tts_medium_styledec.batch.json").read_text())["params"]
    a = offline_batch.make_job(bp, np.random.default_rng([5, 1]))
    b = offline_batch.make_job(bp, np.random.default_rng([5, 1]))
    assert a == b
    c = offline_batch.make_job(bp, np.random.default_rng([6, 1]))
    assert sorted(map(len, a[0])) != [] and a[0] != c[0]
    tp = dict(json.loads((BENCH / "workloads" / "tts_medium.train.json").read_text())["params"],
              corpus_items=48)
    x, y = train_steps.make_corpus(tp, 9), train_steps.make_corpus(tp, 9)
    assert all(np.array_equal(u, v) for u, v in zip(x["mel"], y["mel"]))
    z = train_steps.make_corpus(tp, 10)
    assert sorted(m.shape[0] for m in x["mel"]) == sorted(m.shape[0] for m in z["mel"])
    lo, hi = tp["mel_frames"]
    for d, m, ph in zip(x["duration"], x["mel"], x["phoneme"]):
        assert d.sum() == m.shape[0] and len(d) == len(ph) and d.min() >= 1
        assert lo <= m.shape[0] <= hi
    for key in ("pitch", "energy"):
        v = np.concatenate(x[key])
        assert v.min() >= 0.0 and v.max() <= 1.0 + 1e-6
