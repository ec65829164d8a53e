"""The port's corpus preprocessing against the JAX package's (CPU).

Both packages' `cli.preprocess` run on the `lj_corpus` fixture's recipe
with `--aligner pseudo` and on a 2-utterance tone-speak corpus with
`--aligner tone`, into their own directories; the files must agree:
train.txt, the label files, durations and startstop equal; pitch equal (a
numpy copy on the same wav); mel within 1e-4 absolute, energy and
stats.json's energy within 1e-5 relative (the port's preprocessing STFT
runs in float64, so the gap is the JAX package's own float32 rounding:
~8e-5 at quiet mel bins, where the log amplifies it). Then the parts: the
tone CTC emissions (1e-4 of the flax net), the three Viterbi versions
against `forced_align_jax` and each other, the cluster aligner and units
(1e-5), the audio, pitch and synthvoice copies (1e-6 or bitwise), and
`get_mel_from_wav` through the JAX package's length buckets.
"""

import json
import os

import jax  # noqa: F401  (JAX on the CPU, set by conftest)
import numpy as np
import pytest
import torch
import yaml
from test_preprocess import lj_corpus  # noqa: F401 (a module fixture)

from zerovox_tpu.cli import preprocess as jcli
from zerovox_tpu.dsp import audio as jaudio
from zerovox_tpu.dsp import pitch as jpitch
from zerovox_tpu.dsp.mels import get_mel_from_wav as jax_mel
from zerovox_tpu.preprocess import aligner as jal
from zerovox_tpu.preprocess import ctc_align as jctc
from zerovox_tpu.preprocess import tone_ctc as jtone
from zerovox_tpu.preprocess import units as junits
from zerovox_tpu.utils import synthvoice as jsv

from zerovox_tpu_torch.cli import preprocess as pcli
from zerovox_tpu_torch.dsp import audio as paudio
from zerovox_tpu_torch.dsp import pitch as ppitch
from zerovox_tpu_torch.dsp.mels import get_mel_from_wav as port_mel
from zerovox_tpu_torch.preprocess import aligner as pal
from zerovox_tpu_torch.preprocess import ctc_align as pctc
from zerovox_tpu_torch.preprocess import tone_ctc as ptone
from zerovox_tpu_torch.preprocess import units as punits
from zerovox_tpu_torch.symbols import Symbols
from zerovox_tpu_torch.training.data import SpeechDataModule
from zerovox_tpu_torch.utils import synthvoice as psv
from zerovox_tpu_torch.weights import tone_ctc_from_flax, tone_ctc_to_flax

MEL_ATOL = 1e-4
ENERGY_RTOL = 1e-5
TONE_TEXTS = ["abacus ring around the maypole", "wizard of oz meets the jumpy vixen"]
AUDIO = {"sampling_rate": 22050, "fft_size": 1024, "hop_size": 256, "win_length": 1024,
         "num_mels": 80, "fmin": 0, "fmax": 8000}
PHONES, PUNCTS = "'-abcdefghijklmnopqrstuvwxyz", " ,.;:-!?\""
# per corpus: (aligner, min alignment score, batch, min_mel_len), as the JAX tests run them
RUNS = {"pseudo": ("pseudo", "0.3", "2", 50), "tone": ("tone", "0.5", "2", 20)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _modelcfg(min_mel_len: int) -> dict:
    return {"audio": dict(AUDIO),
            "model": {"max_txt_len": 512, "min_mel_len": min_mel_len, "max_mel_len": 1750,
                      "phones": PHONES, "puncts": PUNCTS}}


@pytest.fixture(scope="module")
def pp(lj_corpus, tmp_path_factory):  # noqa: F811
    """{kind: (JAX output dir, port output dir, corpus config)} after both
    packages' CLI mains ran each corpus (the port with --device cpu)."""
    root = tmp_path_factory.mktemp("torch_pp")
    jsv.make_corpus(str(root / "tones"), TONE_TEXTS, sample_rate=22050)
    corpus_paths = {"pseudo": lj_corpus, "tone": str(root / "tones")}
    old = os.environ.get("ZEROVOX_PREPROCESSED_DATA_PATH")
    out = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for kind, (aligner, min_score, batch, min_mel) in RUNS.items():
            cc = {"dataset": "LJSpeech", "language": "en",
                  "path": {"corpus_path": corpus_paths[kind], "preprocessed_path": kind}}
            mc_path, cc_path = root / f"{kind}_model.yaml", root / f"{kind}_corpus.yaml"
            mc_path.write_text(yaml.dump(_modelcfg(min_mel)))
            cc_path.write_text(yaml.dump(cc))
            argv = [str(mc_path), str(cc_path), "--aligner", aligner, "-m", min_score, "-b", batch]
            dirs = []
            for pkg, main, extra in (("jax", jcli.main, []),
                                     ("port", pcli.main, ["--device", "cpu"])):
                base = root / pkg
                base.mkdir(exist_ok=True)
                os.environ["ZEROVOX_PREPROCESSED_DATA_PATH"] = str(base)
                main(argv + extra)
                dirs.append(base / kind)
            out[kind] = (*dirs, cc)
    finally:
        torch.set_num_threads(n)
        if old is None:
            os.environ.pop("ZEROVOX_PREPROCESSED_DATA_PATH", None)
        else:
            os.environ["ZEROVOX_PREPROCESSED_DATA_PATH"] = old
    return out


def _bases(d):
    with open(d / "train.txt") as f:
        return [os.path.splitext(line.split("|")[0])[0] for line in f.read().splitlines() if line]


@pytest.mark.parametrize("kind", list(RUNS))
def test_train_txt_and_labels_equal(pp, kind):
    jdir, pdir, _ = pp[kind]
    assert (pdir / "train.txt").read_text() == (jdir / "train.txt").read_text()
    bases = _bases(jdir)
    assert len(bases) >= 2
    for b in bases:
        assert (pdir / "wavs" / f"{b}.wav.txt").read_text() == \
            (jdir / "wavs" / f"{b}.wav.txt").read_text()
    assert sorted(os.listdir(pdir / "wavs")) == sorted(os.listdir(jdir / "wavs"))


@pytest.mark.parametrize("kind", list(RUNS))
def test_durations_and_startstop_equal(pp, kind):
    jdir, pdir, _ = pp[kind]
    for b in _bases(jdir):
        np.testing.assert_array_equal(np.load(pdir / "duration" / f"duration-{b}.npy"),
                                      np.load(jdir / "duration" / f"duration-{b}.npy"))
        assert json.loads((pdir / "mel" / f"startstop-{b}.json").read_text()) == \
            json.loads((jdir / "mel" / f"startstop-{b}.json").read_text())


@pytest.mark.parametrize("kind", list(RUNS))
def test_pitch_equal_and_resampled_wavs_equal(pp, kind):
    jdir, pdir, _ = pp[kind]
    for b in _bases(jdir):
        np.testing.assert_array_equal(np.load(pdir / "pitch" / f"pitch-{b}.npy"),
                                      np.load(jdir / "pitch" / f"pitch-{b}.npy"))
        assert (pdir / "wavs" / f"{b}.wav").read_bytes() == (jdir / "wavs" / f"{b}.wav").read_bytes()


@pytest.mark.parametrize("kind", list(RUNS))
def test_mel_and_energy_close(pp, kind):
    jdir, pdir, _ = pp[kind]
    for b in _bases(jdir):
        mel, want = np.load(pdir / "mel" / f"mel-{b}.npy"), np.load(jdir / "mel" / f"mel-{b}.npy")
        assert mel.shape == want.shape and mel.dtype == want.dtype == np.float32
        np.testing.assert_allclose(mel, want, rtol=0, atol=MEL_ATOL)
        en, want = (np.load(d / "energy" / f"energy-{b}.npy") for d in (pdir, jdir))
        np.testing.assert_allclose(en, want, rtol=ENERGY_RTOL, atol=0)


@pytest.mark.parametrize("kind", list(RUNS))
def test_stats_json_close(pp, kind):
    jdir, pdir, _ = pp[kind]
    got, want = (json.loads((d / "stats.json").read_text()) for d in (pdir, jdir))
    assert got["pitch"] == want["pitch"]
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=ENERGY_RTOL, atol=0)


@pytest.mark.parametrize("kind", list(RUNS))
def test_datamodule_reads_the_port_output(pp, kind):
    _, pdir, cc = pp[kind]
    s = json.loads((pdir / "stats.json").read_text())
    dm = SpeechDataModule([cc], Symbols(PHONES, PUNCTS),
                          stats={"pitch_min": s["pitch"][0], "pitch_max": s["pitch"][1],
                                 "energy_min": s["energy"][0], "energy_max": s["energy"][1]},
                          batch_size=2, num_workers=1, base_path=str(pdir.parent), ref_mel_len=64)
    dm.prepare_data()
    assert len(dm.train_dataset) == len(_bases(pdir)) >= 2
    x, y = next(iter(dm.train_dataloader()))
    assert x["phoneme"].shape[0] == 2
    assert np.isfinite(y["mel"]).all() and np.isfinite(x["pitch"]).all()


def test_tone_durations_are_phonetic(pp):
    """The port's tone-aligned durations track the synthesizer's (the bound
    of tests/test_aligner.py's JAX check)."""
    _, pdir, _ = pp["tone"]
    lines = [ln for ln in (pdir / "train.txt").read_text().splitlines() if ln]
    assert len(lines) == len(TONE_TEXTS)
    errors = []
    for line in lines:
        wavfn, phones, _, _ = line.split("|")
        dur = np.load(pdir / "duration" / f"duration-{os.path.splitext(wavfn)[0]}.npy")
        chars = [PHONES[int(i)] for i in phones.split(",")]
        for c, d in zip(chars[1:-1], dur[1:-1]):
            errors.append(abs(float(d) - psv.char_duration(c) * 22050 / 256))
    assert float(np.mean(errors)) <= 3.0


# ------------------------------------------------------------------- aligners


@pytest.fixture(scope="module")
def tone_batch():
    """Two tone-speak wavs at 16 kHz, the shorter zero-padded (a batch)."""
    wavs = [psv.render_text(t, 16000, seed=5 + i) for i, t in enumerate(("hello world", "abc"))]
    n = max(len(w) for w in wavs)
    return np.stack([np.pad(w, (0, n - len(w))) for w in wavs])


def test_tone_ctc_emissions_match_the_flax_net(tone_batch):
    want = jtone.ToneCTCAligner().emissions(tone_batch)
    got = ptone.ToneCTCAligner(device="cpu").emissions(tone_batch)
    assert got.shape == want.shape == (2, tone_batch.shape[1] // 320, 28)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_tone_ctc_weights_are_the_bundled_ones():
    with open(ptone.WEIGHTS_FILE, "rb") as f, open(jtone.WEIGHTS_FILE, "rb") as g:
        assert f.read() == g.read()
    params = ptone.load_params()
    sd = tone_ctc_from_flax(params)
    assert sd.keys() == ptone.ToneCTCNet().state_dict().keys()
    back = tone_ctc_to_flax(sd)
    for mod, leaves in jtone.load_params().items():
        for name, arr in leaves.items():
            np.testing.assert_array_equal(back[mod][name], arr)


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_forced_align_torch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    T, C = int(rng.integers(30, 90)), 7
    logits = rng.normal(size=(T, C))
    em = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    targets = rng.integers(1, C, size=int(rng.integers(2, T // 4)))
    a_jx, s_jx = jctc.forced_align_jax(em, targets)
    a_pt, s_pt = pctc.forced_align_torch(torch.from_numpy(em), targets)
    np.testing.assert_array_equal(a_pt.numpy(), np.asarray(a_jx))
    np.testing.assert_allclose(s_pt.numpy(), np.asarray(s_jx), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_native_equals_plain_and_the_jax_native(seed):
    rng = np.random.default_rng(seed)
    T, C = int(rng.integers(30, 120)), 8
    logits = rng.normal(size=(T, C))
    em = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    targets = rng.integers(1, C, size=int(rng.integers(1, T // 4)))
    a_nat, s_nat = pctc.forced_align(em, targets)
    a_np, s_np = pctc.forced_align_plain(em, targets)
    np.testing.assert_array_equal(a_nat, a_np)
    np.testing.assert_allclose(s_nat, s_np, atol=1e-5)
    a_j, s_j = jctc.forced_align(em, targets)
    np.testing.assert_array_equal(a_nat, a_j)
    np.testing.assert_array_equal(s_nat, s_j)
    spans = pctc.merge_tokens(a_nat, s_nat)
    assert [s.token for s in spans] == list(targets)


def test_forced_align_edges():
    with pytest.raises(ValueError, match="too long"):
        pctc.forced_align(np.zeros((2, 4)), np.array([1, 2, 3]))
    with pytest.raises(ValueError, match="too long"):
        pctc.forced_align_plain(np.zeros((2, 4)), np.array([1, 2, 3]))
    a, _ = pctc.forced_align(np.log(np.full((3, 3), 1 / 3)), np.array([], np.int64))
    np.testing.assert_array_equal(a, [0, 0, 0])
    a_t, _ = pctc.forced_align_torch(torch.log(torch.full((3, 3), 1 / 3)), np.array([], np.int64))
    np.testing.assert_array_equal(a_t.numpy(), [0, 0, 0])


def test_native_build_names_the_library_by_its_source():
    from zerovox_tpu_torch import native

    path = native.lib_path("ctc_align")
    assert path.parent == native.BUILD_DIR and path.name.startswith("libctc_align-")
    assert native.build("ctc_align") == path and path.exists()


@pytest.fixture(scope="module")
def unit_wavs():
    rng = np.random.default_rng(7)
    bank = [220.0, 440.0, 880.0, 1760.0]
    wavs = []
    for s in range(4):
        t = np.arange(int(0.25 * 16000)) / 16000
        segs = [0.4 * np.sin(2 * np.pi * bank[i] * t) for i in rng.integers(0, 4, size=5)]
        w = np.concatenate([np.zeros(4800)] + segs + [np.zeros(4800)]).astype(np.float32)
        wavs.append(w + 1e-4 * np.random.default_rng(s).normal(size=w.shape).astype(np.float32))
    return wavs


def test_units_and_cluster_aligner_match_jax(unit_wavs, tmp_path):
    feats = [punits.unit_features(w) for w in unit_wavs]
    for (m, r), w in zip(feats, unit_wavs):
        jm, jr = junits.unit_features(w)
        np.testing.assert_allclose(m, jm, rtol=0, atol=1e-5)
        np.testing.assert_allclose(r, jr, rtol=0, atol=1e-5)
    cents = punits.fit_units([f[0] for f in feats], k=6, seed=0, iters=8)
    np.testing.assert_allclose(cents, junits.fit_units([f[0] for f in feats], k=6, seed=0,
                                                       iters=8), rtol=0, atol=1e-5)
    assert punits.transcribe(unit_wavs[0], cents) == junits.transcribe(unit_wavs[0], cents)
    path = str(tmp_path / "units.npz")
    punits.save_units(path, cents)
    batch = np.stack(unit_wavs[:2])
    got = pal.make_aligner(f"cluster:{path}").emissions(batch)
    want = jal.make_aligner(f"cluster:{path}").emissions(batch)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    pal_pseudo, jal_pseudo = pal.make_aligner("pseudo"), jal.make_aligner("pseudo")
    for a in (pal_pseudo, jal_pseudo):
        a.set_transcripts(["ab cd", "efg"])
    np.testing.assert_allclose(pal_pseudo.emissions(batch), jal_pseudo.emissions(batch),
                               rtol=0, atol=1e-6)


def test_make_aligner_never_falls_back(tmp_path):
    with pytest.raises(ValueError, match="no alignment model"):
        pal.make_aligner(None)
    with pytest.raises(RuntimeError, match="Refusing to fall back"):
        pal.make_aligner(str(tmp_path / "does_not_exist"), device="cpu")
    assert isinstance(pal.make_aligner("pseudo"), pal.EnergyPseudoAligner)
    assert isinstance(pal.make_aligner("tone", device="cpu"), ptone.ToneCTCAligner)


# ------------------------------------------------------- audio, pitch, mels


def test_audio_helpers_match_jax():
    rng = np.random.default_rng(1)
    x = (np.sin(np.arange(40000) * 0.03) * 0.3 + rng.normal(size=40000) * 0.05).astype(np.float32)
    x[:3000] *= 1e-3
    for sr in (16000, 22050, 48000):
        for a, b in zip(paudio._k_weighting_coeffs(sr), jaudio._k_weighting_coeffs(sr)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert abs(paudio.measure_lufs(x, sr) - jaudio.measure_lufs(x, sr)) <= 1e-6
    np.testing.assert_allclose(paudio.loudness_normalize(x, 22050),
                               jaudio.loudness_normalize(x, 22050), rtol=0, atol=1e-6)
    for th in (0.004, 0.2):
        assert paudio.first_and_last_hop_above_threshold(x, 256, th) == \
            jaudio.first_and_last_hop_above_threshold(x, 256, th)
    assert paudio.measure_lufs(np.zeros(100, np.float32), 22050) == float("-inf")


def test_pitch_and_synthvoice_copies_are_bitwise():
    wav, bounds = psv.render_text_with_boundaries("hello tone", 22050, seed=3)
    jwav, jbounds = jsv.render_text_with_boundaries("hello tone", 22050, seed=3)
    np.testing.assert_array_equal(wav, jwav)
    assert bounds == jbounds
    f0 = ppitch.estimate_f0(wav, 22050, 256)
    np.testing.assert_array_equal(f0, jpitch.estimate_f0(wav, 22050, 256))
    f0i = ppitch.interpolate_f0(f0)
    np.testing.assert_array_equal(f0i, jpitch.interpolate_f0(f0))
    durs = [5, 0, 17, 40, 900]
    np.testing.assert_array_equal(ppitch.phoneme_level_average(f0i, durs),
                                  jpitch.phoneme_level_average(f0i, durs))


@pytest.mark.parametrize("n", [9999, 40000])
def test_get_mel_from_wav_matches_the_jax_buckets(n):
    """The JAX package pads to a length bucket and slices back; the port
    computes the unpadded frames, which must be the same."""
    rng = np.random.default_rng(n)
    wav = (np.sin(np.arange(n) * 0.05) * 0.3 + rng.normal(size=n) * 0.05).astype(np.float32)
    mel, en = port_mel(wav, **AUDIO, device="cpu")
    mel_j, en_j = jax_mel(wav, **AUDIO)
    assert mel.shape == mel_j.shape and mel.dtype == np.float32
    np.testing.assert_allclose(mel, mel_j, rtol=0, atol=MEL_ATOL)
    np.testing.assert_allclose(en, en_j, rtol=ENERGY_RTOL, atol=0)
