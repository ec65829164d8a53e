"""The port's corpus and checkpoint tools against the JAX package's CLIs (CPU).

On one small tone-speak corpus, preprocessed by the port: `stats` prints
what the JAX CLI prints; `dump_ckpt` lists the same names, shapes and
dtypes of a `.msgpack` and a torch `.ckpt`; `edit_meldec` adds a vocoder to
a `.msgpack` byte for byte as the JAX CLI does (the JAX `load_model` reads
the port-edited file and gets the JAX-edited weights), removes it back to
the original bytes, and edits a torch `.ckpt` as the JAX CLI does; and
`export_hifigan` on a tiny random model and vocoder writes the JAX CLI's
file list, original wavs equal, synthesized wavs within 1e-3 and `.h5`
feats within 1e-4 (the waveform and mel tolerances of the port's parity
tests).
"""

import json
import os
import shutil

import h5py
import jax  # noqa: F401  (JAX on the CPU, set by conftest)
import numpy as np
import pytest
import torch
import yaml

from zerovox_tpu.cli import dump_ckpt as jdump
from zerovox_tpu.cli import edit_meldec as jedit
from zerovox_tpu.cli import export_hifigan as jexport
from zerovox_tpu.cli import stats as jstats
from zerovox_tpu.synthesize import ZeroVoxTTS as JaxTTS
from zerovox_tpu.training import checkpointing as jckpt
from zerovox_tpu.utils.synthvoice import make_corpus

from zerovox_tpu_torch.cli import dump_ckpt as pdump
from zerovox_tpu_torch.cli import edit_meldec as pedit
from zerovox_tpu_torch.cli import export_hifigan as pexport
from zerovox_tpu_torch.cli import stats as pstats
from zerovox_tpu_torch.cli.preprocess import main as preprocess_main
from zerovox_tpu_torch.config import ZeroVoxConfig
from zerovox_tpu_torch.dsp.audio import load_wav
from zerovox_tpu_torch.models.hifigan import HifiGanConfig, MelDec
from zerovox_tpu_torch.synthesize import ZeroVoxTTS, random_init_
from zerovox_tpu_torch.training.checkpointing import save_native_checkpoint
from zerovox_tpu_torch.weights import to_jax_variables

WAV_TOL, MEL_TOL = 1e-3, 1e-4
MELDEC_CONF = {"resblock": "1", "upsample_rates": [8, 8, 2, 2],
               "upsample_kernel_sizes": [16, 16, 4, 4], "upsample_initial_channel": 32,
               "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3, 5]],
               "num_mels": 80, "sampling_rate": 22050}
MODELCFG = {
    "audio": {"sampling_rate": 22050, "fft_size": 1024, "hop_size": 256, "win_length": 1024,
              "num_mels": 80, "fmin": 0, "fmax": 8000},
    "model": {"max_txt_len": 64, "min_mel_len": 20, "max_mel_len": 512,
              "phones": "'-abcdefghijklmnopqrstuvwxyz", "puncts": " ,.;:-!?\"",
              "emb_dim": 32, "punct_emb_dim": 16,
              "encoder": {"fs2_layer": 1, "fs2_head": 2, "vp_filter_size": 8, "ve_n_bins": 8},
              "decoder": {"kind": "fastspeech2", "n_layers": 1, "n_head": 2,
                          "conv_filter_size": 32, "conv_kernel_size": [9, 1], "dropout": 0.2,
                          "scln": True},
              "resnet": {"layers": [1, 1, 1, 1], "num_filters": [8, 8, 8, 8],
                         "encoder_type": "ASP"}},
    "training": {"learning_rate": 1e-4},
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A tone-speak corpus preprocessed by the port, a model dir (random
    weights as checkpoints/0000.msgpack) and an upstream-layout vocoder dir
    (config.json + generator.ckpt). Sets ZEROVOX_PREPROCESSED_DATA_PATH for
    the module."""
    root = tmp_path_factory.mktemp("torch_tools")
    make_corpus(str(root / "corpus"), ["hello world synth", "export the corpus now",
                                       "three samples minimum"])
    pp_base = root / "pp"
    pp_base.mkdir()
    old = os.environ.get("ZEROVOX_PREPROCESSED_DATA_PATH")
    os.environ["ZEROVOX_PREPROCESSED_DATA_PATH"] = str(pp_base)
    modelcfg = json.loads(json.dumps(MODELCFG))
    corpus_cfg = {"dataset": "LJSpeech", "language": "en",
                  "path": {"corpus_path": str(root / "corpus"), "preprocessed_path": "expcorp"}}
    mc, cc = root / "modelcfg.yaml", root / "corpus.yaml"
    mc.write_text(yaml.dump(modelcfg))
    cc.write_text(yaml.dump(corpus_cfg))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    preprocess_main([str(mc), str(cc), "--aligner", "pseudo", "-m", "0.3", "-b", "2",
                     "--device", "cpu"])
    torch.set_num_threads(n)

    stats = json.loads((pp_base / "expcorp" / "stats.json").read_text())
    modelcfg["stats"] = {"pitch_min": stats["pitch"][0], "pitch_max": stats["pitch"][1],
                         "energy_min": stats["energy"][0], "energy_max": stats["energy"][1]}
    modelcfg["lang"] = ["en"]
    model_dir = root / "model"
    (model_dir / "checkpoints").mkdir(parents=True)
    (model_dir / "modelcfg.yaml").write_text(yaml.dump(modelcfg))
    cfg = ZeroVoxConfig.from_dict(modelcfg)
    engine = ZeroVoxTTS.from_random(cfg, HifiGanConfig.from_dict(MELDEC_CONF), seed=1,
                                    device="cpu")
    save_native_checkpoint(model_dir / "checkpoints" / "0000.msgpack",
                           to_jax_variables(engine.state_dicts()[0], cfg),
                           meta={"epoch": 0, "loss": 1.0})

    meldec_dir = root / "meldec"
    meldec_dir.mkdir()
    hcfg = HifiGanConfig.from_dict(MELDEC_CONF)
    md = MelDec(hcfg)
    random_init_(md, torch.Generator().manual_seed(7))
    gen = {k[len("generator."):]: v for k, v in md.state_dict().items()
           if k.startswith("generator.")}
    (meldec_dir / "config.json").write_text(json.dumps(MELDEC_CONF))
    torch.save({"generator": gen}, meldec_dir / "generator.ckpt")
    yield {"root": root, "cc": str(cc), "mc": str(mc), "model_dir": model_dir,
           "meldec_dir": meldec_dir, "hcfg": hcfg, "gen": gen}
    if old is None:
        os.environ.pop("ZEROVOX_PREPROCESSED_DATA_PATH", None)
    else:
        os.environ["ZEROVOX_PREPROCESSED_DATA_PATH"] = old


def _out(capsys, main, argv) -> str:
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def test_stats_prints_what_the_jax_cli_prints(env, capsys):
    argv = [env["mc"], env["cc"], str(env["root"] / "corpus.yaml")]
    want = _out(capsys, jstats.main, argv)
    got = _out(capsys, pstats.main, argv)
    assert got == want and "speakers=1" in got and "hours=0.00" in got
    [res] = pstats.run(MODELCFG, [("c", [yaml.safe_load(open(env["cc"]))])])
    assert res["speakers"] == 1 and 0 < res["hours"] * 3600 < 10


@pytest.mark.parametrize("kind", ["msgpack", "ckpt", "missing"])
def test_dump_ckpt_prints_what_the_jax_cli_prints(env, capsys, kind):
    path = {"msgpack": env["model_dir"] / "checkpoints" / "0000.msgpack",
            "ckpt": env["meldec_dir"] / "generator.ckpt",
            "missing": env["root"] / "nothing.ckpt"}[kind]
    want = _out(capsys, jdump.main, [str(path)])
    got = _out(capsys, pdump.main, [str(path)])
    assert got == want and len(got.splitlines()) >= 1


def _native_copy(env, name):
    path = env["root"] / name
    shutil.copy(env["model_dir"] / "checkpoints" / "0000.msgpack", path)
    return path


def test_edit_meldec_native_adds_as_jax_and_removes_to_the_original(env):
    orig = (env["model_dir"] / "checkpoints" / "0000.msgpack").read_bytes()
    pj, pp = _native_copy(env, "jax_edit.msgpack"), _native_copy(env, "port_edit.msgpack")
    jedit.main([str(pj), "--meldec", str(env["meldec_dir"])])
    pedit.main([str(pp), "--meldec", str(env["meldec_dir"])])
    assert pp.read_bytes() == pj.read_bytes() != orig
    assert "meldec" in jckpt.load_native_checkpoint(pp)
    pedit.main([str(pp)])
    assert pp.read_bytes() == orig
    jedit.main([str(pj)])
    assert pj.read_bytes() == orig


def test_jax_load_model_reads_the_port_edited_checkpoint(env):
    dirs = {}
    for who, main in (("jax", jedit.main), ("port", pedit.main)):
        d = env["root"] / f"edited_{who}"
        (d / "checkpoints").mkdir(parents=True)
        shutil.copy(env["model_dir"] / "modelcfg.yaml", d / "modelcfg.yaml")
        ckpt = d / "checkpoints" / "0000.msgpack"
        shutil.copy(env["model_dir"] / "checkpoints" / "0000.msgpack", ckpt)
        main([str(ckpt), "--meldec", str(env["meldec_dir"])])
        dirs[who] = d
    trees = {who: JaxTTS.load_model(str(d), str(env["meldec_dir"]))[1]._variables["meldec"]
             for who, d in dirs.items()}
    want = jax.tree_util.tree_leaves_with_path(trees["jax"])
    got = jax.tree_util.tree_leaves_with_path(trees["port"])
    assert [p for p, _ in got] == [p for p, _ in want] and len(want) > 10
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def test_edit_meldec_weight_normed_generator_close_to_jax(env):
    """An upstream generator in training form (weight_g, weight_v): both
    packages fold it; float32 folds may round apart by an ulp."""
    wn_dir = env["root"] / "meldec_wn"
    wn_dir.mkdir()
    shutil.copy(env["meldec_dir"] / "config.json", wn_dir / "config.json")
    gen = {}
    for k, v in env["gen"].items():
        if k.endswith(".weight") and v.dim() == 3:
            g = torch.sqrt((v ** 2).sum(dim=(1, 2), keepdim=True)) * 1.5
            gen[k + "_g"], gen[k + "_v"] = g, v * 0.75
        else:
            gen[k] = v
    torch.save({"generator": gen}, wn_dir / "generator.ckpt")
    pj, pp = _native_copy(env, "wn_jax.msgpack"), _native_copy(env, "wn_port.msgpack")
    jedit.main([str(pj), "--meldec", str(wn_dir)])
    pedit.main([str(pp), "--meldec", str(wn_dir)])
    want = jax.tree_util.tree_leaves(jckpt.load_native_checkpoint(pj)["meldec"])
    got = jax.tree_util.tree_leaves(jckpt.load_native_checkpoint(pp)["meldec"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_edit_meldec_torch_ckpt_as_jax(env):
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3), "_meldec.old": torch.zeros(1)}
    paths = {}
    for who, main in (("jax", jedit.main), ("port", pedit.main)):
        p = env["root"] / f"{who}.ckpt"
        torch.save({"state_dict": dict(sd), "epoch": 3}, p)
        main([str(p), "--meldec", str(env["meldec_dir"])])
        paths[who] = p
    want = torch.load(paths["jax"], weights_only=False)
    got = torch.load(paths["port"], weights_only=False)
    assert got.keys() == want.keys() and got["state_dict"].keys() == want["state_dict"].keys()
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    pedit.main([str(paths["port"])])
    left = torch.load(paths["port"], weights_only=False)["state_dict"]
    assert list(left) == ["a.weight"]


def test_edit_meldec_hub_name_reads_the_cache_only(env, monkeypatch, tmp_path):
    import urllib.request

    def no_network(*args, **kwargs):
        raise AssertionError("edit_meldec tried the network")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    monkeypatch.setenv("CACHED_PATH_ZEROVOX", str(tmp_path / "cache"))
    ckpt = _native_copy(env, "hub_edit.msgpack")
    with pytest.raises(FileNotFoundError, match="hub cache"):
        pedit.main([str(ckpt), "--meldec", "some-vocoder"])
    cached = tmp_path / "cache" / "model_repo" / "some-vocoder"
    shutil.copytree(env["meldec_dir"], cached)
    pedit.main([str(ckpt), "--meldec", "some-vocoder"])
    ref = _native_copy(env, "dir_edit.msgpack")
    pedit.main([str(ref), "--meldec", str(env["meldec_dir"])])
    assert ckpt.read_bytes() == ref.read_bytes()


@pytest.fixture(scope="module")
def exported(env):
    """Both CLIs' exports of the corpus (batch 2: one wrap-padded tail)."""
    outs = {}
    for who, main, extra in (("jax", jexport.main, []),
                             ("port", pexport.main, ["--device", "cpu"])):
        out = env["root"] / f"export_{who}"
        main([env["cc"], "--out-dir", str(out), "--model", str(env["model_dir"]),
              "--meldec-model", str(env["meldec_dir"]), "--batch-size", "2",
              "--num_workers", "0"] + extra)
        outs[who] = out
    return outs


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_export_writes_the_jax_file_list(exported):
    files = _files(exported["port"])
    assert files == _files(exported["jax"])
    assert len([f for f in files if f.endswith(".h5")]) == 3  # every item, the pad one skipped


def test_export_wavs_and_text_match_jax(exported):
    for f in _files(exported["jax"]):
        got_p, want_p = exported["port"] / f, exported["jax"] / f
        if f.endswith("-synth.wav"):
            got, want = load_wav(got_p)[0], load_wav(want_p)[0]
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=WAV_TOL)
        elif f.endswith((".wav", ".txt")):
            assert got_p.read_bytes() == want_p.read_bytes(), f


def test_export_h5_matches_jax(exported):
    for f in _files(exported["jax"]):
        if not f.endswith(".h5"):
            continue
        with h5py.File(exported["port"] / f) as got, h5py.File(exported["jax"] / f) as want:
            assert got["feats"].shape == want["feats"].shape
            np.testing.assert_allclose(got["feats"][:], want["feats"][:], rtol=0, atol=MEL_TOL)
            np.testing.assert_array_equal(got["wave"][:], want["wave"][:])
            assert got["feats"].shape[0] * 256 == got["wave"].shape[0]


def test_export_items_yield_without_writing(env):
    """The yaml-free step the card runs: items from the parsed configs and
    an engine, nothing written."""
    modelcfg = yaml.safe_load((env["model_dir"] / "modelcfg.yaml").read_text())
    engine = ZeroVoxTTS.from_checkpoint(ZeroVoxConfig.from_dict(modelcfg),
                                        env["model_dir"] / "checkpoints" / "0000.msgpack",
                                        env["meldec_dir"], device="cpu")
    before = _files(env["root"])
    items = list(pexport.export_items([yaml.safe_load(open(env["cc"]))], modelcfg, engine,
                                      batch_size=2, num_workers=1))
    assert _files(env["root"]) == before
    assert len(items) == 3 and {it.split for it in items} == {"train"}
    for it in items:
        assert it.mel.shape[0] * 256 == len(it.orig_wav) == len(it.synth_wav)
        assert np.isfinite(it.synth_wav).all() and it.text


def test_export_items_orig_gives_the_preprocessed_mels(env):
    """--orig exports the ground-truth mels: the preprocessed .npy rows."""
    modelcfg = yaml.safe_load((env["model_dir"] / "modelcfg.yaml").read_text())
    engine = ZeroVoxTTS.from_checkpoint(ZeroVoxConfig.from_dict(modelcfg),
                                        env["model_dir"] / "checkpoints" / "0000.msgpack",
                                        env["meldec_dir"], device="cpu")
    items = list(pexport.export_items([yaml.safe_load(open(env["cc"]))], modelcfg, engine,
                                      batch_size=2, num_workers=1, orig=True))
    pp = env["root"] / "pp" / "expcorp"
    assert len(items) == 3
    for it in items:
        np.testing.assert_array_equal(it.mel, np.load(pp / "mel" / f"mel-{it.basename}.npy"))
        assert np.isfinite(it.synth_wav).all()
