"""Native checkpoints, the hub cache and `load_model` across packages.

* The port's msgpack codec against flax's: the same bytes for the same tree,
  and each reads the other's files exactly (leaf types and dtypes too).
* `to_jax_variables` / `meldec_to_jax_variables` invert
  `from_jax_variables` / `meldec_from_jax_variables` exactly.
* A model the port's `Trainer.fit` trains (CPU, tiny widths) is read by the
  JAX package's `load_native_checkpoint` and `load_model`; a JAX-written
  model directory is read by the port's `load_model`; each with a vocoder
  directory holding an upstream `generator.ckpt` or a native
  `generator.msgpack`. Every port engine is held to the JAX engine on the
  same files and forced durations: waveform atol 1e-3 (and 1e-3 of its
  peak), mel 1e-4, the port's stated bounds.
* `fit`'s checkpoint schedule and pruning equal the JAX trainer's; resuming
  from `save_train_state` gives the uninterrupted run's next step exactly.
* Hub names resolve from a pre-populated cache; a miss raises without the
  network (`urlretrieve` is replaced by a failing stub).
"""

import dataclasses
import json
import os
import shutil
import types
import urllib.request

import flax.serialization as fs
import jax
import numpy as np
import pytest
import torch
import yaml

import zerovox_tpu.config as jc
from zerovox_tpu.models.hifigan import HifiGanConfig as JaxHifiGanConfig, MelDec as JaxMelDec
from zerovox_tpu.synthesize import ZeroVoxTTS as JaxTTS
from zerovox_tpu.training import checkpointing as jckpt
from zerovox_tpu.training import trainer as jtrainer

import zerovox_tpu_torch.config as pc
from zerovox_tpu_torch import hub
from zerovox_tpu_torch.models.hifigan import HifiGanConfig, MelDec
from zerovox_tpu_torch.synthesize import ZeroVoxTTS, random_init_
from zerovox_tpu_torch.training import checkpointing as pckpt
from zerovox_tpu_torch.training.data import SpeechDataModule
from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig, device_batch
from zerovox_tpu_torch.utils.msgpack_codec import packb, unpackb
from zerovox_tpu_torch.weights import (from_jax_variables, meldec_from_jax_variables,
                                       meldec_to_jax_variables, to_jax_variables)

from test_torch_train import CORPORA, STATS, cfg_dict, corpus_dir  # noqa: F401 (a fixture)
from test_torch_weights import _cfg, _jax_variables, _leaves

TEXT = "Hello world, this is a test."
# the engines' tiny vocoder: 16 mels (the training config's), hop 256
MELDEC = dict(num_mels=16, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
              upsample_initial_channel=32, resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 3, 5),))


def _same_trees(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert type(x) is type(y), path
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            np.testing.assert_array_equal(x, y, err_msg=str(path))
        else:
            assert x == y, path


def _kind_cfg(mod, kind, scln):
    c = _cfg(mod, 16, scln)
    return dataclasses.replace(c, model=dataclasses.replace(
        c.model, decoder=dataclasses.replace(c.model.decoder, kind=kind)))


@pytest.fixture(scope="module")
def jax_trees():
    """JAX `ZeroVox` variables per (decoder kind, scln), made once."""
    cache = {}

    def get(kind, scln):
        if (kind, scln) not in cache:
            cache[kind, scln] = _jax_variables(_kind_cfg(jc, kind, scln))
        return cache[kind, scln]

    return get


# ------------------------------------------------------------------ codec

def test_writer_gives_flax_bytes_for_a_zerovox_tree(tmp_path, jax_trees):
    variables = jax_trees("fastspeech2", True)
    assert packb(variables) == fs.msgpack_serialize(variables)
    jckpt.save_native_checkpoint(tmp_path / "jax.msgpack", variables, meta={"epoch": 0})
    pckpt.save_native_checkpoint(tmp_path / "port.msgpack", variables, meta={"epoch": 0})
    assert (tmp_path / "jax.msgpack").read_bytes() == (tmp_path / "port.msgpack").read_bytes()
    assert pckpt.load_checkpoint_meta(tmp_path / "jax.msgpack") == {"epoch": 0}
    assert not (tmp_path / "port.msgpack.tmp").exists()


def test_readers_read_each_others_files():
    rng = np.random.default_rng(0)
    tree = {
        "params": {"w": rng.normal(size=(3, 5)).astype(np.float32),
                   "f64": rng.normal(size=(4,)), "zero_d": np.array(1.5, np.float32),
                   "empty": np.zeros((0, 3), np.int64), "ints": np.arange(7, dtype=np.int32),
                   "bools": np.array([True, False, True])},
        "scalars": {"py_int": 7, "neg": -40000, "big": 2 ** 40, "py_float": 0.25, "flag": True,
                    "off": False, "none": None, "name": "x" * 40,
                    "np_f64": np.float64(2.5), "np_i16": np.int16(-3), "np_bool": np.bool_(True)},
        "list": [1, np.float32(2.0), {"k": np.ones(2, np.uint8)}],
    }
    _same_trees(unpackb(fs.msgpack_serialize(tree)), fs.msgpack_restore(fs.msgpack_serialize(tree)))
    _same_trees(fs.msgpack_restore(packb(tree)), fs.msgpack_restore(fs.msgpack_serialize(tree)))
    assert type(unpackb(packb(tree))["scalars"]["np_f64"]) is np.float64


def test_codec_refuses_what_it_cannot_read_or_write():
    with pytest.raises(ValueError, match="chunk"):
        unpackb(packb({"a": {"__msgpack_chunked_array__": True, "shape": {"0": 3}}}))
    with pytest.raises(TypeError):
        packb({"a": (1, 2)})  # flax's strict packer refuses tuples too
    with pytest.raises(ValueError, match="trailing"):
        unpackb(packb({"a": 1}) + b"\x00")


# ------------------------------------------------------ to_jax_variables

# scln shapes only the FastSpeech2 decoder's layer norms; the StyleTTS
# decoder's tree is the same either way
@pytest.mark.parametrize("kind,scln", [("fastspeech2", True), ("fastspeech2", False),
                                       ("styletts", True)])
def test_to_jax_variables_inverts_from_jax_variables(jax_trees, kind, scln):
    variables = jax_trees(kind, scln)
    cfg = _kind_cfg(pc, kind, scln)
    sd = from_jax_variables(variables, cfg)
    back = to_jax_variables(sd, cfg)
    want, got = _leaves(variables), _leaves(back)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    again = from_jax_variables(back, cfg)
    assert again.keys() == sd.keys() and all(torch.equal(again[k], sd[k]) for k in sd)


@pytest.mark.parametrize("hcfg", [dict(upsample_initial_channel=64), dict(
    upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
    resblock="2", resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)))])
def test_meldec_to_jax_variables_inverts_meldec_from_jax_variables(hcfg):
    init = jax.jit(lambda k: JaxMelDec(JaxHifiGanConfig(**hcfg)).init(
        k, np.zeros((1, 8, 80), np.float32), normalize_before=True))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(1)))
    variables["params"]["mean"] = np.linspace(-1, 1, 80).astype(np.float32)
    back = meldec_to_jax_variables(meldec_from_jax_variables(variables, HifiGanConfig(**hcfg)),
                                   HifiGanConfig(**hcfg))
    want, got = _leaves(variables), _leaves(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------- checkpoints across packages

def _meldec_dirs(root, seed=5):
    """The same random vocoder as an upstream `generator.ckpt` dir and as a
    native `generator.msgpack` dir."""
    hcfg = HifiGanConfig(**MELDEC)
    md = MelDec(hcfg)
    random_init_(md, torch.Generator().manual_seed(seed))
    sd = md.state_dict()
    dirs = {}
    for kind in ("ckpt", "msgpack"):
        d = root / f"meldec_{kind}"
        d.mkdir()
        (d / "config.json").write_text(json.dumps(dataclasses.asdict(hcfg)))
        dirs[kind] = d
    gen = {k[len("generator."):]: v for k, v in sd.items() if k.startswith("generator.")}
    torch.save({"generator": gen}, dirs["ckpt"] / "generator.ckpt")
    pckpt.save_native_checkpoint(dirs["msgpack"] / "generator.msgpack",
                                 {"params": meldec_to_jax_variables(sd, hcfg)["params"]["generator"]})
    return dirs


@pytest.fixture(scope="module")
def trained(corpus_dir, tmp_path_factory):  # noqa: F811
    """A port model trained by `fit` for 2 epochs (checkpoints/0000 and
    0001.msgpack + modelcfg.yaml), the same weights written by the JAX
    package's `save_native_checkpoint` into a second model directory, and
    the two vocoder directories."""
    root = tmp_path_factory.mktemp("models")
    cfg = pc.ZeroVoxConfig.from_dict(cfg_dict(True))
    dm = SpeechDataModule(CORPORA, cfg.symbols(), STATS, batch_size=4, num_workers=2,
                          base_path=corpus_dir, ref_mel_len=64)
    dm.prepare_data()
    port_dir = root / "port_model"
    trainer = Trainer(cfg, TrainerConfig(max_epochs=2, warmup_epochs=1, seed=0,
                                         out_folder=str(port_dir)),
                      steps_per_epoch=dm.steps_per_epoch(), device="cpu")
    state = trainer.fit(dm.train_dataloader, trainer.init_state())
    cfg.to_yaml(port_dir / "modelcfg.yaml")

    jax_dir = root / "jax_model"
    (jax_dir / "checkpoints").mkdir(parents=True)
    shutil.copy(port_dir / "modelcfg.yaml", jax_dir / "modelcfg.yaml")
    variables = jckpt.load_native_checkpoint(port_dir / "checkpoints" / "0001.msgpack")
    jckpt.save_native_checkpoint(jax_dir / "checkpoints" / "0000.msgpack", variables)
    return cfg, state, port_dir, jax_dir, _meldec_dirs(root)


def test_fit_writes_checkpoints_the_jax_package_reads(trained):
    cfg, state, port_dir, _, _ = trained
    ckpts = port_dir / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["0000.msgpack", "0000.msgpack.json",
                                         "0001.msgpack", "0001.msgpack.json"]
    meta = jckpt.load_checkpoint_meta(ckpts / "0001.msgpack")
    assert meta["epoch"] == 1 and meta["step"] == state.step == 6 and np.isfinite(meta["loss"])
    variables = jckpt.load_native_checkpoint(ckpts / "0001.msgpack")
    assert set(variables) == {"params", "batch_stats"}
    _same_trees(variables, pckpt.load_native_checkpoint(ckpts / "0001.msgpack"))
    # back through from_jax_variables: the trained weights and statistics, bitwise
    sd = from_jax_variables(variables, cfg)
    trained_sd = state.model.state_dict()
    assert sd.keys() == trained_sd.keys()
    for k, v in trained_sd.items():
        if not k.endswith("num_batches_tracked"):  # no JAX counterpart
            assert torch.equal(sd[k], v), k


@pytest.fixture(scope="module")
def jax_reference(trained):
    """The JAX engine from `load_model` on the port-written model directory
    and the native vocoder directory: its speaker embedding and tts_ex on
    forced durations."""
    _, _, port_dir, _, meldecs = trained
    _, jax_tts = JaxTTS.load_model(str(port_dir), str(meldecs["msgpack"]))
    spk = np.asarray(jax_tts.speaker_embed(
        np.random.default_rng(0).normal(size=12000).astype(np.float32) * 0.2))
    dur = np.full(len(jax_tts.text2phonemeids(TEXT)[0]), 3, np.int32)
    wav, _, n, mel = jax_tts.tts_ex(TEXT, spk, duration=dur)
    return jax_tts, spk, dur, np.asarray(wav), n, np.asarray(mel)


@pytest.mark.parametrize("writer", ["port_fit", "jax"])
@pytest.mark.parametrize("meldec", ["ckpt", "msgpack"])
def test_load_model_matches_the_jax_engine(trained, jax_reference, writer, meldec):
    _, _, port_dir, jax_dir, meldecs = trained
    _, spk, dur, want_wav, want_n, want_mel = jax_reference
    model_dir = port_dir if writer == "port_fit" else jax_dir
    modelcfg, port = ZeroVoxTTS.load_model(model_dir, meldec_model=meldecs[meldec], device="cpu")
    assert modelcfg["audio"]["num_mels"] == 16 and port.meldec_model == str(meldecs[meldec])
    wav, _, n, mel = port.tts_ex(TEXT, spk, duration=dur)
    assert n == want_n == 3 * len(dur)
    np.testing.assert_allclose(mel, want_mel, atol=1e-4, rtol=0)
    peak = np.max(np.abs(want_wav))
    err = np.max(np.abs(wav - want_wav))
    assert wav.shape == want_wav.shape and peak > 1e-3
    assert err < 1e-3 and err < 1e-3 * peak, (err, peak)


def test_jax_load_model_reads_the_upstream_vocoder_dir_alike(trained, jax_reference):
    """The JAX engine on the generator.ckpt vocoder equals the one on the
    generator.msgpack vocoder the port wrote from the same weights."""
    _, _, port_dir, _, meldecs = trained
    _, spk, dur, want_wav, _, _ = jax_reference
    _, jax_tts = JaxTTS.load_model(str(port_dir), str(meldecs["ckpt"]))
    wav, _, _, _ = jax_tts.tts_ex(TEXT, spk, duration=dur)
    np.testing.assert_allclose(np.asarray(wav), want_wav, atol=1e-6, rtol=0)


def test_embedded_meldec_mean_and_scale_are_loaded_beside_a_meldec_dir(trained):
    """A checkpoint that embeds `_meldec.mean`/`_meldec.scale` next to a
    vocoder directory: both packages take the embedded buffers; a
    generator.msgpack directory keeps identity, as the JAX package does."""
    cfg, state, port_dir, _, meldecs = trained
    root = port_dir.parent / "embedded_model"
    (root / "checkpoints").mkdir(parents=True)
    shutil.copy(port_dir / "modelcfg.yaml", root / "modelcfg.yaml")
    mean = np.linspace(-2, 1, 16).astype(np.float32)
    scale = np.linspace(0.5, 2, 16).astype(np.float32)
    sd = {k: v for k, v in state.model.state_dict().items()}
    sd["_meldec.mean"], sd["_meldec.scale"] = torch.tensor(mean), torch.tensor(scale)
    torch.save({"state_dict": sd}, root / "checkpoints" / "last.ckpt")

    _, jax_tts = JaxTTS.load_model(str(root), str(meldecs["ckpt"]))
    _, port = ZeroVoxTTS.load_model(root, meldec_model=meldecs["ckpt"], device="cpu")
    for name, want in (("mean", mean), ("scale", scale)):
        np.testing.assert_array_equal(np.asarray(jax_tts._meldec_variables["params"][name]), want)
        np.testing.assert_array_equal(getattr(port._meldec, name).numpy(), want)
    _, port = ZeroVoxTTS.load_model(root, meldec_model=meldecs["msgpack"], device="cpu")
    np.testing.assert_array_equal(port._meldec.mean.numpy(), np.zeros(16, np.float32))
    np.testing.assert_array_equal(port._meldec.scale.numpy(), np.ones(16, np.float32))


@pytest.mark.parametrize("max_epochs,every,keep", [(5, 2, 2), (4, 1, 0), (5, 3, 1)])
def test_checkpoint_schedule_and_pruning_follow_the_jax_trainer(tmp_path, max_epochs, every,
                                                                keep):
    cfg = pc.ZeroVoxConfig.from_dict(cfg_dict(False))
    kw = dict(max_epochs=max_epochs, keep_checkpoints=keep, checkpoint_every_n_epochs=every)
    port = Trainer(cfg, TrainerConfig(out_folder=str(tmp_path / "port"), **kw), 1, device="cpu")
    state = port.init_state()
    jax_tr = jtrainer.Trainer(jc.ZeroVoxConfig.from_dict(cfg_dict(False)),
                              jtrainer.TrainerConfig(out_folder=str(tmp_path / "jax"), **kw), 1)
    jstate = types.SimpleNamespace(params={"w": np.zeros(2, np.float32)}, batch_stats={})
    losses = [{"loss": 1.0, "mel_loss": 1.0, "pitch_loss": 0.0, "energy_loss": 0.0,
               "duration_loss": 0.0}]
    for root in (port.checkpoint_root(), jax_tr.checkpoint_root()):
        os.makedirs(root)
    for epoch in range(max_epochs):
        port._on_epoch_end(epoch, losses, state, port.checkpoint_root(), 0.0)
        jax_tr._on_epoch_end(epoch, losses, jstate, jax_tr.checkpoint_root(), 0.0)

    def saved(root):
        return sorted(f for f in os.listdir(root) if f.endswith(".msgpack"))

    assert saved(port.checkpoint_root()) == saved(jax_tr.checkpoint_root())
    assert f"{max_epochs - 1:04d}.msgpack" in saved(port.checkpoint_root())
    # the port also removes a pruned checkpoint's meta file
    assert sorted(os.listdir(port.checkpoint_root())) == sorted(
        [f for f in saved(port.checkpoint_root())] + [f + ".json" for f in saved(port.checkpoint_root())])


def test_resume_gives_the_uninterrupted_next_step(corpus_dir, tmp_path):  # noqa: F811
    """fit for one epoch, save_train_state; the uninterrupted run's next
    step against restore_train_state into a fresh trainer and that step:
    equal losses and weights (dropout on, so the generator's state counts)."""
    d = cfg_dict(True)
    d["model"]["encoder"].update(fs2_dropout=0.2, vp_dropout=0.2)
    d["model"]["decoder"]["dropout"] = 0.2
    cfg = pc.ZeroVoxConfig.from_dict(d)
    dm = SpeechDataModule(CORPORA, cfg.symbols(), STATS, batch_size=4, num_workers=2,
                          base_path=corpus_dir, ref_mel_len=64)
    dm.prepare_data()
    tcfg = TrainerConfig(max_epochs=1, warmup_epochs=1, seed=3, out_folder=str(tmp_path))
    trainer = Trainer(cfg, tcfg, steps_per_epoch=dm.steps_per_epoch(), device="cpu")
    state = trainer.fit(dm.train_dataloader, trainer.init_state())
    trainer.save_train_state(state, tmp_path / "state.pt", epoch=0)
    batch = device_batch(next(iter(dm.train_dataloader(1))), "cpu")
    want = trainer.train_step(state, batch)

    fresh = Trainer(cfg, TrainerConfig(max_epochs=2, warmup_epochs=1, seed=3),
                    steps_per_epoch=dm.steps_per_epoch(), device="cpu")
    resumed = fresh.init_state()
    assert fresh.restore_train_state(resumed, tmp_path / "state.pt") == 1
    assert resumed.step == 3 and resumed.optimizer.count == 3
    got = fresh.train_step(resumed, batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    a, b = state.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(x, y) for x, y in zip(state.optimizer.nu, resumed.optimizer.nu))


# ------------------------------------------------------------------ hub

@pytest.fixture
def hub_cache(trained, tmp_path, monkeypatch):
    """A pre-populated hub cache in tmp_path holding a model (modelcfg.yaml
    + checkpoint.pkl, an upstream torch checkpoint) and a vocoder
    (config.json + generator.ckpt); downloads fail."""
    _, state, port_dir, _, meldecs = trained
    monkeypatch.setenv("CACHED_PATH_ZEROVOX", str(tmp_path))

    def no_network(url, filename=None, *args, **kwargs):
        raise OSError(f"no network in the tests: {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    model = tmp_path / "model_repo" / "tiny-tts"
    model.mkdir(parents=True)
    shutil.copy(port_dir / "modelcfg.yaml", model / "modelcfg.yaml")
    torch.save({"state_dict": state.model.state_dict()}, model / "checkpoint.pkl")
    shutil.copytree(meldecs["ckpt"], tmp_path / "model_repo" / "tiny-meldec")
    return state


def test_hub_names_resolve_from_the_cache(hub_cache, trained, jax_reference):
    _, _, port_dir, _, meldecs = trained
    _, spk, dur, _, _, _ = jax_reference
    modelcfg, from_hub = ZeroVoxTTS.load_model("tiny-tts", meldec_model="tiny-meldec",
                                               device="cpu")
    _, local = ZeroVoxTTS.load_model(port_dir, meldec_model=meldecs["ckpt"], device="cpu")
    assert modelcfg == yaml.safe_load((port_dir / "modelcfg.yaml").read_text())
    want, _, n = local.tts(TEXT, spk, duration=dur)
    got, _, n_got = from_hub.tts(TEXT, spk, duration=dur)
    assert n_got == n
    np.testing.assert_array_equal(got, want)


def test_a_hub_miss_raises_without_the_network(hub_cache):
    with pytest.raises(RuntimeError, match="CACHED_PATH_ZEROVOX"):
        hub.download_model_file("absent-model", "modelcfg.yaml")
    with pytest.raises(RuntimeError, match="not cached"):
        ZeroVoxTTS.load_model("absent-model", device="cpu")
    with pytest.raises(RuntimeError, match="not cached"):
        ZeroVoxTTS.load_model("tiny-tts", meldec_model="absent-meldec", device="cpu")
    assert hub.get_default_model("de") == hub.DEFAULT_TTS_MODEL_NAME_DE
