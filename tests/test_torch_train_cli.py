"""The port's training CLI and the trainer options it drives, on the CPU:
both packages' CLIs end to end on one tiny corpus, the device corpus cache
against the host data path, remat against the plain step, and the run
name, full-state checkpoints, resume, TensorBoard scalars and the profiler.

Bounds: the two CLIs' written modelcfg.yaml equal and their epoch losses
within 1e-4 relative (float32, every dropout rate 0, the same initial
weights from one .msgpack); the port's last checkpoint, read by the JAX
package's `load_native_checkpoint`, within 1e-4 x each tensor's max of the
JAX run's (against 1e-3 x the model's largest weight for a tensor that is
~0, such as a bias still near its zero init). Cached batches, remat's
gradients and a resumed epoch's losses equal their references bitwise.
"""

import json
import os
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch
import yaml

from zerovox_tpu.cli import train as jax_cli
from zerovox_tpu.training.checkpointing import load_native_checkpoint as jax_load

import zerovox_tpu_torch.config as pc
import zerovox_tpu_torch.models.fs2 as port_fs2
import zerovox_tpu_torch.models.resnetse as port_resnetse
from zerovox_tpu_torch.cli import train as port_cli
from zerovox_tpu_torch.symbols import Symbols
from zerovox_tpu_torch.synthesize import random_init_
from zerovox_tpu_torch.training import data as pdata
from zerovox_tpu_torch.training.checkpointing import save_native_checkpoint
from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig, device_batch
from zerovox_tpu_torch.weights import to_jax_variables

PHONES = "'-abcdefghijklmnopqrstuvwxyz"
PUNCTS = " ,.;:-!?\""
N_MELS = 16
CORPUS = {"language": "en", "path": {"preprocessed_path": "corpus"}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes run fastest on one intra-op thread, and the suite runs
    its files in parallel processes, where torch's default of a thread per
    core oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def modelcfg(dropout: float = 0.0, fused: bool = False) -> dict:
    return {
        "audio": {"num_mels": N_MELS},
        "model": {
            "max_txt_len": 64, "max_mel_len": 256, "phones": PHONES, "puncts": PUNCTS,
            "emb_dim": 16, "punct_emb_dim": 8,
            "encoder": {"fs2_layer": 1, "fs2_head": 2, "vp_filter_size": 8, "ve_n_bins": 8,
                        "fs2_dropout": dropout, "vp_dropout": dropout},
            "decoder": {"kind": "fastspeech2", "n_layers": 1, "n_head": 2,
                        "conv_filter_size": 32, "dropout": dropout},
            "resnet": {"layers": [1, 1, 1, 1], "num_filters": [32 if fused else 8, 8, 8, 8]},
        },
        "training": {"learning_rate": 1e-5},
    }


@pytest.fixture(scope="module")
def pp_root(tmp_path_factory):
    """A preprocessed corpus (train.txt, feature files, stats.json): 12
    utterances of 24-175 frames, so a 64-frame reference crop takes both the
    offset crop and the tiling."""
    root = tmp_path_factory.mktemp("pp")
    pp = root / "corpus"
    for d in ("mel", "pitch", "energy", "duration"):
        os.makedirs(pp / d)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(12):
        base = f"utt{i:03d}"
        L = int(rng.integers(8, 26))
        durations = rng.integers(2, 8, size=L).astype(np.int64)
        T = int(durations.sum())
        np.save(pp / "mel" / f"mel-{base}.npy", rng.normal(size=(T, N_MELS)).astype(np.float32))
        np.save(pp / "pitch" / f"pitch-{base}.npy", rng.uniform(60, 390, L).astype(np.float32))
        np.save(pp / "energy" / f"energy-{base}.npy", rng.uniform(0.2, 45, L).astype(np.float32))
        np.save(pp / "duration" / f"duration-{base}.npy", durations)
        with open(pp / "mel" / f"startstop-{base}.json", "w") as f:
            json.dump({"start_hop": 0, "end_hop": T}, f)
        phones = ",".join(map(str, rng.integers(1, 28, size=L)))
        puncts = ",".join(map(str, rng.integers(0, 10, size=L)))
        lines.append(f"{base}.wav|{phones}|{puncts}|text {i}")
    (pp / "train.txt").write_text("\n".join(lines) + "\n")
    (pp / "stats.json").write_text(json.dumps({"pitch": [55.0, 395.0, 200.0, 50.0],
                                               "energy": [0.15, 48.0, 20.0, 10.0]}))
    return root


@pytest.fixture
def cli_files(pp_root, tmp_path, monkeypatch):
    """modelcfg.yaml and corpus.yaml; the data path in the environment."""
    monkeypatch.setenv("ZEROVOX_PREPROCESSED_DATA_PATH", str(pp_root))
    monkeypatch.setenv("ZEROVOX_COMPILE_CACHE", "0")
    cfg_path, corpus_path = tmp_path / "modelcfg.yaml", tmp_path / "corpus.yaml"
    cfg_path.write_text(yaml.dump(modelcfg()))
    corpus_path.write_text(yaml.dump(CORPUS))
    return cfg_path, corpus_path


def _merged_cfg(pp_root, dropout=0.0, fused=False) -> pc.ZeroVoxConfig:
    return pc.ZeroVoxConfig.from_dict(
        port_cli.merge_stats(modelcfg(dropout, fused), [CORPUS], str(pp_root)))


# ------------------------------------------------------------ both CLIs

def test_both_clis_train_alike(cli_files, pp_root, tmp_path):
    cfg_path, corpus_path = cli_files
    init = tmp_path / "init.msgpack"
    model_cfg = _merged_cfg(pp_root)
    from zerovox_tpu_torch.models.zerovox import ZeroVox

    m = ZeroVox(model_cfg)
    random_init_(m, torch.Generator().manual_seed(5))
    with torch.no_grad():  # biases and norms away from their zero / identity init
        g = torch.Generator().manual_seed(6)
        for p in m.parameters():
            if p.dim() < 2:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    save_native_checkpoint(init, to_jax_variables(m.state_dict(), model_cfg))

    common = ["-c", str(cfg_path), str(corpus_path), "--accelerator", "cpu", "--devices", "1",
              "--precision", "32", "--checkpoint", str(init), "--max-epochs", "2",
              "--warmup-epochs", "1", "--batch-size", "4", "--num_workers", "2"]
    jax_cli.main(common + ["--out-folder", str(tmp_path / "jax")])
    out = port_cli.main(common + ["--out-folder", str(tmp_path / "port")])
    assert out["trainer"].device.type == "cpu" and out["state"].step == 6

    assert ((tmp_path / "jax" / "modelcfg.yaml").read_text()
            == (tmp_path / "port" / "modelcfg.yaml").read_text())
    for epoch in (0, 1):
        name = f"checkpoints/{epoch:04d}.msgpack.json"
        want = json.loads((tmp_path / "jax" / name).read_text())
        got = json.loads((tmp_path / "port" / name).read_text())
        assert got["epoch"] == want["epoch"] == epoch and got["step"] == want["step"]
        assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    want = jax_load(tmp_path / "jax" / "checkpoints" / "0001.msgpack")
    got = jax_load(tmp_path / "port" / "checkpoints" / "0001.msgpack")
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(got_leaves) == len(want_leaves)
    floor = 1e-3 * max(np.abs(np.asarray(v)).max() for _, v in want_leaves)
    for path, w in want_leaves:
        w, g = np.asarray(w), np.asarray(got_leaves[path])
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), floor), path


def test_cli_defaults_and_what_is_not_ported(cli_files, monkeypatch, tmp_path):
    cfg_path, corpus_path = cli_files
    args = port_cli.get_args(["-c", str(cfg_path), str(corpus_path)])
    assert (args.accelerator, args.precision, args.optim_dtype, args.data_device_cache,
            args.packed_speaker, args.fused_speaker, args.batch_size, args.max_epochs,
            args.checkpoint_format) == ("cuda", "bf16-mixed", "auto", "auto", None, 0, 24, 40,
                                        "msgpack")
    assert port_cli.resolve_optim_dtype("auto", "cuda") == "bf16"
    assert port_cli.resolve_optim_dtype("auto", "cpu") == "f32"
    assert port_cli.resolve_optim_dtype("f32", "cuda") == "f32"
    # data parallelism is ported (tests/test_torch_parallel.py); what remains
    # refused is a mesh the machine cannot hold and flags that contradict
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--devices 2: only 1 CUDA device"):
        port_cli.main(["-c", str(cfg_path), str(corpus_path), "--devices", "2"])
    for extra in (["--distributed", "--devices", "2"], ["--coordinator-address", "h:1"],
                  ["--num-processes", "2"], ["--process-id", "0"]):
        with pytest.raises(ValueError, match="--distributed"):
            port_cli.main(["-c", str(cfg_path), str(corpus_path), "--accelerator", "cpu"] + extra)
    with pytest.raises(SystemExit, match="requires --packed-speaker"):
        port_cli.main(["-c", str(cfg_path), str(corpus_path), "--accelerator", "cpu",
                       "--fused-speaker"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cli.main(["-c", str(cfg_path), str(corpus_path), "--max-epochs", "1",
                       "--out-folder", str(tmp_path / "out")])


def test_cli_run_without_yaml_at_the_defaults_then_resume(pp_root, tmp_path, monkeypatch):
    """`run` on parsed dicts, as the card's machine drives it (no pyyaml):
    bf16-mixed, bf16 second moments, the fused stage 1, the device cache,
    remat, a run name, pruning to one checkpoint, a profile of 2 steps; then
    --resume for a third epoch from the saved train state."""
    monkeypatch.setenv("ZEROVOX_PREPROCESSED_DATA_PATH", str(pp_root))
    monkeypatch.setitem(__import__("sys").modules, "yaml", None)
    out_folder, prof = tmp_path / "run", tmp_path / "prof"
    argv = ["-c", "unused.yaml", "unused", "--accelerator", "cpu", "--devices", "1",
            "--batch-size", "4", "--max-epochs", "2", "--warmup-epochs", "1",
            "--optim-dtype", "bf16", "--packed-speaker", "1", "--fused-speaker",
            "--data-device-cache", "on", "--remat", "--remat-speaker", "--name", "smoke",
            "--keep-checkpoints", "1", "--checkpoint-format", "state", "--profile", str(prof),
            "--profile-steps", "2", "--out-folder", str(out_folder), "--num_workers", "1"]
    cfg = port_cli.merge_stats(modelcfg(fused=True), [CORPUS], str(pp_root))
    out = port_cli.run(port_cli.get_args(argv), cfg, [CORPUS])
    trainer, state = out["trainer"], out["state"]
    assert trainer.mixed and state.step == 6 and out["datamodule"].device_cache
    assert out["cfg"].model.fused_speaker and out["cfg"].model.remat
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(n.dtype == torch.bfloat16 for n in state.optimizer.nu)
    ckpts = out_folder / "checkpoints" / "smoke"
    assert sorted(os.listdir(ckpts)) == ["0001.msgpack", "0001.msgpack.json", "state"]
    assert os.listdir(ckpts / "state") == ["0001.pt"]
    assert any(f.endswith(".json") for f in os.listdir(prof))
    assert os.listdir(out_folder / "lightning_logs" / "smoke")

    args = port_cli.get_args(argv + ["--resume", "--max-epochs", "3"])
    resumed = port_cli.run(args, cfg, [CORPUS])
    assert resumed["state"].step == 9
    assert sorted(os.listdir(ckpts / "state")) == ["0002.pt"]
    meta = json.loads((ckpts / "0002.msgpack.json").read_text())
    assert meta["epoch"] == 2 and meta["step"] == 9 and np.isfinite(meta["loss"])


# ------------------------------------------------------- device corpus cache

def _datamodules(pp_root, **kw):
    mods = []
    for cache in (False, True):
        dm = pdata.SpeechDataModule([CORPUS], Symbols(PHONES, PUNCTS), _merged_cfg(pp_root).stats
                                    .__dict__, batch_size=4, num_workers=2, ref_mel_len=64,
                                    base_path=str(pp_root), device_cache=cache, device="cpu", **kw)
        dm.prepare_data()
        mods.append(dm)
    return mods


def test_device_cache_batches_equal_the_host_path(pp_root):
    host, cached = _datamodules(pp_root, drop_last=False)
    for epoch in (0, 1):
        want, got = list(host.train_dataloader(epoch)), list(cached.train_dataloader(epoch))
        assert cached._cache is not None and len(got) == len(want) == 3
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx["pad_items"] == wx["pad_items"]
            for k, v in {**{k: v for k, v in gx.items() if k != "pad_items"}, **gy}.items():
                ref = wy[k] if k == "mel" else wx[k]
                assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
                assert v.numpy().dtype == ref.dtype and v.shape == ref.shape, k
                np.testing.assert_array_equal(v.numpy(), ref, err_msg=k)
            for k, v in device_batch((gx, gy), "cpu").items():
                np.testing.assert_array_equal(v.numpy(), device_batch((wx, wy), "cpu")[k].numpy())
    lens = host.train_dataset  # both crop branches were taken
    mel_lens = [lens.load_item(i)["mel"].shape[0] for i in range(len(lens))]
    assert min(mel_lens) < 64 < max(mel_lens)


def test_device_cache_over_budget_never_allocates(pp_root, monkeypatch, capsys):
    monkeypatch.setattr(pdata, "DEVICE_CACHE_BYTE_LIMIT", 1000)

    def refuse(self, device):
        raise AssertionError("an over-budget corpus was uploaded")

    monkeypatch.setattr(pdata._DeviceCorpusCache, "upload", refuse)
    host, cached = _datamodules(pp_root)
    got = list(cached.train_dataloader(0))
    assert "device corpus cache disabled" in capsys.readouterr().out
    assert cached._cache is None and not cached.device_cache
    for (gx, gy), (wx, wy) in zip(got, host.train_dataloader(0)):
        assert isinstance(gx["ref_mel"], np.ndarray)
        np.testing.assert_array_equal(gx["ref_mel"], wx["ref_mel"])
        np.testing.assert_array_equal(gy["mel"], wy["mel"])


# ------------------------------------------------------------------ remat

def _remat_step(pp_root, remat: bool, fused: bool):
    base = _merged_cfg(pp_root, dropout=0.3, fused=fused)
    import dataclasses as dc

    m = dc.replace(base.model, remat=remat, remat_speaker=remat, packed_speaker=int(fused),
                   fused_speaker=fused)
    trainer = Trainer(dc.replace(base, model=m), TrainerConfig(seed=3), steps_per_epoch=1,
                      device="cpu")
    state = trainer.init_state()
    host, _ = _datamodules(pp_root)
    losses = trainer.forward_backward(state, device_batch(next(iter(host.train_dataloader(0))),
                                                          "cpu"))
    return (losses, {n: p.grad.clone() for n, p in state.model.named_parameters()},
            {n: b.clone() for n, b in state.model.named_buffers()})


@pytest.mark.parametrize("fused", [False, True])
def test_remat_keeps_the_step_bitwise(pp_root, fused):
    """Dropout 0.3 everywhere: a step with remat and remat_speaker gives the
    same losses, gradients and running statistics, bit for bit, as the step
    without them (the recomputation replays the dropout masks and does not
    update the running statistics twice)."""
    want = _remat_step(pp_root, False, fused)
    got = _remat_step(pp_root, True, fused)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_a_naive_checkpoint_would_change_the_gradients(pp_root, monkeypatch):
    """What the test above guards against: torch's checkpoint alone draws new
    dropout masks in the recomputation (it restores only the default
    generators) and updates the running statistics a second time."""
    from torch.utils.checkpoint import checkpoint

    def naive(module, *args):
        return checkpoint(module, *args, use_reentrant=False)

    want = _remat_step(pp_root, False, False)
    monkeypatch.setattr(port_fs2, "remat", naive)
    monkeypatch.setattr(port_resnetse, "remat", naive)
    got = _remat_step(pp_root, True, False)
    assert any(not torch.equal(got[1][k], want[1][k]) for k in want[1])
    assert any(not torch.equal(got[2][k], want[2][k]) for k in want[2])


# ------------------------------------------------------------- trainer options

def test_resume_from_equals_the_uninterrupted_run(pp_root, tmp_path):
    """fit for 2 of 3 epochs with full-state checkpoints (bf16 second
    moments), then a fresh trainer's resume_from + fit: the third epoch's
    losses, the weights and the stored nu equal the uninterrupted run's."""
    cfg = _merged_cfg(pp_root, dropout=0.2)
    host, _ = _datamodules(pp_root)

    def trainer(epochs, folder):
        return Trainer(cfg, TrainerConfig(max_epochs=epochs, warmup_epochs=1, seed=0,
                                          optim_dtype="bf16", checkpoint_format="state",
                                          name="r", log_every_n_steps=2,
                                          out_folder=str(tmp_path / folder)),
                       steps_per_epoch=3, device="cpu")

    full = trainer(3, "full")
    whole = full.fit(host.train_dataloader, full.init_state())
    part = trainer(2, "part")
    part.fit(host.train_dataloader, part.init_state())
    again = trainer(3, "part")
    state, start = again.resume_from(again.init_state())
    assert start == 2 and state.step == 6
    assert all(n.dtype == torch.bfloat16 for n in state.optimizer.nu)
    again.fit(host.train_dataloader, state, start_epoch=start)
    for folder in ("full", "part"):
        assert sorted(os.listdir(tmp_path / folder / "checkpoints" / "r" / "state")) == [
            "0000.pt", "0001.pt", "0002.pt"]
    got = json.loads((tmp_path / "part/checkpoints/r/0002.msgpack.json").read_text())
    want = json.loads((tmp_path / "full/checkpoints/r/0002.msgpack.json").read_text())
    assert got == want
    for a, b in zip(state.model.state_dict().values(), whole.model.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(state.optimizer.nu, whole.optimizer.nu):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        trainer(3, "nothing").resume_from(full.init_state())


def test_tensorboard_scalars_and_profile(pp_root, tmp_path):
    from tensorboardX import SummaryWriter  # noqa: F401  (the test needs the optional package)
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    host, _ = _datamodules(pp_root)
    prof = tmp_path / "prof"
    tr = Trainer(_merged_cfg(pp_root), TrainerConfig(max_epochs=1, warmup_epochs=1, seed=0,
                                                     log_every_n_steps=1, name="tb",
                                                     out_folder=str(tmp_path), profile_steps=1,
                                                     profile_dir=str(prof)),
                 steps_per_epoch=3, device="cpu")
    tr.fit(host.train_dataloader, tr.init_state())
    ev = EventAccumulator(str(tmp_path / "lightning_logs" / "tb"))
    ev.Reload()
    tags = set(ev.Tags()["scalars"])
    assert {"loss", "mel", "pitch", "energy", "dur", "aloss", "amel", "apitch", "aenergy", "adur",
            "lr"} <= tags
    assert [e.step for e in ev.Scalars("loss")] == [1, 2, 3]
    assert [e.step for e in ev.Scalars("aloss")] == [3]
    traces = sorted(os.listdir(prof))
    assert len(traces) == 2 and traces[0].endswith(".json") and traces[1].endswith(".txt")
    with open(prof / traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_cli_namespace_fields_match_the_jax_cli():
    """Every argument of the JAX CLI exists in the port's, with the same
    default except the device ones (accelerator: cuda for tpu; the resume
    format: state for orbax)."""
    jax_args = vars(jax_cli.get_args(["-c", "m.yaml", "c.yaml"]))
    port_args = vars(port_cli.get_args(["-c", "m.yaml", "c.yaml"]))
    assert jax_args.keys() == port_args.keys()
    differ = {k for k in jax_args if jax_args[k] != port_args[k]}
    assert differ == {"accelerator"}
    assert isinstance(port_cli.get_args(["-c", "m", "c", "--packed-speaker"]), Namespace)


def test_devices_2_on_cpu_ranks_trains_as_one_process(pp_root, tmp_path, monkeypatch):
    """`--devices 2 --accelerator cpu` spawns two gloo ranks, each on its
    half of every batch of 4, rank 0 writing the checkpoints: the run's
    epoch loss within 1e-4 relative of the one-process run's (float32,
    dropout 0, the fused stage 1, remat: the global BatchNorm statistics and
    masked means make the two runs one computation up to rounding, and the
    ranks replay the recomputed blocks' all-reduces alike) and its weights
    within 2 x lr x steps (tests/test_torch_train.py's bound: Adam turns a
    gradient that is zero up to rounding, as the attention key biases' is,
    into a +-lr step)."""
    monkeypatch.setenv("ZEROVOX_PREPROCESSED_DATA_PATH", str(pp_root))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' torch: one thread each
    cfg = port_cli.merge_stats(modelcfg(fused=True), [CORPUS], str(pp_root))
    common = ["-c", "unused.yaml", "unused", "--accelerator", "cpu", "--precision", "32",
              "--batch-size", "4", "--max-epochs", "1", "--warmup-epochs", "1",
              "--packed-speaker", "1", "--fused-speaker", "--remat", "--remat-speaker",
              "--num_workers", "1"]
    runs = {}
    for devices in ("1", "2"):
        out = tmp_path / f"devices{devices}"
        args = port_cli.get_args(common + ["--devices", devices, "--out-folder", str(out)])
        got = port_cli.run(args, cfg, [CORPUS])
        assert (got is None) == (devices == "2")  # the spawned ranks return nothing
        ckpts = out / "checkpoints"
        assert sorted(os.listdir(ckpts)) == ["0000.msgpack", "0000.msgpack.json"]
        runs[devices] = (json.loads((ckpts / "0000.msgpack.json").read_text()),
                         jax_load(ckpts / "0000.msgpack"))
    (meta1, w1), (meta2, w2) = runs["1"], runs["2"]
    assert meta2["step"] == meta1["step"] == 3
    assert abs(meta2["loss"] - meta1["loss"]) <= 1e-4 * abs(meta1["loss"])
    got = dict(jax.tree_util.tree_leaves_with_path(w2))
    for path, w in jax.tree_util.tree_leaves_with_path(w1):
        assert np.abs(np.asarray(got[path]) - np.asarray(w)).max() <= 2 * 1e-5 * 3, path


def test_distributed_needs_the_card_unless_told_cpu(tmp_path, monkeypatch):
    """`--distributed` at the default `--accelerator cuda` resolves to the
    card and raises without one, before any group is formed: a run never
    quietly trains on the CPU."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_cli.get_args(["-c", "m", "c", "--distributed", "--coordinator-address",
                              f"file://{tmp_path}/store", "--num-processes", "1",
                              "--process-id", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.run(args, {}, [])
    assert not dist.is_initialized()


def test_distributed_on_two_cpu_processes(pp_root, tmp_path, monkeypatch):
    """`--distributed --accelerator cpu` in two processes that join one gloo
    group through a file store: each loads its own batches of `--batch-size`
    rows (not a block of a global batch), shuffled with its rank as the
    seed; the gradients are all-reduced, so both end with the same weights;
    rank 0 alone writes the checkpoint."""
    import torch.multiprocessing as mp
    import torch_parallel_ranks as ranks

    monkeypatch.setenv("ZEROVOX_PREPROCESSED_DATA_PATH", str(pp_root))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = port_cli.merge_stats(modelcfg(), [CORPUS], str(pp_root))
    out = tmp_path / "out"
    argv = ["-c", "unused.yaml", "unused", "--accelerator", "cpu", "--precision", "32",
            "--batch-size", "4", "--max-epochs", "1", "--warmup-epochs", "1",
            "--num_workers", "1", "--out-folder", str(out), "--distributed",
            "--coordinator-address", f"file://{tmp_path}/store", "--num-processes", "2"]
    mp.start_processes(ranks.distributed_cli, args=(argv, cfg, [CORPUS], str(tmp_path)),
                       nprocs=2, start_method="spawn")
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    symbols = Symbols(PHONES, PUNCTS)
    for r, g in enumerate(got):
        assert (g["rank"], g["world"], g["device"], g["backend"]) == (r, 2, "cpu", "gloo")
        assert g["process_local"]
        dm = pdata.SpeechDataModule([CORPUS], symbols, cfg["stats"], batch_size=4,
                                    num_workers=1, seed=r, device="cpu")
        dm.prepare_data()
        want = [x["mel_len"].tolist() for x, _ in dm.train_dataloader(0)]
        assert len(want) == 3 and all(len(b) == 4 for b in want)
        assert g["seen"] == want, r
    assert got[0]["seen"] != got[1]["seen"]
    for n, p in got[0]["params"].items():
        assert torch.equal(p, got[1]["params"][n]), n
    ckpts = out / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["0000.msgpack", "0000.msgpack.json"]
    assert json.loads((ckpts / "0000.msgpack.json").read_text())["step"] == 3
    for path, w in jax.tree_util.tree_leaves_with_path(jax_load(ckpts / "0000.msgpack")):
        assert np.all(np.isfinite(np.asarray(w))), path
