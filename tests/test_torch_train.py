"""The port's acoustic-model training slice on the CPU against the JAX
package: data path, length-regulator gradient, training forward, loss,
optimizer and schedule, and a 5-step training run with the fused speaker
stage 1 (JAX Pallas in interpret mode) on the same weights and batches.

Bounds, float32 throughout, every dropout rate 0 (dropout cannot match
across frameworks): batches equal exactly; loss 1e-6 relative; optimizer
and schedule 1e-6; training forward 1e-4 (the inference decoder's bound in
tests/test_torch_fs2.py; train-mode BatchNorm adds batch-statistic rounding
to the style vector); the run's losses 1e-4 relative,
its step-1 gradients 1e-4 x each tensor's largest value (a gradient whose
exact value is zero, as the attention key biases' is under the softmax's
shift invariance, against 1e-3 x the model's largest gradient instead of its
own float noise), and its parameters
after 5 steps within 2 * lr * 5 absolute: Adam with eps 1e-9 turns a
gradient that is zero up to rounding into a +-lr step whose sign rounding
decides, so parameters can part by up to lr per step.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import zerovox_tpu.config as jc
from zerovox_tpu.checkpoint import convert_zerovox_state_dict
from zerovox_tpu.models.zerovox import ZeroVox as JaxZeroVox, zerovox_loss as jax_loss_fn
from zerovox_tpu.ops.length_regulator import length_regulate as jax_length_regulate
from zerovox_tpu.ops.pallas import se_fused
from zerovox_tpu.parallel.mesh import MeshConfig, make_mesh, shard_batch
from zerovox_tpu.symbols import Symbols as JaxSymbols
from zerovox_tpu.training import data as jdata
from zerovox_tpu.training import trainer as jtrainer
from zerovox_tpu.training.optim import make_optimizer, warmup_cosine_epoch_schedule as jax_schedule

import zerovox_tpu_torch.config as pc
from zerovox_tpu_torch.models.layers import Dropout
from zerovox_tpu_torch.models.zerovox import ZeroVox, zerovox_loss
from zerovox_tpu_torch.ops.length_regulator import length_regulate
from zerovox_tpu_torch.symbols import Symbols
from zerovox_tpu_torch.synthesize import random_init_
from zerovox_tpu_torch.training import data as pdata
from zerovox_tpu_torch.training.optim import AdamW, warmup_cosine_epoch_schedule
from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig, device_batch
from zerovox_tpu_torch.weights import from_jax_variables

PHONES = "'-abcdefghijklmnopqrstuvwxyz"
PUNCTS = " ,.;:-!?\""
N_MELS = 16  # a multiple of 8: the encoder's pooling width is n_mels / 8
STATS = {"pitch_min": 50.0, "pitch_max": 400.0, "energy_min": 0.1, "energy_max": 50.0}
CORPORA = [{"language": "en", "path": {"preprocessed_path": "corpus"}}]
LR = 1e-3


def cfg_dict(fused: bool) -> dict:
    return {
        "audio": {"num_mels": N_MELS},
        "model": {
            "max_txt_len": 64, "max_mel_len": 256, "phones": PHONES, "puncts": PUNCTS,
            "emb_dim": 16, "punct_emb_dim": 8,
            "packed_speaker": 1 if fused else 0, "fused_speaker": fused,
            "encoder": {"fs2_layer": 1, "fs2_head": 2, "vp_filter_size": 8, "ve_n_bins": 8,
                        "fs2_dropout": 0.0, "vp_dropout": 0.0},
            "decoder": {"kind": "fastspeech2", "n_layers": 1, "n_head": 2,
                        "conv_filter_size": 32, "dropout": 0.0},
            "resnet": {"layers": [1, 1, 1, 1], "num_filters": [32 if fused else 8, 8, 8, 8]},
        },
        "training": {"learning_rate": LR},
        "stats": STATS,
        "lang": ["en"],
    }


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    """A synthetic preprocessed corpus in the on-disk contract."""
    root = tmp_path_factory.mktemp("corpus")
    pp = root / "corpus"
    for d in ("mel", "pitch", "energy", "duration"):
        os.makedirs(pp / d)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(12):
        base = f"utt{i:03d}"
        L = int(rng.integers(8, 20))
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
    return str(root)


def _modules(corpus_dir, num_workers=2):
    kw = dict(batch_size=4, num_workers=num_workers, base_path=corpus_dir, ref_mel_len=64)
    port = pdata.SpeechDataModule(CORPORA, Symbols(PHONES, PUNCTS), STATS, **kw)
    ref = jdata.SpeechDataModule(CORPORA, JaxSymbols(PHONES, PUNCTS), STATS, **kw)
    port.prepare_data()
    ref.prepare_data()
    return port, ref


def _batches(dm, n=5):
    out = [b for epoch in (0, 1) for b in dm.train_dataloader(epoch)]
    return out[:n]


# ------------------------------------------------------------------ data

def test_batches_equal_the_jax_data_path(corpus_dir):
    port, ref = _modules(corpus_dir)
    assert len(port.train_dataset) == len(ref.train_dataset) == 12
    assert port.steps_per_epoch() == ref.steps_per_epoch() == 3
    for epoch in (0, 3):
        got, want = list(port.train_dataloader(epoch)), list(ref.train_dataloader(epoch))
        assert len(got) == len(want) == 3
        for (gx, gy), (wx, wy) in zip(got, want):
            assert set(gx) == set(wx)
            for k in gx:
                if isinstance(gx[k], np.ndarray):
                    np.testing.assert_array_equal(gx[k], wx[k], err_msg=k)
                else:
                    assert gx[k] == wx[k], k
            np.testing.assert_array_equal(gy["mel"], wy["mel"])


def test_collate_equals_jax_collate(corpus_dir):
    port, _ = _modules(corpus_dir)
    items = [port.train_dataset.load_item(i) for i in range(5)]
    gx, gy = pdata.collate(items, np.random.default_rng(4), ref_mel_len=100)
    wx, wy = jdata.collate(items, np.random.default_rng(4), ref_mel_len=100)
    for k in ("phoneme", "puncts", "phoneme_mask", "mel_mask", "pitch", "energy",
              "duration", "ref_mel"):
        np.testing.assert_array_equal(gx[k], wx[k], err_msg=k)
    np.testing.assert_array_equal(gy["mel"], wy["mel"])


def test_device_batch_is_the_jax_step_input(corpus_dir):
    port, _ = _modules(corpus_dir, num_workers=1)
    batch = next(iter(port.train_dataloader(0)))
    got = device_batch(batch, "cpu")
    want = jtrainer.device_batch(batch)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=k)


# ------------------------------------------------- layers of the training forward

def test_length_regulator_gradient_reaches_x():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 4)).astype(np.float32)
    dur = np.asarray([[2, 0, 3, 1, 4, 0], [1, 1, 1, 5, 0, 0]], np.int32)
    ct = rng.normal(size=(2, 16, 4)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jax_length_regulate(a, jnp.asarray(dur), 16)[0] * ct))(x)
    xt = torch.tensor(x, requires_grad=True)
    (length_regulate(xt, torch.from_numpy(dur), 16)[0] * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert torch.all(xt.grad[dur == 0] == 0)  # phones of duration 0 get no gradient


def test_dropout_rule():
    x = torch.ones(4000)
    d = Dropout(0.25)
    d.generator = torch.Generator().manual_seed(5)
    y = d(x)
    assert torch.unique(y).tolist() == [0.0, torch.tensor(1 / 0.75).item()]
    assert abs((y == 0).float().mean().item() - 0.25) < 0.03
    d.generator.manual_seed(5)
    assert torch.equal(d(x), y)
    assert torch.equal(d.eval()(x), x)


def _port_model(fused: bool, seed: int = 0) -> ZeroVox:
    model = ZeroVox(pc.ZeroVoxConfig.from_dict(cfg_dict(fused)))
    random_init_(model, torch.Generator().manual_seed(seed))
    return model


def test_training_forward_matches_jax(corpus_dir):
    port, _ = _modules(corpus_dir)
    batch = next(iter(port.train_dataloader(0)))
    model = _port_model(fused=False, seed=1).train()
    variables = convert_zerovox_state_dict(model.state_dict(), jc.ZeroVoxConfig.from_dict(cfg_dict(False)))
    want, _ = JaxZeroVox(jc.ZeroVoxConfig.from_dict(cfg_dict(False))).apply(
        variables, jtrainer.device_batch(batch), train=True, rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"])
    with torch.no_grad():
        got = model(device_batch(batch, "cpu"), train=True)
    for k in ("mel", "pitch", "energy", "log_duration"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    for k in ("mel_mask", "mel_len", "duration_rounded"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_loss_matches_jax():
    rng = np.random.default_rng(7)
    B, L, T, M = 3, 9, 20, N_MELS
    pred = {"mel": rng.normal(size=(B, T, M)), "pitch": rng.normal(size=(B, L)),
            "energy": rng.normal(size=(B, L)), "log_duration": rng.normal(size=(B, L))}
    pred = {k: v.astype(np.float32) for k, v in pred.items()}
    batch = {"mel": rng.normal(size=(B, T, M)).astype(np.float32),
             "pitch": rng.normal(size=(B, L)).astype(np.float32),
             "energy": rng.normal(size=(B, L)).astype(np.float32),
             "duration": rng.integers(0, 6, size=(B, L)).astype(np.int32),
             "phoneme_mask": np.arange(L)[None] >= np.asarray([9, 5, 7])[:, None],
             "mel_mask": np.arange(T)[None] >= np.asarray([20, 11, 16])[:, None]}
    want = jax_loss_fn(pred, batch)
    got = zerovox_loss({k: torch.from_numpy(v) for k, v in pred.items()},
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)


# ------------------------------------------------------------ optimizer

def test_schedule_matches_jax():
    want = jax_schedule(3e-4, warmup_epochs=2, total_epochs=7, steps_per_epoch=3)
    got = warmup_cosine_epoch_schedule(3e-4, warmup_epochs=2, total_epochs=7, steps_per_epoch=3)
    for step in range(30):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))), rtol=1e-6)


@pytest.mark.parametrize("betas", [(0.0, 0.99), (0.9, 0.99)])
def test_optimizer_matches_optax(betas):
    rng = np.random.default_rng(11)
    shapes = {"w": (8, 16), "b": (16,), "k": (3, 4, 5)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(weight_decay=1e-2, betas=betas, eps=1e-9, grad_clip=1.0)
    tx = make_optimizer(jax_schedule(1e-2, 2, 5, 1), **kw)
    schedule = warmup_cosine_epoch_schedule(1e-2, 2, 5, 1)
    p_ref = {k: jnp.asarray(v) for k, v in init.items()}
    s_ref = tx.init(p_ref)
    params = [torch.tensor(init[k], requires_grad=True) for k in shapes]
    opt = AdamW(params, **kw)
    for step in range(5):
        # scales 0.02 .. 0.6 and up: the clip is idle on some steps, active on others
        grads = {k: (rng.normal(size=s) * 0.02 * 3 ** step).astype(np.float32)
                 for k, s in shapes.items()}
        u, s_ref = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, s_ref, p_ref)
        p_ref = optax.apply_updates(p_ref, u)
        for p, k in zip(params, shapes):
            p.grad = torch.from_numpy(grads[k])
        opt.step(schedule(step))
        for p, k in zip(params, shapes):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_ref[k]), rtol=0,
                                       atol=1e-6, err_msg=f"{k} at step {step}")


# ------------------------------------------------ the slice: 5 training steps

def test_five_train_steps_match_the_jax_trainer(corpus_dir, monkeypatch, tmp_path):
    port_dm, _ = _modules(corpus_dir)
    batches = _batches(port_dm)
    pcfg = pc.ZeroVoxConfig.from_dict(cfg_dict(True))
    jcfg = jc.ZeroVoxConfig.from_dict(cfg_dict(True))
    sd = _port_model(fused=True, seed=2).state_dict()
    variables = convert_zerovox_state_dict(sd, jcfg)

    calls = []
    orig = se_fused.se_conv
    monkeypatch.setattr(se_fused, "se_conv", lambda *a: calls.append(1) or orig(*a))

    # JAX: step-1 gradients, then 5 steps of its trainer on a one-device mesh
    jb = [jtrainer.device_batch(b) for b in batches]

    def loss(params):
        outs, _ = JaxZeroVox(jcfg).apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jb[0], train=True,
            spkemb_train=True, rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return jax_loss_fn(outs, jb[0])["loss"]

    grads = jax.jit(jax.grad(loss))(variables["params"])
    assert calls, "the JAX run did not take the fused stage-1 path"
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(max_epochs=2, warmup_epochs=1, batch_size=4,
                                                       out_folder=str(tmp_path), seed=0),
                          steps_per_epoch=3, mesh=mesh)
    jstate = jt.init_state(jb[0], init_variables=variables)
    want = []
    for b in jb:
        jstate, losses = jt._train_step(jstate, shard_batch(b, mesh), jax.random.PRNGKey(0))
        want.append(float(losses["loss"]))

    # the port: the same weights and batches
    trainer = Trainer(pcfg, TrainerConfig(max_epochs=2, warmup_epochs=1, seed=0),
                      steps_per_epoch=3, device="cpu")
    fresh = trainer.init_state(sd)
    trainer.forward_backward(fresh, device_batch(batches[0], "cpu"))
    grad_sd = from_jax_variables({"params": grads, "batch_stats": variables["batch_stats"]}, pcfg)
    floor = 1e-3 * max(np.abs(g.numpy()).max() for g in grad_sd.values())
    for name, p in fresh.model.named_parameters():
        want_g = grad_sd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want_g, rtol=0,
                                   atol=1e-4 * max(np.abs(want_g).max(), floor), err_msg=name)

    state = trainer.init_state(sd)
    got = [trainer.train_step(state, device_batch(b, "cpu"))["loss"].item() for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert state.step == 5
    want_sd = from_jax_variables({"params": jstate.params, "batch_stats": jstate.batch_stats},
                                 pcfg)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_sd[name].numpy(), rtol=0,
                                   atol=2 * LR * 5, err_msg=name)


def test_fit_runs_epochs_and_says_it_saves_nothing(corpus_dir, capsys, tmp_path):
    """fit runs its epochs and, since checkpoints are ported, no longer says
    it saved nothing: it writes one native checkpoint an epoch."""
    port_dm, _ = _modules(corpus_dir)
    trainer = Trainer(pc.ZeroVoxConfig.from_dict(cfg_dict(False)),
                      TrainerConfig(max_epochs=2, warmup_epochs=1, log_every_n_steps=2, seed=0,
                                    out_folder=str(tmp_path)),
                      steps_per_epoch=port_dm.steps_per_epoch(), device="cpu")
    state = trainer.fit(port_dm.train_dataloader, trainer.init_state())
    out = capsys.readouterr().out
    assert state.step == 6
    assert "epoch 0: loss=" in out and "epoch 1: loss=" in out
    assert "invalid loss" not in out
    assert "saved nothing" not in out
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "0000.msgpack", "0000.msgpack.json", "0001.msgpack", "0001.msgpack.json"]


def test_decoder_only_steps_only_the_decoder(corpus_dir):
    port_dm, _ = _modules(corpus_dir)
    batch = device_batch(next(iter(port_dm.train_dataloader(0))), "cpu")
    trainer = Trainer(pc.ZeroVoxConfig.from_dict(cfg_dict(False)),
                      TrainerConfig(max_epochs=1, train_decoder_only=True, seed=0),
                      steps_per_epoch=1, device="cpu")
    state = trainer.init_state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    trainer.train_step(state, batch)
    after = state.model.state_dict()
    changed = {k for k in before if not torch.equal(before[k], after[k])}
    assert changed and all(k.startswith("_mel_decoder.") for k in changed)


def test_restore_into_keeps_the_decoder_when_asked():
    trainer = Trainer(pc.ZeroVoxConfig.from_dict(cfg_dict(False)), TrainerConfig(seed=0),
                      steps_per_epoch=1, device="cpu")
    imported = _port_model(fused=False, seed=3).state_dict()
    for reinit in (False, True):
        state = trainer.init_state()
        fresh = {k: v.clone() for k, v in state.model.state_dict().items()}
        got = trainer.restore_into(state, imported, reinit_decoder=reinit).model.state_dict()
        for k, v in got.items():
            want = fresh[k] if reinit and k.startswith("_mel_decoder.") else imported[k]
            assert torch.equal(v, want), k
