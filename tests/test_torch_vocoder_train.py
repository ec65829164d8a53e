"""The port's HiFi-GAN GAN training against the JAX package's (CPU, float32).

The discriminators (logits and every feature map), the GAN losses, the
mel-loss frontend, the segment sampler, one GAN round (fused and split:
losses, and the discriminators' and generator's gradients, read through an
optimizer that records them), a 3-step trajectory with the real optimizers
and schedule, a bf16-mixed round, `generator.msgpack` across the two
packages and the training CLI, at the JAX tests' tiny sizes
(tests/test_vocoder_train.py).

Tolerances: feature maps and mels 1e-5 x the tensor's max; a round's losses
1e-4 relative and gradients 1e-3 x each tensor's max (the float32 sums of
the nets' convolutions reassociate differently in XLA and in torch); the
3-step trajectory 1e-3 relative; bf16-mixed 5e-2 (docs/PERFORMANCE.md's
bf16 bound). The JAX trainer's `vocoder-NNNN.msgpack` (P13a): the restored
weights, moments and counts equal the file's bitwise, the next round's
losses 1e-3 relative (the trajectory's bound) and its weights 2 x lr (one
Adam step turns a gradient that is zero up to rounding into +-lr); the
port's writer gives flax's bytes.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_vocoder_train import HOP, MELS, SR, _write_pp_dir, tiny_dcfg, tiny_gcfg

from zerovox_tpu.checkpoint import convert_hifigan_mpd, convert_hifigan_msd
from zerovox_tpu.models import hifigan as jh
from zerovox_tpu.training import vocoder as jv

from zerovox_tpu_torch.models import hifigan as ph
from zerovox_tpu_torch.training import vocoder as pv
from zerovox_tpu_torch.weights import (generator_from_jax_params, generator_to_jax_params,
                                       mpd_from_jax_variables, mpd_to_jax_variables,
                                       msd_from_jax_variables, msd_to_jax_variables)

PERIODS, SCALES = (2, 3), 2  # the JAX tests' discriminator variants


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_gcfg(cfg=None):
    g = cfg or tiny_gcfg()
    return ph.HifiGanConfig(**{k: getattr(g, k) for k in ph.HifiGanConfig.__dataclass_fields__})


def port_dcfg(segment_frames=8):
    d = tiny_dcfg(segment_frames)
    return pv.VocoderDataConfig(**{k: getattr(d, k) for k in pv.VocoderDataConfig.__dataclass_fields__})


def _close_rel(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(np.max(np.abs(want)), 1e-12)
    assert np.max(np.abs(got - want)) <= bound, (what, np.max(np.abs(got - want)), bound)


def _nchw(fm):
    """A JAX feature map (NHWC or NLC) in the port's layout (NCHW or NCL)."""
    a = np.asarray(fm)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a.transpose(0, 2, 1)


# --------------------------------------------------------- discriminators


@pytest.mark.parametrize("periods,scales", [(PERIODS, SCALES), ((2, 3, 5, 7, 11), 3)])
def test_discriminators_match_jax(periods, scales):
    """Logits and every feature map of MPD and MSD on the same weights (the
    JAX init carried over), at a 128-sample segment; the port's state_dict
    carries the upstream keys `convert_hifigan_mpd` / `convert_hifigan_msd`
    read."""
    rng = np.random.default_rng(len(periods))
    y = rng.uniform(-0.5, 0.5, (2, 128)).astype(np.float32)
    y_hat = rng.uniform(-0.5, 0.5, (2, 128)).astype(np.float32)
    for jnet, pnet, fwd, back, conv in (
            (jh.MultiPeriodDiscriminator(periods=periods), ph.MultiPeriodDiscriminator(periods),
             mpd_from_jax_variables, mpd_to_jax_variables,
             lambda sd: convert_hifigan_mpd(sd, periods)),
            (jh.MultiScaleDiscriminator(num_scales=scales), ph.MultiScaleDiscriminator(scales),
             msd_from_jax_variables, msd_to_jax_variables,
             convert_hifigan_msd if scales == 3 else None)):
        key = periods if isinstance(pnet, ph.MultiPeriodDiscriminator) else scales
        params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(0), y, y_hat)["params"])
        pnet.load_state_dict(fwd(params, key))
        back_tree = back(pnet.state_dict(), key)
        assert jax.tree.structure(back_tree) == jax.tree.structure(params)
        jax.tree.map(np.testing.assert_array_equal, back_tree, params)
        if conv is not None:
            jax.tree.map(np.testing.assert_array_equal, conv(pnet.state_dict()), params)
        want = jax.jit(jnet.apply)({"params": params}, y, y_hat)
        with torch.no_grad():
            got = pnet(torch.from_numpy(y), torch.from_numpy(y_hat))
        for g_list, w_list in zip(got[:2], want[:2]):  # logits
            assert len(g_list) == len(w_list) == len(key if isinstance(key, tuple) else range(key))
            for g, w in zip(g_list, w_list):
                _close_rel(g.numpy(), w, 1e-5, "logits")
        for g_list, w_list in zip(got[2:], want[2:]):  # feature maps
            for g_maps, w_maps in zip(g_list, w_list):
                assert len(g_maps) == len(w_maps)
                for g, w in zip(g_maps, w_maps):
                    _close_rel(g.numpy(), _nchw(w), 1e-5, "fmap")


def test_gan_losses_match_jax():
    rng = np.random.default_rng(1)
    outs = [[rng.normal(size=(3, n)).astype(np.float32) for n in (5, 9)] for _ in range(2)]
    fmaps = [[[rng.normal(size=(2, 4, n)).astype(np.float32) for n in (7, 3)] for _ in range(2)]
             for _ in range(2)]
    t = lambda tree: jax.tree.map(torch.from_numpy, tree)  # noqa: E731
    got, want = ph.discriminator_loss(t(outs[0]), t(outs[1])), jh.discriminator_loss(*outs)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    np.testing.assert_allclose([float(v) for v in got[1] + got[2]],
                               [float(v) for v in want[1] + want[2]], rtol=1e-6)
    got, want = ph.generator_loss(t(outs[1])), jh.generator_loss(outs[1])
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    np.testing.assert_allclose(float(ph.feature_loss(t(fmaps[0]), t(fmaps[1]))),
                               float(jh.feature_loss(*fmaps)), rtol=1e-6)


def test_avg_pool_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 37)).astype(np.float32)
    np.testing.assert_allclose(ph._avg_pool1d(torch.from_numpy(x)).numpy(),
                               np.asarray(jh._avg_pool1d(x, 4, 2, 2)), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------- data


def test_batched_logmel_matches_jax():
    wav = np.random.default_rng(3).uniform(-0.5, 0.5, (2, 16 * HOP)).astype(np.float32)
    want = np.asarray(jv.make_batched_logmel(tiny_dcfg(16))(jnp.asarray(wav)))
    got = pv.make_batched_logmel(port_dcfg(16))(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 16, MELS)
    _close_rel(got, want, 1e-5, "logmel")


def test_dataset_batches_match_jax_bitwise(tmp_path):
    """Two epochs of the same seed's batches, bitwise the JAX package's;
    `device_batches` bitwise `batches`; `skip_epochs` resumes the plan."""
    root = str(tmp_path / "pp")
    _write_pp_dir(root, n_items=5, n_frames=24, start_hop=2)
    jds = jv.VocoderDataset([root], tiny_dcfg(8), seed=7)
    pds = pv.VocoderDataset([root], port_dcfg(8), seed=7)
    dev = pv.VocoderDataset([root], port_dcfg(8), seed=7)
    assert len(pds) == len(jds) == 5 and pds.cache_nbytes() == jds.cache_nbytes()
    for _ in range(2):
        jb, pb, db = list(jds.batches(2)), list(pds.batches(2)), list(dev.device_batches(2, "cpu"))
        assert len(jb) == len(pb) == len(db) == 3
        for j, p, d in zip(jb, pb, db):
            for k in ("mel", "wav"):
                np.testing.assert_array_equal(p[k], j[k])
                assert d[k].dtype == torch.float32
                np.testing.assert_array_equal(d[k].numpy(), p[k])
    fresh, skipped = (pv.VocoderDataset([root], port_dcfg(8), seed=7) for _ in range(2))
    list(fresh.batches(2))
    skipped.skip_epochs(1, 2)
    for a, b in zip(skipped.batches(2), fresh.batches(2)):
        np.testing.assert_array_equal(a["wav"], b["wav"])


def test_dataset_h5_dir(tmp_path):
    h5py = pytest.importorskip("h5py")
    root = str(tmp_path / "h5")
    os.makedirs(root)
    rng = np.random.default_rng(0)
    with h5py.File(os.path.join(root, "a.h5"), "w") as h:
        h.create_dataset("feats", data=rng.normal(size=(30, MELS)))
        h.create_dataset("wave", data=rng.normal(size=(30 * HOP,)))
    ds, jds = pv.VocoderDataset([root], port_dcfg(8)), jv.VocoderDataset([root], tiny_dcfg(8))
    assert len(ds) == 1
    got, want = next(ds.batches(2)), next(jds.batches(2))
    np.testing.assert_array_equal(got["mel"], want["mel"])
    np.testing.assert_array_equal(got["wav"], want["wav"])


# ------------------------------------------------------------- GAN round


def _jax_recorder():
    """The same for optax: zero updates, the gradients kept as the state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), {"g": g}))


def _pair(tmp_path, n_items=4, batch=4):
    """A port trainer state, its weights as JAX variables and one batch."""
    root = str(tmp_path / "pp")
    if not os.path.exists(root):
        _write_pp_dir(root, n_items=n_items, n_frames=24)
    tcfg = pv.VocoderTrainerConfig(batch_size=batch, learning_rate=1e-3, mpd_periods=PERIODS,
                                   msd_scales=SCALES, out_folder=str(tmp_path / "out"))
    trainer = pv.VocoderTrainer(port_gcfg(), port_dcfg(8), tcfg, 1, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(5))
    gcfg = port_gcfg()
    jparams = {"g": generator_to_jax_params(state.gen.state_dict(), gcfg),
               "d": {"mpd": mpd_to_jax_variables(state.mpd.state_dict(), PERIODS),
                     "msd": msd_to_jax_variables(state.msd.state_dict(), SCALES)}}
    batch_np = next(pv.VocoderDataset([root], port_dcfg(8), seed=0).batches(batch))
    return trainer, state, jparams, batch_np


def _jax_state(jparams, tx_g, tx_d):
    g, d = jparams["g"], jparams["d"]
    return jv.VocoderTrainState(g_params=g, d_params=d, g_opt=tx_g.init(g), d_opt=tx_d.init(d),
                                step=jnp.zeros((), jnp.int32))


def _jax_step(tx_g, tx_d, precision="32"):
    """The JAX package's round, `make_vocoder_step(jit=False)`, under one
    jax.jit without donation (op by op it compiles each primitive anew:
    ~10x slower on the CPU, the same math)."""
    return jax.jit(jv.make_vocoder_step(
        jh.Generator(tiny_gcfg()), jh.MultiPeriodDiscriminator(periods=PERIODS),
        jh.MultiScaleDiscriminator(num_scales=SCALES), tx_g, tx_d,
        jv.make_batched_logmel(tiny_dcfg(8)), precision=precision, jit=False))


@pytest.fixture(scope="module")
def jax_round(tmp_path_factory):
    """The JAX package's fused round with recording optimizers, run once:
    its split round is the same math (the JAX package's own tests hold the
    two together), so the port's fused and split rounds are both held to
    it. Returns the dir `_pair` reads and the round's state and losses."""
    root = tmp_path_factory.mktemp("round")
    _, _, jparams, batch = _pair(root)
    rec = _jax_recorder()
    jstate, want = _jax_step(rec, rec)(_jax_state(jparams, rec, rec), batch)
    return root, jstate, want


@pytest.mark.parametrize("split", [False, True])
def test_gan_round_losses_and_gradients_match_jax(jax_round, split):
    root, jstate, want = jax_round
    trainer, state, _, batch = _pair(root)
    state.g_opt, state.d_opt = (pv.GradRecorder(state.gen.parameters()),
                                pv.GradRecorder([*state.mpd.parameters(), *state.msd.parameters()]))
    step = pv.make_vocoder_step(trainer.logmel, trainer.schedule, split=split)
    assert hasattr(step, "parts") == split
    got = step(state, pv.to_device_batch(batch, "cpu"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    assert state.step == int(jstate.step) == 1
    g_want = generator_from_jax_params(jax.device_get(jstate.g_opt["g"]), port_gcfg())
    for (name, _), g in zip(state.gen.named_parameters(), state.g_opt.grads):
        _close_rel(g.numpy(), g_want[name].numpy(), 1e-3, f"G {name}")
    d_want = {**{"mpd." + k: v for k, v in mpd_from_jax_variables(
        jax.device_get(jstate.d_opt["g"]["mpd"]), PERIODS).items()},
        **{"msd." + k: v for k, v in msd_from_jax_variables(
            jax.device_get(jstate.d_opt["g"]["msd"]), SCALES).items()}}
    names = [f"mpd.{n}" for n, _ in state.mpd.named_parameters()] + \
            [f"msd.{n}" for n, _ in state.msd.named_parameters()]
    for name, g in zip(names, state.d_opt.grads):
        _close_rel(g.numpy(), d_want[name].numpy(), 1e-3, f"D {name}")


def test_gan_trajectory_matches_jax(tmp_path):
    """Three rounds with the real optimizers: optax.adamw(b1 0.8, b2 0.99,
    weight decay 0.01) on optax's staircase exponential decay (one step an
    epoch, decay 0.9, so the rate moves every step)."""
    trainer, state, jparams, batch = _pair(tmp_path)
    sched_p = pv.exponential_decay_schedule(1e-3, 1, 0.9)
    step = pv.make_vocoder_step(trainer.logmel, sched_p)
    sched_j = optax.exponential_decay(1e-3, transition_steps=1, decay_rate=0.9, staircase=True)
    tx = optax.adamw(sched_j, b1=0.8, b2=0.99, weight_decay=0.01)
    jstep = _jax_step(tx, tx)
    jstate = _jax_state(jparams, tx, tx)
    for i in range(3):
        got = step(state, pv.to_device_batch(batch, "cpu"))
        jstate, want = jstep(jstate, batch)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3,
                                       err_msg=f"step {i} {k}")
    assert state.g_opt.count == state.d_opt.count == 3


def test_bf16_mixed_round_matches_jax(tmp_path):
    trainer, state, jparams, batch = _pair(tmp_path, batch=2)
    step = pv.make_vocoder_step(trainer.logmel, trainer.schedule, precision="bf16-mixed")
    got = step(state, pv.to_device_batch(batch, "cpu"))
    tx = optax.adamw(1e-3, b1=0.8, b2=0.99, weight_decay=0.01)
    _, want = _jax_step(tx, tx, precision="bf16-mixed")(_jax_state(jparams, tx, tx), batch)
    for k in want:
        assert np.isfinite(float(got[k])), k
        assert abs(float(got[k]) - float(want[k])) <= 5e-2 * max(1.0, abs(float(want[k]))), \
            (k, float(got[k]), float(want[k]))
    for p in state.gen.parameters():
        assert p.dtype == torch.float32  # float32 master weights


def test_optimizer_matches_optax():
    """vocoder_adamw + exponential_decay_schedule against optax.adamw on
    optax.exponential_decay over four updates of random gradients."""
    rng = np.random.default_rng(4)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    params = [torch.tensor(a, requires_grad=True) for a in p0]
    opt = pv.vocoder_adamw(params)
    sched = pv.exponential_decay_schedule(2e-3, 2, 0.5)
    tx = optax.adamw(optax.exponential_decay(2e-3, 2, 0.5, staircase=True), b1=0.8, b2=0.99,
                     weight_decay=0.01)
    jp = [jnp.asarray(a) for a in p0]
    js = tx.init(jp)
    for _ in range(4):
        grads = [rng.normal(size=a.shape).astype(np.float32) * 5 for a in p0]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        opt.step(sched(opt.count))
        upd, js = tx.update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, upd)
    for p, j in zip(params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


# -------------------------------------------------------- files and CLI


def test_generator_msgpack_across_packages(tmp_path):
    """Each package's `generator.msgpack` + config.json is a meldec dir the
    other package loads, with the same weights."""
    from zerovox_tpu.synthesize import ZeroVoxTTS as JaxTTS

    from zerovox_tpu_torch.synthesize import _load_meldec

    trainer, state, jparams, _ = _pair(tmp_path)
    out = str(tmp_path / "port_voc")
    trainer.save_generator(state, out)
    cfg, variables = JaxTTS._load_meldec(out)
    assert cfg.upsample_rates == tiny_gcfg().upsample_rates and cfg.num_mels == MELS
    jax.tree.map(np.testing.assert_array_equal, variables["params"]["generator"], jparams["g"])

    jcfg = jv.VocoderTrainerConfig(max_epochs=1, out_folder=str(tmp_path / "jax_out"),
                                   mpd_periods=PERIODS, msd_scales=SCALES)
    jtrainer = jv.VocoderTrainer(tiny_gcfg(), tiny_dcfg(8), jcfg, steps_per_epoch=1)
    # other weights than the port's: the port's, halved
    jstate = jv.VocoderTrainState(g_params=jax.tree.map(lambda a: a / 2, jparams["g"]),
                                  d_params=None, g_opt=None, d_opt=None,
                                  step=jnp.asarray(3, jnp.int32))
    jdir = str(tmp_path / "jax_voc")
    jtrainer.save_generator(jstate, jdir)
    pcfg, sd = _load_meldec(jdir, {}, False)
    assert pcfg == port_gcfg()
    want = generator_from_jax_params(jax.device_get(jstate.g_params), pcfg)
    for k, v in want.items():
        assert torch.equal(sd["generator." + k], v), k


def _cli_dir(root, n_items=3, n_frames=12):
    """A preprocess dir at the CLI's fixed hop (256) and sampling rate."""
    from zerovox_tpu_torch.dsp.audio import save_wav

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "wavs"))
    os.makedirs(os.path.join(root, "mel"))
    lines = []
    for i in range(n_items):
        t = np.arange(n_frames * 256) / 22050
        save_wav(os.path.join(root, "wavs", f"u{i}.wav"),
                 (0.4 * np.sin(2 * np.pi * (200 + 50 * i) * t)).astype(np.float32), 22050)
        np.save(os.path.join(root, "mel", f"mel-u{i}.npy"),
                rng.normal(size=(n_frames, 80)).astype(np.float32))
        lines.append(f"u{i}.wav|x")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def test_cli_trains_and_resumes_on_the_cpu(tmp_path):
    """`main` on the CPU: two epochs at batch 2 with a checkpoint each epoch,
    the generator loads back; `--checkpoint` of epoch 0 then replays epoch 1
    with the uninterrupted run's losses."""
    from zerovox_tpu_torch.cli import train_vocoder

    data = str(tmp_path / "pp")
    _cli_dir(data, n_items=2)
    gcfg = str(tmp_path / "gen.json")
    with open(gcfg, "w") as f:  # V1's rates at narrow widths and one short tower
        json.dump({"upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
                   "resblock_dilation_sizes": [[1]]}, f)
    common = ["--data", data, "--accelerator", "cpu", "--batch-size", "2", "--segment-frames",
              "2", "--generator-config", gcfg, "--checkpoint-every-n-epochs", "1"]
    out = str(tmp_path / "run")
    train_vocoder.main(common + ["--out-folder", out, "--max-epochs", "2"])
    with open(os.path.join(out, "losses.json")) as f:
        full = json.load(f)
    assert [r["epoch"] for r in full] == [0, 1]
    assert sorted(f for f in os.listdir(os.path.join(out, "checkpoints")) if f.endswith(".pt")) \
        == ["vocoder-0000.pt", "vocoder-0001.pt"]
    from zerovox_tpu_torch.synthesize import _load_meldec

    cfg, sd = _load_meldec(out, {}, False)
    assert cfg.upsample_initial_channel == 16 and "generator.conv_post.weight" in sd

    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    with open(os.path.join(resumed, "losses.json"), "w") as f:
        json.dump(full[:1], f)
    train_vocoder.main(common + ["--out-folder", resumed, "--max-epochs", "2", "--checkpoint",
                                 os.path.join(out, "checkpoints", "vocoder-0000.pt")])
    with open(os.path.join(resumed, "losses.json")) as f:
        again = json.load(f)
    assert [r["epoch"] for r in again] == [0, 1]
    for k, v in full[1].items():
        np.testing.assert_allclose(again[1][k], v, rtol=1e-5, err_msg=k)

    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_vocoder.main(["--data", data])


def test_cli_bench_row(tmp_path):
    """`--bench`'s row (`bench_step`) on the tiny nets: the step's FLOP
    counted, a positive median marginal step time; the H100's peaks by
    precision, and no MFU off the card (there is no peak of the CPU's to
    divide by)."""
    import argparse

    from zerovox_tpu_torch.cli import train_vocoder

    trainer, state, _, _ = _pair(tmp_path, batch=2)
    ds = pv.VocoderDataset([str(tmp_path / "pp")], port_dcfg(8), seed=0)
    args = argparse.Namespace(batch_size=2, segment_frames=8, precision="32", gan_step="fused",
                              bench_steps=2)
    row = train_vocoder.bench_step(args, trainer, ds, state)
    assert row["flops_per_step"] > 0 and row["ms_per_step"] > 0 and row["device"] == "cpu"
    assert train_vocoder.PEAK_FLOPS == {"32": 67e12, "bf16-mixed": 989e12}
    assert row["peak_flops"] is None and row["mfu_pct"] is None
    # the counted step, then each pair's chains of 1 and 2 steps, each after its warm steps
    assert state.step == 1 + train_vocoder.BENCH_PAIRS * (2 * train_vocoder.BENCH_WARM + 1 + 2)


# --------------------------------------------- the JAX trainer's resume file


@pytest.fixture(scope="module")
def jax_resume(tmp_path_factory):
    """The JAX trainer after one round with its real optimizers and its
    `vocoder-0000.msgpack`, then its next round; the port's trainer and the
    batch. One discriminator of each kind keeps the file small; the JAX
    trainer runs on one CPU device and starts from the port's initial
    weights (flax's init of the discriminators takes ~30 s op by op)."""
    from zerovox_tpu.parallel import mesh as jmesh

    tmp = tmp_path_factory.mktemp("resume")
    root = str(tmp / "pp")
    _write_pp_dir(root, n_items=4, n_frames=24)
    batch = next(pv.VocoderDataset([root], port_dcfg(8), seed=0).batches(4))
    trainer = pv.VocoderTrainer(port_gcfg(), port_dcfg(8), pv.VocoderTrainerConfig(
        learning_rate=1e-3, lr_decay=0.9, mpd_periods=(2,), msd_scales=1,
        out_folder=str(tmp / "port")), 1, device="cpu")
    init = trainer.init_state(torch.Generator().manual_seed(5))
    jt = jv.VocoderTrainer(tiny_gcfg(), tiny_dcfg(8), jv.VocoderTrainerConfig(
        learning_rate=1e-3, lr_decay=0.9, mpd_periods=(2,), msd_scales=1), steps_per_epoch=1,
        mesh=jmesh.make_mesh(jmesh.MeshConfig(data=1), devices=jax.devices()[:1]))
    jparams = {"g": generator_to_jax_params(init.gen.state_dict(), port_gcfg()),
               "d": {"mpd": mpd_to_jax_variables(init.mpd.state_dict(), (2,)),
                     "msd": msd_to_jax_variables(init.msd.state_dict(), 1)}}
    jstate, _ = jt._step(_jax_state(jparams, jt.tx_g, jt.tx_d), batch)
    path = jt.save_state(jstate, str(tmp / "jax"), 0)
    saved = jax.tree.map(np.array, jax.device_get(jstate))  # copies: the step donates its input
    jstate, want = jt._step(jstate, batch)
    return {"jt": jt, "path": path, "saved": saved, "next": jax.device_get(jstate),
            "want": {k: float(v) for k, v in want.items()}, "trainer": trainer, "batch": batch,
            "tmp": tmp}


def test_jax_msgpack_resume_continues_the_jax_run(jax_resume):
    from flax import serialization

    r = jax_resume
    trainer, host = r["trainer"], r["saved"]
    state = trainer.init_state()
    assert trainer.restore_state(state, r["path"]) == 1  # the epoch after the file's
    assert state.step == state.g_opt.count == state.d_opt.count == 1
    g = generator_from_jax_params(host.g_params, port_gcfg())
    for n, p in state.gen.named_parameters():
        assert torch.equal(p.detach(), g[n]), n
    mu = generator_from_jax_params(host.g_opt[0].mu, port_gcfg())
    nu = msd_from_jax_variables(host.d_opt[0].nu["msd"], 1)
    k = sum(1 for _ in state.mpd.parameters())
    for (n, _), m in zip(state.gen.named_parameters(), state.g_opt.mu):
        assert torch.equal(m, mu[n]), n
    for (n, _), v in zip(state.msd.named_parameters(), state.d_opt.nu[k:]):
        assert torch.equal(v, nu[n]), n

    # the next round, against the JAX package's
    got = trainer.train_step(state, r["batch"])
    for key, v in r["want"].items():
        np.testing.assert_allclose(float(got[key]), v, rtol=1e-3, err_msg=key)
    g = generator_from_jax_params(r["next"].g_params, port_gcfg())
    for n, p in state.gen.named_parameters():
        assert (p.detach() - g[n]).abs().max() <= 2 * 1e-3 * 0.9, n

    # the port's file of this state is flax's bytes of it, as the JAX trainer reads it
    out = trainer.save_jax_state(state, str(r["tmp"] / "port"), 1)
    with open(out, "rb") as f:
        blob = f.read()
    restored = jax.device_get(r["jt"].restore_state(r["next"], out))
    assert serialization.to_bytes(restored) == blob
    with open(out + ".json") as f:
        assert int(restored.step) == 2 and json.load(f) == {"epoch": 1}
    g = generator_from_jax_params(restored.g_params, port_gcfg())
    for n, p in state.gen.named_parameters():
        assert torch.equal(p.detach(), g[n]), n


def test_inverse_writer_gives_the_jax_files_bytes(jax_resume, tmp_path):
    trainer, path = jax_resume["trainer"], jax_resume["path"]
    state = trainer.init_state()
    trainer.restore_state(state, path)
    out = trainer.save_jax_state(state, str(tmp_path / "port"), 0)
    with open(path, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()


def test_count_mismatch_raises(jax_resume, tmp_path):
    from zerovox_tpu_torch.utils.msgpack_codec import packb, unpackb

    trainer, path = jax_resume["trainer"], jax_resume["path"]
    with open(path, "rb") as f:
        tree = unpackb(f.read())
    tree["d_opt"]["2"]["count"] = np.asarray(5, np.int32)
    bad = str(tmp_path / "bad.msgpack")
    with open(bad, "wb") as f:
        f.write(packb(tree, sort_keys=False))
    with open(bad + ".json", "w") as f:
        json.dump({"epoch": 0}, f)
    with pytest.raises(ValueError, match="d_opt's Adam count 1 is not its schedule's 5"):
        trainer.restore_state(trainer.init_state(), bad)
