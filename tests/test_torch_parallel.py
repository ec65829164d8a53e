"""Data parallelism (`zerovox_tpu_torch/parallel/`) on the CPU against the
JAX package's mesh: two gloo ranks, spawned once for the module with a file
store (`parallel.mesh.spawn`; their bodies are tests/torch_parallel_ranks.py),
each on its half of the batch, against the JAX step on a 2-device CPU mesh
(`make_mesh(MeshConfig(data=2), devices=jax.devices()[:2])`) on the same
weights and the whole batch. The ranks run while this process computes the
JAX references.

The acoustic step runs at tiny widths with the fused speaker stage 1
(`se_conv_plain` on the CPU; the JAX package's Pallas kernel in interpret
mode) and every dropout rate 0, on a batch whose halves hold different
numbers of valid frames and phones (rows of 6, 9 | 18, 20 phones). Float32
bounds as tests/test_torch_train.py's: losses 1e-4 relative, gradients 1e-4
x each tensor's max (a gradient that is zero up to rounding against 1e-3 x
the model's largest), BatchNorm running statistics 1e-5. bf16-mixed bounds
as tests/test_torch_bf16.py's, against the JAX package's bf16-mixed step on
the same mesh: losses 5e-2 relative, the running statistics 5e-2 x each
tensor's max, and the gradients of each group (the speaker encoder; the
rest) in aggregate, ||port - jax|| / ||jax||, within 1.5 x the JAX
package's own bf16-to-float32 distance of the group on this batch (bf16
rounding alone moves single gradients by 10-50 %). In both precisions a
rank that took the means over its own shard (DDP's average of per-rank
means), or the BatchNorm statistics of its own shard, misses those bounds
on this batch.

The GAN round (one discriminator of each kind): losses 1e-4 relative,
gradients 1e-3 x each tensor's max (tests/test_torch_vocoder_train.py's
bounds). Serving: `tts_batch` over two CPU replicas with B=3 padded to 4,
against the JAX package's `tts_batch` on a 2-device mesh within 1e-3 (the
waveform bound), and against the port without a mesh: bitwise on a
one-device mesh (the same shapes), and within 1e-5 of the peak on two
replicas, whose shards run at batch 2 where the engine runs 3: the CPU's
BLAS rounds an M-row product by M (4e-8 to 1.3e-6 measured, 1.1e-6 of the
peak on this engine).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import N_MELS, cfg_dict
from test_torch_vocoder_train import _jax_recorder, port_dcfg, port_gcfg
from test_vocoder_train import _write_pp_dir, tiny_dcfg, tiny_gcfg

import zerovox_tpu.config as jc
from zerovox_tpu.checkpoint import convert_zerovox_state_dict
from zerovox_tpu.models.hifigan import HifiGanConfig as JaxHifiGanConfig
from zerovox_tpu.parallel import mesh as jmesh
from zerovox_tpu.synthesize import ZeroVoxTTS as JaxTTS
from zerovox_tpu.training import trainer as jtrainer
from zerovox_tpu.training import vocoder as jv

import torch_parallel_ranks as ranks
import zerovox_tpu_torch.config as pc
from zerovox_tpu_torch.models.hifigan import HifiGanConfig
from zerovox_tpu_torch.models.zerovox import ZeroVox
from zerovox_tpu_torch.parallel import mesh as pmesh
from zerovox_tpu_torch.synthesize import ZeroVoxTTS, random_init_
from zerovox_tpu_torch.training import data as pdata
from zerovox_tpu_torch.training import trainer as ptrainer
from zerovox_tpu_torch.training import vocoder as pv
from zerovox_tpu_torch.weights import (from_jax_variables, generator_from_jax_params,
                                       generator_to_jax_params, meldec_to_jax_variables,
                                       mpd_from_jax_variables, mpd_to_jax_variables,
                                       msd_from_jax_variables, msd_to_jax_variables,
                                       to_jax_variables)

PHONES_PER_ROW = (6, 9, 18, 20)  # rank 0: 15 phones, rank 1: 38
PRECISIONS = ("32", "bf16-mixed")
VARIANTS = ("global", "per_rank_means", "per_rank_bn")
PERIODS, SCALES = (2,), 1  # the GAN round's discriminators


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh2():
    return jmesh.make_mesh(jmesh.MeshConfig(data=2), devices=jax.devices()[:2])


def _spawn_async(fn, tmp, *args):
    """fn on two gloo ranks in a thread, so that they run while this
    process computes the references; returns `results(what)`, which waits
    for the ranks and loads their `tmp/<what>{r}.pt`."""
    errors = []

    def run():
        try:
            pmesh.spawn(fn, 2, *args, str(tmp), devices=["cpu"] * 2)
        except BaseException as e:  # re-raised in the test's thread
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()

    def results(what: str) -> list:
        thread.join()
        if errors:
            raise errors[0]
        return [torch.load(tmp / f"{what}{r}.pt", weights_only=False) for r in range(2)]

    return results


def _copies(tree: dict) -> dict:
    """Clones of a (nested) dict's tensors for the ranks: passing a tensor to
    a spawned process moves its storage into shared memory, from under the
    numpy views that this process's conversions still read."""
    return {k: _copies(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _batch() -> dict:
    """Four utterances, the short two in rank 0's half."""
    rng = np.random.default_rng(0)
    items = []
    for i, L in enumerate(PHONES_PER_ROW):
        dur = rng.integers(2, 8, size=L).astype(np.int64)
        T = int(dur.sum())
        items.append({"phoneme": rng.integers(1, 28, size=L), "puncts": rng.integers(0, 10, size=L),
                      "pitch": rng.uniform(0, 1, L).astype(np.float32),
                      "energy": rng.uniform(0, 1, L).astype(np.float32), "duration": dur,
                      "mel": rng.normal(size=(T, N_MELS)).astype(np.float32), "text": f"t{i}",
                      "basename": f"u{i}", "preprocessed_path": "p", "start_hop": 0, "end_hop": T})
    x, y = pdata.collate(items, np.random.default_rng(1), ref_mel_len=64)
    return {**x, **y}


def _jax_acoustic_step(cfg: dict, variables: dict, batch: dict, precision: str) -> dict:
    """The JAX trainer's step over the 2-device mesh with a recording
    optimizer (its state is the gradients): losses, gradients and the
    running statistics in the port's names."""
    jcfg = jc.ZeroVoxConfig.from_dict(cfg)
    pcfg = pc.ZeroVoxConfig.from_dict(cfg)
    jb = jtrainer.device_batch(batch)
    mesh = _jax_mesh2()
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(max_epochs=1, warmup_epochs=1, batch_size=4,
                                                       seed=0, precision=precision),
                          steps_per_epoch=1, mesh=mesh)
    jt.tx = _jax_recorder()
    jstate = jt.init_state(jb, init_variables=variables)
    jstate, jlosses = jt._train_step(jstate, jmesh.shard_batch(jb, mesh), jax.random.PRNGKey(0))
    buffers = from_jax_variables({"params": jax.device_get(jstate.params),
                                  "batch_stats": jax.device_get(jstate.batch_stats)}, pcfg)
    return {"losses": {k: float(v) for k, v in jlosses.items()},
            "grads": from_jax_variables({"params": jax.device_get(jstate.opt_state["g"]),
                                         "batch_stats": variables["batch_stats"]}, pcfg),
            "buffers": {n: b for n, b in buffers.items() if "running" in n}}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One spawn of two ranks for the module: the acoustic step in every
    (variant, precision) and one GAN round; meanwhile the JAX package's
    steps on the 2-device mesh, on the same weights and batches."""
    cfg = cfg_dict(True)
    model = ZeroVox(pc.ZeroVoxConfig.from_dict(cfg))
    random_init_(model, torch.Generator().manual_seed(2))
    sd = model.state_dict()
    batch = _batch()

    tmp = tmp_path_factory.mktemp("ranks")
    root = str(tmp / "pp")
    _write_pp_dir(root, n_items=4, n_frames=24)
    vbatch = next(pv.VocoderDataset([root], port_dcfg(8), seed=0).batches(4))
    tcfg = pv.VocoderTrainerConfig(batch_size=4, learning_rate=1e-3, mpd_periods=PERIODS,
                                   msd_scales=SCALES, out_folder=str(tmp / "out"))
    vstate = pv.VocoderTrainer(port_gcfg(), port_dcfg(8), tcfg, 1, device="cpu").init_state(
        torch.Generator().manual_seed(5))
    nets = {k: getattr(vstate, k).state_dict() for k in ("gen", "mpd", "msd")}

    jobs = tuple((v, p) for p in PRECISIONS for v in VARIANTS)
    results = _spawn_async(ranks.steps, tmp, (cfg, _copies(sd), batch, jobs),
                           (port_gcfg(), port_dcfg(8), tcfg, _copies(nets), vbatch))

    variables = convert_zerovox_state_dict(sd, jc.ZeroVoxConfig.from_dict(cfg))
    want = {p: _jax_acoustic_step(cfg, variables, batch, p) for p in PRECISIONS}

    rec = _jax_recorder()
    mesh = _jax_mesh2()
    jt = jv.VocoderTrainer(tiny_gcfg(), tiny_dcfg(8),
                           jv.VocoderTrainerConfig(mpd_periods=PERIODS, msd_scales=SCALES), 1,
                           mesh=mesh)
    step = jv.make_vocoder_step(jt.gen, jt.mpd, jt.msd, rec, rec, jt._logmel)
    g = generator_to_jax_params(nets["gen"], port_gcfg())
    d = {"mpd": mpd_to_jax_variables(nets["mpd"], PERIODS),
         "msd": msd_to_jax_variables(nets["msd"], SCALES)}
    jstate = jmesh.replicate(jv.VocoderTrainState(
        g_params=g, d_params=d, g_opt=rec.init(g), d_opt=rec.init(d),
        step=jnp.zeros((), jnp.int32)), mesh)
    jstate, vlosses = step(jstate, jmesh.shard_batch(vbatch, mesh))
    mpd = mpd_from_jax_variables(jax.device_get(jstate.d_opt["g"]["mpd"]), PERIODS)
    msd = msd_from_jax_variables(jax.device_get(jstate.d_opt["g"]["msd"]), SCALES)
    gen = generator_from_jax_params(jax.device_get(jstate.g_opt["g"]), port_gcfg())
    vwant = {"losses": {k: float(v) for k, v in vlosses.items()},
             "g_grads": [gen[n] for n, _ in vstate.gen.named_parameters()],
             "d_grads": ([mpd[n] for n, _ in vstate.mpd.named_parameters()]
                         + [msd[n] for n, _ in vstate.msd.named_parameters()])}
    return {"want": want, "got": results("acoustic"), "vwant": vwant,
            "vgot": results("vocoder")}


# ---------------------------------------------------------- acoustic step


def _misses(got: dict, want: dict) -> dict:
    """Each float32 quantity's largest gap over its bound (> 1 misses)."""
    loss = max(abs(got["losses"][k] - v) / (1e-4 * abs(v)) for k, v in want["losses"].items())
    floor = 1e-3 * max(want["grads"][n].abs().max().item() for n in got["grads"])
    grad = max(((g - want["grads"][n]).abs().max()
                / (1e-4 * max(want["grads"][n].abs().max().item(), floor))).item()
               for n, g in got["grads"].items())
    bn = max((got["buffers"][n] - b).abs().max().item() / 1e-5 for n, b in want["buffers"].items())
    return {"loss": loss, "grad": grad, "bn": bn}


def _dist(a: dict, b: dict, names: list) -> float:
    """||a - b|| / ||b|| over the named tensors."""
    num = sum(float(((a[n] - b[n]) ** 2).sum()) for n in names)
    return (num / sum(float((b[n] ** 2).sum()) for n in names)) ** 0.5


def _misses16(got: dict, want16: dict, want32: dict) -> dict:
    """Each bf16-mixed quantity's gap over its bound (> 1 misses)."""
    loss = max(abs(got["losses"][k] - v) / (5e-2 * abs(v)) for k, v in want16["losses"].items())
    spk = [n for n in got["grads"] if n.startswith("_spkemb.")]
    groups = {"grad_spk": spk, "grad_rest": [n for n in got["grads"] if n not in spk]}
    out = {"loss": loss}
    for key, names in groups.items():
        out[key] = (_dist(got["grads"], want16["grads"], names)
                    / (1.5 * _dist(want16["grads"], want32["grads"], names)))
    out["bn"] = max((got["buffers"][n] - b).abs().max().item() / (5e-2 * b.abs().max().item())
                    for n, b in want16["buffers"].items())
    return out


def test_two_rank_step_matches_the_jax_mesh_step(spawned):
    want, got = spawned["want"]["32"], spawned["got"]
    r0, r1 = (r[("global", "32")] for r in got)
    assert r0["rows"] == r1["rows"] == 2
    assert set(r0["losses"]) == set(want["losses"])
    misses = _misses(r0, want)
    assert all(v <= 1 for v in misses.values()), misses
    # every rank ends the step with the same weights and statistics
    for key in ("params", "buffers", "grads"):
        for n, v in r0[key].items():
            assert torch.equal(v, r1[key][n]), (key, n)


def test_per_rank_means_or_statistics_would_miss(spawned):
    """The test's teeth: the halves hold 15 and 38 phones, so DDP's average
    of per-rank means, or per-rank BatchNorm statistics, give another step."""
    want, got = spawned["want"]["32"], spawned["got"]
    means = _misses(got[0][("per_rank_means", "32")], want)
    assert means["loss"] > 1 and means["grad"] > 1, means
    bn = _misses(got[0][("per_rank_bn", "32")], want)
    assert bn["bn"] > 1 and bn["grad"] > 1, bn


def test_two_rank_bf16_mixed_step(spawned):
    want, got = spawned["want"], spawned["got"]
    r0, r1 = (r[("global", "bf16-mixed")] for r in got)
    misses = _misses16(r0, want["bf16-mixed"], want["32"])
    assert all(v <= 1 for v in misses.values()), misses
    for n, v in r0["params"].items():
        assert v.dtype == torch.float32 and torch.equal(v, r1["params"][n]), n
        assert r0["grads"][n].dtype == torch.float32 and torch.equal(r0["grads"][n],
                                                                     r1["grads"][n]), n
    for n, v in r0["buffers"].items():
        assert v.dtype == torch.float32 and torch.equal(v, r1["buffers"][n]), n


def test_per_rank_variants_miss_in_bf16_mixed(spawned):
    """The bf16-mixed bounds have teeth too: per-rank means move both
    gradient groups past theirs (their losses stay within 5e-2: both shards'
    per-frame losses are alike on this batch), and per-rank statistics move
    the running statistics and the speaker encoder's gradients."""
    want, got = spawned["want"], spawned["got"]
    means = _misses16(got[0][("per_rank_means", "bf16-mixed")], want["bf16-mixed"], want["32"])
    assert means["grad_spk"] > 1 and means["grad_rest"] > 1, means
    bn = _misses16(got[0][("per_rank_bn", "bf16-mixed")], want["bf16-mixed"], want["32"])
    assert bn["bn"] > 1 and bn["grad_spk"] > 1, bn


# ---------------------------------------------------------------- GAN round


def test_two_rank_gan_round_matches_the_jax_mesh(spawned):
    want, got = spawned["vwant"], spawned["vgot"]
    for k, v in want["losses"].items():
        for r in got:
            assert abs(r["losses"][k] - v) <= 1e-4 * abs(v), k
    for key in ("g_grads", "d_grads"):
        assert len(got[0][key]) == len(want[key])
        for g, w in zip(got[0][key], want[key]):
            assert (g - w).abs().max() <= 1e-3 * w.abs().max()
    for a, b in zip(got[0]["g_grads"] + got[0]["d_grads"], got[1]["g_grads"] + got[1]["d_grads"]):
        assert torch.equal(a, b)


# ------------------------------------------------------------- serving mesh

HCFG = dict(resblock="1", upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
            upsample_initial_channel=32, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3, 5),))
TEXTS = ["Hello world.", "This is a somewhat longer sentence for the batch.", "Short one"]


def _engine_cfg(mod):
    return mod.ZeroVoxConfig(model=mod.ModelConfig(
        max_txt_len=64, max_mel_len=256, emb_dim=48, punct_emb_dim=16,
        encoder=mod.EncoderConfig(fs2_layer=1, fs2_head=2, vp_filter_size=16, ve_n_bins=16),
        decoder=mod.DecoderConfig(kind="fastspeech2", n_layers=1, n_head=2, conv_filter_size=64),
        resnet=mod.ResNetConfig(layers=(1, 1, 1, 1), num_filters=(8, 16, 16, 16))))


def _close(got, want, tol):
    assert got.shape == want.shape and np.all(np.isfinite(got))
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err <= tol, err


@pytest.mark.parametrize("model", [1, 2])
def test_tts_batch_over_a_serving_mesh(model):
    """A data x model serving mesh (model 2: four CPU devices) keeps its
    replicas on the data axis, as the JAX engine replicates its weights
    over `model` and splits its rows over `data`."""
    # the port's seeded weights on both sides (the JAX `from_random` jits
    # flax's init of both models: ~20 s on the CPU)
    single = ZeroVoxTTS.from_random(_engine_cfg(pc), HifiGanConfig(**HCFG), seed=0, device="cpu")
    sds = single.state_dicts()
    jax_tts = JaxTTS(_engine_cfg(jc), to_jax_variables(sds[0], single.cfg),
                     JaxHifiGanConfig(**HCFG),
                     meldec_to_jax_variables(sds[1], HifiGanConfig(**HCFG)),
                     mesh=jmesh.make_mesh(jmesh.MeshConfig(data=2, model=model),
                                          devices=jax.devices()[:2 * model]))
    two = ZeroVoxTTS(single.cfg, sds[0], HifiGanConfig(**HCFG), sds[1],
                     mesh=pmesh.make_mesh(pmesh.MeshConfig(data=2, model=model),
                                          devices=["cpu"] * (2 * model)))
    one = ZeroVoxTTS(single.cfg, sds[0], HifiGanConfig(**HCFG), sds[1], device="cpu",
                     mesh=pmesh.make_mesh(devices=["cpu"]))
    assert two.device.type == "cpu" and len(two._replicas) == 2

    rng = np.random.default_rng(1)
    spk = rng.normal(size=(3, 1, single.cfg.model.emb_size)).astype(np.float32)
    spk /= np.linalg.norm(spk, axis=-1, keepdims=True)
    durs = [np.full(len(single.text2phonemeids(t)[0]), 3, np.int32) for t in TEXTS]
    for d in (durs, None):
        ref = single.tts_batch(TEXTS, spk, durations=d)
        got = two.tts_batch(TEXTS, spk, durations=d)
        assert len(got) == 3 and [n for _, n in got] == [n for _, n in ref]
        for (w, _), (r, _) in zip(got, ref):
            _close(w, r, 1e-5 * max(np.max(np.abs(r)), 1e-3))
        for (w, n), (r, m) in zip(one.tts_batch(TEXTS, spk, durations=d), ref):
            assert n == m and np.array_equal(w, r)

    want = jax_tts.tts_batch(TEXTS, spk, durations=durs)
    got = two.tts_batch(TEXTS, spk, durations=durs)
    for (w, n), (r, m) in zip(got, want):
        assert n == m
        _close(w, np.asarray(r), min(1e-3, 1e-3 * max(np.max(np.abs(r)), 1e-3)))
    # B = 1 does not shard: the single-utterance path runs on the first device
    wav, _, n = two.tts(TEXTS[0], spk[:1])
    assert wav.shape == (n * two.cfg.audio.hop_size,)


# ------------------------------------------------------------------- raises


def test_what_the_mesh_refuses(monkeypatch):
    with pytest.raises(ValueError, match="does not cover 2 devices"):
        pmesh.make_mesh(pmesh.MeshConfig(data=3), devices=["cpu", "cpu"])
    square = pmesh.make_mesh(pmesh.MeshConfig(data=2, model=2), devices=["cpu"] * 4)
    assert square.shape == {"data": 2, "model": 2} and len(square.data_devices) == 2
    with pytest.raises(ValueError, match="mesh 2x2 does not cover 2 devices"):
        pmesh.make_mesh(pmesh.MeshConfig(data=2, model=2), devices=["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--devices 2: only 1 CUDA device"):
        pmesh.device_count(2, "cuda")
    from zerovox_tpu_torch.cli import train_vocoder

    with pytest.raises(RuntimeError, match="--devices 2: only 1 CUDA device"):
        train_vocoder.main(["--data", "unused", "--devices", "2"])
    assert pmesh.device_count(-1, "cuda") == 1 and pmesh.device_count(3, "cpu") == 3

    two = pmesh.make_mesh(pmesh.MeshConfig(data=2), devices=["cpu", "cpu"])
    assert two.shape == {"data": 2, "model": 1} and two.world == 1 and two.rank == 0
    with pytest.raises(ValueError, match="one process a device"):
        ptrainer.Trainer(pc.ZeroVoxConfig.from_dict(cfg_dict(True)), ptrainer.TrainerConfig(),
                         steps_per_epoch=1, mesh=two)

    class NoData:
        axis_names = ("model",)

    with pytest.raises(ValueError, match="'data' axis"):
        ZeroVoxTTS.from_random(_engine_cfg(pc), HifiGanConfig(**HCFG), mesh=NoData())
    # without a process group a batch stays whole
    batch = {"mel": np.zeros((4, 3)), "text": ["a", "b", "c", "d"]}
    assert pmesh.shard_batch(batch, two) is batch


def test_mesh_defaults_need_the_card(monkeypatch, tmp_path):
    """Without a card the defaults raise, as every entry point's: the CPU
    and gloo only where the caller names the CPU."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.initialize_distributed(coordinator_address=f"file://{tmp_path}/store",
                                     num_processes=1, process_id=0)
    assert not dist.is_initialized()
    assert pmesh.make_mesh(devices=["cpu"]).devices == (torch.device("cpu"),)


def test_spawn_without_devices_needs_the_cards(monkeypatch):
    """spawn with no devices puts rank r on cuda:r: without enough cards it
    raises before it starts any process; CPU ranks are asked for by name."""
    import torch.multiprocessing as mp

    started = []
    monkeypatch.setattr(mp, "start_processes", lambda *a, **k: started.append(1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="only 0 CUDA device"):
        pmesh.spawn(_mesh_rank_noop, 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="only 1 CUDA device"):
        pmesh.spawn(_mesh_rank_noop, 2)
    assert not started
    pmesh.spawn(_mesh_rank_noop, 2, devices=["cpu"] * 2)
    assert started == [1]


def _mesh_rank_noop(rank: int) -> None:
    pass
