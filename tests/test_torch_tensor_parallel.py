"""Tensor parallelism (the `model` axis, `zerovox_tpu_torch/parallel/tensor.py`)
on the CPU against the JAX package's data x model mesh.

Layout: `parallel.mesh.param_sharding_rules` splits the leaves that the JAX
`param_sharding_rules` shards, on the mapped axes (the JAX last axis is a
torch weight's axis 0, the JAX axis -2 its axis 1), for tests/test_mesh.py's
`tiny_cfg` and its StyleTTS-decoder variant at model 2 and 4. Each port
parameter is filled with its index and its position along the rule's axis,
carried through `weights.to_jax_variables`, and found again in the JAX tree.

Steps: four gloo ranks spawned once as a 2 x 2 mesh (their bodies in
tests/torch_tensor_parallel_ranks.py; they run while this process computes
the JAX references) on tests/test_torch_parallel.py's acoustic
configuration and batch (fused speaker stage 1, rows of 6, 9 | 18, 20
phones), against the JAX `Trainer` on `make_mesh(MeshConfig(data=2,
model=2), jax.devices()[:4])` on the same weights, dropout 0, with the real
optimizer (its gradients recorded before it): two float32 steps with
losses 1e-4 relative, gradients 1e-4 x each tensor's max (1e-3 x the
model's largest as the floor), Adam's second moments twice that (a square
of the gradient, floor 1e-3 x the largest) and the BatchNorm running
statistics 1e-5 (that file's bounds); bf16-mixed at its bf16 bounds. The
gradients and moments of the split leaves are gathered over the model axis
first. The clip binds on this batch (its global norm is ~75 against 1.0).
Three controls must miss those bounds: the row-parallel sum through
`all_reduce_sum` (its backward sums the cotangent over the model ranks),
BatchNorm and loss sums over the world in place of `data_group`, and the
clip's norm over the local blocks only.

Runs without a JAX counterpart are held to the port's own 2-rank
data-parallel step (the ranks of one model index, over their `data_group`,
which tests/test_torch_parallel.py holds to the JAX package) at the float32
bounds: one head at model 2 (q, k and v gathered, every rank running every
head), dropout on (masks drawn by data index), a checkpoint written under
2 x 2 resumed on the data-parallel mesh and the reverse, and one GAN round
(the nets replicated over `model`). Replicated parameters are bitwise equal
on all four ranks, split blocks on the ranks of one model index.
"""

import copy
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from test_mesh import tiny_cfg
from test_torch_parallel import _batch, _copies, _misses16
from test_torch_train import cfg_dict
from test_torch_vocoder_train import port_dcfg, port_gcfg

import zerovox_tpu.config as jc
from zerovox_tpu.checkpoint import convert_zerovox_state_dict
from zerovox_tpu.parallel import mesh as jmesh
from zerovox_tpu.training import trainer as jtrainer

import torch_tensor_parallel_ranks as ranks
import zerovox_tpu_torch.config as pc
from zerovox_tpu_torch.models.zerovox import ZeroVox
from zerovox_tpu_torch.parallel import mesh as pmesh
from zerovox_tpu_torch.synthesize import random_init_
from zerovox_tpu_torch.training import vocoder as pv
from zerovox_tpu_torch.weights import from_jax_variables, to_jax_variables

PRECISIONS = ("32", "bf16-mixed")
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- layout


def _tiny_dict() -> dict:
    return {
        "audio": {"num_mels": 20},
        "model": {
            "max_txt_len": 32, "max_mel_len": 64, "emb_dim": 48, "punct_emb_dim": 16,
            "encoder": {"fs2_layer": 1, "fs2_head": 2, "vp_filter_size": 8, "ve_n_bins": 8},
            "decoder": {"kind": "fastspeech2", "n_layers": 1, "n_head": 2,
                        "conv_filter_size": 64},
            "resnet": {"layers": [1, 1, 1, 1], "num_filters": [8, 8, 8, 8]},
        },
    }


def _jax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _jax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("decoder", ["fastspeech2", "styletts"])
def test_the_rule_splits_the_jax_rules_leaves(decoder, model):
    d = _tiny_dict()
    d["model"]["decoder"]["kind"] = decoder
    if decoder == "fastspeech2":  # the same configuration as tests/test_mesh.py's
        assert jc.ZeroVoxConfig.from_dict(d) == tiny_cfg()
    pcfg = pc.ZeroVoxConfig.from_dict(d)
    port = ZeroVox(pcfg)
    rule = pmesh.param_sharding_rules(port, model)
    names = [n for n, _ in port.named_parameters()]
    sd = port.state_dict()
    for i, n in enumerate(names):
        p, axis = sd[n], rule[n]
        pos = torch.zeros(p.shape)
        if axis is not None:
            shape = [1] * p.dim()
            shape[axis] = p.shape[axis]
            pos = pos + torch.arange(p.shape[axis], dtype=torch.float32).view(shape)
        sd[n] = (i + 1) * 1000.0 + pos
    params = to_jax_variables(sd, pcfg)["params"]
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=1, model=model), devices=jax.devices()[:model])
    specs = dict(_jax_leaves(jax.tree.map(lambda s: s.spec, jmesh.param_sharding_rules(params, mesh),
                                          is_leaf=lambda s: hasattr(s, "spec"))))
    seen = set()
    for path, leaf in _jax_leaves(params):
        leaf = np.asarray(leaf)
        name = names[int(leaf.flat[0] // 1000) - 1]
        seen.add(name)
        varying = [a for a in range(leaf.ndim) if leaf.shape[a] > 1
                   and not np.all(np.diff(leaf, axis=a) == 0)]
        spec = tuple(specs[path])
        want = [a for a, s in enumerate(spec) if s == "model"]
        if rule[name] is None:
            assert not want, (path, name, spec)
        else:
            assert want == varying and len(want) == 1, (path, name, spec, varying)
    assert seen == set(names)
    split = [n for n in names if rule[n] is not None]
    assert any(".w_1." in n for n in split) and any("se.fc" in n for n in split)
    if decoder == "styletts":
        assert any(".norm1.fc." in n for n in split)


# ------------------------------------------------------------------ steps


def _recording(tx):
    """tx, with the gradients it receives kept in its state ("g")."""
    def init(params):
        return {"g": jax.tree.map(jax.numpy.zeros_like, params), "inner": tx.init(params)}

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state["inner"], params)
        return updates, {"g": grads, "inner": inner}

    return optax.GradientTransformation(init, update)


def _nu(opt_state):
    return next(s.nu for s in opt_state["inner"] if hasattr(s, "nu"))


def _jax_steps(cfg: dict, variables: dict, batch: dict, precision: str) -> list[dict]:
    """STEPS steps of the JAX trainer on the 2 x 2 mesh: each step's
    losses, gradients, second moments and running statistics in the port's
    names, and the gradients' global norm."""
    jcfg = jc.ZeroVoxConfig.from_dict(cfg)
    pcfg = pc.ZeroVoxConfig.from_dict(cfg)
    jb = jtrainer.device_batch(batch)
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=2, model=2), devices=jax.devices()[:4])
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(max_epochs=1, warmup_epochs=1, batch_size=4,
                                                       seed=0, precision=precision),
                          steps_per_epoch=1, mesh=mesh)
    jt.tx = _recording(jt.tx)
    jstate = jt.init_state(jb, init_variables=variables)
    # every leaf on the mesh (the optimizer's counts start on one device),
    # and each step's state put back onto that placement: the jitted step
    # then compiles once
    whole = NamedSharding(mesh, P())
    jstate = jax.tree.map(lambda x: x if len(x.sharding.device_set) > 1
                          else jax.device_put(x, whole), jstate)
    placement = jax.tree.map(lambda x: x.sharding, jstate)
    out = []
    for _ in range(STEPS):
        jstate, jlosses = jt._train_step(jstate, jmesh.shard_batch(jb, mesh),
                                         jax.random.PRNGKey(0))
        jstate = jax.device_put(jstate, placement)
        g = jax.device_get(jstate.opt_state["g"])
        stats = {"params": jax.device_get(jstate.params),
                 "batch_stats": jax.device_get(jstate.batch_stats)}
        buffers = from_jax_variables(stats, pcfg)
        out.append({"losses": {k: float(v) for k, v in jlosses.items()},
                    "grads": from_jax_variables({"params": g, "batch_stats": stats["batch_stats"]},
                                                pcfg),
                    "nu": from_jax_variables({"params": jax.device_get(_nu(jstate.opt_state)),
                                              "batch_stats": stats["batch_stats"]}, pcfg),
                    "buffers": {n: b for n, b in buffers.items() if "running" in n},
                    "norm": float(optax.global_norm(g))})
    return out


def _cfgs() -> dict:
    base = cfg_dict(True)
    one = copy.deepcopy(base)
    one["model"]["encoder"]["fs2_head"] = one["model"]["decoder"]["n_head"] = 1
    drop = copy.deepcopy(base)
    drop["model"]["encoder"].update(fs2_dropout=0.2, vp_dropout=0.3)
    drop["model"]["decoder"]["dropout"] = 0.2
    return {"base": base, "one_head": one, "dropout": drop}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One spawn of four ranks (a 2 x 2 mesh) for the module; meanwhile the
    JAX package's steps on its 2 x 2 mesh, on the same weights and batch."""
    cfgs = _cfgs()
    sds = {}
    for k, cfg in cfgs.items():
        model = ZeroVox(pc.ZeroVoxConfig.from_dict(cfg))
        random_init_(model, torch.Generator().manual_seed(2))
        sds[k] = model.state_dict()
    batch = _batch()

    tmp = tmp_path_factory.mktemp("tp")
    from test_vocoder_train import _write_pp_dir

    root = str(tmp / "pp")
    _write_pp_dir(root, n_items=4, n_frames=24)
    vbatch = next(pv.VocoderDataset([root], port_dcfg(8), seed=0).batches(4))
    tcfg = pv.VocoderTrainerConfig(batch_size=4, learning_rate=1e-3, mpd_periods=(2,),
                                   msd_scales=1, out_folder=str(tmp / "out"))
    vstate = pv.VocoderTrainer(port_gcfg(), port_dcfg(8), tcfg, 1, device="cpu").init_state(
        torch.Generator().manual_seed(5))
    nets = {k: getattr(vstate, k).state_dict() for k in ("gen", "mpd", "msd")}

    errors = []

    def run():
        try:
            pmesh.spawn(ranks.tp_steps, 4, {k: copy.deepcopy(v) for k, v in cfgs.items()},
                        {k: _copies(v) for k, v in sds.items()}, batch,
                        (port_gcfg(), port_dcfg(8), tcfg, _copies(nets), vbatch), str(tmp),
                        devices=["cpu"] * 4, mesh=pmesh.MeshConfig(data=2, model=2))
        except BaseException as e:  # re-raised in the test's thread
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    base = cfgs["base"]
    variables = convert_zerovox_state_dict(sds["base"], jc.ZeroVoxConfig.from_dict(base))
    with ThreadPoolExecutor(len(PRECISIONS)) as pool:  # XLA compiles them side by side
        want = dict(zip(PRECISIONS, pool.map(lambda p: _jax_steps(base, variables, batch, p),
                                             PRECISIONS)))
    thread.join()
    if errors:
        raise errors[0]
    got = [torch.load(tmp / f"tp{r}.pt", weights_only=False) for r in range(4)]
    files = {k: torch.load(tmp / f"{k}_state.pt", weights_only=True) for k in ("tp", "dp0")}
    fit = {k: tmp / f"fit_{k}" / "checkpoints" for k in ("tp", "dp0")}
    return {"want": want, "got": got, "files": files, "fit": fit}


def _misses(got: dict, want: dict) -> dict:
    """Each float32 quantity's largest gap over its bound (> 1 misses)."""
    loss = max(abs(got["losses"][k] - v) / (1e-4 * abs(v)) for k, v in want["losses"].items())
    out = {"loss": loss}
    for key, tol in (("grads", 1e-4), ("nu", 2e-4)):
        floor = 1e-3 * max(w.abs().max().item() for w in want[key].values())
        out[key] = max(((g - want[key][n]).abs().max()
                        / (tol * max(want[key][n].abs().max().item(), floor))).item()
                       for n, g in got[key].items())
    out["bn"] = max((got["buffers"][n] - b).abs().max().item() / 1e-5
                    for n, b in want["buffers"].items())
    return out


def test_the_mesh_and_its_blocks(spawned):
    got = spawned["got"]
    assert [r["coords"] for r in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    r0 = got[0]["tp32"]
    assert r0["rows"] == 2 and got[0]["shape"] == {"data": 2, "model": 2}
    # Adam's moments take their local weight's shape; split weights hold half
    assert all(p == v for p, v in r0["moment_shapes"])
    whole = r0["steps"][0]["params"]
    for n, axis in r0["split"].items():
        full = list(whole[n].shape)
        full[axis] //= 2
        assert list(r0["local"][n].shape) == full, n


@pytest.mark.parametrize("step", range(STEPS))
def test_two_by_two_steps_match_the_jax_mesh(spawned, step):
    """After the first update the two packages' weights part where Adam's
    first step, g / (|g| + eps), normalizes gradients that are zero up to
    rounding (the key biases', the attention pool's BatchNorm and its second
    conv's biases: up to 5e-4 apart after step 1, in the data-parallel port
    as here), and the pool's running mean takes 0.1 of that shift (1.2e-5
    from JAX at step 2 here, 9.1e-6 in the data-parallel port). Step 2's
    running statistics are therefore held to the port's data-parallel step
    (which tests/test_torch_parallel.py holds to the JAX mesh), everything
    else to the JAX step."""
    want = spawned["want"]["32"][step]
    assert want["norm"] > 1.0  # the clip (grad_clip 1.0) binds
    got = spawned["got"][0]
    misses = _misses(got["tp32"]["steps"][step], want)
    if step > 0:
        misses["bn"] = _misses(got["tp32"]["steps"][step], got["dp32"]["steps"][step])["bn"]
    assert all(v <= 1 for v in misses.values()), misses


@pytest.mark.parametrize("step", range(STEPS))
def test_two_by_two_bf16_mixed_steps(spawned, step):
    want = spawned["want"]
    misses = _misses16(spawned["got"][0]["tp16"]["steps"][step], want["bf16-mixed"][step],
                       want["32"][step])
    assert all(v <= 1 for v in misses.values()), misses


@pytest.mark.parametrize("control,key", [("row_all_reduce_sum", "grads"),
                                         ("world_sums", "grads"), ("world_sums", "bn"),
                                         ("local_clip_norm", "nu")])
def test_the_controls_miss(spawned, control, key):
    """Each wrong reduction moves the step past a bound: the cotangent
    summed over the model ranks doubles upstream gradients; the world's
    sums halve every rank's share of the loss and count each row twice in
    the running variance's correction; the local norm clips by another
    factor, which Adam's second moments keep."""
    misses = _misses(spawned["got"][0][control]["steps"][0], spawned["want"]["32"][0])
    assert misses[key] > 1, misses


def _replicas_equal(got: list, run: str) -> None:
    split = got[0][run]["split"]
    for n, v in got[0][run]["local"].items():
        peers = (2,) if n in split else (1, 2, 3)
        for r in peers:
            assert torch.equal(v, got[r][run]["local"][n]), (run, n, r)
    for n in split:  # the other model index holds the other block
        assert torch.equal(got[1][run]["local"][n], got[3][run]["local"][n]), (run, n)


@pytest.mark.parametrize("run", ["tp32", "tp16"])
def test_replicas_stay_bitwise_equal(spawned, run):
    _replicas_equal(spawned["got"], run)


def _close(got: dict, want: dict) -> None:
    misses = _misses(got, want)
    assert all(v <= 1 for v in misses.values()), misses


@pytest.mark.parametrize("name", ["one_head", "dropout"])
def test_against_the_data_parallel_step(spawned, name):
    """One head at model 2 gathers q, k and v; dropout draws by data index."""
    r0 = spawned["got"][0][name]
    assert any(n.endswith("slf_attn.w_qs.weight") for n in r0["tp"]["split"])
    _close(r0["tp"]["steps"][0], r0["dp"]["steps"][0])
    _replicas_equal([r[name] for r in spawned["got"]], "tp")


def test_checkpoints_cross_meshes(spawned):
    """The 2 x 2 run's train state holds the data-parallel run's keys and
    shapes; each mesh resumes the other's file to the uninterrupted step."""
    tp, dp = spawned["files"]["tp"], spawned["files"]["dp0"]
    assert tp["model"].keys() == dp["model"].keys()
    for k, v in dp["model"].items():
        assert tp["model"][k].shape == v.shape, k
    for key in ("nu",):
        assert [t.shape for t in tp["optimizer"][key]] == [t.shape for t in dp["optimizer"][key]]
    assert tp["step"] == dp["step"] == 1
    got = spawned["got"][0]
    _close(got["dp_from_tp"]["steps"][0], got["tp32"]["steps"][1])
    _close(got["tp_from_dp"]["steps"][0], got["dp32"]["steps"][1])


def test_fit_writes_whole_checkpoints(spawned):
    """`fit` on the 2 x 2 mesh (rank 0's model group gathers, rank 0 writes)
    leaves the data-parallel run's `.msgpack` and `state/0000.pt`: the same
    leaves and shapes, the same step."""
    from zerovox_tpu_torch.training.checkpointing import load_native_checkpoint

    tp, dp = (load_native_checkpoint(spawned["fit"][k] / "0000.msgpack") for k in ("tp", "dp0"))
    flat = [dict(_jax_leaves(t)) for t in (tp, dp)]
    assert flat[0].keys() == flat[1].keys()
    for k, v in flat[1].items():
        assert np.shape(flat[0][k]) == np.shape(v), k
        assert np.allclose(flat[0][k], v, rtol=1e-4, atol=2e-3), k  # 2 lr: Adam's sign on rounding
    states = [torch.load(spawned["fit"][k] / "state" / "0000.pt", weights_only=True)
              for k in ("tp", "dp0")]
    assert states[0]["step"] == states[1]["step"] == 1
    assert {k: v.shape for k, v in states[0]["model"].items()} == \
        {k: v.shape for k, v in states[1]["model"].items()}


def test_gan_round_replicates_over_model(spawned):
    for r in spawned["got"]:
        tp, dp = r["gan"]["tp"], r["gan"]["dp"]
        for k, v in dp["losses"].items():
            assert abs(tp["losses"][k] - v) <= 1e-6 * abs(v), k
        for key in ("g_grads", "d_grads"):
            for g, w in zip(tp[key], dp[key]):
                assert (g - w).abs().max() <= 1e-6 * w.abs().max()
    a = spawned["got"][0]["gan"]["tp"]
    for r in spawned["got"][1:]:
        for x, y in zip(a["g_grads"] + a["d_grads"], r["gan"]["tp"]["g_grads"] + r["gan"]["tp"]["d_grads"]):
            assert torch.equal(x, y)

