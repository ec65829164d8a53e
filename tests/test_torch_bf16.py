"""bf16-mixed training on the CPU against the JAX package: Adam's bf16
second moments, kernel K4's bf16 plain versions against the JAX `se_conv`
on bf16 inputs (Pallas in interpret mode), and one bf16-mixed train step
with the fused speaker stage 1 against the JAX `make_train_step(precision=
"bf16-mixed")` on the same weights and batch.

Bounds: nu bitwise and parameters 1e-6 (the optimizer computes in float32
and rounds only the stored nu, as optax does); y and dx within one bf16 step
of their largest value (2^-8 x max) and the float32 sums within 1e-3 x max,
the chip check's bounds (dw, ds and dt as stated at
`test_se_conv_plain_bf16_matches_jax`); the step's losses within 5e-2
relative (the JAX package's bf16 bound, docs/PERFORMANCE.md:130-133) and its
gradients as stated at `test_bf16_mixed_step_matches_jax`. Every dropout
rate is 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import zerovox_tpu.config as jc
from zerovox_tpu.models.resnetse import _pack2x2, _pack_kernel, _unpack2x2
from zerovox_tpu.models.zerovox import ZeroVox as JaxZeroVox
from zerovox_tpu.ops.pallas import se_fused
from zerovox_tpu.training import trainer as jtrainer
from zerovox_tpu.training.optim import make_optimizer, warmup_cosine_epoch_schedule as jax_schedule

import zerovox_tpu_torch.config as pc
from zerovox_tpu_torch.ops.se_conv import SeConv, se_conv, se_conv_bwd_plain, se_conv_plain
from zerovox_tpu_torch.synthesize import random_init_
from zerovox_tpu_torch.training.optim import AdamW, warmup_cosine_epoch_schedule
from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig
from zerovox_tpu_torch.weights import from_jax_variables, to_jax_variables

C = 32
BF16_ULP = 2.0 ** -8
RED_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes run fastest on one intra-op thread, and the suite runs
    its files in parallel processes, where torch's default of a thread per
    core oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_err(got, want, floor=1e-12):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor))


# ------------------------------------------------------------------ optimizer

def test_adamw_bf16_second_moments_match_make_optimizer():
    rng = np.random.default_rng(21)
    shapes = {"w": (8, 16), "b": (16,), "k": (3, 4, 5)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(weight_decay=1e-2, betas=(0.0, 0.99), eps=1e-9, grad_clip=1.0)
    tx = make_optimizer(jax_schedule(1e-2, 2, 5, 1), state_dtype="bf16", **kw)
    schedule = warmup_cosine_epoch_schedule(1e-2, 2, 5, 1)
    p_ref = {k: jnp.asarray(v) for k, v in init.items()}
    s_ref = tx.init(p_ref)
    params = [torch.tensor(init[k], requires_grad=True) for k in shapes]
    opt = AdamW(params, state_dtype="bf16", **kw)
    assert all(n.dtype == torch.bfloat16 for n in opt.nu)
    for step in range(5):
        grads = {k: (rng.normal(size=s) * 0.02 * 3 ** step).astype(np.float32)
                 for k, s in shapes.items()}
        u, s_ref = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, s_ref, p_ref)
        p_ref = optax.apply_updates(p_ref, u)
        for p, k in zip(params, shapes):
            p.grad = torch.from_numpy(grads[k])
        opt.step(schedule(step))
        nu_ref = s_ref[1].nu
        for n, p, k in zip(opt.nu, params, shapes):
            assert nu_ref[k].dtype == jnp.bfloat16
            np.testing.assert_array_equal(n.float().numpy(), np.asarray(nu_ref[k], np.float32),
                                          err_msg=f"nu {k} at step {step}")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_ref[k]), rtol=0,
                                       atol=1e-6, err_msg=f"{k} at step {step}")


def test_adamw_bf16_with_a_first_moment_warns_and_keeps_f32(capsys):
    opt = AdamW([torch.zeros(3, requires_grad=True)], betas=(0.9, 0.99), state_dtype="bf16")
    assert opt.state_dtype == "f32" and opt.nu[0].dtype == torch.float32
    assert "requires betas[0] == 0" in capsys.readouterr().out
    with pytest.raises(ValueError):
        AdamW([torch.zeros(3, requires_grad=True)], state_dtype="fp16")


# ------------------------------------------------------------- K4 in bf16

def _jax_se_conv_bf16(x, w, s, t, relu):
    """The JAX se_conv on canonical NCHW bf16 x and torch-layout bf16 taps,
    packed and unpacked with the JAX package's helpers (interpret mode)."""
    B, _, H, W = x.shape
    xp = _pack2x2(jnp.transpose(x, (0, 2, 3, 1)))
    h2, w2 = H // 2, W // 2
    spec = se_fused.make_spec(h2, w2, relu_out=relu, interpret=True)
    xp = jnp.pad(xp, ((0, 0), (0, 0), (0, se_fused.stored_width(spec) - w2), (0, 0)))
    wm = se_fused.pack_taps(_pack_kernel(jnp.transpose(w, (2, 3, 1, 0))), jnp.bfloat16)
    y, ssum, ssq, m = se_fused.se_conv(xp, wm, jnp.tile(s, 4)[None], jnp.tile(t, 4)[None], spec)
    y = jnp.transpose(_unpack2x2(y[:, :, :w2]), (0, 3, 1, 2))
    return (y, se_fused.fold_phases(ssum, 4), se_fused.fold_phases(ssq, 4),
            m.reshape(B, 4, C).sum(1))


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


@pytest.mark.parametrize("B,H,W", [(2, 16, 48), (1, 8, 272)])
@pytest.mark.parametrize("relu", [True, False])
def test_se_conv_plain_bf16_matches_jax(B, H, W, relu):
    """y, dx, the sums, ds and dt at the chip check's bounds (ds measured up
    to 9.3e-4 x max: the JAX kernel recovers x from the bf16 u where the
    port reads x). dw within 1e-2 x max (measured up to 7.1e-3): the JAX
    VJP rounds dw to bf16 per packed tap and sums the phase copies in
    bf16."""
    rng = np.random.default_rng(B * H + W + relu)
    x = _bf16(rng.normal(size=(B, C, H, W)))
    w = _bf16(rng.normal(size=(C, C, 3, 3)) / np.sqrt(9 * C))
    s = rng.uniform(0.5, 1.5, C).astype(np.float32)
    t = (rng.normal(size=C) * 0.3).astype(np.float32)
    cts = [rng.normal(size=(B, C, H, W)).astype(np.float32), rng.normal(size=C).astype(np.float32),
           rng.normal(size=C).astype(np.float32), rng.normal(size=(B, C)).astype(np.float32)]
    cts[0] = _bf16(cts[0])

    def jax_loss(*args):
        outs = _jax_se_conv_bf16(*args, relu)
        return sum(jnp.vdot(o.astype(jnp.float32), jnp.asarray(ct, jnp.float32))
                   for o, ct in zip(outs, cts)), outs

    (_, want), want_g = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3),
                                                   has_aux=True))(x, w, s, t)
    assert want[0].dtype == jnp.bfloat16 and want_g[0].dtype == jnp.bfloat16

    leaves = [torch.from_numpy(np.asarray(a, np.float32)) for a in (x, w)]
    leaves = [a.bfloat16().requires_grad_(True) for a in leaves]
    leaves += [torch.tensor(a, requires_grad=True) for a in (s, t)]
    got = se_conv(*leaves, relu)  # bf16 CPU tensors: the plain versions under SeConv
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    torch.autograd.backward(got, [torch.from_numpy(np.asarray(cts[0], np.float32)).bfloat16()]
                            + [torch.from_numpy(c) for c in cts[1:]])

    assert _rel_err(got[0].detach().float(), want[0]) <= BF16_ULP
    for name, a, b in zip(("sum", "sq", "m"), got[1:], want[1:]):
        assert _rel_err(a.detach(), b) <= RED_TOL, name
    assert _rel_err(leaves[0].grad.float(), want_g[0]) <= BF16_ULP  # dx
    for name, p, g, tol in zip(("dw", "ds", "dt"), leaves[1:], want_g[1:], (1e-2, RED_TOL, RED_TOL)):
        assert _rel_err(p.grad.float(), g) <= tol, name


def test_se_conv_bf16_cpu_runs_the_plain_versions():
    """SeConv on bf16 CPU tensors: forward as se_conv_plain, backward as
    se_conv_bwd_plain on that y, dw returned in w's dtype."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, C, 6, 10, generator=g).bfloat16()
    w = (torch.randn(C, C, 3, 3, generator=g) / 17).bfloat16()
    s, t = torch.rand(C, generator=g) + 0.5, torch.randn(C, generator=g)
    outs = SeConv.apply(x, w, s, t, True)
    for a, b in zip(outs, se_conv_plain(x, w, s, t, True)):
        assert torch.equal(a, b)
    cts = (torch.randn(1, C, 6, 10, generator=g).bfloat16(), torch.randn(C, generator=g),
           torch.randn(C, generator=g), torch.randn(1, C, generator=g))
    leaves = [a.clone().requires_grad_(True) for a in (x, w, s, t)]
    torch.autograd.backward(SeConv.apply(*leaves, True), cts)
    want = se_conv_bwd_plain(x, outs[0], *cts[:1], w, s, t, *cts[1:], True)
    assert torch.equal(leaves[0].grad, want[0])
    assert leaves[1].grad.dtype == torch.bfloat16
    assert torch.equal(leaves[1].grad, want[1].bfloat16())
    assert torch.equal(leaves[2].grad, want[2]) and torch.equal(leaves[3].grad, want[3])


# --------------------------------------------------- one bf16-mixed step

N_MELS = 16


def _cfg_dict() -> dict:
    return {
        "audio": {"num_mels": N_MELS},
        "model": {
            "max_txt_len": 64, "max_mel_len": 256, "emb_dim": 16, "punct_emb_dim": 8,
            "packed_speaker": 1, "fused_speaker": True,
            "encoder": {"fs2_layer": 1, "fs2_head": 2, "vp_filter_size": 8, "ve_n_bins": 8,
                        "fs2_dropout": 0.0, "vp_dropout": 0.0},
            "decoder": {"n_layers": 1, "n_head": 2, "conv_filter_size": 32, "dropout": 0.0},
            "resnet": {"layers": [1, 1, 1, 1], "num_filters": [32, 8, 8, 8]},
        },
        "training": {"learning_rate": 1e-3},
        "stats": {"pitch_min": 50.0, "pitch_max": 400.0, "energy_min": 0.1, "energy_max": 50.0},
    }


def _batch(rng, B=2, L=12, T=48, ref=32):
    plen = np.asarray([L, L - 3])
    dur = rng.integers(1, 5, size=(B, L)).astype(np.int32)
    dur[1, plen[1]:] = 0
    mlen = np.minimum(dur.sum(1), T)
    return {
        "phoneme": np.where(np.arange(L)[None] < plen[:, None],
                            rng.integers(1, 28, size=(B, L)), 0).astype(np.int32),
        "puncts": rng.integers(0, 10, size=(B, L)).astype(np.int32),
        "phoneme_mask": np.arange(L)[None] >= plen[:, None],
        "pitch": rng.uniform(0, 1, size=(B, L)).astype(np.float32),
        "energy": rng.uniform(0, 1, size=(B, L)).astype(np.float32),
        "duration": dur,
        "mel_mask": np.arange(T)[None] >= mlen[:, None],
        "ref_mel": rng.normal(size=(B, ref, N_MELS)).astype(np.float32),
        "mel": rng.normal(size=(B, T, N_MELS)).astype(np.float32),
    }


def _grads_out() -> optax.GradientTransformation:
    """An optax transform whose state after an update is the gradient."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))


def test_bf16_mixed_step_matches_jax():
    """The port's bf16-mixed forward + loss + backward against the JAX
    make_train_step(precision="bf16-mixed") on the same weights and batch,
    the speaker encoder's stage 1 through K4 on both sides (Pallas in
    interpret mode with bf16 inputs). Losses within 5e-2 relative.

    Gradients: at these widths and random weights bf16 rounding itself moves
    each gradient by 10-50 % of its tensor's max (the JAX package's own bf16
    step against its float32 step on these inputs: 0.14 in aggregate over
    the phoneme encoder, variance adaptor and decoder, 0.32 over the speaker
    encoder), so no per-tensor 5e-2 bound can hold. Each group is held in
    aggregate, ||port - jax|| / ||jax|| over its gradients, within 1.5 x the
    JAX package's own bf16-to-float32 distance of the group, measured here;
    and every parameter, gradient and running statistic stays float32."""
    pcfg = pc.ZeroVoxConfig.from_dict(_cfg_dict())
    jcfg = jc.ZeroVoxConfig.from_dict(_cfg_dict())
    rng = np.random.default_rng(8)
    batch = _batch(rng)

    trainer = Trainer(pcfg, TrainerConfig(precision="bf16-mixed", optim_dtype="bf16", seed=0),
                      steps_per_epoch=1, device="cpu")
    state = trainer.init_state()
    with torch.no_grad():  # biases and norms away from their zero / identity init
        g = torch.Generator().manual_seed(4)
        for p in state.model.parameters():
            if p.dim() < 2:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    variables = to_jax_variables(state.model.state_dict(), pcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_step(precision):
        step = jtrainer.make_train_step(JaxZeroVox(jcfg), _grads_out(), precision=precision,
                                        jit=False)
        jstate = jtrainer.TrainState(params=params, batch_stats=variables["batch_stats"],
                                     opt_state=_grads_out().init(params),
                                     step=jnp.zeros((), jnp.int32))
        new, losses = jax.jit(step)(jstate, jbatch, jax.random.PRNGKey(0))
        return (from_jax_variables({"params": new.opt_state, "batch_stats": new.batch_stats}, pcfg),
                from_jax_variables({"params": params, "batch_stats": new.batch_stats}, pcfg),
                losses)

    grads16, stats16, want = jax_step("bf16-mixed")
    grads32, _, _ = jax_step("32")

    calls = []
    orig = SeConv.apply
    SeConv.apply = lambda *a: calls.append(a[0].dtype) or orig(*a)
    try:
        got = trainer.forward_backward(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    finally:
        SeConv.apply = orig
    assert calls == [torch.bfloat16] * 2  # block 0's two convs, in bf16

    for k in want:
        assert abs(got[k].item() - float(want[k])) <= 5e-2 * abs(float(want[k])), k
    named = dict(state.model.named_parameters())
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in named.values())

    def dist(a, b, names):
        num = sum(float(((a[n] - b[n]) ** 2).sum()) for n in names)
        return (num / sum(float((b[n] ** 2).sum()) for n in names)) ** 0.5

    port = {n: p.grad for n, p in named.items()}
    spk = [n for n in named if n.startswith("_spkemb.")]
    for names in (spk, [n for n in named if n not in spk]):
        assert dist(port, grads16, names) <= 1.5 * dist(grads16, grads32, names)
    for name, t in state.model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            assert t.dtype == torch.float32
            assert _rel_err(t.numpy(), stats16[name].numpy()) <= 5e-2, name
