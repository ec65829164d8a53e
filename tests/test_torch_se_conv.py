"""Kernel K4's module on the CPU against the JAX package: `se_conv_plain`
against the JAX `se_conv` (Pallas in interpret mode, packed and unpacked
with the JAX package's helpers), and the port's fused stage-1 ResNetSE34V2
against the JAX module with packed_speaker=1, fused_speaker=True, in train
and eval mode.

Bounds: 1e-4 absolute on unit-scale activations and on the L2-normalized
embedding; 1e-4 x the largest value of the JAX result on every reduction,
running statistic and gradient (sums over every position, taken in another
order). Two exceptions in the module test, both measured on these inputs:
train-mode parameter gradients are held to 2e-4 x their largest value,
because the JAX package's own fused and unfused paths already differ by up
to 1.6e-4 there (the single-pass BatchNorm variance E[y^2] - mean^2 of the
fused path cancels digits); and a gradient whose exact value is zero (the
attention biases ahead of the softmax over time, which is shift-invariant)
is held against 1e-3 x the encoder's largest gradient instead of its own
float noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zerovox_tpu.config as jc
from zerovox_tpu.checkpoint import convert_zerovox_state_dict
from zerovox_tpu.models.resnetse import _pack2x2, _pack_kernel, _unpack2x2
from zerovox_tpu.models.zerovox import ZeroVox as JaxZeroVox
from zerovox_tpu.ops.pallas import se_fused

import zerovox_tpu_torch.config as pc
import zerovox_tpu_torch.models.resnetse as port_resnetse
from zerovox_tpu_torch.models.zerovox import ZeroVox
from zerovox_tpu_torch.ops.se_conv import se_conv, se_conv_plain
from zerovox_tpu_torch.synthesize import random_init_
from zerovox_tpu_torch.weights import from_jax_variables

C = 32


def _jax_se_conv(x, w, s, t, relu):
    """JAX se_conv on canonical NCHW x and torch-layout taps: pack, run the
    Pallas pass, unpack, fold the phases."""
    B, _, H, W = x.shape
    xp = _pack2x2(jnp.transpose(x, (0, 2, 3, 1)))
    h2, w2 = H // 2, W // 2
    spec = se_fused.make_spec(h2, w2, relu_out=relu, interpret=True)
    xp = jnp.pad(xp, ((0, 0), (0, 0), (0, se_fused.stored_width(spec) - w2), (0, 0)))
    wm = se_fused.pack_taps(_pack_kernel(jnp.transpose(w, (2, 3, 1, 0))), jnp.float32)
    y, ssum, ssq, m = se_fused.se_conv(xp, wm, jnp.tile(s, 4)[None], jnp.tile(t, 4)[None], spec)
    y = jnp.transpose(_unpack2x2(y[:, :, :w2]), (0, 3, 1, 2))
    return (y, se_fused.fold_phases(ssum, 4), se_fused.fold_phases(ssq, 4),
            m.reshape(B, 4, C).sum(1))


def _assert_rel(got, want, tol, what, floor=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), floor), err_msg=what)


@pytest.mark.parametrize("B,H,W", [(2, 16, 48), (1, 8, 272)])
@pytest.mark.parametrize("relu", [True, False])
def test_se_conv_plain_matches_jax(B, H, W, relu):
    rng = np.random.default_rng(B * H + W + relu)
    x = rng.normal(size=(B, C, H, W)).astype(np.float32)
    w = (rng.normal(size=(C, C, 3, 3)) / np.sqrt(9 * C)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, C).astype(np.float32)
    t = (rng.normal(size=C) * 0.3).astype(np.float32)
    cts = [rng.normal(size=shape).astype(np.float32)
           for shape in ((B, C, H, W), (C,), (C,), (B, C))]

    def jax_loss(*args):
        outs = _jax_se_conv(*args, relu)
        return sum(jnp.vdot(o, ct) for o, ct in zip(outs, cts)), outs

    (_, want), want_g = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3),
                                                   has_aux=True))(x, w, s, t)

    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, s, t)]
    got = se_conv(*leaves, relu)  # CPU tensors: the plain version
    torch.autograd.backward(got, [torch.tensor(ct) for ct in cts])

    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    for name, a, b in zip(("sum", "sq", "m"), got[1:], want[1:]):
        _assert_rel(a.detach().numpy(), b, 1e-4, name)
    for name, p, g in zip(("dx", "dw", "ds", "dt"), leaves, want_g):
        _assert_rel(p.grad.numpy(), g, 1e-4, name)


def test_se_conv_cpu_runs_the_plain_version():
    x, w = torch.randn(1, C, 4, 6), torch.randn(C, C, 3, 3)
    s, t = torch.rand(C) + 0.5, torch.randn(C)
    for a, b in zip(se_conv(x, w, s, t, True), se_conv_plain(x, w, s, t, True)):
        assert torch.equal(a, b)


# ------------------------------------------------- fused stage 1 in the module

def _cfg(mod):
    return mod.ZeroVoxConfig(
        audio=mod.AudioConfig(num_mels=16),
        model=mod.ModelConfig(
            emb_dim=16, punct_emb_dim=8, packed_speaker=1, fused_speaker=True,
            encoder=mod.EncoderConfig(fs2_layer=1, vp_filter_size=8, ve_n_bins=8),
            decoder=mod.DecoderConfig(n_layers=1, conv_filter_size=32),
            resnet=mod.ResNetConfig(layers=(2, 1, 1, 1), num_filters=(32, 16, 16, 16))))


def _port_model(seed):
    port = ZeroVox(_cfg(pc))
    gen = torch.Generator().manual_seed(seed)
    random_init_(port, gen)
    with torch.no_grad():  # running stats and affine terms away from identity
        for name, t in port._spkemb.state_dict().items():
            if name.endswith(("running_mean", "bias")):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
            elif name.endswith(("running_var", "bn1.weight", "bn2.weight")):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    return port


@pytest.mark.parametrize("train", [True, False])
def test_fused_stage1_resnetse_matches_jax(train, monkeypatch):
    port = _port_model(11 + train)
    variables = convert_zerovox_state_dict(port.state_dict(), _cfg(jc))
    rng = np.random.default_rng(3)
    mel = rng.normal(size=(2, 40, 16)).astype(np.float32)  # even H and W: JAX fuses
    tgt = rng.normal(size=(2, 1, 24)).astype(np.float32)

    jax_calls, port_calls = [], []
    orig_jax, orig_port = se_fused.se_conv, port_resnetse.se_conv
    monkeypatch.setattr(se_fused, "se_conv", lambda *a: jax_calls.append(1) or orig_jax(*a))
    monkeypatch.setattr(port_resnetse, "se_conv",
                        lambda *a, **k: port_calls.append(1) or orig_port(*a, **k))

    def jax_loss(params):
        emb, mutated = JaxZeroVox(_cfg(jc)).apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, mel, train=train,
            method=JaxZeroVox.speaker_embed, mutable=["batch_stats"])
        return jnp.sum(emb * tgt), (emb, mutated["batch_stats"])

    grads, (want, stats) = jax.jit(jax.grad(jax_loss, has_aux=True))(variables["params"])
    assert len(jax_calls) == 4  # the JAX run took the fused path: 2 blocks x 2 convs
    want_sd = from_jax_variables({"params": variables["params"], "batch_stats": stats}, _cfg(pc))
    grad_sd = from_jax_variables({"params": grads, "batch_stats": stats}, _cfg(pc))

    emb = port.speaker_embed(torch.from_numpy(mel), train=train)
    (emb * torch.from_numpy(tgt)).sum().backward()
    assert len(port_calls) == 4  # 2 blocks x 2 convs

    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    for name, t in port.state_dict().items():
        if name.startswith("_spkemb.") and name.endswith(("running_mean", "running_var")):
            _assert_rel(t.numpy(), want_sd[name].numpy(), 1e-4, name)
    grads = {name: (p.grad.numpy(), grad_sd[name].numpy())
             for name, p in port.named_parameters() if name.startswith("_spkemb.")}
    floor = 1e-3 * max(np.abs(want).max() for _, want in grads.values())
    for name, (got, want) in grads.items():
        _assert_rel(got, want, 2e-4 if train else 1e-4, name, floor)
