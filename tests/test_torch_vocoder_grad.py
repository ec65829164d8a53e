"""The vocoder's gradients (CPU, float32): `Generator(use_pallas=False)`, the
default, runs its nn.Modules, and its gradients for the mel and for every
parameter equal `jax.grad` of the JAX Generator on the same weights; the
kernel route (`use_pallas=True`) refuses autograd instead of returning a
result without a graph.

Tolerance: 1e-4 x each gradient's max |value| (float32 sums of a few
hundred terms through a dozen convs, taken in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerovox_tpu.models.hifigan import HifiGanConfig as JaxHifiGanConfig, MelDec as JaxMelDec

from zerovox_tpu_torch.models.hifigan import Generator, HifiGanConfig, MelDec
from zerovox_tpu_torch.ops.mrf import fused_mrf, pack_towers
from zerovox_tpu_torch.ops.resblock import fused_resblock1
from zerovox_tpu_torch.ops.upsample_stage import fused_upsample_stage, pack_upsampler
from zerovox_tpu_torch.weights import meldec_from_jax_variables

GRAD_TOL = 1e-4
# narrow and shallow: two towers sharing dilations (the MRF kernels' case,
# with the packed-stage widths 32 -> 16 -> 8), one tower, and towers whose
# dilations differ (the ResBlock1 kernel's cases), and ResBlock2
CONFIGS = {
    "two_towers": dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                       upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
                       resblock_dilation_sizes=((1, 3), (1, 3)), num_mels=16),
    "one_tower": dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                      upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                      resblock_dilation_sizes=((1, 3, 5),), num_mels=16),
    "differing": dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                      upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
                      resblock_dilation_sizes=((1, 3), (1, 2)), num_mels=16),
    "resblock2": dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                      upsample_initial_channel=16, resblock="2", resblock_kernel_sizes=(3, 5),
                      resblock_dilation_sizes=((1, 3), (1, 2)), num_mels=16),
}
T_MEL = 10


def _jax_variables(hcfg, seed):
    """JAX MelDec weights with nonzero biases."""
    init = JaxMelDec(JaxHifiGanConfig(**hcfg)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, T_MEL, hcfg["num_mels"]), jnp.float32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        if path[-1].key == "bias" else np.asarray(a), init)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_generator_gradients_match_jax_grad(name):
    hcfg = CONFIGS[name]
    variables = _jax_variables(hcfg, seed=len(name))
    rng = np.random.default_rng(7)
    mel = rng.normal(size=(1, T_MEL, hcfg["num_mels"])).astype(np.float32)
    cfg = HifiGanConfig(**hcfg)
    ct = rng.normal(size=(1, T_MEL * cfg.total_upsample)).astype(np.float32)

    jmel = JaxMelDec(JaxHifiGanConfig(**hcfg))

    def loss(params, m):
        return jnp.sum(jmel.apply({"params": params}, m) * ct)

    g_params, g_mel = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(mel))
    want = meldec_from_jax_variables({"params": jax.tree.map(np.asarray, g_params)}, cfg)

    md = MelDec(cfg)  # use_pallas=False: the nn.Modules
    md.load_state_dict(meldec_from_jax_variables(variables, cfg))
    x = torch.from_numpy(mel).requires_grad_(True)
    (md(x) * torch.from_numpy(ct)).sum().backward()

    def close(got, ref, what):
        assert got is not None, f"{what}: no gradient"
        ref = torch.tensor(np.array(ref))
        assert got.shape == ref.shape, what
        err = (got - ref).abs().max().item()
        assert err <= GRAD_TOL * ref.abs().max().item(), f"{what}: {err} of max {ref.abs().max()}"

    close(x.grad, g_mel, "mel")
    named = dict(md.named_parameters())
    assert set(named) == {k for k in want if k.startswith("generator.")}
    for key, p in named.items():
        close(p.grad, want[key], key)
    prefixes = {k.split(".")[1] for k in named}
    assert prefixes == {"conv_pre", "ups", "resblocks", "conv_post"}


@pytest.mark.parametrize("name", ["two_towers", "one_tower"])
def test_kernel_route_refuses_autograd(name):
    """use_pallas=True with grad enabled raises (the input or a parameter
    requires grad); under no_grad it runs and equals the nn.Modules' route."""
    cfg = HifiGanConfig(**CONFIGS[name])
    gen = Generator(cfg, use_pallas=True)
    mel = torch.from_numpy(np.random.default_rng(1).normal(size=(1, T_MEL, 16)).astype(np.float32))
    with pytest.raises(RuntimeError, match="no backward"):
        gen(mel)
    gen.requires_grad_(False)
    with pytest.raises(RuntimeError, match="no backward"):
        gen(mel.clone().requires_grad_(True))
    gen.requires_grad_(True)
    with torch.no_grad():
        got = gen(mel)
    plain = Generator(cfg)
    plain.load_state_dict(gen.state_dict())
    with torch.no_grad():
        want = plain(mel)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    with torch.inference_mode():  # the engine's calls
        assert gen(mel).shape == want.shape


def test_kernel_wrappers_refuse_autograd():
    """Each wrapper raises, on the CPU too, for a tensor that requires grad
    while grad is enabled; under no_grad the same call runs."""
    rng = np.random.default_rng(2)

    def r(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.1)

    tower = (r(2, 3, 8, 8), r(2, 8), r(2, 3, 8, 8), r(2, 8))
    x = r(1, 20, 8).requires_grad_(True)
    calls = {
        "fused_mrf": lambda: fused_mrf(x, pack_towers([tower]), (1, 3), (3,)),
        "fused_resblock1": lambda: fused_resblock1(x, *tower, (1, 3)),
        "fused_upsample_stage": lambda: fused_upsample_stage(
            x, pack_upsampler(r(4, 8, 8), r(8), 2), 1, pack_towers([tower]), (1, 3), (3,)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: the fused kernel has no backward"):
            call()
        with torch.no_grad():
            assert torch.isfinite(call()).all()
    w1 = tower[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_resblock1(x.detach(), w1, *tower[1:], (1, 3))
