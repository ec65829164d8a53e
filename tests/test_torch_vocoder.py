"""The port's vocoder against the JAX package (CPU, float32): the plain
versions of kernels K1 (MRF) and K2 (upsample stage) against the JAX Pallas
kernels run in interpret mode, and the whole Generator against the JAX
Generator on the same weights.

Tolerance rtol/atol 5e-4: the bound the JAX package holds its own fused
vocoder kernels to against their unfused path (tests/test_packed_vocoder.py),
since six chained convs per tower reassociate float32 sums differently.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerovox_tpu.checkpoint import _SD, convert_hifigan_generator
from zerovox_tpu.models.hifigan import Generator as JaxGenerator, HifiGanConfig as JaxHifiGanConfig
from zerovox_tpu.ops.pallas.mrf import fused_mrf as jax_fused_mrf, mrf_reference
from zerovox_tpu.ops.pallas.packed import fused_packed_stage

from zerovox_tpu_torch.models import hifigan as port_hifigan
from zerovox_tpu_torch.models.hifigan import Generator, HifiGanConfig
from zerovox_tpu_torch.ops.mrf import fused_mrf, mrf_plain, pack_towers
from zerovox_tpu_torch.ops.upsample_stage import (fused_upsample_stage, pack_upsampler,
                                                   upsample_stage_plain)
from zerovox_tpu_torch.synthesize import random_init_

KS = (3, 7, 11)
DILS = (1, 3, 5)
TOL = dict(rtol=5e-4, atol=5e-4)


def _r(rng, *shape, scale=0.3):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _towers(rng, C):
    return [(_r(rng, 3, k, C, C, scale=1 / np.sqrt(k * C)), _r(rng, 3, C, scale=0.1),
             _r(rng, 3, k, C, C, scale=1 / np.sqrt(k * C)), _r(rng, 3, C, scale=0.1))
            for k in KS]


def _torch(towers):
    return [tuple(torch.from_numpy(a) for a in t) for t in towers]


@pytest.mark.parametrize("C,T", [(32, 101), (64, 80)])
def test_mrf_plain_matches_jax_kernel_interpret(C, T):
    rng = np.random.default_rng(C + T)
    x = _r(rng, 1, T, C, scale=1.0)
    towers = _towers(rng, C)
    jt = [tuple(map(jnp.asarray, t)) for t in towers]
    want = jax_fused_mrf(jnp.asarray(x), jt, DILS, KS, tile=64, interpret=True)
    want_ref = mrf_reference(jnp.asarray(x[0]), jt, DILS)[None]
    got = fused_mrf(torch.from_numpy(x), pack_towers(_torch(towers)), DILS, KS)  # CPU: plain
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)


@pytest.mark.parametrize("widths", [(128, 64), (64, 32)])
@pytest.mark.parametrize("T_in", [80, 101])
@pytest.mark.parametrize("post", [False, True])
def test_upsample_stage_plain_matches_jax_kernel_interpret(widths, T_in, post):
    C_in, C_out = widths
    rng = np.random.default_rng(C_in + T_in + post)
    x = _r(rng, 1, T_in, C_in, scale=1.0)
    up = _r(rng, 4, C_in, C_out, scale=1 / np.sqrt(2 * C_in))  # torch taps (k, in, out)
    up_b = _r(rng, C_out, scale=0.1)
    towers = _towers(rng, C_out)
    p = (_r(rng, 7, C_out, 1, scale=1 / np.sqrt(7 * C_out)), _r(rng, 1, scale=0.1)) if post else None
    want = fused_packed_stage(
        jnp.asarray(x), jnp.asarray(np.flip(up, 0).copy()), jnp.asarray(up_b), 2, 1,
        [tuple(map(jnp.asarray, t)) for t in towers], DILS, KS,
        post=None if p is None else tuple(map(jnp.asarray, p)), tile=64, interpret=True)
    got = fused_upsample_stage(torch.from_numpy(x),
                               pack_upsampler(torch.from_numpy(up), torch.from_numpy(up_b), 2),
                               1, pack_towers(_torch(towers)), DILS, KS,
                               post=None if p is None else tuple(map(torch.from_numpy, p)))
    assert got.shape == ((1, 2 * T_in) if post else (1, 2 * T_in, C_out))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the plain version is what the wrapper ran on the CPU tensor
    again = upsample_stage_plain(torch.from_numpy(x), torch.from_numpy(up), torch.from_numpy(up_b),
                                 2, 1, _torch(towers), DILS,
                                 post=None if p is None else tuple(map(torch.from_numpy, p)))
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("init_ch", [256, 64])
def test_generator_matches_jax_generator(init_ch):
    """init 256: stages of width 128 and 64 take the MRF path, 64->32 and
    32->16 the upsample-stage path (all plain on the CPU); init 64: the
    narrow stages take both paths at other widths."""
    cfg = HifiGanConfig(upsample_initial_channel=init_ch)
    gen = Generator(cfg, use_pallas=True)
    random_init_(gen, torch.Generator().manual_seed(init_ch))
    with torch.no_grad():
        for p in gen.parameters():
            if p.dim() == 1:
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(p.numel()))
    params = convert_hifigan_generator(_SD(gen.state_dict()), JaxHifiGanConfig(
        upsample_initial_channel=init_ch))
    mel = _r(np.random.default_rng(0), 1, 20, 80, scale=1.0)
    jgen = JaxGenerator(JaxHifiGanConfig(upsample_initial_channel=init_ch))
    want = jax.jit(jgen.apply)({"params": params}, jnp.asarray(mel))
    with torch.no_grad():
        got = gen(torch.from_numpy(mel))
    assert got.shape == (1, 20 * 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_default_generator_routes_stages_like_the_jax_package(monkeypatch):
    """Default config: stage 0 (C=256) plain, stage 1 (C=128) MRF kernel,
    stages 2 and 3 the upsample-stage kernel, the last with conv_post."""
    calls = []

    def spy(name, fn):
        @functools.wraps(fn)
        def wrapped(x, *a, **kw):
            calls.append((name, tuple(x.shape[1:]), kw.get("post") is not None))
            return fn(x, *a, **kw)
        return wrapped

    monkeypatch.setattr(port_hifigan, "fused_mrf", spy("mrf", fused_mrf))
    monkeypatch.setattr(port_hifigan, "fused_upsample_stage", spy("stage", fused_upsample_stage))
    gen = Generator(HifiGanConfig(), use_pallas=True)
    with torch.no_grad():
        wav = gen(torch.zeros(1, 4, 80))
    assert wav.shape == (1, 4 * 256)
    assert calls == [("mrf", (256, 128), False), ("stage", (256, 128), False),
                     ("stage", (512, 64), True)]
    calls.clear()
    with torch.no_grad():  # batch > 1: the MRF kernel is batch-1 only, as in the JAX package
        gen(torch.zeros(2, 4, 80))
    assert [c[0] for c in calls] == ["stage", "stage"]


def test_mrf_plain_is_the_mean_of_resblocks():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_r(rng, 1, 40, 8, scale=1.0))
    towers = _torch(_towers(rng, 8))
    one = [mrf_plain(x, [t], DILS) for t in towers]
    np.testing.assert_allclose(mrf_plain(x, towers, DILS).numpy(),
                               (sum(one) / 3).numpy(), rtol=1e-6, atol=1e-6)
