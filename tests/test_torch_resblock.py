"""Kernel K3 (one fused ResBlock1 tower) and the vocoder routing that uses
it, against the JAX package (CPU, float32): the port's `fused_resblock1` on
CPU tensors (its plain version) against the JAX Pallas kernel run in
interpret mode and against its XLA reference; the port's Generator against
the JAX Generator (its plain path: a compiled Pallas call cannot run on the
CPU) for a single-tower vocoder and one whose towers' dilations differ.

Tolerance rtol/atol 5e-4: the bound the JAX package holds its fused vocoder
kernels to against their unfused path (tests/test_packed_vocoder.py), since
six chained convs reassociate float32 sums differently.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerovox_tpu.checkpoint import _SD, convert_hifigan_generator
from zerovox_tpu.models.hifigan import Generator as JaxGenerator, HifiGanConfig as JaxHifiGanConfig
from zerovox_tpu.ops.pallas.resblock import fused_resblock1 as jax_fused_resblock1
from zerovox_tpu.ops.pallas.resblock import resblock1_reference

from zerovox_tpu_torch.models import hifigan as port_hifigan
from zerovox_tpu_torch.models.hifigan import Generator, HifiGanConfig
from zerovox_tpu_torch.ops.mrf import mrf_plain
from zerovox_tpu_torch.ops.resblock import fused_resblock1, resblock1_plain
from zerovox_tpu_torch.synthesize import random_init_

TOL = dict(rtol=5e-4, atol=5e-4)
TILE = 64  # the JAX kernel's tile in these tests; K3's halo is 12 rows at k=3, dilations 1,3,5


def _r(rng, *shape, scale=0.3):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _tower(rng, C, k, P):
    return (_r(rng, P, k, C, C, scale=1 / np.sqrt(k * C)), _r(rng, P, C, scale=0.1),
            _r(rng, P, k, C, C, scale=1 / np.sqrt(k * C)), _r(rng, P, C, scale=0.1))


@pytest.mark.parametrize("C", [32, 64])
@pytest.mark.parametrize("k,dils", [(3, (1, 3, 5)), (5, (1, 3, 5)), (3, (1, 3))])
@pytest.mark.parametrize("T", [9, 40, TILE, 101])  # below the halo, below, at and off the tile
def test_resblock_plain_matches_jax_kernel_interpret(C, k, dils, T):
    rng = np.random.default_rng(C + 7 * k + T + len(dils))
    x = _r(rng, 1, T, C, scale=1.0)
    tower = _tower(rng, C, k, len(dils))
    jt = tuple(map(jnp.asarray, tower))
    want = jax_fused_resblock1(jnp.asarray(x), *jt, dils, tile=TILE, interpret=True)
    want_ref = resblock1_reference(jnp.asarray(x[0]), *jt, dils)[None]
    got = fused_resblock1(torch.from_numpy(x), *map(torch.from_numpy, tower), dils)
    assert got.shape == (1, T, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)


def test_resblock_plain_batch_rows_are_independent():
    """B > 1: each row is the block of that row alone (the kernel's grid
    takes batch rows as a second axis); 1e-5, as PyTorch's CPU convolution
    sums a batch in another order than one row."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_r(rng, 3, 50, 32, scale=1.0))
    tower = tuple(map(torch.from_numpy, _tower(rng, 32, 3, 3)))
    got = fused_resblock1(x, *tower, (1, 3, 5))
    for b in range(3):
        np.testing.assert_allclose(got[b:b + 1].numpy(),
                                   resblock1_plain(x[b:b + 1], *tower, (1, 3, 5)).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_one_tower_mrf_is_the_resblock():
    """K1 with one tower is K3: the mean over one tower is the tower."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(_r(rng, 1, 70, 16, scale=1.0))
    tower = tuple(map(torch.from_numpy, _tower(rng, 16, 3, 3)))
    np.testing.assert_array_equal(mrf_plain(x, [tower], (1, 3, 5)).numpy(),
                                  resblock1_plain(x, *tower, (1, 3, 5)).numpy())


SINGLE = dict(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
              upsample_initial_channel=64, resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 3, 5),))
DIFFERING = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                 upsample_initial_channel=64, resblock_kernel_sizes=(3, 5),
                 resblock_dilation_sizes=((1, 3, 5), (1, 2)))


@pytest.mark.parametrize("hcfg", [SINGLE, DIFFERING], ids=["single_tower", "differing_dilations"])
def test_generator_with_resblock_towers_matches_jax_generator(hcfg):
    cfg = HifiGanConfig(**hcfg)
    gen = Generator(cfg, use_pallas=True)
    random_init_(gen, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for p in gen.parameters():
            if p.dim() == 1:
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(p.numel()))
    jcfg = JaxHifiGanConfig(**hcfg)
    params = convert_hifigan_generator(_SD(gen.state_dict()), jcfg)
    mel = _r(np.random.default_rng(1), 1, 12, 80, scale=1.0)
    want = jax.jit(JaxGenerator(jcfg).apply)({"params": params}, jnp.asarray(mel))
    with torch.no_grad():
        got = gen(torch.from_numpy(mel))
    assert got.shape == (1, 12 * cfg.total_upsample)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _spy(calls, name, fn):
    @functools.wraps(fn)
    def wrapped(x, *a, **kw):
        calls.append((name, tuple(x.shape), tuple(a[-1]) if name == "resblock" else None))
        return fn(x, *a, **kw)
    return wrapped


def test_resblock_towers_route_like_the_jax_package(monkeypatch):
    """Batch 1: every stage of C <= 128 sends each ResBlock1 tower to K3
    with that tower's dilations, in tower order; K1 and K2 (which need
    several towers sharing dilations) are never taken. Batch 2: all plain,
    as the JAX package keeps K3 to batch 1."""
    calls = []
    for attr, name in (("fused_resblock1", "resblock"), ("fused_mrf", "mrf"),
                       ("fused_upsample_stage", "stage")):
        monkeypatch.setattr(port_hifigan, attr, _spy(calls, name, getattr(port_hifigan, attr)))
    gen = Generator(HifiGanConfig(**{**SINGLE, "upsample_initial_channel": 512}),
                    use_pallas=True)
    with torch.no_grad():
        wav = gen(torch.zeros(1, 3, 80))
    assert wav.shape == (1, 3 * 256)
    assert calls == [("resblock", (1, 3 * 64, 128), (1, 3, 5)),
                     ("resblock", (1, 3 * 128, 64), (1, 3, 5)),
                     ("resblock", (1, 3 * 256, 32), (1, 3, 5))]
    calls.clear()
    with torch.no_grad():
        Generator(HifiGanConfig(**DIFFERING), use_pallas=True)(torch.zeros(1, 3, 80))
    assert calls == [("resblock", (1, 12, 32), (1, 3, 5)), ("resblock", (1, 12, 32), (1, 2)),
                     ("resblock", (1, 48, 16), (1, 3, 5)), ("resblock", (1, 48, 16), (1, 2))]
    calls.clear()
    with torch.no_grad():
        gen(torch.zeros(2, 3, 80))
    assert calls == []


def test_switches_route_like_the_jax_package(monkeypatch):
    """use_pallas off (the default): no stage takes a kernel, at any batch.
    pallas_all_batches: batch 2 takes K1 and K3 as batch 1 does (K2 takes
    every batch either way), as the JAX Generator's switch does."""
    calls = []
    for attr, name in (("fused_resblock1", "resblock"), ("fused_mrf", "mrf"),
                       ("fused_upsample_stage", "stage")):
        monkeypatch.setattr(port_hifigan, attr, _spy(calls, name, getattr(port_hifigan, attr)))
    single = HifiGanConfig(**{**SINGLE, "upsample_initial_channel": 512})
    default = HifiGanConfig()
    for cfg in (single, default):
        for B in (1, 2):
            with torch.no_grad():
                Generator(cfg)(torch.zeros(B, 3, 80))
    assert calls == []
    with torch.no_grad():
        Generator(single, use_pallas=True, pallas_all_batches=True)(torch.zeros(2, 3, 80))
    assert calls == [("resblock", (2, 3 * 64, 128), (1, 3, 5)),
                     ("resblock", (2, 3 * 128, 64), (1, 3, 5)),
                     ("resblock", (2, 3 * 256, 32), (1, 3, 5))]
    calls.clear()
    with torch.no_grad():
        Generator(default, use_pallas=True, pallas_all_batches=True)(torch.zeros(2, 3, 80))
    assert [(c[0], c[1][0]) for c in calls] == [("mrf", 2), ("stage", 2), ("stage", 2)]
