"""The port's layer primitives against the JAX package's `models/layers.py`
(CPU, float32). Single reductions of a few dozen terms: atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerovox_tpu.models import layers as jl
from zerovox_tpu.models.fs2 import _position_table

from zerovox_tpu_torch.models import layers as pl

TOL = dict(rtol=1e-5, atol=1e-5)


def _r(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("k,d,pad", [(9, 1, 4), (1, 1, 0), (3, 3, 3), (11, 5, 25), (7, 1, 3)])
def test_conv1d_matches_jax(k, d, pad):
    rng = np.random.default_rng(k * d)
    x, w, b = _r(rng, 2, 30, 6), _r(rng, k, 6, 5), _r(rng, 5)
    want = jl.conv1d(jnp.asarray(x), jnp.asarray(w), padding=pad, dilation=d) + b
    got = pl.conv1d(torch.from_numpy(x), torch.from_numpy(w).permute(2, 1, 0),
                    torch.from_numpy(b), padding=pad, dilation=d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k,s", [(16, 8), (4, 2), (8, 4)])
def test_conv_transpose1d_matches_jax(k, s):
    """The JAX kernel is stored flipped on the taps; the port's is torch's."""
    rng = np.random.default_rng(k)
    x, w, b = _r(rng, 1, 13, 6), _r(rng, 6, 4, k), _r(rng, 4)  # torch (in, out, k)
    jax_kernel = np.flip(np.transpose(w, (2, 0, 1)), axis=0).copy()
    want = jl.conv_transpose1d_subpixel(jnp.asarray(x), jnp.asarray(jax_kernel), s, (k - s) // 2) + b
    got = pl.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), s,
                              (k - s) // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_scln_and_torch_std_match_jax():
    rng = np.random.default_rng(0)
    x, s, kern = _r(rng, 2, 7, 12), _r(rng, 2, 1, 12), _r(rng, 12, 24)
    x[0, 3] = 1.5  # a constant row: std 0, kept finite by the 1e-12
    np.testing.assert_allclose(pl.torch_std(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.torch_std(jnp.asarray(x))), **TOL)
    want = jl.SCLN(12).apply({"params": {"affine_layer": {"kernel": kern}}}, x, s)
    scln = pl.SCLN(12)
    scln.load_state_dict({"affine_layer.linear.weight": torch.from_numpy(kern.T.copy())})
    with torch.no_grad():
        got = scln(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_norms_match_jax():
    rng = np.random.default_rng(1)
    x, g, b = _r(rng, 2, 9, 6), _r(rng, 6), _r(rng, 6)
    want = jl.LayerNorm(6).apply({"params": {"scale": g, "bias": b}}, x)
    ln = torch.nn.LayerNorm(6)
    ln.load_state_dict({"weight": torch.from_numpy(g), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        np.testing.assert_allclose(ln(torch.from_numpy(x)).numpy(), np.asarray(want), **TOL)
    want = jl.InstanceNorm(6).apply({}, x)
    np.testing.assert_allclose(pl.instance_norm_time(torch.from_numpy(x)).numpy(),
                               np.asarray(want), **TOL)
    # the port's vocoder uses torch's leaky relu
    np.testing.assert_array_equal(torch.nn.functional.leaky_relu(torch.from_numpy(x), 0.1).numpy(),
                                  np.asarray(jl.leaky_relu(jnp.asarray(x), 0.1)))


@pytest.mark.parametrize("seq_len", [16, 96, 700])
def test_position_table_matches_jax(seq_len):
    """Past the trained length (512 here) the JAX package regenerates the
    table; the port's table is length-independent either way."""
    want = np.asarray(_position_table(seq_len, 512, 64))
    got = pl.position_table(seq_len, 64, torch.device("cpu"), torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
