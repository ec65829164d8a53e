"""The port's StyleTTS decoder against the JAX package (CPU, float32): each
of ResBlk1d, AdaIN1d, AdainResBlk1d and StyleTTSDecoder against the JAX
module on the same weights, carried over by the JAX package's own torch
importer; the decoder's weights round-trip exactly through
`from_jax_variables`.

Tolerance: 1e-4 x the output's max |value|. Each module is a few float32
convolutions and instance norms, whose sums the two frameworks take in
other orders; the bound scales with the output because random weights set
its size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zerovox_tpu.config as jc
from zerovox_tpu.checkpoint import (_SD, _convert_adain_resblk1d, _convert_resblk1d,
                                    convert_styletts_decoder, convert_zerovox_state_dict)
from zerovox_tpu.models import styletts as jst
from zerovox_tpu.models.zerovox import ZeroVox as JaxZeroVox

import zerovox_tpu_torch.config as pc
from zerovox_tpu_torch.models import styletts as pst
from zerovox_tpu_torch.models.zerovox import ZeroVox
from zerovox_tpu_torch.synthesize import random_init_
from zerovox_tpu_torch.weights import from_jax_variables

REL = 1e-4


def _init(module, seed):
    """Seeded random weights with nonzero biases, norm scales and gains, so
    every parameter reaches the output."""
    random_init_(module, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("weight_g") or (p.dim() == 1 and name.endswith("weight")):
                p.uniform_(0.5, 1.5, generator=gen)
            elif p.dim() == 1:
                p.normal_(0.0, 0.1, generator=gen)
    return module.eval()


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= REL * np.max(np.abs(want)), (err, np.max(np.abs(want)))


@pytest.mark.parametrize("dim_in,dim_out,normalize", [(16, 32, True), (32, 32, True), (24, 16, False)])
def test_resblk1d_matches_jax(dim_in, dim_out, normalize):
    port = _init(pst.ResBlk1d(dim_in, dim_out, normalize=normalize), dim_in + dim_out)
    params = _convert_resblk1d(_SD(port.state_dict()), normalize=normalize,
                               learned_sc=dim_in != dim_out)
    x = _x(0, 2, 30, dim_in)
    want = jst.ResBlk1d(dim_in, dim_out, normalize=normalize).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, want)


def test_adain1d_matches_jax():
    port = _init(pst.AdaIN1d(12, 20), 5)
    params = {"fc": {"kernel": port.fc.weight.detach().numpy().T, "bias": port.fc.bias.detach().numpy()}}
    x, s = _x(1, 2, 25, 20), _x(2, 2, 12)
    want = jst.AdaIN1d(20).apply({"params": params}, jnp.asarray(x), jnp.asarray(s))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    _close(got, want)


@pytest.mark.parametrize("dim_in,dim_out", [(40, 32), (32, 32)])
def test_adain_resblk1d_matches_jax(dim_in, dim_out):
    port = _init(pst.AdainResBlk1d(dim_in, dim_out, style_dim=12), dim_in)
    params = _convert_adain_resblk1d(_SD(port.state_dict()), learned_sc=dim_in != dim_out)
    x, s = _x(3, 2, 28, dim_in), _x(4, 2, 12)
    want = jst.AdainResBlk1d(dim_in, dim_out).apply({"params": params}, jnp.asarray(x),
                                                     jnp.asarray(s))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    _close(got, want)


def test_styletts_decoder_matches_jax():
    port = _init(pst.StyleTTSDecoder(24, 24, residual_dim=8, dim_out=10), 9)
    params = convert_styletts_decoder(_SD(port.state_dict()))
    enc, spk = _x(5, 2, 33, 24), _x(6, 2, 1, 24)
    mask = np.zeros((2, 33), bool)
    mask[1, 20:] = True
    want = jst.StyleTTSDecoder(24, 24, residual_dim=8, dim_out=10).apply(
        {"params": params}, jnp.asarray(enc), jnp.asarray(mask), jnp.asarray(spk))
    with torch.no_grad():
        got = port(torch.from_numpy(enc), torch.from_numpy(mask), torch.from_numpy(spk)).numpy()
    assert got.shape == (2, 33, 10)
    _close(got, want)


def _cfg(mod):
    return mod.ZeroVoxConfig(model=mod.ModelConfig(
        max_txt_len=64, max_mel_len=256, emb_dim=32, punct_emb_dim=16,
        encoder=mod.EncoderConfig(fs2_layer=1, fs2_head=2, vp_filter_size=16, ve_n_bins=16),
        decoder=mod.DecoderConfig(kind="styletts"),
        resnet=mod.ResNetConfig(layers=(1, 1, 1, 1), num_filters=(8, 16, 16, 16))))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_styletts_weights_round_trip_exactly():
    """JAX variables -> from_jax_variables -> the port's ZeroVox (strict
    load) -> the JAX package's importer gives back exactly the starting
    tensors: the whole model, and the decoder through
    convert_styletts_decoder on its own."""
    jcfg = _cfg(jc)
    batch = {
        "phoneme": np.zeros((1, 16), np.int32), "puncts": np.zeros((1, 16), np.int32),
        "phoneme_mask": np.zeros((1, 16), bool), "pitch": np.zeros((1, 16), np.float32),
        "energy": np.zeros((1, 16), np.float32), "duration": np.ones((1, 16), np.int32),
        "mel_mask": np.zeros((1, 16), bool), "ref_mel": np.zeros((1, 32, 80), np.float32),
    }
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k: JaxZeroVox(jcfg).init({"params": k}, batch, train=False))(jax.random.PRNGKey(2)))
    model = ZeroVox(_cfg(pc))
    model.load_state_dict(from_jax_variables(variables, _cfg(pc)))
    sd = model.state_dict()
    # emb_size 48: bottleneck 96, residual 64
    assert sd["_mel_decoder.encode.0.conv1.weight_g"].shape == (48, 1, 1)
    assert sd["_mel_decoder.encode.0.conv1x1.weight_v"].shape == (96, 48, 1)
    assert sd["_mel_decoder.decode.2.norm1.fc.weight"].shape == (2 * (96 + 64), 48)
    want = _leaves(variables)
    got = _leaves(convert_zerovox_state_dict(sd, jcfg))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    dec = _leaves(convert_styletts_decoder(_SD(sd).sub("_mel_decoder.")))
    dec_want = _leaves(variables["params"]["mel_decoder"])
    assert dec.keys() == dec_want.keys()
    for k in dec_want:
        np.testing.assert_array_equal(dec_want[k], dec[k], err_msg=k)
