"""Weights carried across packages: JAX `from_random` variables ->
`from_jax_variables` -> the port's modules -> their state_dict -> the JAX
package's own torch importer gives back exactly the starting tensors. That
proves the port's modules carry the upstream state_dict key names."""

import jax
import numpy as np
import pytest

import zerovox_tpu.config as jc
from zerovox_tpu.checkpoint import (_SD, _fold_weight_norm, convert_hifigan_generator,
                                    convert_zerovox_state_dict)
from zerovox_tpu.models.hifigan import HifiGanConfig, MelDec as JaxMelDec
from zerovox_tpu.models.zerovox import ZeroVox as JaxZeroVox

import zerovox_tpu_torch.config as pc
from zerovox_tpu_torch.models.hifigan import HifiGanConfig as PortHifiGanConfig, MelDec
from zerovox_tpu_torch.models.zerovox import ZeroVox
from zerovox_tpu_torch.weights import (fold_weight_norm, from_jax_variables,
                                       meldec_from_jax_variables, upstream_generator_state_dict)


def _cfg(mod, punct_emb_dim=16, scln=True):
    return mod.ZeroVoxConfig(model=mod.ModelConfig(
        max_txt_len=64, max_mel_len=256, emb_dim=32, punct_emb_dim=punct_emb_dim,
        encoder=mod.EncoderConfig(fs2_layer=2, fs2_head=2, vp_filter_size=16, ve_n_bins=16),
        decoder=mod.DecoderConfig(n_layers=2, n_head=2, conv_filter_size=32, scln=scln),
        resnet=mod.ResNetConfig(layers=(2, 1, 1, 1), num_filters=(8, 16, 16, 16))))


def _jax_variables(cfg):
    batch = {
        "phoneme": np.zeros((1, 16), np.int32), "puncts": np.zeros((1, 16), np.int32),
        "phoneme_mask": np.zeros((1, 16), bool), "pitch": np.zeros((1, 16), np.float32),
        "energy": np.zeros((1, 16), np.float32), "duration": np.ones((1, 16), np.int32),
        "mel_mask": np.zeros((1, 16), bool), "ref_mel": np.zeros((1, 32, 80), np.float32),
    }
    v = jax.jit(lambda k: JaxZeroVox(cfg).init({"params": k}, batch, train=False))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, v)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("punct_emb_dim,scln", [(16, True), (0, False)])
def test_zerovox_round_trip_is_exact(punct_emb_dim, scln):
    jcfg = _cfg(jc, punct_emb_dim, scln)
    variables = _jax_variables(jcfg)
    model = ZeroVox(_cfg(pc, punct_emb_dim, scln))
    model.load_state_dict(from_jax_variables(variables, _cfg(pc, punct_emb_dim, scln)))
    back = convert_zerovox_state_dict(model.state_dict(), jcfg)
    want, got = _leaves(variables), _leaves(back)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].shape == got[k].shape, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


@pytest.mark.parametrize("hcfg", [
    dict(),
    dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
         resblock="2", resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2))),
])
def test_generator_round_trip_is_exact(hcfg):
    jh = HifiGanConfig(**{"upsample_initial_channel": 64, **hcfg})
    ph = PortHifiGanConfig(**{"upsample_initial_channel": 64, **hcfg})
    init = jax.jit(lambda k: JaxMelDec(jh).init(k, np.zeros((1, 8, 80), np.float32),
                                                normalize_before=True))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(1)))
    md = MelDec(ph)
    md.load_state_dict(meldec_from_jax_variables(variables, ph))
    gen_sd = {k[len("generator."):]: v for k, v in md.state_dict().items()
              if k.startswith("generator.")}
    back = convert_hifigan_generator(_SD(gen_sd), jh)
    want, got = _leaves(variables["params"]["generator"]), _leaves(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    np.testing.assert_array_equal(md.mean.numpy(), variables["params"]["mean"])
    np.testing.assert_array_equal(md.scale.numpy(), variables["params"]["scale"])


def test_weight_norm_fold_matches_jax_importer():
    import torch

    rng = np.random.default_rng(0)
    v = torch.tensor(rng.normal(size=(6, 4, 3)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(6, 1, 1)).astype(np.float32))
    sd = {"conv_pre.weight_g": g, "conv_pre.weight_v": v, "conv_pre.bias": torch.zeros(6)}
    folded = fold_weight_norm(sd)
    assert set(folded) == {"conv_pre.weight", "conv_pre.bias"}
    want = _fold_weight_norm(g, v)
    np.testing.assert_allclose(folded["conv_pre.weight"].numpy(), want, rtol=1e-6, atol=1e-7)
    assert "generator.conv_pre.weight" in upstream_generator_state_dict(sd)
