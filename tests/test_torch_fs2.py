"""The port's acoustic model (encoder, variance adaptor, length regulation,
SCLN decoder) against the JAX package's `ZeroVox.encode` / `ZeroVox.decode`
on the same weights and inputs, in float32 on the CPU.

Tolerance 1e-5 on the encoder outputs (a few layers of float32 matmuls and
LayerNorms at these widths agree to ~1e-6) and 1e-4 on the decoded mel,
whose values come out of 96-frame attention reductions and two SCLNs.
"""

import jax
import numpy as np
import pytest
import torch

import zerovox_tpu.config as jc
from zerovox_tpu.checkpoint import convert_zerovox_state_dict
from zerovox_tpu.models.zerovox import ZeroVox as JaxZeroVox

import zerovox_tpu_torch.config as pc
from zerovox_tpu_torch.models.zerovox import ZeroVox
from zerovox_tpu_torch.synthesize import random_init_


def _cfg(mod, punct_emb_dim):
    return mod.ZeroVoxConfig(model=mod.ModelConfig(
        max_txt_len=64, max_mel_len=256, emb_dim=48, punct_emb_dim=punct_emb_dim,
        encoder=mod.EncoderConfig(fs2_layer=2, fs2_head=2, vp_filter_size=32, ve_n_bins=32),
        decoder=mod.DecoderConfig(n_layers=2, n_head=2, conv_filter_size=64),
        resnet=mod.ResNetConfig(layers=(1, 1, 1, 1), num_filters=(8, 8, 8, 8))))


@pytest.fixture(scope="module", params=[16, 0], ids=["concat-punct", "additive-punct"])
def models(request):
    pcfg, jcfg = _cfg(pc, request.param), _cfg(jc, request.param)
    port = ZeroVox(pcfg)
    random_init_(port, torch.Generator().manual_seed(request.param))
    with torch.no_grad():  # nonzero biases and norms so every parameter matters
        for p in port.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.1)
    port.eval()
    variables = convert_zerovox_state_dict(port.state_dict(), jcfg)
    return port, JaxZeroVox(jcfg), variables, pcfg


def _inputs(seed, B=2, L=32):
    rng = np.random.default_rng(seed)
    n = np.array([L - 5, 11])[:B]
    ph = rng.integers(1, 29, size=(B, L)).astype(np.int32)
    pu = rng.integers(0, 10, size=(B, L)).astype(np.int32)
    pu[:, ::3] = 0
    mask = np.arange(L)[None, :] >= n[:, None]
    ph[mask] = 0
    pu[mask] = 0
    spk = rng.normal(size=(B, 1, 64)).astype(np.float32)
    return ph, pu, mask, spk


def test_encode_matches_jax(models):
    port, jmodel, variables, pcfg = models
    ph, pu, mask, spk = _inputs(0)
    spk = spk[..., : pcfg.model.emb_size]
    want = jax.jit(lambda v, a, b, m, s: jmodel.apply(v, a, b, s, phoneme_mask=m,
                                                      method=JaxZeroVox.encode))(
        variables, ph, pu, mask, spk)
    with torch.no_grad():
        got = port.encode(torch.from_numpy(ph).long(), torch.from_numpy(pu).long(),
                          torch.from_numpy(spk), phoneme_mask=torch.from_numpy(mask))
    for k in ("x", "pitch", "energy", "log_duration"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(got["duration_rounded"].numpy(),
                                  np.asarray(want["duration_rounded"]))


def test_decode_with_forced_durations_matches_jax(models):
    port, jmodel, variables, pcfg = models
    ph, pu, mask, spk = _inputs(1)
    spk = spk[..., : pcfg.model.emb_size]
    dur = np.where(mask, 0, np.random.default_rng(2).integers(0, 5, size=mask.shape)).astype(np.int32)

    def jax_fn(v, a, b, m, s, d):
        enc = jmodel.apply(v, a, b, s, phoneme_mask=m, duration_target=d, method=JaxZeroVox.encode)
        return jmodel.apply(v, enc["x"], enc["duration_rounded"], s, 96, method=JaxZeroVox.decode)

    mel_j, len_j, mask_j = jax.jit(jax_fn)(variables, ph, pu, mask, spk, dur)
    with torch.no_grad():
        enc = port.encode(torch.from_numpy(ph).long(), torch.from_numpy(pu).long(),
                          torch.from_numpy(spk), phoneme_mask=torch.from_numpy(mask),
                          duration_target=torch.from_numpy(dur))
        mel, mel_len, mel_mask = port.decode(enc["x"], enc["duration_rounded"],
                                             torch.from_numpy(spk), 96)
    np.testing.assert_array_equal(mel_len.numpy(), np.asarray(len_j))
    np.testing.assert_array_equal(mel_mask.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(mel.numpy(), np.asarray(mel_j), rtol=1e-4, atol=1e-4)
