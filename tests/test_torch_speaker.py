"""The port's speaker path — the mel frontend and the ResNetSE34V2 encoder in
eval mode — against the JAX package on the same audio and weights (CPU,
float32).

The log-mel is compared at atol 1e-4: log() turns the float32 STFT's
relative rounding of the quietest bins into absolute error of that order.
The embedding comes out of long conv and pooling reductions and is
L2-normalized; it is held to 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

import zerovox_tpu.config as jc
from zerovox_tpu.checkpoint import convert_zerovox_state_dict
from zerovox_tpu.dsp.mels import MelFrontend as JaxMelFrontend, mel_filterbank as jax_bank
from zerovox_tpu.models.zerovox import ZeroVox as JaxZeroVox

import zerovox_tpu_torch.config as pc
from zerovox_tpu_torch.dsp.mels import MelFrontend, mel_filterbank
from zerovox_tpu_torch.models.zerovox import ZeroVox
from zerovox_tpu_torch.synthesize import random_init_


def test_filterbank_is_identical():
    np.testing.assert_array_equal(mel_filterbank(22050, 1024, 80, 0, 8000),
                                  jax_bank(22050, 1024, 80, 0, 8000))


@pytest.mark.parametrize("n", [22050, 9999])
def test_frontend_matches_jax(n):
    rng = np.random.default_rng(n)
    wav = (np.sin(np.arange(n) * 0.05) * 0.3 + rng.normal(size=n) * 0.05).astype(np.float32)
    mel_j, en_j = JaxMelFrontend()(wav)
    mel, en = MelFrontend(device="cpu")(wav)
    assert mel.shape == mel_j.shape
    np.testing.assert_allclose(mel.numpy(), mel_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(en.numpy(), en_j, rtol=1e-5, atol=1e-5)


def _cfg(mod):
    return mod.ZeroVoxConfig(model=mod.ModelConfig(
        emb_dim=48, punct_emb_dim=16,
        encoder=mod.EncoderConfig(fs2_layer=1, vp_filter_size=16, ve_n_bins=16),
        decoder=mod.DecoderConfig(n_layers=1, conv_filter_size=32),
        resnet=mod.ResNetConfig(layers=(2, 2, 1, 1), num_filters=(8, 16, 16, 32))))


@pytest.mark.parametrize("T", [64, 75])
def test_resnetse_embedding_matches_jax(T):
    port = ZeroVox(_cfg(pc))
    gen = torch.Generator().manual_seed(T)
    random_init_(port, gen)
    with torch.no_grad():  # running stats and affine terms away from identity
        for name, t in port._spkemb.state_dict().items():
            if name.endswith(("running_mean", "bias")):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
            elif name.endswith(("running_var", "bn1.weight", "bn2.weight")):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    port.eval()
    variables = convert_zerovox_state_dict(port.state_dict(), _cfg(jc))
    mel = np.random.default_rng(T).normal(size=(1, T, 80)).astype(np.float32)
    want = jax.jit(lambda v, m: JaxZeroVox(_cfg(jc)).apply(
        v, m, method=JaxZeroVox.speaker_embed))(variables, mel)
    with torch.no_grad():
        got = port.speaker_embed(torch.from_numpy(mel))
    assert got.shape == (1, 1, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
