"""The port's PQMF filter bank, multi-band MelDec and Griffin-Lim against
the JAX package's (CPU, float32): the same inputs through both, within
1e-5 x the output's max; Griffin-Lim's waveform within 1e-4 x its max
after up to 2 rounds.

Griffin-Lim's rounds amplify float32 rounding where a frame's spectrum is
near zero (the phase taken there is the rounding's): on a 440 Hz tone the
two packages' waveforms are 6e-8, 1.1e-6, 6.6e-6, 5.7e-4 and 2.9e-3 apart
after 0, 1, 2, 4 and 8 rounds, as the JAX package's own float32 run is
3.2e-4 from its float64 run after 8 (XLA's and torch's CPU FFTs are
equally accurate). At 8 rounds the test therefore holds what Griffin-Lim
optimizes: the mel the output re-analyzes to, against the input, about as
close for the port as for the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerovox_tpu.dsp.griffinlim import GriffinLim as JaxGriffinLim
from zerovox_tpu.dsp.mels import get_mel_from_wav
from zerovox_tpu.models.hifigan import HifiGanConfig as JaxHifiGanConfig, MelDec as JaxMelDec
from zerovox_tpu.ops.pqmf import PQMF as JaxPQMF

from zerovox_tpu_torch.dsp.griffinlim import GriffinLim
from zerovox_tpu_torch.models.hifigan import HifiGanConfig, MelDec
from zerovox_tpu_torch.ops.pqmf import PQMF
from zerovox_tpu_torch.weights import meldec_from_jax_variables


def _close_rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


def _tones(n, sr=16000):
    t = np.arange(n) / sr
    x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1830 * t)
    return np.stack([x, 0.5 * x[::-1]]).astype(np.float32)


@pytest.mark.parametrize("subbands", [4, 2])
def test_pqmf_analysis_and_synthesis_match_jax(subbands):
    x = _tones(1024)
    port, jax_bank = PQMF(subbands), JaxPQMF(subbands)
    bands = port.analysis(torch.from_numpy(x))
    want = np.asarray(jax_bank.analysis(jnp.asarray(x)))
    assert bands.shape == (2, 1024 // subbands, subbands)
    _close_rel(bands.numpy(), want, 1e-5)
    _close_rel(port.synthesis(bands).numpy(), np.asarray(jax_bank.synthesis(jnp.asarray(want))),
               1e-5)
    # the torch-style [B, subbands, T] layout is taken too
    _close_rel(port.synthesis(bands.transpose(1, 2)).numpy(),
               np.asarray(jax_bank.synthesis(jnp.asarray(want))), 1e-5)


def test_multiband_meldec_matches_jax():
    """MelDec(subbands=4): the generator's stacked subbands through PQMF
    synthesis, on the JAX MelDec's weights."""
    import jax

    kw = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
              resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),), num_mels=20)
    jcfg, cfg = JaxHifiGanConfig(**kw), HifiGanConfig(**kw)
    mel = np.random.default_rng(0).normal(size=(2, 12, 20)).astype(np.float32)
    jmd = JaxMelDec(jcfg, subbands=4)
    variables = jax.device_get(jax.jit(jmd.init)(jax.random.PRNGKey(1), mel))
    want = np.asarray(jax.jit(jmd.apply)(variables, mel))
    md = MelDec(cfg, subbands=4).eval()
    md.load_state_dict(meldec_from_jax_variables(variables, cfg))
    with torch.no_grad():
        got = md(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 12 * 8)
    _close_rel(got, want, 1e-5)


def _tone_mel(seconds=0.25, sr=22050):
    t = np.arange(int(seconds * sr)) / sr
    wav = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    mel, _ = get_mel_from_wav(audio=wav, sampling_rate=sr, fft_size=1024, hop_size=256,
                              win_length=1024, num_mels=80, fmin=0, fmax=8000)
    return mel  # [80, T]


@pytest.mark.parametrize("n_iter", [0, 1, 2])
def test_griffinlim_matches_jax(n_iter):
    mel = _tone_mel()
    want = JaxGriffinLim(n_iter=n_iter)(mel.T)
    got = GriffinLim(n_iter=n_iter, device="cpu")(mel.T)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.max(np.abs(got)) == pytest.approx(0.9, rel=1e-6)
    _close_rel(got, want, 1e-4)


def test_griffinlim_8_rounds_reconstructs_like_jax():
    """After 8 rounds: the mel amplitudes the output re-analyzes to against
    the input's (cosine over the interior frames), for the port within 5e-3
    of the JAX package's (0.9361 and 0.9382 measured on the CPU: the
    rounds' rounding moves it by that much), both above 0.9."""
    mel = _tone_mel(0.5)

    def cosine(wav):
        m2, _ = get_mel_from_wav(audio=wav, sampling_rate=22050, fft_size=1024, hop_size=256,
                                 win_length=1024, num_mels=80, fmin=0, fmax=8000)
        T = min(mel.shape[1], m2.shape[1]) - 4
        a, b = np.exp(mel[:, 4:T]).ravel(), np.exp(m2[:, 4:T]).ravel()
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))

    got, want = cosine(GriffinLim(n_iter=8, device="cpu")(mel.T)), cosine(JaxGriffinLim(n_iter=8)(mel.T))
    assert got > 0.9 and want > 0.9 and abs(got - want) < 5e-3, (got, want)


def test_griffinlim_defaults_to_the_card():
    """Like the port's other entry points, GriffinLim runs on the card
    unless the caller passes device="cpu"; without a card it raises."""
    if torch.cuda.is_available():
        assert GriffinLim(n_iter=1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GriffinLim(n_iter=1)
