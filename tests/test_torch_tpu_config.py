"""The lane-aligned `tts_medium_tpu` model and HiFi-GAN V3 (`resblock="2"`):
the configurations chip_smoke.py writes in code (the card's machine has no
pyyaml) against the YAML file and jik876/hifi-gan's `config_v3.json`, then
the JAX engine and the port's engine on the same weights with the punctuation
folded into the phone embedding (`punct_emb_dim=0`) and a V3-shaped vocoder.

Tolerances: those of tests/test_torch_synthesize.py (mel 1e-4; waveform
atol 1e-3 and 1e-3 of its peak, since random weights give a quiet
waveform; the stream within 1e-6 of the full render and 1e-3 of the peak
of the JAX stream).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import zerovox_tpu.config as jc
from zerovox_tpu.models.hifigan import HifiGanConfig as JaxHifiGanConfig
from zerovox_tpu.synthesize import ZeroVoxTTS as JaxTTS

import zerovox_tpu_torch.config as pc
from zerovox_tpu_torch.synthesize import ZeroVoxTTS
from zerovox_tpu_torch.weights import meldec_to_jax_variables, to_jax_variables

ROOT = Path(__file__).resolve().parents[1]
YAML = ROOT / "configs" / "tts_medium_tpu.yaml"
TEXT = "Hello world, this is a test."
CHUNK = 24
# jik876/hifi-gan config_v3.json's generator
CONFIG_V3 = {"resblock": "2", "upsample_rates": (8, 8, 4), "upsample_kernel_sizes": (16, 16, 8),
             "upsample_initial_channel": 256, "resblock_kernel_sizes": (3, 5, 7),
             "resblock_dilation_sizes": ((1, 2), (2, 6), (3, 12))}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("raw")
    return d


def test_tts_medium_tpu_is_the_yaml_file():
    got = _chip_smoke().tts_medium_tpu()
    want = pc.ZeroVoxConfig.from_yaml(YAML)
    assert got == want
    assert _fields(got) == _fields(want) == _fields(jc.ZeroVoxConfig.from_yaml(YAML))
    assert got.model.emb_size == 512 and got.model.punct_emb_dim == 0
    # two heads of 256: K5's head dim on this model
    assert got.model.emb_size // got.model.encoder.fs2_head == 256
    assert got.model.emb_size // got.model.decoder.n_head == 256


def test_hifigan_v3_is_config_v3():
    cs = _chip_smoke()
    v3 = cs.hifigan_v3()
    assert {k: getattr(v3, k) for k in CONFIG_V3} == CONFIG_V3
    assert v3.total_upsample == cs.tts_medium_tpu().audio.hop_size == 256
    # ResBlock1's formula (an over-estimate for ResBlock2, exact for streaming)
    assert v3.receptive_field_frames() == 27


def _cfg(mod):
    return mod.ZeroVoxConfig(model=mod.ModelConfig(
        max_txt_len=64, max_mel_len=256, emb_dim=48, punct_emb_dim=0,
        encoder=mod.EncoderConfig(fs2_layer=1, fs2_head=2, vp_filter_size=16, ve_n_bins=16),
        decoder=mod.DecoderConfig(n_layers=1, n_head=2, conv_filter_size=64),
        resnet=mod.ResNetConfig(layers=(1, 1, 1, 1), num_filters=(8, 16, 16, 16))))


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's engine through `from_jax_variables` on
    one set of weights: the port's seeded random weights carried into JAX
    trees (`to_jax_variables`), which skips compiling the JAX model's init."""
    # V3 at 32 initial channels: stages of 16, 8 and 4 channels on ResBlock2
    # towers, which neither package fuses (nn.Modules on both)
    hcfg = dataclasses.replace(_chip_smoke().hifigan_v3(), upsample_initial_channel=32)
    sd, md = ZeroVoxTTS.from_random(_cfg(pc), hcfg, seed=0, device="cpu").state_dicts()
    variables, meldec_variables = to_jax_variables(sd, _cfg(pc)), meldec_to_jax_variables(md, hcfg)
    jax_tts = JaxTTS(_cfg(jc), variables, JaxHifiGanConfig(**dataclasses.asdict(hcfg)),
                     meldec_variables)
    port = ZeroVoxTTS.from_jax_variables(_cfg(pc), variables, hcfg, meldec_variables,
                                         device="cpu")
    ref_wav = np.random.default_rng(0).normal(size=12000).astype(np.float32) * 0.2
    spk = np.asarray(jax_tts.speaker_embed(ref_wav))
    dur = np.full(len(jax_tts.text2phonemeids(TEXT)[0]), 3, np.int32)
    return jax_tts, port, ref_wav, spk, dur


def test_speaker_embed_matches_jax(engines):
    jax_tts, port, ref_wav, spk, _ = engines
    got = port.speaker_embed(ref_wav).numpy()
    assert got.shape == spk.shape == (1, 1, 48)
    np.testing.assert_allclose(got, spk, atol=1e-4, rtol=0)


def test_tts_ex_matches_jax(engines):
    jax_tts, port, _, spk, dur = engines
    assert not port._meldec.generator._mrf_fusable
    wav_j, ph_j, n_j, mel_j = jax_tts.tts_ex(TEXT, spk, duration=dur)
    wav_p, ph_p, n_p, mel_p = port.tts_ex(TEXT, spk, duration=dur)
    assert n_p == n_j == 3 * len(dur)
    np.testing.assert_array_equal(ph_p, ph_j)
    assert mel_p.shape == mel_j.shape == (port.cfg.audio.num_mels, n_j)
    np.testing.assert_allclose(mel_p, mel_j, atol=1e-4, rtol=0)
    assert wav_p.shape == wav_j.shape == (n_j * 256,)
    assert np.all(np.isfinite(wav_p))
    peak = np.max(np.abs(wav_j))
    assert peak > 1e-3
    err = np.max(np.abs(wav_p - wav_j))
    assert err < 1e-3 and err < 1e-3 * peak


def test_stream_matches_full_render_and_jax_stream(engines):
    jax_tts, port, _, spk, dur = engines
    wav, _, n = port.tts(TEXT, spk, duration=dur)
    chunks = list(port.tts_stream(TEXT, spk, duration=dur, chunk_frames=CHUNK))
    assert len(chunks) == -(-n // CHUNK)
    streamed = np.concatenate(chunks)
    assert streamed.shape == wav.shape
    np.testing.assert_allclose(streamed, wav, atol=1e-6, rtol=0)
    jax_streamed = np.concatenate(
        [np.asarray(c) for c in jax_tts.tts_stream(TEXT, spk, duration=dur, chunk_frames=CHUNK)])
    assert jax_streamed.shape == streamed.shape
    np.testing.assert_allclose(streamed, jax_streamed, atol=1e-3 * np.max(np.abs(wav)), rtol=0)
