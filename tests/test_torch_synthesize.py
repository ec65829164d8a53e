"""The slice as a whole: the JAX engine and the port's engine on the same
weights, text, forced durations and reference wav.

Tolerances: speaker embedding and mel 1e-4 (float32 through a few dozen
layers, summed in other orders); waveform atol 1e-3, the port's stated
waveform bound, and also 1e-3 of the waveform's peak, since random weights
give a quiet waveform.
"""

import jax
import numpy as np
import pytest

import zerovox_tpu.config as jc
from zerovox_tpu.models.hifigan import HifiGanConfig as JaxHifiGanConfig
from zerovox_tpu.synthesize import ZeroVoxTTS as JaxTTS

import zerovox_tpu_torch.config as pc
from zerovox_tpu_torch.models.hifigan import HifiGanConfig
from zerovox_tpu_torch.synthesize import ZeroVoxTTS

TEXT = "Hello world, this is a test."
CHUNK = 24


def _cfg(mod):
    return mod.ZeroVoxConfig(model=mod.ModelConfig(
        max_txt_len=64, max_mel_len=256, emb_dim=48, punct_emb_dim=16,
        encoder=mod.EncoderConfig(fs2_layer=1, fs2_head=2, vp_filter_size=16, ve_n_bins=16),
        decoder=mod.DecoderConfig(n_layers=1, n_head=2, conv_filter_size=64),
        resnet=mod.ResNetConfig(layers=(1, 1, 1, 1), num_filters=(8, 16, 16, 16))))


@pytest.fixture(scope="module")
def engines():
    # 256 initial channels: stages of 128 and 64 channels take the MRF path,
    # 64->32 and 32->16 the upsample-stage path, as on the card
    jax_tts = JaxTTS.from_random(_cfg(jc), JaxHifiGanConfig(upsample_initial_channel=256), seed=0)
    variables = jax.tree.map(np.asarray, jax_tts._variables)
    meldec_variables = jax.tree.map(np.asarray, jax_tts._meldec_variables)
    port = ZeroVoxTTS.from_jax_variables(_cfg(pc), variables,
                                         HifiGanConfig(upsample_initial_channel=256),
                                         meldec_variables, device="cpu")
    ref_wav = np.random.default_rng(0).normal(size=12000).astype(np.float32) * 0.2
    spk = np.asarray(jax_tts.speaker_embed(ref_wav))
    dur = np.full(len(jax_tts.text2phonemeids(TEXT)[0]), 3, np.int32)
    return jax_tts, port, ref_wav, spk, dur


def test_speaker_embed_matches_jax(engines):
    jax_tts, port, ref_wav, spk, _ = engines
    got = port.speaker_embed(ref_wav).numpy()
    assert got.shape == spk.shape == (1, 1, port.cfg.model.emb_size)
    np.testing.assert_allclose(got, spk, atol=1e-4, rtol=0)


def test_tts_ex_matches_jax(engines):
    jax_tts, port, _, spk, dur = engines
    wav_j, ph_j, n_j, mel_j = jax_tts.tts_ex(TEXT, spk, duration=dur)
    wav_p, ph_p, n_p, mel_p = port.tts_ex(TEXT, spk, duration=dur)
    assert n_p == n_j == 3 * len(dur)
    np.testing.assert_array_equal(ph_p, ph_j)
    assert mel_p.shape == mel_j.shape == (port.cfg.audio.num_mels, n_j)
    np.testing.assert_allclose(mel_p, mel_j, atol=1e-4, rtol=0)
    assert wav_p.shape == wav_j.shape == (n_j * port.cfg.audio.hop_size,)
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


def test_streamer_windows_carry_their_chunks(engines):
    """ChunkStreamer itself: each dispatched window carries its chunk's
    samples (on the CPU with no copy in flight), an interior window's chunk
    equals that stretch of the full render, and a stream handed its first
    window equals the full render and the JAX stream."""
    from zerovox_tpu_torch.streaming import ChunkStreamer
    from zerovox_tpu_torch.synthesize import MEL_BUCKETS, pick_bucket

    jax_tts, port, _, spk, dur = engines
    wav, _, n = port.tts(TEXT, spk, duration=dur)
    ids, puncts = port.text2phonemeids(TEXT)
    enc, _, d = port._encode(ids, puncts, spk, dur)
    mel = port._decode(enc, spk, pick_bucket(n, MEL_BUCKETS))
    up = port._meldec_cfg.total_upsample
    streamer = ChunkStreamer(port._meldec, port._meldec_cfg, mel, CHUNK)
    first = streamer.dispatch(0)
    assert first.ready is None and first.samples.shape == (CHUNK * up,)
    inner = streamer.dispatch(CHUNK)
    np.testing.assert_allclose(ChunkStreamer.trim(inner, CHUNK, up),
                               wav[CHUNK * up:2 * CHUNK * up], atol=1e-6, rtol=0)
    chunks = list(streamer.chunks(n, first_wav=first))
    assert [len(c) for c in chunks[:-1]] == [CHUNK * up] * (len(chunks) - 1)
    streamed = np.concatenate(chunks)
    np.testing.assert_allclose(streamed, wav, atol=1e-6, rtol=0)
    jax_streamed = np.concatenate(
        [np.asarray(c) for c in jax_tts.tts_stream(TEXT, spk, duration=dur, chunk_frames=CHUNK)])
    np.testing.assert_allclose(streamed, jax_streamed, atol=1e-3 * np.max(np.abs(wav)), rtol=0)


def test_predicted_durations_match_jax(engines):
    """No forced durations: both engines predict the lengths, pick the
    speculative mel bucket from the phone count, and read the duration sum
    from the device."""
    jax_tts, port, _, spk, _ = engines
    wav_j, _, n_j = jax_tts.tts(TEXT, spk)
    wav_p, _, n_p = port.tts(TEXT, spk)
    assert n_p == n_j >= 1
    assert wav_p.shape == wav_j.shape == (n_j * port.cfg.audio.hop_size,)
    np.testing.assert_allclose(wav_p, wav_j, atol=1e-3 * max(np.max(np.abs(wav_j)), 1e-3), rtol=0)


def test_load_model_reads_a_model_directory(engines, tmp_path):
    """`load_model` on an upstream-style layout (modelcfg.yaml +
    checkpoints/*.ckpt, and a meldec dir with config.json + generator.ckpt)
    gives the engine whose weights were saved."""
    import dataclasses
    import json

    import torch

    _, port, _, spk, dur = engines
    sd, meldec_sd = port.state_dicts()
    (tmp_path / "checkpoints").mkdir()
    torch.save({"state_dict": sd}, tmp_path / "checkpoints" / "last.ckpt")
    port.cfg.to_yaml(tmp_path / "modelcfg.yaml")
    meldec_dir = tmp_path / "meldec"
    meldec_dir.mkdir()
    (meldec_dir / "config.json").write_text(json.dumps(dataclasses.asdict(port._meldec_cfg)))
    gen = {k[len("generator."):]: v for k, v in meldec_sd.items() if k.startswith("generator.")}
    torch.save({"generator": gen}, meldec_dir / "generator.ckpt")

    modelcfg, loaded = ZeroVoxTTS.load_model(tmp_path, meldec_model=meldec_dir, device="cpu")
    assert modelcfg["model"]["emb_dim"] == port.cfg.model.emb_dim
    want, _, n = port.tts(TEXT, spk, duration=dur)
    got, _, n_got = loaded.tts(TEXT, spk, duration=dur)
    assert n_got == n
    np.testing.assert_array_equal(got, want)
