"""The StyleTTS-decoder serving slice as a whole, and `tts_batch`: the JAX
engine and the port's engine on the same weights, texts, durations and
reference wavs (CPU, float32).

The engine is a small StyleTTS-decoder acoustic model with a single-tower
HiFi-GAN, whose every stage runs ResBlock1 tower by tower (kernel K3's
route at batch 1, plain at batch > 1). The StyleTTS decoder's mel depends
on the mel bucket it runs at, so `tts_batch` rows are held to the JAX
package's `tts_batch` rows, not to `tts_ex`.

Tolerances: waveform atol 1e-3, the port's stated waveform bound, and also
1e-3 of the waveform's peak, since random weights give a quiet waveform;
mel 1e-4 x its peak (float32 through a few dozen layers, summed in other
orders); streamed chunks against the full render 1e-6.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import zerovox_tpu.config as jc
from zerovox_tpu.models.hifigan import HifiGanConfig as JaxHifiGanConfig
from zerovox_tpu.synthesize import ZeroVoxTTS as JaxTTS

import zerovox_tpu_torch.config as pc
from zerovox_tpu_torch.models.hifigan import HifiGanConfig
from zerovox_tpu_torch.models.styletts import StyleTTSDecoder
from zerovox_tpu_torch.synthesize import ZeroVoxTTS

TEXT = "Hello world, this is a test."
TEXTS = ["Hello world.", "This is a somewhat longer sentence for the batch.", "Short one"]
CHUNK = 24
SINGLE_TOWER = dict(upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                    upsample_initial_channel=64, resblock_kernel_sizes=(3,),
                    resblock_dilation_sizes=((1, 3, 5),))


def _cfg(mod, kind="styletts"):
    return mod.ZeroVoxConfig(model=mod.ModelConfig(
        max_txt_len=64, max_mel_len=256, emb_dim=48, punct_emb_dim=16,
        encoder=mod.EncoderConfig(fs2_layer=1, fs2_head=2, vp_filter_size=16, ve_n_bins=16),
        decoder=mod.DecoderConfig(kind=kind, n_layers=1, n_head=2, conv_filter_size=64),
        resnet=mod.ResNetConfig(layers=(1, 1, 1, 1), num_filters=(8, 16, 16, 16))))


def _pair(kind, hcfg, seed):
    jax_tts = JaxTTS.from_random(_cfg(jc, kind), JaxHifiGanConfig(**hcfg), seed=seed)
    port = ZeroVoxTTS.from_jax_variables(
        _cfg(pc, kind), jax.tree.map(np.asarray, jax_tts._variables), HifiGanConfig(**hcfg),
        jax.tree.map(np.asarray, jax_tts._meldec_variables), device="cpu")
    return jax_tts, port


@pytest.fixture(scope="module")
def engines():
    jax_tts, port = _pair("styletts", SINGLE_TOWER, 0)
    assert isinstance(port._model._mel_decoder, StyleTTSDecoder)
    rng = np.random.default_rng(0)
    ref_wavs = [rng.normal(size=12000).astype(np.float32) * s for s in (0.2, 0.1, 0.3)]
    spks = np.concatenate([np.asarray(jax_tts.speaker_embed(w)) for w in ref_wavs])
    return jax_tts, port, ref_wavs, spks


def _close_wav(got, want):
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    err = np.max(np.abs(got - want), initial=0.0)
    assert err < 1e-3 and err <= 1e-3 * max(np.max(np.abs(want), initial=0.0), 1e-3), err


def test_speaker_embed_matches_jax(engines):
    jax_tts, port, ref_wavs, spks = engines
    got = np.concatenate([port.speaker_embed(w).numpy() for w in ref_wavs])
    np.testing.assert_allclose(got, spks, atol=1e-4, rtol=0)


def test_tts_ex_matches_jax(engines):
    jax_tts, port, _, spks = engines
    spk = spks[:1]
    dur = np.full(len(jax_tts.text2phonemeids(TEXT)[0]), 3, np.int32)
    wav_j, ph_j, n_j, mel_j = jax_tts.tts_ex(TEXT, spk, duration=dur)
    wav_p, ph_p, n_p, mel_p = port.tts_ex(TEXT, spk, duration=dur)
    assert n_p == n_j == 3 * len(dur)
    np.testing.assert_array_equal(ph_p, ph_j)
    assert mel_p.shape == mel_j.shape
    assert np.max(np.abs(mel_p - mel_j)) <= 1e-4 * np.max(np.abs(mel_j))
    assert wav_p.shape == (n_j * port.cfg.audio.hop_size,)
    assert np.max(np.abs(wav_j)) > 1e-3
    _close_wav(wav_p, wav_j)


def test_stream_matches_full_render_and_jax(engines):
    jax_tts, port, _, spks = engines
    spk = spks[:1]
    dur = np.full(len(port.text2phonemeids(TEXT)[0]), 3, np.int32)
    wav, _, n = port.tts(TEXT, spk, duration=dur)
    chunks = list(port.tts_stream(TEXT, spk, duration=dur, chunk_frames=CHUNK))
    assert len(chunks) == -(-n // CHUNK)
    streamed = np.concatenate(chunks)
    assert streamed.shape == wav.shape
    np.testing.assert_allclose(streamed, wav, atol=1e-6, rtol=0)
    jax_streamed = np.concatenate(
        [np.asarray(c) for c in jax_tts.tts_stream(TEXT, spk, duration=dur, chunk_frames=CHUNK)])
    _close_wav(streamed, jax_streamed)


def _durations(port, texts, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 7, size=len(port.text2phonemeids(t)[0])).astype(np.int32)
            for t in texts]


def test_tts_batch_forced_matches_jax(engines):
    jax_tts, port, _, spks = engines
    durs = _durations(port, TEXTS, 1)
    want = jax_tts.tts_batch(TEXTS, spks, durations=durs)
    got = port.tts_batch(TEXTS, torch.from_numpy(spks), durations=durs)
    assert len(got) == len(want) == 3
    for (w_p, n_p), (w_j, n_j), d in zip(got, want, durs):
        assert n_p == n_j == int(d.sum())
        assert w_p.shape == (n_p * port.cfg.audio.hop_size,)
        _close_wav(w_p, np.asarray(w_j))


def test_tts_batch_predicted_matches_jax(engines):
    """No forced durations: a speculative bucket from the longest text, one
    host sync on the duration sums, the waveform trimmed to the exact
    bucket."""
    jax_tts, port, _, spks = engines
    want = jax_tts.tts_batch(TEXTS, spks)
    got = port.tts_batch(TEXTS, spks)
    for (w_p, n_p), (w_j, n_j) in zip(got, want):
        assert n_p == n_j
        _close_wav(w_p, np.asarray(w_j))


def test_tts_batch_rows_are_decoded_at_the_batch_bucket(engines):
    """A StyleTTS row depends on the mel bucket: a short row in a batch whose
    longest row needs a larger bucket differs from the same row alone, in
    both packages alike."""
    jax_tts, port, _, spks = engines
    durs = _durations(port, TEXTS, 2)
    assert max(int(d.sum()) for d in durs) > 96 > int(durs[0].sum())
    batch = port.tts_batch(TEXTS, spks, durations=durs)
    alone = port.tts_batch(TEXTS[:1], spks[:1], durations=durs[:1])
    assert batch[0][1] == alone[0][1]
    assert np.max(np.abs(batch[0][0] - alone[0][0])) > 1e-6
    _close_wav(batch[0][0], np.asarray(jax_tts.tts_batch(TEXTS, spks, durations=durs)[0][0]))


def test_tts_batch_checks_its_inputs(engines):
    _, port, _, spks = engines
    with pytest.raises(ValueError, match="durations"):
        port.tts_batch(TEXTS[:2], spks[:2], durations=[np.ones(3, np.int32)] * 2)
    with pytest.raises(ValueError, match="speaker embeddings"):
        port.tts_batch(TEXTS, spks[:2])
    empty = port.tts_batch(["...", "..."], spks[:2])
    assert [n for _, n in empty] == [0, 0] and all(w.shape == (1,) for w, _ in empty)


def test_tts_batch_fs2_default_vocoder_matches_jax():
    """The FS2 decoder with a three-tower vocoder at batch 2: the port runs
    the MRF stages plain (K1 is batch-1 only) and the narrow stages through
    the upsample-stage route (its plain version on the CPU)."""
    hcfg = dict(upsample_initial_channel=256)
    jax_tts, port = _pair("fastspeech2", hcfg, 4)
    spks = np.concatenate([np.asarray(jax_tts.speaker_embed(
        np.random.default_rng(s).normal(size=12000).astype(np.float32) * 0.2)) for s in (1, 2)])
    durs = _durations(port, TEXTS[:2], 3)
    want = jax_tts.tts_batch(TEXTS[:2], spks, durations=durs)
    got = port.tts_batch(TEXTS[:2], spks, durations=durs)
    for (w_p, n_p), (w_j, n_j) in zip(got, want):
        assert n_p == n_j
        _close_wav(w_p, np.asarray(w_j))


def test_load_model_reads_a_styletts_checkpoint(engines, tmp_path):
    """`load_model` reads a StyleTTS model directory (modelcfg.yaml with
    decoder kind styletts + checkpoints/*.ckpt holding `_mel_decoder.*`
    weight_g/weight_v keys) and gives the engine whose weights were saved."""
    _, port, _, spks = engines
    sd, meldec_sd = port.state_dicts()
    assert "_mel_decoder.to_out.0.weight_v" in sd
    (tmp_path / "checkpoints").mkdir()
    torch.save({"state_dict": sd}, tmp_path / "checkpoints" / "last.ckpt")
    port.cfg.to_yaml(tmp_path / "modelcfg.yaml")
    meldec_dir = tmp_path / "meldec"
    meldec_dir.mkdir()
    (meldec_dir / "config.json").write_text(json.dumps(dataclasses.asdict(port._meldec_cfg)))
    gen = {k[len("generator."):]: v for k, v in meldec_sd.items() if k.startswith("generator.")}
    torch.save({"generator": gen}, meldec_dir / "generator.ckpt")

    modelcfg, loaded = ZeroVoxTTS.load_model(tmp_path, meldec_model=meldec_dir, device="cpu")
    assert modelcfg["model"]["decoder"]["kind"] == "styletts"
    dur = np.full(len(port.text2phonemeids(TEXT)[0]), 3, np.int32)
    want, _, n = port.tts(TEXT, spks[:1], duration=dur)
    got, _, n_got = loaded.tts(TEXT, spks[:1], duration=dur)
    assert n_got == n
    np.testing.assert_array_equal(got, want)
