"""bf16 inference on the CPU against the JAX package: the plain bf16
versions of kernels K1 (fused MRF), K2 (fused upsample stage, with and
without conv_post) and K3 (one fused ResBlock1 tower) against the JAX
kernels on bf16 inputs (Pallas in interpret mode), and the bf16 engine
(`precision="bf16"`) against the JAX package's bf16 engine and against its
own float32 engine on the same weights, for both decoders, under forced
durations.

Bounds:
  * kernels: one bf16 step of the largest output (2^(floor(log2 max) - 7)).
    Both sides compute in float32 on the widened inputs (in other orders)
    and round the output once, so an element may round one step apart;
  * waveforms: 5e-2, the JAX package's bf16 bound (tests/test_synthesize.py,
    docs/PERFORMANCE.md:130-133). Random weights make a quiet waveform, so
    they are also held within a quarter of the float32 waveform's peak (a
    silent or unrelated waveform would meet 5e-2);
  * the port's bf16 mel and waveform against the JAX package's bf16 ones:
    twice the JAX package's own bf16 - float32 distance on the same weights
    (two bf16 engines that each stay that close to one float32 result);
  * the CPU's bf16 stream against its full render: 1e-4 and under one bf16
    step of the peak (the plain versions give a window's rows the whole's
    bits up to float32 rounding);
  * log-durations: 5e-2 (one bf16 step at the magnitudes random weights
    predict is 2^-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zerovox_tpu.config as jc
from zerovox_tpu.models.hifigan import HifiGanConfig as JaxHifiGanConfig
from zerovox_tpu.ops.pallas.mrf import fused_mrf as jax_fused_mrf
from zerovox_tpu.ops.pallas.packed import fused_packed_stage
from zerovox_tpu.ops.pallas.resblock import fused_resblock1 as jax_fused_resblock1
from zerovox_tpu.synthesize import ZeroVoxTTS as JaxTTS

import zerovox_tpu_torch.config as pc
from zerovox_tpu_torch.models.hifigan import HifiGanConfig
from zerovox_tpu_torch.ops.mrf import fused_mrf, mrf_plain, pack_towers, widen
from zerovox_tpu_torch.ops.resblock import fused_resblock1, resblock1_plain
from zerovox_tpu_torch.ops.upsample_stage import (fused_upsample_stage, pack_upsampler,
                                                   upsample_stage_plain)
from zerovox_tpu_torch.synthesize import ZeroVoxTTS
from zerovox_tpu_torch.weights import meldec_to_jax_variables, to_jax_variables

KS = (3, 7, 11)
DILS = (1, 3, 5)
WAV_TOL = 5e-2
TEXT = "Hello world, this is a test."


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The suite runs its files in parallel processes, where torch's
    default of a thread per core oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def bf16_step(t) -> float:
    """One bf16 step at the largest magnitude of t."""
    m = float(np.max(np.abs(np.asarray(t, np.float32))))
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _bf(rng, *shape, scale):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).bfloat16()


def _towers(rng, C, ks=KS, P=3):
    return [(_bf(rng, P, k, C, C, scale=1 / np.sqrt(k * C)), _bf(rng, P, C, scale=0.5),
             _bf(rng, P, k, C, C, scale=1 / np.sqrt(k * C)), _bf(rng, P, C, scale=0.5))
            for k in ks]


def _jax(t):
    """A bf16 torch tensor as a bf16 JAX array (through float32: exact)."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _assert_one_step(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= bf16_step(want)


# ------------------------------------------------------------------ kernels

@pytest.mark.parametrize("C,T", [(128, 37), (64, 80)])
def test_mrf_plain_bf16_matches_jax(C, T):
    rng = np.random.default_rng(C + T)
    x = _bf(rng, 1, T, C, scale=1.0)
    towers = _towers(rng, C)
    got = fused_mrf(x, pack_towers(towers), DILS, KS)  # CPU tensor: the plain version
    assert got.dtype == torch.bfloat16
    # the contract: float32 throughout on the widened inputs, rounded once
    assert torch.equal(got, mrf_plain(x.float(), widen(towers), DILS).bfloat16())
    want = jax_fused_mrf(_jax(x), [tuple(_jax(a) for a in t) for t in towers], DILS, KS,
                         tile=64, interpret=True)
    assert want.dtype == jnp.bfloat16
    _assert_one_step(got.float(), want)


@pytest.mark.parametrize("widths,post", [((128, 64), False), ((64, 32), True), ((64, 32), False)])
def test_upsample_stage_plain_bf16_matches_jax(widths, post):
    C_in, C_out = widths
    T_in = 41
    rng = np.random.default_rng(C_in + post)
    x = _bf(rng, 1, T_in, C_in, scale=1.0)
    up_w = _bf(rng, 4, C_in, C_out, scale=1 / np.sqrt(2 * C_in))  # torch taps (k, in, out)
    up_b = _bf(rng, C_out, scale=0.5)
    towers = _towers(rng, C_out)
    p = ((_bf(rng, 7, C_out, 1, scale=1 / np.sqrt(7 * C_out)), _bf(rng, 1, scale=0.1))
         if post else None)
    got = fused_upsample_stage(x, pack_upsampler(up_w, up_b, 2), 1, pack_towers(towers), DILS, KS,
                               post=p)
    assert got.dtype == torch.bfloat16
    assert got.shape == ((1, 2 * T_in) if post else (1, 2 * T_in, C_out))
    plain32 = upsample_stage_plain(x.float(), up_w.float(), up_b.float(), 2, 1, widen(towers), DILS,
                                   post=None if p is None else tuple(t.float() for t in p))
    assert torch.equal(got, plain32.bfloat16())
    want = fused_packed_stage(
        _jax(x), jnp.flip(_jax(up_w), 0), _jax(up_b), 2, 1,
        [tuple(_jax(a) for a in t) for t in towers], DILS, KS,
        post=None if p is None else tuple(_jax(a) for a in p), tile=64, interpret=True)
    assert want.dtype == jnp.bfloat16
    _assert_one_step(got.float(), want)


@pytest.mark.parametrize("C,T", [(128, 37), (64, 80), (32, 101)])
def test_resblock1_plain_bf16_matches_jax(C, T):
    rng = np.random.default_rng(C + T + 1)
    x = _bf(rng, 1, T, C, scale=1.0)
    tower = _towers(rng, C, ks=(3,))[0]
    got = fused_resblock1(x, *tower, DILS)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, resblock1_plain(x.float(), *widen([tower])[0], DILS).bfloat16())
    want = jax_fused_resblock1(_jax(x), *(_jax(a) for a in tower), DILS, tile=64, interpret=True)
    assert want.dtype == jnp.bfloat16
    _assert_one_step(got.float(), want)


def test_plain_bf16_keeps_float32_intermediates():
    """torch's bf16 conv1d rounds every conv output to bf16; the kernels'
    contract (and the TPU kernel's) keeps them float32, so the plain version
    does not run torch's bf16 convolutions: at the main path's width the two
    give other bits."""
    rng = np.random.default_rng(5)
    x = _bf(rng, 1, 200, 128, scale=1.0)
    towers = _towers(rng, 128)
    got = mrf_plain(x, towers, DILS)
    xc = x.transpose(1, 2)
    from zerovox_tpu_torch.ops.mrf import _torch_convs, resblock1_ncl

    rounded = sum(resblock1_ncl(xc, _torch_convs(w1, b1), _torch_convs(w2, b2), DILS)
                  for w1, b1, w2, b2 in towers) / len(towers)
    assert not torch.equal(got, rounded.transpose(1, 2))


# ------------------------------------------------------------------ engines

def _cfg(mod, kind):
    return mod.ZeroVoxConfig(model=mod.ModelConfig(
        max_txt_len=64, max_mel_len=256, emb_dim=48, punct_emb_dim=16,
        encoder=mod.EncoderConfig(fs2_layer=1, fs2_head=2, vp_filter_size=16, ve_n_bins=16),
        decoder=mod.DecoderConfig(kind=kind, n_layers=1, n_head=2, conv_filter_size=64),
        resnet=mod.ResNetConfig(layers=(1, 1, 1, 1), num_filters=(8, 16, 16, 16))))


# FastSpeech2 with the default three towers at 256 initial channels: K1 on
# the stages of 128 and 64 channels, K2 on 64->32 and K2 + conv_post on
# 32->16 (the card's main path takes K1 and K2 so at 512); StyleTTS with one
# tower: K3's route on the stages of 128, 64, 32 and 16 channels
VOCODERS = {"fastspeech2": {"upsample_initial_channel": 256},
            "styletts": {"upsample_initial_channel": 256, "resblock_kernel_sizes": (3,),
                         "resblock_dilation_sizes": ((1, 3, 5),)}}


@pytest.fixture(scope="module", params=sorted(VOCODERS))
def engines(request):
    """The port's float32 and bf16 engines from one seed, the JAX package's
    bf16 and float32 engines on the same float32 weights, a float32 speaker
    embedding and forced durations."""
    kind = request.param
    hcfg = HifiGanConfig(**VOCODERS[kind])
    ports = {prec: ZeroVoxTTS.from_random(_cfg(pc, kind), hcfg, seed=0, device="cpu",
                                          precision=prec) for prec in ("f32", "bf16")}
    sd, md = ports["f32"].state_dicts()
    variables = to_jax_variables(sd, _cfg(pc, kind))
    meldec_variables = meldec_to_jax_variables(md, hcfg)
    jax16, jax32 = (JaxTTS(_cfg(jc, kind), variables, JaxHifiGanConfig(**VOCODERS[kind]),
                           meldec_variables, precision=prec) for prec in ("bf16", "f32"))
    ref_wav = np.random.default_rng(0).normal(size=12000).astype(np.float32) * 0.2
    spk = ports["f32"].speaker_embed(ref_wav).numpy()
    dur = np.full(len(ports["f32"].text2phonemeids(TEXT)[0]), 3, np.int32)
    return kind, (jax16, jax32), ports, ref_wav, spk, dur


def test_engine_casts_every_floating_tensor(engines):
    _, _, ports, *_ = engines
    p16 = ports["bf16"]
    for module in (p16._model, p16._meldec):
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            assert t.dtype == (torch.bfloat16 if t.is_floating_point() else torch.int64), name
    assert p16._meldec.mean.dtype == p16._meldec.scale.dtype == torch.bfloat16
    tracked = [t for n, t in p16._model.named_buffers() if n.endswith("num_batches_tracked")]
    assert tracked and all(t.dtype == torch.int64 for t in tracked)
    # state_dicts() hands out float32 copies of the bf16 values
    sd, md = p16.state_dicts()
    assert all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())
    assert torch.equal(md["generator.conv_pre.weight"].bfloat16(),
                       p16._meldec.generator.conv_pre.weight)


def test_speaker_embed_bf16_matches_jax(engines):
    _, (jax16, _), ports, ref_wav, spk, _ = engines
    got = ports["bf16"].speaker_embed(ref_wav)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 1, ports["bf16"].cfg.model.emb_size)
    want = _f32(jax16.speaker_embed(ref_wav))
    assert np.max(np.abs(_f32(got.float()) - want)) < WAV_TOL
    assert np.max(np.abs(_f32(got.float()) - spk)) < WAV_TOL


def test_tts_ex_bf16_matches_jax_and_float32(engines):
    kind, (jax16, jax32), ports, _, spk, dur = engines
    wav_j, _, n_j, mel_j = jax16.tts_ex(TEXT, spk, duration=dur)
    wav_j32, _, _, mel_j32 = jax32.tts_ex(TEXT, spk, duration=dur)
    wav_p, _, n_p, mel_p = ports["bf16"].tts_ex(TEXT, spk, duration=dur)
    wav_32, _, _, _ = ports["f32"].tts_ex(TEXT, spk, duration=dur)
    assert n_p == n_j == 3 * len(dur)
    assert wav_p.dtype == np.float32 and mel_p.dtype == np.float32
    assert wav_p.shape == wav_j.shape and mel_p.shape == _f32(mel_j).shape
    assert np.all(np.isfinite(wav_p))
    peak = np.max(np.abs(wav_32))
    assert peak > 1e-3
    bound = min(WAV_TOL, 0.25 * peak)
    for name, other in (("jax bf16", _f32(wav_j)), ("port f32", wav_32)):
        err = np.max(np.abs(wav_p - other))
        print(f"{kind}: port bf16 - {name}: {err:.6g} (peak {peak:.6g}, bound {bound:.6g})")
        assert err < bound, (kind, err, bound, peak)
    # against the JAX bf16 engine, within twice its own distance from float32
    for what, got, want, want32 in (("wav", wav_p, wav_j, wav_j32), ("mel", mel_p, mel_j, mel_j32)):
        err = np.max(np.abs(got - _f32(want)))
        own = np.max(np.abs(_f32(want) - _f32(want32)))
        print(f"{kind} {what}: port bf16 - jax bf16 {err:.6g}; jax bf16 - jax f32 {own:.6g}")
        assert own > 0 and err <= 2 * own, (kind, what, err, own)


def test_log_durations_bf16_match_jax(engines):
    """Predicted log-durations (no forced durations) of the two bf16
    encoders. XLA on the CPU fuses bf16 elementwise chains without rounding
    between them, so the rounded durations may differ in a few phones."""
    _, (jax16, _), ports, _, spk, _ = engines
    p16 = ports["bf16"]
    ids, puncts = p16.text2phonemeids(TEXT)
    phonemes, punct_rows, mask = p16._text_rows([(ids, puncts)])
    enc = p16._run_encode(phonemes, punct_rows, mask, p16._spk(spk))
    want = jax16._jit_encode(jax16._variables, phonemes.astype(np.int32),
                             punct_rows.astype(np.int32), mask, spk)
    got_ld = enc["log_duration"].float().numpy()
    assert np.max(np.abs(got_ld - _f32(want["log_duration"]))) < 5e-2
    differ = int(np.sum(enc["duration_rounded"].numpy() != np.asarray(want["duration_rounded"])))
    print(f"log-durations {np.max(np.abs(got_ld - _f32(want['log_duration']))):.6g} apart; "
          f"rounded durations differ in {differ} of {len(ids)} phones")
    assert differ <= len(ids) // 4, differ


def test_stream_and_batch_return_float32(engines):
    _, _, ports, _, spk, dur = engines
    p16 = ports["bf16"]
    wav, _, n = p16.tts(TEXT, spk, duration=dur)
    chunks = list(p16.tts_stream(TEXT, spk, duration=dur, chunk_frames=24))
    assert all(isinstance(c, np.ndarray) and c.dtype == np.float32 for c in chunks)
    streamed = np.concatenate(chunks)
    assert streamed.shape == wav.shape
    err = np.max(np.abs(streamed - wav))
    print(f"CPU bf16 stream - full render {err:.6g} (peak {np.max(np.abs(wav)):.6g})")
    assert err <= min(1e-4, bf16_step(wav)) and err < bf16_step(wav)
    rows = p16.tts_batch([TEXT, "Short one."], np.concatenate([spk, spk]),
                         durations=[dur, np.full(len(p16.text2phonemeids("Short one.")[0]), 3)])
    assert [r[0].dtype for r in rows] == [np.float32, np.float32]
    assert rows[0][1] == n and rows[0][0].shape == wav.shape
    assert np.all(np.isfinite(rows[0][0])) and np.all(np.isfinite(streamed))


def test_precision_comes_from_the_environment(monkeypatch):
    cfg = _cfg(pc, "fastspeech2")
    small = HifiGanConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                          resblock_dilation_sizes=((1, 3, 5),))
    monkeypatch.setenv("ZEROVOX_PRECISION", "bf16")
    eng = ZeroVoxTTS.from_random(cfg, small, device="cpu")
    assert eng.precision == "bf16"
    assert eng._model._mel_decoder.mel_linear.weight.dtype == torch.bfloat16
    # an explicit argument wins over the environment
    assert ZeroVoxTTS.from_random(cfg, small, device="cpu", precision="f32").precision == "f32"
    monkeypatch.delenv("ZEROVOX_PRECISION")
    assert ZeroVoxTTS.from_random(cfg, small, device="cpu").precision == "f32"
    with pytest.raises(ValueError):
        ZeroVoxTTS.from_random(cfg, small, device="cpu", precision="fp16")
