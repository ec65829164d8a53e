"""Flash attention (K5) and the ZEROVOX_ATTN=flash path, against the JAX
package's own flash branch on the CPU.

The JAX package's `models/fs2.py` calls the Pallas library kernel
`jax.experimental.pallas.ops.tpu.flash_attention`; here it runs in interpret
mode (`force_tpu_interpret_mode`) with fs2.py's block sizes, and every JAX
function is traced afresh under the environment it is compared in (the
module reads ZEROVOX_ATTN at trace time). The port runs
`flash_attention_plain` (CPU tensors), the function its CUDA kernels are held
to on the card (tests/test_torch_gpu.py, chip_smoke.py phase 21).

Tolerances, float32: the function itself 1e-5 forward and 1e-4 x each
gradient's largest value backward (float32 softmax in other orders); the
encoder and the decoded mel 1e-4 (tests/test_torch_fs2.py's decoder
bound), and the port's flash path against its einsum path 1e-5 on valid
positions; a train step's losses 1e-4 relative and gradients 1e-3 x each
tensor's largest value; a tts_ex waveform 1e-3 (and 1e-3 of its peak). bf16:
within one bf16 step of the largest value of the JAX kernel's output and two
of each gradient's (both round P, and dS, to bf16 before their products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (BlockSizes, SegmentIds,
                                                             flash_attention as jax_flash)

import zerovox_tpu.config as jc
from zerovox_tpu.checkpoint import convert_zerovox_state_dict
from zerovox_tpu.models import fs2 as jfs2
from zerovox_tpu.models.hifigan import HifiGanConfig as JaxHifiGanConfig
from zerovox_tpu.models.zerovox import ZeroVox as JaxZeroVox, zerovox_loss as jax_loss_fn
from zerovox_tpu.synthesize import ZeroVoxTTS as JaxTTS
from zerovox_tpu.training import trainer as jtrainer

import zerovox_tpu_torch.config as pc
from zerovox_tpu_torch.models import fs2 as pfs2
from zerovox_tpu_torch.models.hifigan import HifiGanConfig
from zerovox_tpu_torch.models.zerovox import ZeroVox
from zerovox_tpu_torch.ops.flash_attention import flash_attention
from zerovox_tpu_torch.symbols import Symbols
from zerovox_tpu_torch.synthesize import ZeroVoxTTS, random_init_
from zerovox_tpu_torch.training import data as pdata
from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig, device_batch
from zerovox_tpu_torch.weights import (from_jax_variables, meldec_to_jax_variables,
                                        to_jax_variables)


def bf16_step(x) -> float:
    m = float(np.max(np.abs(x)))
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


@pytest.fixture
def flash(monkeypatch):
    monkeypatch.setenv("ZEROVOX_ATTN", "flash")


# ------------------------------------------------------------ dispatch

@pytest.mark.parametrize("spec", [None, "auto", "einsum", "flash", "pallas"])
def test_flash_eligible_is_the_jax_rule(monkeypatch, spec):
    if spec is None:
        monkeypatch.delenv("ZEROVOX_ATTN", raising=False)
    else:
        monkeypatch.setenv("ZEROVOX_ATTN", spec)
    for L in (128, 255, 256, 384, 640, 689, 1024):
        assert pfs2.flash_eligible(L) == jfs2._flash_eligible(L), (spec, L)


# ------------------------------------------------------------ the function

def _jax_block_sizes(L):
    blk = 256 if L % 256 == 0 else 128  # models/fs2.py's block sizes
    return BlockSizes(block_q=blk, block_k_major=blk, block_k=blk, block_b=1,
                      block_q_major_dkv=blk, block_k_major_dkv=blk, block_k_dkv=blk,
                      block_q_dkv=blk, block_k_major_dq=blk, block_k_dq=blk, block_q_dq=blk)


def _jax_attention(q, k, v, seg, scale, do):
    """The library kernel in interpret mode as models/fs2.py calls it (a head
    dim above 128 zero-padded to a multiple of 128), and its VJP."""
    d = q.shape[-1]
    pd = (-d) % 128 if d > 128 else 0
    segs = SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))

    def f(q, k, v):
        q, k, v = (jnp.pad(t, ((0, 0),) * 3 + ((0, pd),)) for t in (q, k, v))
        o = jax_flash(q, k, v, segment_ids=segs, sm_scale=scale,
                      block_sizes=_jax_block_sizes(q.shape[2]))
        return o[..., :d]

    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(jax.jit(f), q, k, v)
        grads = vjp(do)
    return [np.asarray(x, np.float32) for x in (o, *grads)]


def _port_attention(q, k, v, seg, scale, do):
    q, k, v = (torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16 if x.dtype == jnp.bfloat16
                                                          else torch.float32).requires_grad_(True)
               for x in (q, k, v))
    o = flash_attention(q, k, v, torch.from_numpy(np.asarray(seg)), scale)
    o.backward(torch.tensor(np.asarray(do, np.float32)).to(o.dtype))
    return [x.detach().float().numpy() for x in (o, q.grad, k.grad, v.grad)]


def _attention_inputs(seed, B, h, L, d, lengths):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, h, L, d)).astype(np.float32) for _ in range(4))
    seg = (np.arange(L)[None] >= np.asarray(lengths)[:, None]).astype(np.int32)
    return q, k, v, seg, do


@pytest.mark.parametrize("B,h,L,d,lengths", [(2, 2, 256, 24, (256, 150)),
                                             (1, 2, 256, 136, (201,))])
def test_flash_attention_matches_the_library_kernel(B, h, L, d, lengths):
    q, k, v, seg, do = _attention_inputs(d, B, h, L, d, lengths)
    scale = 1.0 / np.sqrt(d)
    want = _jax_attention(q, k, v, seg, scale, do)
    got = _port_attention(q, k, v, seg, scale, do)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5, err_msg="o")
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_flash_attention_bf16_matches_the_library_kernel():
    q, k, v, seg, do = _attention_inputs(5, 2, 2, 256, 24, (256, 150))
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    want = _jax_attention(bf[0], bf[1], bf[2], seg, 1.0 / np.sqrt(24), bf[3])
    got = _port_attention(bf[0], bf[1], bf[2], seg, 1.0 / np.sqrt(24), bf[3])
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        err, step = np.abs(g - w).max(), bf16_step(w)
        assert err <= (1 if name == "o" else 2) * step, f"{name}: {err} against a step of {step}"


# ------------------------------------------------------------ the modules

def _cfg(mod, max_mel_len=512):
    return mod.ZeroVoxConfig(model=mod.ModelConfig(
        max_txt_len=64, max_mel_len=max_mel_len, emb_dim=48, punct_emb_dim=16,
        encoder=mod.EncoderConfig(fs2_layer=2, fs2_head=2, vp_filter_size=32, ve_n_bins=32),
        decoder=mod.DecoderConfig(n_layers=2, n_head=2, conv_filter_size=64),
        resnet=mod.ResNetConfig(layers=(1, 1, 1, 1), num_filters=(8, 8, 8, 8))))


@pytest.fixture(scope="module")
def models():
    port = ZeroVox(_cfg(pc))
    random_init_(port, torch.Generator().manual_seed(3))
    with torch.no_grad():  # nonzero biases and norms so every parameter matters
        for p in port.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.1)
    port.eval()
    jcfg = _cfg(jc)
    return port, JaxZeroVox(jcfg), convert_zerovox_state_dict(port.state_dict(), jcfg)


def _text(seed, L=256, lengths=(256, 201)):
    rng = np.random.default_rng(seed)
    ph = rng.integers(1, 29, size=(len(lengths), L)).astype(np.int32)
    pu = rng.integers(0, 10, size=ph.shape).astype(np.int32)
    mask = np.arange(L)[None, :] >= np.asarray(lengths)[:, None]
    ph[mask] = 0
    pu[mask] = 0
    spk = rng.normal(size=(len(lengths), 1, 64)).astype(np.float32)
    # one frame a phone: the mel's valid lengths are the texts' (bucket 256)
    dur = np.where(mask, 0, 1).astype(np.int32)
    return ph, pu, mask, spk, dur


def _port_encode_decode(port, ph, pu, mask, spk, dur, T):
    with torch.no_grad():
        enc = port.encode(torch.from_numpy(ph).long(), torch.from_numpy(pu).long(),
                          torch.from_numpy(spk), phoneme_mask=torch.from_numpy(mask),
                          duration_target=torch.from_numpy(dur))
        mel, _, mel_mask = port.decode(enc["x"], enc["duration_rounded"], torch.from_numpy(spk), T)
    return enc["x"].numpy(), mel.numpy(), mel_mask.numpy()


def test_encoder_and_decoder_match_the_jax_flash_branch(models, flash, monkeypatch):
    port, jmodel, variables = models
    ph, pu, mask, spk, dur = _text(0)
    calls = []
    orig = jax_flash
    monkeypatch.setattr("jax.experimental.pallas.ops.tpu.flash_attention.flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or orig(*a, **k))

    def jax_fn(v, a, b, m, s, d):
        enc = jmodel.apply(v, a, b, s, phoneme_mask=m, duration_target=d, method=JaxZeroVox.encode)
        mel, _, mel_mask = jmodel.apply(v, enc["x"], enc["duration_rounded"], s, 256,
                                        method=JaxZeroVox.decode)
        return enc["x"], mel, mel_mask

    with pltpu.force_tpu_interpret_mode():
        x_j, mel_j, mask_j = jax.jit(jax_fn)(variables, ph, pu, mask, spk, dur)
    assert len(calls) == 4, f"the JAX model took its flash branch {len(calls)} times, not 4"
    x_p, mel_p, mask_p = _port_encode_decode(port, ph, pu, mask, spk, dur, 256)
    np.testing.assert_array_equal(mask_p, np.asarray(mask_j))
    np.testing.assert_allclose(x_p, np.asarray(x_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mel_p, np.asarray(mel_j), rtol=1e-4, atol=1e-4)

    # the port's flash path against its einsum path, on valid positions
    monkeypatch.setenv("ZEROVOX_ATTN", "einsum")
    x_e, mel_e, _ = _port_encode_decode(port, ph, pu, mask, spk, dur, 256)
    np.testing.assert_allclose(x_p[~mask], x_e[~mask], rtol=0, atol=1e-5)
    np.testing.assert_allclose(mel_p[~mask_p], mel_e[~mask_p], rtol=0, atol=1e-5)


def test_module_takes_the_flash_branch_only_when_eligible(models, flash, monkeypatch):
    port, _, _ = models
    import zerovox_tpu_torch.models.fs2 as mod

    lengths = []
    orig = mod.flash_attention
    monkeypatch.setattr(mod, "flash_attention",
                        lambda q, *a: lengths.append(q.shape[2]) or orig(q, *a))
    ph, pu, mask, spk, dur = _text(1, L=192, lengths=(192, 150))
    _port_encode_decode(port, ph, pu, mask, spk, dur, 256)  # text 192: einsum; mel 256: flash
    assert lengths == [256, 256]


# ------------------------------------------------------------ a train step

PHONES = "'-abcdefghijklmnopqrstuvwxyz"
PUNCTS = " ,.;:-!?\""
STATS = {"pitch_min": 50.0, "pitch_max": 400.0, "energy_min": 0.1, "energy_max": 50.0}


def _train_cfg(mod):
    return mod.ZeroVoxConfig.from_dict({
        "audio": {"num_mels": 16},
        "model": {"max_txt_len": 64, "max_mel_len": 512, "phones": PHONES, "puncts": PUNCTS,
                  "emb_dim": 16, "punct_emb_dim": 8,
                  "encoder": {"fs2_layer": 1, "fs2_head": 2, "vp_filter_size": 8,
                              "ve_n_bins": 8, "fs2_dropout": 0.0, "vp_dropout": 0.0},
                  "decoder": {"kind": "fastspeech2", "n_layers": 1, "n_head": 2,
                              "conv_filter_size": 32, "dropout": 0.0},
                  "resnet": {"layers": [1, 1, 1, 1], "num_filters": [8, 8, 8, 8]}},
        "training": {"learning_rate": 1e-3}, "stats": STATS, "lang": ["en"]})


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """Four utterances of 200-256 phones at one frame a phone: text and mel
    buckets 256."""
    import json

    pp = tmp_path_factory.mktemp("corpus") / "corpus"
    for d in ("mel", "pitch", "energy", "duration"):
        (pp / d).mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i, L in enumerate((256, 203, 231, 250)):
        base = f"utt{i:03d}"
        np.save(pp / "mel" / f"mel-{base}.npy", rng.normal(size=(L, 16)).astype(np.float32))
        np.save(pp / "pitch" / f"pitch-{base}.npy", rng.uniform(60, 390, L).astype(np.float32))
        np.save(pp / "energy" / f"energy-{base}.npy", rng.uniform(0.2, 45, L).astype(np.float32))
        np.save(pp / "duration" / f"duration-{base}.npy", np.ones(L, np.int64))
        (pp / "mel" / f"startstop-{base}.json").write_text(json.dumps({"start_hop": 0, "end_hop": L}))
        lines.append(f"{base}.wav|{','.join(map(str, rng.integers(1, 28, size=L)))}|"
                     f"{','.join(map(str, rng.integers(0, 10, size=L)))}|text {i}")
    (pp / "train.txt").write_text("\n".join(lines) + "\n")
    dm = pdata.SpeechDataModule([{"language": "en", "path": {"preprocessed_path": "corpus"}}],
                                Symbols(PHONES, PUNCTS), STATS, batch_size=4, num_workers=1,
                                base_path=str(pp.parent), ref_mel_len=64)
    dm.prepare_data()
    b = next(iter(dm.train_dataloader(0)))
    db = device_batch(b, "cpu")
    assert db["phoneme"].shape[1] == 256 and db["mel"].shape[1] == 256
    return b


def test_train_step_matches_the_jax_flash_step(batch, flash, monkeypatch):
    import zerovox_tpu_torch.models.fs2 as mod

    calls = {"jax": [], "port": []}
    orig_j, orig_p = jax_flash, mod.flash_attention
    monkeypatch.setattr("jax.experimental.pallas.ops.tpu.flash_attention.flash_attention",
                        lambda *a, **k: calls["jax"].append(a[0].shape[2]) or orig_j(*a, **k))
    monkeypatch.setattr(mod, "flash_attention",
                        lambda q, *a: calls["port"].append(q.shape[2]) or orig_p(q, *a))
    pcfg, jcfg = _train_cfg(pc), _train_cfg(jc)
    model = ZeroVox(pcfg)
    random_init_(model, torch.Generator().manual_seed(4))
    sd = model.state_dict()
    variables = convert_zerovox_state_dict(sd, jcfg)
    jb = jtrainer.device_batch(batch)

    def loss(params):
        outs, _ = JaxZeroVox(jcfg).apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jb, train=True,
            spkemb_train=True, rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return jax_loss_fn(outs, jb)["loss"]

    with pltpu.force_tpu_interpret_mode():
        want_loss, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])

    trainer = Trainer(pcfg, TrainerConfig(max_epochs=2, warmup_epochs=1, seed=0),
                      steps_per_epoch=3, device="cpu")
    state = trainer.init_state(sd)
    got = trainer.forward_backward(state, device_batch(batch, "cpu"))
    assert calls["port"] == calls["jax"] == [256, 256], calls  # encoder, decoder
    np.testing.assert_allclose(got["loss"].item(), float(want_loss), rtol=1e-4)
    grad_sd = from_jax_variables({"params": grads, "batch_stats": variables["batch_stats"]}, pcfg)
    floor = 1e-3 * max(np.abs(g.numpy()).max() for g in grad_sd.values())
    for name, p in state.model.named_parameters():
        want_g = grad_sd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want_g, rtol=0,
                                   atol=1e-3 * max(np.abs(want_g).max(), floor), err_msg=name)


# ------------------------------------------------------------ tts_ex

def test_tts_ex_matches_the_jax_engine_under_flash(flash, monkeypatch):
    import zerovox_tpu_torch.models.fs2 as mod

    hcfg = dict(upsample_initial_channel=64)
    port = ZeroVoxTTS.from_random(_cfg(pc, 1024), HifiGanConfig(**hcfg), seed=0, device="cpu")
    sd, meldec_sd = port.state_dicts()
    jax_tts = JaxTTS(_cfg(jc, 1024), to_jax_variables(sd, _cfg(pc, 1024)),
                     JaxHifiGanConfig(**hcfg), meldec_to_jax_variables(meldec_sd,
                                                                     HifiGanConfig(**hcfg)))
    calls = {"jax": [], "port": []}
    orig_j, orig_p = jax_flash, mod.flash_attention
    monkeypatch.setattr("jax.experimental.pallas.ops.tpu.flash_attention.flash_attention",
                        lambda *a, **k: calls["jax"].append(a[0].shape[2]) or orig_j(*a, **k))
    monkeypatch.setattr(mod, "flash_attention",
                        lambda q, *a: calls["port"].append(q.shape[2]) or orig_p(q, *a))
    text = " ".join(["the quick brown fox jumps over the lazy dog"] * 6)
    n = len(port.text2phonemeids(text)[0])
    assert 193 <= n <= 256, n  # text bucket 256
    dur = np.full(n, 2, np.int32)  # mel bucket 512
    spk = np.random.default_rng(1).normal(size=(1, 1, 64)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        wav_j, _, n_j, mel_j = jax_tts.tts_ex(text, spk, duration=dur)
    wav_p, _, n_p, mel_p = port.tts_ex(text, spk, duration=dur)
    assert calls["port"] == calls["jax"] == [256, 256, 512, 512], calls
    assert n_p == n_j == 2 * n
    np.testing.assert_allclose(mel_p, mel_j, atol=1e-4, rtol=0)
    peak = np.max(np.abs(wav_j))
    err = np.max(np.abs(wav_p - wav_j))
    assert peak > 1e-3 and err < 1e-3 and err < 1e-3 * peak, (err, peak)
