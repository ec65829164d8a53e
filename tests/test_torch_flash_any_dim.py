"""Flash attention (K5) at every head dim the JAX package's flash branch takes,
against that branch on the CPU.

The JAX package's `models/fs2.py` takes any d_k == d_v under
ZEROVOX_ATTN=flash (a head dim above 128 zero-padded to a multiple of 128);
the head dim is d_model / n_head. The port's `flash_attention` zero-pads a
head dim that is not a multiple of 8 (`pad_head_dim`, on both devices,
before the kernel-or-plain dispatch), and on the card runs a float32 head
dim above 272 on the cluster kernels (`cl::` in `csrc/flash_attn.cu`),
whose forward's arithmetic is emulated here: each rank's part of the head
dim, its warp pairs' halves of S, the partials summed in rank order, one
online softmax over key tiles, each rank's columns of o, 3xTF32 products
(tests/test_torch_flash_wide_cluster.py emulates its backward). A bf16 head
dim above 272, or a float32 one above the clusters' reach, runs the wide
kernels (`wd::`), whose source is read here.

Tolerances as tests/test_torch_flash_attention.py: the function 1e-5
forward and 1e-4 x each gradient's largest value backward (bf16: one and two
bf16 steps of the largest value); the encoder and the decoded mel 1e-4; a
train step's loss 1e-4 relative and gradients 1e-3 x each tensor's largest
value; the emulation 1e-4 x the largest value of o and of lse.
"""

import math
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

import zerovox_tpu.config as jc
from zerovox_tpu.checkpoint import convert_zerovox_state_dict
from zerovox_tpu.models.zerovox import ZeroVox as JaxZeroVox, zerovox_loss as jax_loss_fn
from zerovox_tpu.training import trainer as jtrainer

import zerovox_tpu_torch.config as pc
from test_torch_flash_attention import (PHONES, PUNCTS, STATS, _attention_inputs, _jax_attention,
                                        _port_attention, _port_encode_decode, _text, batch,
                                        bf16_step)
from test_torch_flash_fwd_emulation import pv as fw_pv, rna_tf32, s_half as fw_s_half, tile
from zerovox_tpu_torch.models.zerovox import ZeroVox
from zerovox_tpu_torch.ops import flash_attention as fa
from zerovox_tpu_torch.synthesize import random_init_
from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig, device_batch
from zerovox_tpu_torch.weights import from_jax_variables

__all__ = ["batch"]  # the corpus fixture, shared with test_torch_flash_attention.py

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "zerovox_tpu_torch" / "csrc" / "flash_attn.cu").read_text()
WD = SOURCE[SOURCE.index("namespace wd {"):SOURCE.index("}  // namespace wd")]
KS = 8  # k of mma.sync.m16n8k8 (TF32)
LOG2E = np.float32(1.4426950408889634)


@pytest.fixture
def flash(monkeypatch):
    monkeypatch.setenv("ZEROVOX_ATTN", "flash")


# ------------------------------------------------------------ the function

@pytest.mark.parametrize("B,h,L,d,lengths", [(1, 2, 256, 132, (201,)), (2, 2, 256, 44, (256, 150)),
                                             (1, 2, 256, 11, (256,)), (1, 1, 256, 528, (190,))])
def test_flash_attention_any_head_dim_matches_the_library_kernel(B, h, L, d, lengths):
    q, k, v, seg, do = _attention_inputs(d, B, h, L, d, lengths)
    scale = 1.0 / np.sqrt(d)
    want = _jax_attention(q, k, v, seg, scale, do)
    got = _port_attention(q, k, v, seg, scale, do)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5, err_msg="o")
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert g.shape == w.shape == (B, h, L, d), name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_flash_attention_bf16_at_d132_matches_the_library_kernel():
    q, k, v, seg, do = _attention_inputs(6, 1, 2, 256, 132, (222,))
    bf = [jax.numpy.asarray(x, jax.numpy.bfloat16) for x in (q, k, v, do)]
    scale = 1.0 / np.sqrt(132)
    want = _jax_attention(bf[0], bf[1], bf[2], seg, scale, bf[3])
    got = _port_attention(bf[0], bf[1], bf[2], seg, scale, bf[3])
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        err, step = np.abs(g - w).max(), bf16_step(w)
        assert err <= (1 if name == "o" else 2) * step, f"{name}: {err} against a step of {step}"


def test_the_cpu_path_pads_as_the_card_does(monkeypatch):
    """At d = 132 flash_attention on CPU tensors goes through pad_head_dim
    (the function the card's path calls before its kernels) and hands the
    plain version d = 136; at a multiple of 8 the tensors pass as they are."""
    seen, plain_dims = [], []
    orig_pad, orig_plain = fa.pad_head_dim, fa.flash_attention_plain
    monkeypatch.setattr(fa, "pad_head_dim",
                        lambda *ts: seen.append(ts[0].shape[-1]) or orig_pad(*ts))
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda q, *a: plain_dims.append(q.shape[-1]) or orig_plain(q, *a))
    x = torch.randn(1, 2, 256, 132, generator=torch.Generator().manual_seed(0))
    o = fa.flash_attention(x, x, x, None, 0.1)
    assert seen == [132] and plain_dims == [136] and o.shape == x.shape
    y = torch.randn(1, 2, 256, 136).transpose(1, 2).transpose(1, 2)
    assert all(a is y for a in orig_pad(y, y, y))
    padded = orig_pad(x, x, x)
    assert all(p.is_contiguous() and p.shape[-1] == 136 and bool((p[..., 132:] == 0).all())
               for p in padded)


# ------------------------------------------------------------ the modules

# (heads, emb_dim, punct_emb_dim): d_model 44 at 4 heads (d = 11), d_model 288
# at 1 head (d = 288: the wide kernels on the card)
HEADS = [(4, 36, 8), (1, 272, 16)]


def _cfg(mod, heads, emb_dim, punct):
    return mod.ZeroVoxConfig(model=mod.ModelConfig(
        max_txt_len=64, max_mel_len=512, emb_dim=emb_dim, punct_emb_dim=punct,
        encoder=mod.EncoderConfig(fs2_layer=1, fs2_head=heads, vp_filter_size=32, ve_n_bins=32),
        decoder=mod.DecoderConfig(n_layers=1, n_head=heads, conv_filter_size=64),
        resnet=mod.ResNetConfig(layers=(1, 1, 1, 1), num_filters=(8, 8, 8, 8))))


@pytest.mark.parametrize("heads,emb_dim,punct", HEADS)
def test_encoder_and_decoder_match_the_jax_flash_branch(flash, monkeypatch, heads, emb_dim, punct):
    port = ZeroVox(_cfg(pc, heads, emb_dim, punct))
    random_init_(port, torch.Generator().manual_seed(heads))
    port.eval()
    jcfg = _cfg(jc, heads, emb_dim, punct)
    variables = convert_zerovox_state_dict(port.state_dict(), jcfg)
    d_model = emb_dim + punct
    ph, pu, mask, _, dur = _text(heads)
    spk = np.random.default_rng(heads).normal(size=(2, 1, d_model)).astype(np.float32)
    dims = {"jax": [], "port": []}
    orig = jax_flash
    monkeypatch.setattr("jax.experimental.pallas.ops.tpu.flash_attention.flash_attention",
                        lambda *a, **k: dims["jax"].append(a[0].shape[-1]) or orig(*a, **k))
    orig_p = fa.flash_attention
    monkeypatch.setattr("zerovox_tpu_torch.models.fs2.flash_attention",
                        lambda q, *a: dims["port"].append(q.shape[-1]) or orig_p(q, *a))

    def jax_fn(v, a, b, m, s, d):
        enc = jmodel.apply(v, a, b, s, phoneme_mask=m, duration_target=d, method=JaxZeroVox.encode)
        mel, _, mel_mask = jmodel.apply(v, enc["x"], enc["duration_rounded"], s, 256,
                                        method=JaxZeroVox.decode)
        return enc["x"], mel, mel_mask

    jmodel = JaxZeroVox(jcfg)
    with pltpu.force_tpu_interpret_mode():
        x_j, mel_j, mask_j = jax.jit(jax_fn)(variables, ph, pu, mask, spk, dur)
    x_p, mel_p, mask_p = _port_encode_decode(port, ph, pu, mask, spk, dur, 256)
    d = d_model // heads
    assert dims["port"] == [d, d], dims  # the encoder's and the decoder's layer
    assert len(dims["jax"]) == 2, dims
    np.testing.assert_array_equal(mask_p, np.asarray(mask_j))
    np.testing.assert_allclose(x_p, np.asarray(x_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mel_p, np.asarray(mel_j), rtol=1e-4, atol=1e-4)


def _train_cfg(mod, heads, emb_dim, punct):
    return mod.ZeroVoxConfig.from_dict({
        "audio": {"num_mels": 16},
        "model": {"max_txt_len": 64, "max_mel_len": 512, "phones": PHONES, "puncts": PUNCTS,
                  "emb_dim": emb_dim, "punct_emb_dim": punct,
                  "encoder": {"fs2_layer": 1, "fs2_head": heads, "vp_filter_size": 8,
                              "ve_n_bins": 8, "fs2_dropout": 0.0, "vp_dropout": 0.0},
                  "decoder": {"kind": "fastspeech2", "n_layers": 1, "n_head": heads,
                              "conv_filter_size": 32, "dropout": 0.0},
                  "resnet": {"layers": [1, 1, 1, 1], "num_filters": [8, 8, 8, 8]}},
        "training": {"learning_rate": 1e-3}, "stats": STATS, "lang": ["en"]})


@pytest.mark.parametrize("heads,emb_dim,punct", HEADS)
def test_train_step_matches_the_jax_flash_step(batch, flash, heads, emb_dim, punct):
    pcfg, jcfg = _train_cfg(pc, heads, emb_dim, punct), _train_cfg(jc, heads, emb_dim, punct)
    model = ZeroVox(pcfg)
    random_init_(model, torch.Generator().manual_seed(4 + heads))
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
    np.testing.assert_allclose(got["loss"].item(), float(want_loss), rtol=1e-4)
    grad_sd = from_jax_variables({"params": grads, "batch_stats": variables["batch_stats"]}, pcfg)
    floor = 1e-3 * max(np.abs(g.numpy()).max() for g in grad_sd.values())
    for name, p in state.model.named_parameters():
        want_g = grad_sd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want_g, rtol=0,
                                   atol=1e-3 * max(np.abs(want_g).max(), floor), err_msg=name)


# ------------------------------------------------------------ the wide kernels' arithmetic

def _const(name: str) -> int:
    """A `constexpr int` of namespace wd, over the constants it names."""
    m = re.search(rf"\nconstexpr int {name} = ([^;]+);", WD)
    assert m, f"constexpr int {name} is not in namespace wd"
    expr = m.group(1)
    for other in re.findall(r"[A-Z][A-Z_0-9]+", expr):
        expr = expr.replace(other, str(_const(other)))
    return int(eval(expr.replace("/", "//"), {}))


def _split(x, passes):
    """tc::split: hi = rna_tf32(x), lo = rna_tf32(x - hi)"""
    hi = rna_tf32(x)
    return hi, (rna_tf32(x - hi) if passes == 3 else torch.zeros_like(x))


def _mma(acc, x, y, passes):
    """acc += x y as F32::mma over one k-step: lo.hi, hi.lo, hi.hi into the
    one accumulator"""
    (xh, xl), (yh, yl) = _split(x, passes), _split(y, passes)
    acc = acc + xl @ yh
    acc = acc + xh @ yl
    return acc + xh @ yh


def emulate_wide_fwd(q, k, v, seg, scale, rg=4, passes=3):
    """(o, the lse of every rank) of cl::fwd_kernel<rg> for float32 [B, h, L,
    d] inputs: rank r's part of the head dim (fa.cluster_parts), its warp
    pairs splitting the part's k-steps in two halves (fw's s_part: S's
    three terms in their own accumulators, lo truncated), each rank's
    partial half 0 + half 1, S the partials summed in rank order; then in
    every rank fw's online softmax over key tiles of BK keys (KQ key groups
    of KW keys, merged by their row max), and O += P V on the rank's columns
    of V. Each rank runs its own softmax on its own sum, as the kernel
    does."""
    t = tile(rg)
    KQ, BK, KW = t["KQ"], t["BK"], t["KW"]
    B, h, L, d = q.shape
    parts = fa.cluster_parts(d)
    c0s = np.cumsum([0] + parts[:-1]).tolist()
    n = len(parts)
    same = seg[:, None, :, None] == seg[:, None, None, :]
    mask = torch.where(same, 0.0, fa.MASK_VALUE).float()
    sl2 = float(np.float32(scale) * LOG2E)
    m = torch.full((n, KQ, B, h, L), -math.inf)
    l = torch.zeros(n, KQ, B, h, L)
    acc = [torch.zeros(KQ, B, h, L, pd) for pd in parts]
    for k0 in range(0, L, BK):
        for g in range(KQ):
            keys = slice(k0 + g * KW, k0 + (g + 1) * KW)
            partial = []
            for c0, pd in zip(c0s, parts):  # each rank's two halves over its part
                kh = (pd // KS + 1) // 2
                x, y = q[..., c0:c0 + pd], k[:, :, keys, c0:c0 + pd]
                partial.append(fw_s_half(x, y, 0, kh, passes) + fw_s_half(x, y, kh, pd // KS, passes))
            for me, (c0, pd) in enumerate(zip(c0s, parts)):
                s = partial[0]
                for r in range(1, n):  # in rank order
                    s = s + partial[r]
                x = (s.double() * sl2 + mask[:, :, :, keys].double()).float()  # fmaf
                mx = torch.maximum(m[me, g], x.amax(-1))
                alpha = torch.exp2(m[me, g] - mx)
                p = torch.exp2(x - mx[..., None])
                l[me, g] = l[me, g] * alpha + p.sum(-1)
                m[me, g] = mx
                acc[me][g] = fw_pv(acc[me][g] * alpha[..., None], p, v[:, :, keys, c0:c0 + pd],
                                   passes)
    o = torch.zeros(B, h, L, d)
    lses = []
    for me, (c0, pd) in enumerate(zip(c0s, parts)):  # the key groups merged by their row max
        mt = m[me].amax(0)
        f = torch.exp2(m[me] - mt)
        lt, om = f[0] * l[me, 0], f[0][..., None] * acc[me][0]
        for g in range(1, KQ):
            lt = lt + f[g] * l[me, g]
            om = om + f[g][..., None] * acc[me][g]
        o[..., c0:c0 + pd] = om * (1.0 / lt)[..., None]
        lses.append(mt * np.float32(math.log(2.0)) + torch.log(lt))
    return o, lses


def test_wide_emulation_matches_the_library_kernel():
    """At d = 528, L = 256 (a cluster of two ranks of 264 columns, the
    training layout of 64 query rows a block): o within 1e-4 x its largest
    value of the JAX library kernel (interpret mode) and of float64 plain,
    lse within 1e-4 x its largest value of the float64 log-sum-exp; every
    rank's lse bitwise rank 0's (only rank 0 writes it); one TF32 pass
    misses the bound."""
    B, h, L, d = 1, 1, 256, 528
    q, k, v, seg, do = _attention_inputs(528, B, h, L, d, (203,))
    scale = 1.0 / np.sqrt(d)
    want_o = _jax_attention(q, k, v, seg, scale, do)[0]
    qt, kt, vt, st = (torch.from_numpy(x) for x in (q, k, v, seg))
    o, lses = emulate_wide_fwd(qt, kt, vt, st, scale)
    path = fa.head_dim_path(d)
    assert path["path"] == "cluster" and path["parts"] == [264, 264] == fa.cluster_parts(d)
    assert len(lses) == path["ranks"] == 2
    assert all(torch.equal(x, lses[0]) for x in lses[1:])
    bound = 1e-4 * np.abs(want_o).max()
    np.testing.assert_allclose(o.numpy(), want_o, rtol=0, atol=bound)
    plain = fa.flash_attention_plain(qt.double(), kt.double(), vt.double(), st, scale)
    assert (o.double() - plain).abs().max() <= 1e-4 * plain.abs().max()
    s = torch.einsum("bhqd,bhkd->bhqk", qt.double(), kt.double()) * scale
    same = st[:, None, :, None] == st[:, None, None, :]
    want_lse = torch.logsumexp(s + torch.where(same, 0.0, fa.MASK_VALUE).double(), dim=-1)
    assert (lses[0].double() - want_lse).abs().max() <= 1e-4 * want_lse.abs().max()
    o1 = emulate_wide_fwd(qt, kt, vt, st, scale, passes=1)[0]
    assert np.abs(o1.numpy() - want_o).max() > bound, "one pass held"


def test_the_source_holds_what_the_wide_emulation_follows():
    """The emulated structure, read from namespace wd: the split, the term
    order, the chunked S, the softmax, the slices, P V from P's C fragments
    (keys 2t, 2t + 1 of each 8 as lane t's k and k + 4); the constants the
    wrapper mirrors; shared memory that does not depend on d and lets two
    blocks share an SM, with conflict-free rows."""
    for line in ("tc::split(p[0], a.hi[0], a.lo[0]);", "F32::mma(d, a, b);",
                 "mma_nt<P, NS>(s, qc + (st & 1) * BR * LDC + 16 * w * LDC,",
                 "fmaf(s[n][e], sl2, sq[e >> 1] == sk[n * 8 + (e & 1)] ? 0.f : MASK)",
                 "alpha[r] = exp2f(m[r] - mx[r]);", "const float p = exp2f(s[n][e] - m[e >> 1]);",
                 "l[r] = l[r] * alpha[r] + ls[r];", "lse[0] = m[0] * LN2 + logf(l[0]);",
                 "if (at.c0 == 0 && t == 0) {", "mma_rc<P, NO, NS>(o, s, vs, LDS, at.nv, g, t);",
                 "tc::split(c[kk][2], a.hi[1], a.lo[1]);", "const float* p = s + (k0 + 2 * t) * ld + g;"):
        assert line in WD, line
    assert "atomic" not in WD
    assert "  tc::mma(d, a.lo, b.hi);\n    tc::mma(d, a.hi, b.lo);\n    tc::mma(d, a.hi, b.hi);" \
        in SOURCE
    assert {k: _const(f"CS_{k.upper()}") for k in fa.WIDE_SLICE} == fa.WIDE_SLICE
    assert all(cs <= 128 and cs % 8 == 0 for cs in fa.WIDE_SLICE.values())
    br, bs, chunk, warps = _const("BR"), _const("BS"), _const("CHUNK_BYTES"), _const("WARPS_W")
    assert br == 16 * warps and _const("THREADS_W") == 32 * warps and fa.L_MULTIPLE % bs == 0
    assert fa.L_MULTIPLE % br == 0 and fa.TUNED_HEAD_DIM == 272
    for esize in (4, 2):  # float32, bf16
        dc, pad = chunk // esize, 16 // esize
        ldc = dc + pad

        def region(rows, cols):
            return rows * cols * esize

        def lds(cs):
            return cs + (4 if esize == 4 else 8)

        fwd = 2 * region(br + bs, ldc) + region(bs, lds(fa.WIDE_SLICE["fwd"])) + bs * 4
        dkv = 4 * region(br + bs, ldc) + 2 * region(bs, lds(fa.WIDE_SLICE["dkv"])) + 3 * bs * 4
        dq = 4 * region(br + bs, ldc) + region(bs, lds(fa.WIDE_SLICE["dq"])) + bs * 4
        # two blocks an SM: 228 KB, less 1 KB a block
        assert max(fwd, dkv, dq) <= (228 * 1024) // 2 - 1024, (esize, fwd, dkv, dq)
        assert (ldc * esize // 4) % 32 == 4  # rows g, column t (or pair t)
        for cs in fa.WIDE_SLICE.values():  # k-major B: rows 2t, 2t + 1, column g
            ldw = lds(cs) * esize / 4
            for r0 in (0, 1):
                banks = {int((2 * tt + r0) * ldw + g * esize / 4) % 32
                         for tt in range(4) for g in range(8)}
                assert len(banks) == (32 if esize == 4 else 16), (esize, cs, r0)
