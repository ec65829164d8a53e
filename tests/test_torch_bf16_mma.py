"""The arithmetic of the bf16 K1 (fused MRF), K2 (fused upsample stage) and
K3 (one ResBlock1 tower), emulated on the CPU: bf16 tensor-core products
with a two-term activation split (csrc/mrf_bf16.cuh) against the plain
versions on bf16 inputs and the JAX kernels in interpret mode.

The bf16 kernels take each float32 activation a that feeds a GEMM as two
bf16 terms, hi = rn(a) and lo = rn(a - hi) (round to nearest even), and sum
two products per conv (lo.w + hi.w, the weights exact in bf16) in float32;
every other intermediate is float32 and the output is rounded to bf16 once.
Here each product is a float32 convolution of one term, with the weights
read back from the kernels' m16n8k16 fragment buffers by the kernels' lane
formula. Bounds (chip_smoke.py's for the bf16 K1-K3 on the card): within
one bf16 step of the largest output, and at most 1 % of the outputs
differing from the plain version's rounding. One bf16 term (the activation
rounded to bf16) falls outside the share bound, which is why the kernels
take two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from zerovox_tpu.ops.pallas.mrf import fused_mrf as jax_fused_mrf
from zerovox_tpu.ops.pallas.packed import fused_packed_stage
from zerovox_tpu.ops.pallas.resblock import fused_resblock1 as jax_fused_resblock1

from zerovox_tpu_torch.ops.mrf import LRELU_SLOPE, mma_fragments_bf16, mrf_plain, pack_towers
from zerovox_tpu_torch.ops.resblock import resblock1_plain
from zerovox_tpu_torch.ops.upsample_stage import pack_upsampler, upsample_stage_plain

KS = (3, 7, 11)
DILS = (1, 3, 5)
SHARE = 0.01  # outputs allowed off plain's rounding
ONE_TERM_SHARE = 0.10  # the one-term control must differ on more than this


def bf16_step(t) -> float:
    """One bf16 step at the largest magnitude of t."""
    m = t.float().abs().max().item()
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def terms(a, n=2):
    """The bf16 terms of float32 a the kernels feed to the MMAs, widened:
    (hi, lo) with hi = rn(a), lo = rn(a - hi); n=1, hi alone."""
    hi = a.bfloat16().float()
    return (hi, (a - hi).bfloat16().float()) if n == 2 else (hi,)


def unfragment16(frag, k, ci, co):
    """Taps [k, ci, co] read back from m16n8k16 fragment order by the
    kernels' lane formula: lane l of block (tap, ks, nf) holds, at position
    e, w[tap][16 ks + 2 (l % 4) + e % 2 + 8 (e // 2)][8 nf + l // 4] (ci
    zero-padded to a multiple of 16)."""
    c16 = -(-ci // 16) * 16
    f = frag.float().reshape(k, c16 // 16, co // 8, 32, 4)
    w = torch.zeros(k, c16, co)
    for lane in range(32):
        for e in range(4):
            rows = torch.arange(c16 // 16) * 16 + 2 * (lane % 4) + e % 2 + 8 * (e // 2)
            cols = torch.arange(co // 8) * 8 + lane // 4
            w[:, rows[:, None], cols[None, :]] = f[:, :, :, lane, e]
    assert torch.all(w[:, ci:] == 0)
    return w[:, :ci]


def conv_terms(x, w, b, dil, n):
    """'same' conv of NCL float32 x with taps w [k, in, out] as the kernels'
    GEMMs: one float32 product per bf16 term of x, summed."""
    k = w.shape[0]
    wt = w.permute(2, 1, 0)
    y = sum(F.conv1d(t, wt, None, padding=(k - 1) // 2 * dil, dilation=dil) for t in terms(x, n))
    return y + b[None, :, None]


def mrf_bf16(x, packed, C, dils, ks, n=2):
    """The bf16 MRF stage over float32 x [B, T, C] (the widened bf16 input or
    the upsampler's float32 output), weights read from the m16n8k16 buffer
    at the kernels' offsets (tower by tower: w1 [P][k] then w2 [P][k] taps,
    each k16(C) x C); float32 out."""
    xc = x.transpose(1, 2)
    P = len(dils)
    c16 = -(-C // 16) * 16
    b = packed.b.float()
    wofs = bofs = 0
    total = None
    for k in ks:
        conv = k * c16 * C
        taps = [unfragment16(packed.w16[wofs + i * conv:wofs + (i + 1) * conv], k, C, C)
                for i in range(2 * P)]
        y = xc
        for q, d in enumerate(dils):
            b1 = b[bofs + q * C:bofs + (q + 1) * C]
            b2 = b[bofs + (P + q) * C:bofs + (P + q + 1) * C]
            t = conv_terms(F.leaky_relu(y, LRELU_SLOPE), taps[q], b1, d, n)
            y = conv_terms(F.leaky_relu(t, LRELU_SLOPE), taps[P + q], b2, 1, n) + y
        total = y if total is None else total + y
        wofs += 2 * P * conv
        bofs += 2 * P * C
    return (total / len(ks)).transpose(1, 2)


def upsample_bf16(x, up, padding, n=2):
    """The transposed conv as the kernel's polyphase GEMMs on the terms of
    leaky(x), the taps read from the m16n8k16 buffer in phase order."""
    k, ci, co = up.w.shape
    s = up.stride
    B, T_in, _ = x.shape
    T_out = (T_in - 1) * s + k - 2 * padding
    taps = unfragment16(up.frag16, k, ci, co)
    xs = terms(F.leaky_relu(x, LRELU_SLOPE), n)
    out = torch.zeros(B, T_out, co)
    tap = 0
    for ph in range(s):
        n_taps = max(0, -(-(k - ph) // s))
        t = torch.arange(T_out)
        t = t[(t + padding) % s == ph]
        acc = torch.zeros(B, len(t), co)
        for j in range(n_taps):
            i = (t + padding - ph) // s - j
            ok = (i >= 0) & (i < T_in)
            for a in xs:
                rows = torch.where(ok[None, :, None], a[:, i.clamp(0, T_in - 1)], 0.0)
                acc = acc + rows @ taps[tap + j]
        out[:, t] = acc + up.b.float()
        tap += n_taps
    return out


def stage_bf16(x, up, padding, packed, C_out, post=None, n=2):
    """The bf16 K2 on bf16 x: float32 inside, the output rounded once;
    conv_post in float32 on the widened weights (the kernel's CUDA cores)."""
    y = mrf_bf16(upsample_bf16(x.float(), up, padding, n), packed, C_out, DILS, KS, n)
    if post is not None:
        pw, pb = (t.float() for t in post)
        y = F.conv1d(F.leaky_relu(y, 0.01).transpose(1, 2), pw.permute(2, 1, 0), pb,
                     padding=(pw.shape[0] - 1) // 2)
        y = torch.tanh(y)[:, 0, :]
    return y.bfloat16()


def _bf(rng, *shape, scale):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).bfloat16()


def _towers(rng, C, ks=KS):
    """chip_smoke.py's random_towers scales, in bf16."""
    return [(_bf(rng, 3, k, C, C, scale=1 / np.sqrt(k * C)), _bf(rng, 3, C, scale=0.5),
             _bf(rng, 3, k, C, C, scale=1 / np.sqrt(k * C)), _bf(rng, 3, C, scale=0.5))
            for k in ks]


def _jax(t):
    """A bf16 torch tensor as a bf16 JAX array (through float32: exact)."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _close(got, want):
    """(largest distance over one bf16 step of want, share of outputs that
    differ) of two bf16 results."""
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    assert got.shape == want.shape
    return ((got - want).abs().max().item() / bf16_step(want),
            (got != want).float().mean().item())


def _stage_inputs(rng, ci, co, T_in, post):
    x = _bf(rng, 1, T_in, ci, scale=1.0)
    up_w = _bf(rng, 4, ci, co, scale=1 / np.sqrt(2 * ci))  # torch taps (k, in, out)
    up_b = _bf(rng, co, scale=0.5)
    towers = _towers(rng, co)
    p = (_bf(rng, 7, co, 1, scale=1 / np.sqrt(7 * co)), _bf(rng, 1, scale=0.1)) if post else None
    return x, up_w, up_b, towers, p


@pytest.mark.parametrize("k,ci,co", [(3, 128, 128), (4, 128, 64), (11, 32, 32), (4, 16, 8),
                                     (7, 8, 8), (3, 24, 16)])
def test_fragment_order_reads_back_the_taps(k, ci, co):
    w = _bf(np.random.default_rng(k + ci + co), k, ci, co, scale=1.0)
    frag = mma_fragments_bf16(w)
    assert frag.dtype == torch.bfloat16 and frag.numel() == k * (-(-ci // 16) * 16) * co
    assert torch.equal(unfragment16(frag, k, ci, co), w.float())


def test_packers_build_both_orders_for_bf16_only():
    """bf16 towers and upsamplers carry the m16n8k16 buffer alone (every
    bf16 kernel reads it), float32 ones the m16n8k8 buffer alone."""
    rng = np.random.default_rng(7)
    towers = _towers(rng, 8)
    packed = pack_towers(towers)
    f32 = pack_towers([tuple(t.float() for t in tw) for tw in towers])
    assert packed.w is None and f32.w16 is None
    assert packed.w16.numel() == 2 * f32.w.numel()  # C = 8: k-steps padded to 16
    up = pack_upsampler(_bf(rng, 4, 16, 8, scale=0.3), _bf(rng, 8, scale=0.5), 2)
    up32 = pack_upsampler(up.w.float(), up.b.float(), 2)
    assert up.frag is None and up32.frag16 is None
    assert up.frag16.numel() == up32.frag.numel()


@pytest.mark.parametrize("C,T", [(128, 2000), (32, 1500), (8, 3000)])
def test_emulated_mrf_matches_plain(C, T):
    """At chip_smoke.py's weight scales: two terms within one bf16 step and
    1 % of outputs of plain's rounding; one term off on more than 10 %."""
    rng = np.random.default_rng(C + T)
    x = _bf(rng, 1, T, C, scale=1.0)
    towers = _towers(rng, C)
    packed = pack_towers(towers)
    plain = mrf_plain(x, towers, DILS)
    err, share = _close(mrf_bf16(x.float(), packed, C, DILS, KS).bfloat16(), plain)
    assert err <= 1.0 and share <= SHARE, (err, share)
    _, share1 = _close(mrf_bf16(x.float(), packed, C, DILS, KS, n=1).bfloat16(), plain)
    assert share1 > ONE_TERM_SHARE, share1


def test_emulated_mrf_matches_jax():
    rng = np.random.default_rng(5)
    x = _bf(rng, 1, 150, 128, scale=1.0)
    towers = _towers(rng, 128)
    got = mrf_bf16(x.float(), pack_towers(towers), 128, DILS, KS).bfloat16()
    want = jax_fused_mrf(_jax(x), [tuple(_jax(a) for a in t) for t in towers], DILS, KS, tile=64,
                         interpret=True)
    assert want.dtype == jnp.bfloat16
    err, share = _close(got, np.array(want.astype(jnp.float32)))
    assert err <= 1.0 and share <= SHARE, (err, share)


@pytest.mark.parametrize("widths,post,T_in", [((128, 64), False, 600), ((64, 32), True, 1500),
                                              ((16, 8), True, 3000)])
def test_emulated_upsample_stage_matches_plain(widths, post, T_in):
    ci, co = widths
    rng = np.random.default_rng(ci + post)
    x, up_w, up_b, towers, p = _stage_inputs(rng, ci, co, T_in, post)
    up, packed = pack_upsampler(up_w, up_b, 2), pack_towers(towers)
    plain = upsample_stage_plain(x, up_w, up_b, 2, 1, towers, DILS, post=p)
    got = stage_bf16(x, up, 1, packed, co, p)
    assert got.shape == plain.shape == ((1, 2 * T_in) if post else (1, 2 * T_in, co))
    err, share = _close(got, plain)
    assert err <= 1.0 and share <= SHARE, (err, share)
    _, share1 = _close(stage_bf16(x, up, 1, packed, co, p, n=1), plain)
    assert share1 > ONE_TERM_SHARE, share1


@pytest.mark.parametrize("widths,post", [((128, 64), False), ((64, 32), True), ((16, 8), True)])
def test_emulated_upsample_stage_matches_jax(widths, post):
    ci, co = widths
    rng = np.random.default_rng(ci + 2 * post + 1)
    x, up_w, up_b, towers, p = _stage_inputs(rng, ci, co, 80, post)
    got = stage_bf16(x, pack_upsampler(up_w, up_b, 2), 1, pack_towers(towers), co, p)
    want = fused_packed_stage(
        _jax(x), jnp.flip(_jax(up_w), 0), _jax(up_b), 2, 1,
        [tuple(_jax(a) for a in t) for t in towers], DILS, KS,
        post=None if p is None else tuple(_jax(a) for a in p), tile=64, interpret=True)
    assert want.dtype == jnp.bfloat16
    err, share = _close(got, np.array(want.astype(jnp.float32)))
    assert err <= 1.0 and share <= SHARE, (err, share)


@pytest.mark.parametrize("C,T", [(32, 1500), (8, 3000), (8, 9)])
def test_emulated_resblock_matches_plain(C, T):
    """The bf16 K3 (one tower, k 3, the towers' buffer read by the lane
    formula) at chip_smoke.py's weight scales: two terms within one bf16
    step and 1 % of outputs off plain's rounding; one term misses that share.
    T = 9 lies below the tower's 12-row halo."""
    rng = np.random.default_rng(C + T + 3)
    x = _bf(rng, 1, T, C, scale=1.0)
    tower = _towers(rng, C, ks=(3,))[0]
    packed = pack_towers([tower])
    plain = resblock1_plain(x, *tower, DILS)
    err, share = _close(mrf_bf16(x.float(), packed, C, DILS, (3,)).bfloat16(), plain)
    assert err <= 1.0 and share <= SHARE, (err, share)
    _, share1 = _close(mrf_bf16(x.float(), packed, C, DILS, (3,), n=1).bfloat16(), plain)
    assert share1 > SHARE, share1


@pytest.mark.parametrize("C,T", [(32, 150), (8, 9)])
def test_emulated_resblock_matches_jax(C, T):
    rng = np.random.default_rng(C + T + 4)
    x = _bf(rng, 1, T, C, scale=1.0)
    tower = _towers(rng, C, ks=(3,))[0]
    got = mrf_bf16(x.float(), pack_towers([tower]), C, DILS, (3,)).bfloat16()
    want = jax_fused_resblock1(_jax(x), *(_jax(a) for a in tower), DILS, tile=64, interpret=True)
    assert want.dtype == jnp.bfloat16
    err, share = _close(got, np.array(want.astype(jnp.float32)))
    assert err <= 1.0 and share <= SHARE, (err, share)
