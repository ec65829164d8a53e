"""The arithmetic of kernels K1 (fused MRF), K2 (fused upsample stage) and
K3 (one fused ResBlock1 tower), emulated on the CPU: 3xTF32 tensor-core
products against the plain float32 versions and the JAX kernels in
interpret mode.

The CUDA kernels split each operand as hi = rna_tf32(x), lo = rna_tf32(x -
hi) (round to nearest, ties away, 10 mantissa bits) and sum three products
per conv (lo.hi + hi.lo + hi.hi) in float32. Here each product is a float32
convolution of the split operands, with the weights read back from the
kernels' MMA fragment buffers by the kernels' own offsets. Bound: 5e-4, the
kernels' bound against their plain versions (chip_smoke.py). Single-pass
TF32 falls outside it at the main path's width, which is why the kernels
take three passes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from zerovox_tpu.ops.pallas.mrf import fused_mrf as jax_fused_mrf
from zerovox_tpu.ops.pallas.packed import fused_packed_stage
from zerovox_tpu.ops.pallas.resblock import fused_resblock1 as jax_fused_resblock1

from zerovox_tpu_torch.ops.mrf import LRELU_SLOPE, mrf_plain, pack_towers
from zerovox_tpu_torch.ops.resblock import resblock1_plain
from zerovox_tpu_torch.ops.upsample_stage import pack_upsampler, upsample_stage_plain

KS = (3, 7, 11)
DILS = (1, 3, 5)
TOL = 5e-4


def rna_tf32(x):
    """cvt.rna.tf32.f32: round the float32 mantissa to 10 bits, ties away
    from zero (on the bit pattern: add half of the dropped range, clear it)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def unfragment(frag, k, ci, co):
    """Taps [k, ci, co] read back from MMA fragment order by the kernels'
    lane formula (csrc/mrf_tc.cuh): lane l of block (tap, ks, nf) holds
    w[tap][8 ks + l % 4 + 4 h][8 nf + l // 4] at position 2 l + h."""
    f = frag.reshape(k, ci // 8, co // 8, 32, 2)
    w = torch.empty(k, ci, co)
    for lane in range(32):
        for h in range(2):
            rows = torch.arange(ci // 8) * 8 + lane % 4 + 4 * h
            cols = torch.arange(co // 8) * 8 + lane // 4
            w[:, rows[:, None], cols[None, :]] = f[:, :, :, lane, h]
    return w


def conv_tc(x, w, b, dil, passes=3):
    """'same' conv of NCL x with taps w [k, in, out] as the kernels' GEMMs:
    3xTF32 (passes=3) or single-pass TF32 (passes=1), float32 sums."""
    k = w.shape[0]
    wt = w.permute(2, 1, 0)
    conv = lambda a, v: F.conv1d(a, v, None, padding=(k - 1) // 2 * dil, dilation=dil)  # noqa: E731
    xh, xl = split(x)
    wh, wl = split(wt)
    y = conv(xh, wh) if passes == 1 else conv(xl, wh) + conv(xh, wl) + conv(xh, wh)
    return y + b[None, :, None]


def mrf_tc(x, packed, C, dils, ks, passes=3):
    """The MRF stage over x [B, T, C], weights and biases read from the
    kernels' flat buffers at the kernels' offsets (tower by tower: w1 [P][k]
    then w2 [P][k] taps; b1 [P][C] then b2 [P][C])."""
    xc = x.transpose(1, 2)
    P = len(dils)
    wofs = bofs = 0
    total = None
    for k in ks:
        conv = k * C * C
        w1 = [unfragment(packed.w[wofs + q * conv:wofs + (q + 1) * conv], k, C, C) for q in range(P)]
        w2 = [unfragment(packed.w[wofs + (P + q) * conv:wofs + (P + q + 1) * conv], k, C, C)
              for q in range(P)]
        b1 = packed.b[bofs:bofs + P * C].reshape(P, C)
        b2 = packed.b[bofs + P * C:bofs + 2 * P * C].reshape(P, C)
        y = xc
        for q, d in enumerate(dils):
            t = conv_tc(F.leaky_relu(y, LRELU_SLOPE), w1[q], b1[q], d, passes)
            y = conv_tc(F.leaky_relu(t, LRELU_SLOPE), w2[q], b2[q], 1, passes) + y
        total = y if total is None else total + y
        wofs += 2 * P * conv
        bofs += 2 * P * C
    return (total / len(ks)).transpose(1, 2)


def upsample_tc(x, up, padding):
    """The transposed conv as the kernel's polyphase GEMMs: output row t of
    phase ph = (t + padding) % s takes taps ph + s j on input row (t +
    padding - ph) / s - j, the taps read from the fragment buffer in phase
    order."""
    k, ci, co = up.w.shape
    s = up.stride
    B, T_in, _ = x.shape
    T_out = (T_in - 1) * s + k - 2 * padding
    taps = unfragment(up.frag, k, ci, co)
    xh, xl = split(F.leaky_relu(x, LRELU_SLOPE))
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
            ah = torch.where(ok[None, :, None], xh[:, i.clamp(0, T_in - 1)], 0.0)
            al = torch.where(ok[None, :, None], xl[:, i.clamp(0, T_in - 1)], 0.0)
            wh, wl = split(taps[tap + j])
            acc = acc + (al @ wh + ah @ wl + ah @ wh)
        out[:, t] = acc + up.b
        tap += n_taps
    return out


def stage_tc(x, up, padding, packed, C_out, post=None):
    y = mrf_tc(upsample_tc(x, up, padding), packed, C_out, DILS, KS)
    if post is None:
        return y
    pw, pb = post  # conv_post stays float32 on the CUDA cores
    y = F.conv1d(F.leaky_relu(y, 0.01).transpose(1, 2), pw.permute(2, 1, 0), pb,
                 padding=(pw.shape[0] - 1) // 2)
    return torch.tanh(y)[:, 0, :]


def _r(rng, *shape, scale):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


def _towers(rng, C):
    """chip_smoke.py's random_towers scales: weights N(0, 1 / (k C)), biases N(0, 1/4)."""
    return [(_r(rng, 3, k, C, C, scale=1 / np.sqrt(k * C)), _r(rng, 3, C, scale=0.5),
             _r(rng, 3, k, C, C, scale=1 / np.sqrt(k * C)), _r(rng, 3, C, scale=0.5))
            for k in KS]


def _jax(ts):
    return [tuple(jnp.asarray(a.numpy()) for a in t) for t in ts]


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the tf32 step above 1
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, one + 2.0 ** -11 + 2.0 ** -20,
                      -(1.0 + 2.0 ** -11), 3.0e-3, -7.25e5], dtype=torch.float32)
    hi = rna_tf32(x)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)  # 13 low bits cleared
    assert hi[:5].tolist() == [1.0, one, 1.0, one + 2.0 ** -10, -one]
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.normal(size=10000).astype(np.float32))
    h, lo = split(v)
    assert torch.all((v - h).abs() <= v.abs() * 2.0 ** -11)
    assert torch.all((v - h - lo).abs() <= v.abs() * 2.0 ** -21)


def test_bf16_values_are_their_own_tf32_hi():
    """A bf16 value splits into TF32 hi = itself and lo = 0 exactly, so the
    float32 kernels on a bf16 tower's widened weights run exactly those
    weights. The bf16 kernels read no m16n8k8 buffer: a bf16 tower carries
    its m16n8k16 buffer alone, which holds the values of the widened
    tower's m16n8k8 buffer in another order (tests/test_torch_bf16_mma.py
    emulates the bf16 kernels on it)."""
    from zerovox_tpu_torch.ops.mrf import widen

    rng = np.random.default_rng(1)
    w = _r(rng, 100000, scale=1.0).bfloat16().float()
    hi, lo = split(w)
    assert torch.equal(hi, w) and torch.all(lo == 0)
    tower = tuple(t.bfloat16() for t in _towers(rng, 32)[1])
    packed = pack_towers([tower])
    assert packed.w is None and packed.w16.dtype == torch.bfloat16
    want = pack_towers(widen([tower])).w
    assert torch.equal(packed.w16.float().sort().values, want.sort().values)


@pytest.mark.parametrize("k,ci,co", [(3, 128, 128), (4, 128, 64), (11, 32, 32), (4, 32, 16),
                                     (7, 16, 16), (3, 8, 8), (4, 16, 8)])
def test_fragment_order_reads_back_the_taps(k, ci, co):
    from zerovox_tpu_torch.ops.mrf import mma_fragments

    w = _r(np.random.default_rng(k + ci + co), k, ci, co, scale=1.0)
    assert torch.equal(unfragment(mma_fragments(w), k, ci, co), w)


@pytest.mark.parametrize("C,T", [(128, 37), (64, 80), (32, 101), (16, 90), (8, 130)])
def test_emulated_mrf_matches_plain_and_jax(C, T):
    rng = np.random.default_rng(C + T)
    x = _r(rng, 1, T, C, scale=1.0)
    towers = _towers(rng, C)
    got = mrf_tc(x, pack_towers(towers), C, DILS, KS)
    plain = mrf_plain(x, towers, DILS)
    want = jax_fused_mrf(jnp.asarray(x.numpy()), _jax(towers), DILS, KS, tile=64, interpret=True)
    assert torch.max(torch.abs(got - plain)).item() < TOL
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < TOL


def test_emulated_mrf_batch_and_other_towers():
    rng = np.random.default_rng(3)
    x = _r(rng, 2, 50, 64, scale=1.0)
    towers = [(_r(rng, 2, k, 64, 64, scale=1 / np.sqrt(k * 64)), _r(rng, 2, 64, scale=0.5),
               _r(rng, 2, k, 64, 64, scale=1 / np.sqrt(k * 64)), _r(rng, 2, 64, scale=0.5))
              for k in (3, 5)]
    got = mrf_tc(x, pack_towers(towers), 64, (1, 2), (3, 5))
    assert torch.max(torch.abs(got - mrf_plain(x, towers, (1, 2)))).item() < TOL


@pytest.mark.parametrize("C,k,dils,T", [(128, 3, DILS, 37), (64, 3, DILS, 80), (32, 3, DILS, 101),
                                       (64, 5, DILS, 50), (32, 5, (1, 3), 40), (16, 3, DILS, 77),
                                       (8, 3, DILS, 120)])
def test_emulated_resblock_matches_plain_and_jax(C, k, dils, T):
    """K3: one tower's convs in 3xTF32, the weights read back from the
    one-tower fragment buffer (`pack_towers([tower])`) by the kernel's
    offsets. The kernel takes the same hi/lo halves whether it stages them
    split in shared memory (C=32) or splits them at each k-step."""
    rng = np.random.default_rng(C + k + T)
    x = _r(rng, 1, T, C, scale=1.0)
    P = len(dils)
    tower = (_r(rng, P, k, C, C, scale=1 / np.sqrt(k * C)), _r(rng, P, C, scale=0.5),
             _r(rng, P, k, C, C, scale=1 / np.sqrt(k * C)), _r(rng, P, C, scale=0.5))
    got = mrf_tc(x, pack_towers([tower]), C, dils, (k,))
    plain = resblock1_plain(x, *tower, dils)
    want = jax_fused_resblock1(jnp.asarray(x.numpy()), *(jnp.asarray(a.numpy()) for a in tower),
                               dils, tile=64, interpret=True)
    assert got.shape == plain.shape == (1, T, C)
    assert torch.max(torch.abs(got - plain)).item() < TOL
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < TOL


@pytest.mark.parametrize("widths", [(128, 64), (64, 32), (32, 16), (16, 8)])
@pytest.mark.parametrize("post", [False, True])
def test_emulated_upsample_stage_matches_plain_and_jax(widths, post):
    C_in, C_out = widths
    T_in = 41
    rng = np.random.default_rng(C_in + post)
    x = _r(rng, 1, T_in, C_in, scale=1.0)
    up_w = _r(rng, 4, C_in, C_out, scale=1 / np.sqrt(2 * C_in))  # torch taps (k, in, out)
    up_b = _r(rng, C_out, scale=0.5)
    towers = _towers(rng, C_out)
    p = (_r(rng, 7, C_out, 1, scale=1 / np.sqrt(7 * C_out)), _r(rng, 1, scale=0.1)) if post else None
    got = stage_tc(x, pack_upsampler(up_w, up_b, 2), 1, pack_towers(towers), C_out, p)
    plain = upsample_stage_plain(x, up_w, up_b, 2, 1, towers, DILS, post=p)
    want = fused_packed_stage(
        jnp.asarray(x.numpy()), jnp.asarray(np.flip(up_w.numpy(), 0).copy()),
        jnp.asarray(up_b.numpy()), 2, 1, _jax(towers), DILS, KS,
        post=None if p is None else tuple(jnp.asarray(a.numpy()) for a in p), tile=64,
        interpret=True)
    assert got.shape == plain.shape == ((1, 2 * T_in) if post else (1, 2 * T_in, C_out))
    assert torch.max(torch.abs(got - plain)).item() < TOL
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < TOL


@pytest.mark.parametrize("k,stride,padding", [(4, 2, 1), (5, 2, 1), (16, 8, 4), (3, 4, 0)])
def test_polyphase_transposed_conv_matches_torch(k, stride, padding):
    """Every phase, with taps per phase unequal (k % stride != 0) or absent
    (k < stride)."""
    rng = np.random.default_rng(k * stride)
    x = _r(rng, 2, 13, 32, scale=1.0)
    w = _r(rng, k, 32, 16, scale=0.2)
    b = _r(rng, 16, scale=0.5)
    got = upsample_tc(x, pack_upsampler(w, b, stride), padding)
    want = F.conv_transpose1d(F.leaky_relu(x, LRELU_SLOPE).transpose(1, 2), w.permute(1, 2, 0), b,
                              stride=stride, padding=padding).transpose(1, 2)
    assert got.shape == want.shape
    assert torch.max(torch.abs(got - want)).item() < 1e-5


def test_single_pass_tf32_is_outside_the_bound():
    """C=128, 2000 rows, chip_smoke.py's weight scales: 3xTF32 stays within
    float32 rounding of a float64 run, single-pass TF32 is past 5e-4."""
    C, T = 128, 2000
    rng = np.random.default_rng(128)
    x = _r(rng, 1, T, C, scale=1.0)
    towers = _towers(rng, C)
    packed = pack_towers(towers)
    ref = mrf_plain(x.double(), [tuple(a.double() for a in t) for t in towers], DILS)
    three = (mrf_tc(x, packed, C, DILS, KS, passes=3).double() - ref).abs().max().item()
    one = (mrf_tc(x, packed, C, DILS, KS, passes=1).double() - ref).abs().max().item()
    f32 = (mrf_plain(x, towers, DILS).double() - ref).abs().max().item()
    assert three < 10 * f32 + 1e-6 and three < TOL / 10
    assert one > TOL


@pytest.mark.parametrize("C,post_widths", [(24, (24, 12)), (12, (8, 4)), (48, (48, 24))])
def test_emulated_padded_widths_match_plain(C, post_widths):
    """A width between the instantiated ones: the wrappers zero-pad x and
    the packers the weights to the next instantiated width (K1/K3: 24 ->
    32, 12 -> 16, 48 -> 64; K2: (24, 12) -> (32, 16), (8, 4) -> (16, 8),
    (48, 24) -> (64, 32)). The kernels' arithmetic on the padded buffers,
    cut back to C, is the plain stage on the unpadded ones."""
    from zerovox_tpu_torch.ops.mrf import kernel_channels, pad_to
    from zerovox_tpu_torch.ops.upsample_stage import kernel_widths

    rng = np.random.default_rng(C)
    Ck = kernel_channels(C)
    x = _r(rng, 1, 60, C, scale=1.0)
    towers = _towers(rng, C)
    packed = pack_towers(towers)
    assert packed.width == Ck and packed.w.numel() == 2 * 3 * sum(KS) * Ck * Ck
    got = mrf_tc(pad_to(x, (*x.shape[:-1], Ck)), packed, Ck, DILS, KS)
    assert torch.all(got[..., C:] == 0)
    assert torch.max(torch.abs(got[..., :C] - mrf_plain(x, towers, DILS))).item() < TOL
    one = pack_towers([towers[0]])
    got = mrf_tc(pad_to(x, (*x.shape[:-1], Ck)), one, Ck, DILS, (3,))[..., :C]
    assert torch.max(torch.abs(got - resblock1_plain(x, *towers[0], DILS))).item() < TOL

    ci, co = post_widths
    Ci, Co = kernel_widths(ci, co)
    xs = _r(rng, 1, 41, ci, scale=1.0)
    up_w = _r(rng, 4, ci, co, scale=1 / np.sqrt(2 * ci))
    up_b = _r(rng, co, scale=0.5)
    tw = _towers(rng, co)
    p = (_r(rng, 7, co, 1, scale=1 / np.sqrt(7 * co)), _r(rng, 1, scale=0.1))
    up = pack_upsampler(up_w, up_b, 2)
    assert up.widths == (Ci, Co) and pack_towers(tw).width == Co
    up_k = up._replace(w=torch.zeros(4, Ci, Co))  # the emulation reads the taps from up.frag
    y = upsample_tc(pad_to(xs, (*xs.shape[:-1], Ci)), up_k._replace(b=up.frag_b), 1)
    got = stage_tc(pad_to(xs, (*xs.shape[:-1], Ci)), up_k._replace(b=up.frag_b), 1, pack_towers(tw), Co,
                   (torch.nn.functional.pad(p[0], (0, 0, 0, Co - co)), p[1]))
    plain = upsample_stage_plain(xs, up_w, up_b, 2, 1, tw, DILS, post=p)
    assert torch.all(y[..., co:] == 0)
    assert got.shape == plain.shape
    assert torch.max(torch.abs(got - plain)).item() < TOL
