"""The arithmetic of K5's float32 backward (`tf::dkv_kernel`, `tf::dq_kernel`
in `csrc/flash_attn.cu`), emulated on the CPU; and the order and rounding
points of the bf16 backward (`wg::dkv_kernel`, `wg::dq_kernel`).

The kernels split each float32 operand as hi = rna_tf32(x), lo =
rna_tf32(x - hi) (at its fragment load, or as P and dS are written) and run
three TF32 products (lo.hi, hi.lo, hi.hi) a product, with float32 sums. Here every tensor-core product is a float32
matmul of the split operands over one k-step of 8, added in the kernels'
order:
  * S and dP (S^T and dP^T in dK/dV) over the head dim, one k-step at a
    time, each of the three terms into its own accumulator, summed as
    hh + (lh + hl);
  * P = exp(S scale + mask - lse) and dS = P (dP - D) scale in float32
    (rounding P and dS to the input type is a no-op in float32);
  * dV += P^T dO, dK += dS^T Q and dQ += dS K one streamed tile of TB rows
    at a time, one k-step of 8 at a time, each term added to the one
    accumulator in the order lo.hi, hi.lo, hi.hi.
Every key tile (dK/dV) and query tile (dQ) runs the same loop, so the
emulation runs them all at once. TB, the k-step and the layout's constants
are parsed out of the source: a kernel change the emulation does not follow
fails here.

Bound: 1e-4 x each gradient's largest value against autograd of
`flash_attention_plain` in float64 (tests/test_torch_gpu.py's bound for the
kernels against plain), and against the JAX library kernel's VJP in
interpret mode; a single-pass TF32 control must miss it.

The bf16 kernels take bf16 products with float32 accumulation (wgmma): S
and dP (S^T and dP^T) over k-steps of 16 columns (the head dim's zero pad
completing the last), one float32 sum; P = exp2(S scale log2(e) - lse
log2(e)) where the segments match, else 0; P rounded to bf16 before P^T dO,
dS = P (dP - D) scale in float32 rounded to bf16 before dS^T Q and dS K;
each gradient summed in float32 one streamed tile of BS rows at a time and
rounded to bf16 once. Bound: two bf16 steps of each gradient's largest value against
the JAX library kernel's bf16 VJP (tests/test_torch_gpu.py's bound for the
bf16 kernels against plain).
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_flash_attention import _attention_inputs, _jax_attention, bf16_step
from zerovox_tpu_torch.ops.flash_attention import MASK_VALUE, flash_attention_plain

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "zerovox_tpu_torch" / "csrc" / "flash_attn.cu").read_text()
SMEM_MAX = 232_448  # bytes of shared memory a block can have on an H100
KS = 8  # k of mma.sync.m16n8k8 (TF32)


TF = SOURCE[SOURCE.index("namespace tf {"):]  # the float32 backward's own constants


def _const(name: str) -> int:
    """A `constexpr int` of namespace tf, else of the source, evaluated over
    the constants it names."""
    m = re.search(rf"constexpr int {name} = ([^;]+);", TF) or \
        re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m, f"constexpr int {name} is not in flash_attn.cu"
    expr = m.group(1)
    for other in re.findall(r"[A-Z][A-Z_0-9]+", expr):
        expr = expr.replace(other, str(_const(other)))
    return int(eval(expr, {}))  # an integer expression of the source's constants


TB = _const("TB")
BW = SOURCE[SOURCE.index("namespace wg {"):SOURCE.index("}  // namespace wg")]  # the bf16 backward
BS = int(re.search(r"constexpr int BS = (\d+);", BW).group(1))
LOG2E = 1.4426950408889634


def rna_tf32(x):
    """cvt.rna.tf32.f32 (tc::to_tf32): round the mantissa to 10 bits, ties
    away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x, passes=3):
    hi = rna_tf32(x)
    return hi, (rna_tf32(x - hi) if passes == 3 else torch.zeros_like(x))


def s_half(x, y, kb, ke, passes=3):
    """X Y^T over columns [kb, ke) as s_tile: one k-step of KS at a time, a
    float32 accumulator per term, hh + (lh + hl)."""
    (xh, xl), (yh, yl) = split(x, passes), split(y, passes)
    shape = (*x.shape[:-1], y.shape[-2])
    lh, hl, hh = (torch.zeros(shape) for _ in range(3))
    for k0 in range(kb, ke, KS):
        ks = slice(k0, k0 + KS)
        lh = lh + xl[..., ks] @ yh[..., ks].transpose(-1, -2)
        hl = hl + xh[..., ks] @ yl[..., ks].transpose(-1, -2)
        hh = hh + xh[..., ks] @ yh[..., ks].transpose(-1, -2)
    return hh + (lh + hl)


def s_tiles(x, y, passes=3):
    """X Y^T over the head dim as s_tile (one warp, every k-step)."""
    return s_half(x, y, 0, x.shape[-1], passes)


def accumulate(acc, x, y, passes=3):
    """acc += X Y as accumulate: one k-step of KS at a time, the three terms
    into acc in the order lo.hi, hi.lo, hi.hi."""
    (xh, xl), (yh, yl) = split(x, passes), split(y, passes)
    for k0 in range(0, x.shape[-1], KS):
        ks = slice(k0, k0 + KS)
        acc = acc + xl[..., ks] @ yh[..., ks, :]
        acc = acc + xh[..., ks] @ yl[..., ks, :]
        acc = acc + xh[..., ks] @ yh[..., ks, :]
    return acc


def emulate_bwd(q, k, v, do, seg, scale, passes=3):
    """(dq, dk, dv) of the float32 kernels for float32 [B, h, L, d] inputs:
    lse and D as the forward kernel and the wrapper give them (float32)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    same = seg[:, None, :, None] == seg[:, None, None, :]
    mask = torch.where(same, 0.0, MASK_VALUE)
    lse = torch.logsumexp(s + mask, dim=-1)
    o = flash_attention_plain(q, k, v, seg, scale)
    dsum = (do * o).sum(-1)
    L = q.shape[2]
    dk, dv, dq = torch.zeros_like(k), torch.zeros_like(v), torch.zeros_like(q)
    for j in range(0, L, TB):  # dK/dV: every key tile over query tile j
        qs = slice(j, j + TB)
        st = s_tiles(k, q[:, :, qs], passes)  # S^T = K Q^T
        dpt = s_tiles(v, do[:, :, qs], passes)  # dP^T = V dO^T
        pt = torch.exp(st * scale + mask[:, :, qs].transpose(-1, -2) - lse[:, :, None, qs])
        dst = pt * (dpt - dsum[:, :, None, qs]) * scale
        dv = accumulate(dv, pt, do[:, :, qs], passes)
        dk = accumulate(dk, dst, q[:, :, qs], passes)
    for j in range(0, L, TB):  # dQ: every query tile over key tile j
        ks = slice(j, j + TB)
        s_ = s_tiles(q, k[:, :, ks], passes)  # S = Q K^T
        dp = s_tiles(do, v[:, :, ks], passes)  # dP = dO V^T
        p = torch.exp(s_ * scale + mask[:, :, :, ks] - lse[..., None])
        ds = p * (dp - dsum[..., None]) * scale
        dq = accumulate(dq, ds, k[:, :, ks], passes)
    return dq, dk, dv


def reference(q, k, v, do, seg, scale):
    """autograd of flash_attention_plain in float64"""
    q, k, v = (x.double().requires_grad_(True) for x in (q, k, v))
    o = flash_attention_plain(q, k, v, seg, scale)
    o.backward(do.double())
    return q.grad, k.grad, v.grad


def _inputs(B, h, L, d, lengths):
    q, k, v, seg, do = _attention_inputs(L + d, B, h, L, d, lengths)
    return (*(torch.from_numpy(x) for x in (q, k, v, do)), torch.from_numpy(seg),
            1.0 / np.sqrt(d))


@pytest.mark.parametrize("B,h,L,d,lengths", [(2, 2, 256, 24, (256, 150)),
                                             (1, 2, 128, 264, (97,))])
def test_emulation_matches_plain_in_float64(B, h, L, d, lengths):
    q, k, v, do, seg, scale = _inputs(B, h, L, d, lengths)
    got = emulate_bwd(q, k, v, do, seg, scale)
    want = reference(q, k, v, do, seg, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err, bound = (g.double() - w).abs().max().item(), 1e-4 * w.abs().max().item()
        assert err <= bound, f"{name}: {err} > {bound}"
    # one TF32 pass (no lo terms) misses the bound at the model's head dim
    if d == 264:
        one = emulate_bwd(q, k, v, do, seg, scale, passes=1)
        gaps = [((g.double() - w).abs().max() / w.abs().max()).item() for g, w in zip(one, want)]
        assert max(gaps) > 1e-4, f"single-pass TF32 within the bound: {gaps}"


def test_emulation_matches_the_library_kernel():
    B, h, L, d, lengths = 1, 2, 256, 24, (201,)
    q, k, v, seg, do = _attention_inputs(7, B, h, L, d, lengths)
    want = _jax_attention(q, k, v, seg, 1.0 / np.sqrt(d), do)[1:]
    got = emulate_bwd(*(torch.from_numpy(x) for x in (q, k, v, do)), torch.from_numpy(seg),
                      1.0 / np.sqrt(d))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_the_source_holds_what_the_emulation_follows():
    """The emulated structure, read from the source: the term order and sum
    of s_tile and accumulate, the tile and the layout, which must fit in one
    block's shared memory at the largest head dim with conflict-free rows."""
    assert "s[n][e] = hh[n][e] + (lh[n][e] + hl[n][e]);" in SOURCE
    assert re.search(r"tc::mma\(d, a\.lo, b\.hi\);\s*tc::mma\(d, a\.hi, b\.lo\);\s*"
                     r"tc::mma\(d, a\.hi, b\.hi\);", SOURCE)
    assert re.search(r"for \(int r = 0; r < 2; \+\+r\) tc::mma\(acc\[r\]\[i\], a\[r\]\.lo, b\.hi\);"
                     r".*a\[r\]\.hi, b\.lo\);.*a\[r\]\.hi, b\.hi\);", SOURCE, re.S)
    for loop in ("for (int kk = 0; kk < TB / 8; ++kk)", "for (int k0 = 0; k0 < d; k0 += 8)"):
        assert loop in SOURCE, loop
    assert "inline int ld_of(int d) { return d % 16 == 0 ? d + 8 : d; }" in SOURCE
    dmax, warps = _const("DMAX"), _const("WARPS")
    assert _const("L_MULTIPLE") % TB == 0 and TB == 32 and warps == 8  # 2 x 2 tiles of S, dP

    def take(n):
        return (n + 15) // 16 * 16

    frags = _const("FRAGS")
    assert frags == 2 * (TB // 8) * 256 and 4 * 8 * 32 <= frags  # A fragments; P's handover
    for d in range(8, dmax + 1, 8):
        ld = d + 8 if d % 16 == 0 else d
        assert ld % 32 in (8, 24), d  # fragment loads on distinct banks, 16-byte rows
        tile = TB * ld * 4  # two resident tiles, two buffers of two streamed ones
        smem = 2 * take(tile) + 2 * take(2 * tile) + 2 * take(frags * 4) + 4 * take(2 * TB * 4)
        assert smem <= SMEM_MAX, (d, smem)
    assert _const("NTW_KV") * warps // 2 >= dmax // 8  # 4 warps cover a row of dK or dV
    assert _const("NTW_Q") * warps >= dmax // 8  # 8 warps cover a row of dQ


def bf16(x):
    return x.to(torch.bfloat16).float()


def s_bf16(x, y):
    """X Y^T over the head dim as the S wgmma loop: k-steps of 16 columns
    (the zero pad completing the last), one float32 sum."""
    d = x.shape[-1]
    acc = torch.zeros(*x.shape[:-1], y.shape[-2])
    for k0 in range(0, d, 16):
        acc = acc + x[..., k0:k0 + 16] @ y[..., k0:k0 + 16].transpose(-1, -2)
    return acc


def p_ds_bf16(s, dp, same, lse, dsum, scale):
    """P (float32) and dS rounded to bf16 from S and dP as the kernels take
    them: the log2 domain, fmaf(s, scale log2(e), -(lse log2(e))) rounded
    once, exp2; dS = P (dP - D) scale."""
    sl2 = np.float32(np.float32(scale) * np.float32(LOG2E))
    l2 = (lse * np.float32(LOG2E)).double()
    p = torch.where(same, torch.exp2((s.double() * float(sl2) - l2).float()), 0.0)
    return p, bf16(p * (dp - dsum) * np.float32(scale))


def emulate_bwd_bf16(q, k, v, do, seg, scale):
    """(dq, dk, dv) of the bf16 kernels for [B, h, L, d] inputs holding bf16
    values: lse and o as the forward gives them (float32, bf16), D in
    float32 as the wrapper computes it."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * np.float32(scale)
    same = seg[:, None, :, None] == seg[:, None, None, :]
    lse = torch.logsumexp(s + torch.where(same, 0.0, MASK_VALUE), dim=-1)
    o = bf16(flash_attention_plain(*(x.bfloat16() for x in (q, k, v)), seg, scale))
    dsum = (do * o).sum(-1)
    L = q.shape[2]
    dk, dv, dq = torch.zeros_like(k), torch.zeros_like(v), torch.zeros_like(q)
    for j in range(0, L, BS):  # dK/dV: every key tile over query tile j
        qs = slice(j, j + BS)
        pt, dst = p_ds_bf16(s_bf16(k, q[:, :, qs]), s_bf16(v, do[:, :, qs]),
                            same[:, :, qs].transpose(-1, -2), lse[:, :, None, qs],
                            dsum[:, :, None, qs], scale)
        dv = dv + bf16(pt) @ do[:, :, qs]
        dk = dk + dst @ q[:, :, qs]
    for j in range(0, L, BS):  # dQ: every query tile over key tile j
        ks = slice(j, j + BS)
        _, ds = p_ds_bf16(s_bf16(q, k[:, :, ks]), s_bf16(do, v[:, :, ks]),
                          same[:, :, :, ks], lse[..., None], dsum[..., None], scale)
        dq = dq + ds @ k[:, :, ks]
    return bf16(dq), bf16(dk), bf16(dv)


def test_bf16_emulation_matches_the_library_kernel():
    """The bf16 kernels' order and rounding points against the library
    kernel's bf16 gradients (the float32 case's inputs, rounded to bf16)."""
    import jax.numpy as jnp

    B, h, L, d, lengths = 1, 2, 256, 24, (201,)
    q, k, v, seg, do = _attention_inputs(7, B, h, L, d, lengths)
    xs = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    want = _jax_attention(xs[0], xs[1], xs[2], seg, 1.0 / np.sqrt(d), xs[3])[1:]
    got = emulate_bwd_bf16(*(torch.from_numpy(np.asarray(x, np.float32)) for x in xs),
                           torch.from_numpy(seg), 1.0 / np.sqrt(d))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err, step = np.abs(g.numpy() - w).max(), bf16_step(w)
        assert err <= 2 * step, f"{name}: {err} against a step of {step}"


def test_the_source_holds_what_the_bf16_emulation_follows():
    """The bf16 kernels' rounding points and sums, read from the source, and
    their layout: a block's 64 rows (one wgmma M), BS streamed rows a step,
    every tile and buffer in one block's shared memory at every head dim."""
    assert "exp2f(fmaf(s[4 * c + e], sl2, -(lq * LOG2E)))" in BW
    assert "const float sl2 = a.scale * LOG2E;" in BW
    # S: every k-step into one accumulator, the first with its input off
    assert "for (int ks = 0; ks < nk; ++ks) mma_s(s, desc_k(x, ks), desc_ks(y, ks), ks);" in BW
    assert "fw::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1])" in BW  # P^T, dS^T to bf16
    assert "fw::pack_bf16(s[4 * c], s[4 * c + 1])" in BW  # dS to bf16 (dQ)
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", BW))
    br, bs = int(consts["BR"]), int(consts["BS"])
    assert br == 64 and bs == BS and bs % 16 == 0

    def take(n):
        return (n + 15) // 16 * 16

    cb = _const("DMAX") // 8  # every head dim's tiles take DMAX columns
    for dkv in (True, False):
        smem = (2 * take(br * cb * 16) + 4 * take(bs * cb * 16) + take(4 * bs // 2 * 32 * 4)
                + (2 if dkv else 0) * take(2 * bs * 4) + take(2 * bs * 4) + take(16))
        assert smem <= SMEM_MAX, (dkv, smem)


def _breakdown():
    spec = importlib.util.spec_from_file_location("bench_k5_breakdown",
                                                  ROOT / "scripts" / "bench_k5_breakdown.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_breakdown_substitutions_occur_once():
    """scripts/bench_k5_breakdown.py builds copies of the source with phases
    taken out by text substitution: each must match exactly once."""
    script = _breakdown()
    for name, subs in script.VARIANTS.items():
        for old, _ in subs:
            assert SOURCE.count(old) == 1, f"{name}: {old!r}"
        assert (script.variant_source(SOURCE, subs) != SOURCE) == bool(subs), name
