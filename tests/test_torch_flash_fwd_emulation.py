"""The arithmetic of K5's float32 forward (`fw::fwd_kernel<F32, RG>` in
`csrc/flash_attn.cu`), emulated on the CPU.

The kernel splits each float32 operand as hi = rna_tf32(x), lo = x - hi,
and the MMA reads lo's top 19 bits (lo enters truncated); every product is
three TF32 products (lo.hi, hi.lo, hi.hi) with float32 sums. Here every
tensor-core product is a float32 matmul of the split operands over one
k-step of 8, added in the kernel's order:
  * S over the head dim in two halves (the two warps of a pair: k-steps
    [0, ceil(nk / 2)) and the rest), each half's three terms in their own
    accumulators summed as hh + (lh + hl), then S = half 0 + half 1;
    the k-order 2t, 2t + 1 takes the same products as the natural one;
  * the online softmax in the log2 domain, one key tile of BK keys a step:
    x = fma(S, scale log2(e), mask), the running max m, alpha =
    exp2(m_old - m), P = exp2(x - m), l = l alpha + rowsum(P), O = O alpha;
  * O += P V one 8-key block at a time, the three terms added to the one
    accumulator in the order lo.hi, hi.lo, hi.hi (P split as an A fragment
    straight from S's C fragment: keys 2t, 2t + 1 of each 8);
  * the key groups: each row group's keys split KQ ways inside every key
    tile (KW = BK / KQ keys a group), each group with its own m, l and O,
    merged in order by the largest m: O = sum_q exp2(m_q - m) O_q,
    l = sum_q exp2(m_q - m) l_q; o = O / l, lse = m ln(2) + ln(l).
The query rows of a block do not change a row's arithmetic, so the emulation
runs every row at once. The tile's constants (KQ, BK, KW for RG row groups)
are parsed out of the source: a kernel change the emulation does not follow
fails here.

Bound: 1e-4 x the largest value of o and of lse against
`flash_attention_plain` and the log-sum-exp in float64, and against the JAX
library kernel in interpret mode; a single-pass TF32 control must miss it.
"""

import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_flash_attention import _attention_inputs, _jax_attention
from zerovox_tpu_torch.ops.flash_attention import MASK_VALUE, flash_attention_plain

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "zerovox_tpu_torch" / "csrc" / "flash_attn.cu").read_text()
FW = SOURCE[SOURCE.index("namespace fw {"):SOURCE.index("}  // namespace fw")]
SMEM_MAX = 232_448  # bytes of shared memory a block can have on an H100
KS = 8  # k of mma.sync.m16n8k8 (TF32)
LOG2E = np.float32(1.4426950408889634)


def _const(name: str, text: str = SOURCE) -> int:
    """A namespace-level `constexpr int` of the source, over the constants it
    names."""
    m = re.search(rf"\nconstexpr int {name} = ([^;]+);", text) or \
        re.search(rf"\nconstexpr int {name} = ([^;]+);", SOURCE)
    assert m, f"constexpr int {name} is not in flash_attn.cu"
    expr = m.group(1)
    for other in re.findall(r"[A-Z][A-Z_0-9]+", expr):
        expr = expr.replace(other, str(_const(other)))
    return int(eval(expr.replace("/", "//"), {}))


def tile(rg: int) -> dict:
    """fw::Tile<F32, RG>'s KQ, BQ, BK, KW, NS, evaluated from the source."""
    body = FW[FW.index("struct Tile {"):]
    body = body[:body.index("};")]
    env = {"RG": rg, "imax": max, "PAIRS": _const("PAIRS", FW)}
    out = {}
    for name in ("KQ", "BQ", "BK", "KW", "NS"):
        m = re.search(rf"static constexpr int {name} = ([^;]+);", body)
        assert m, f"Tile::{name} is not in flash_attn.cu"
        expr = m.group(1).replace("P::KS", str(KS)).replace("/", "//")
        out[name] = env[name] = int(eval(expr, {"__builtins__": {}}, env))
    return out


def rna_tf32(x):
    """cvt.rna.tf32.f32 (tc::to_tf32): round the mantissa to 10 bits, ties
    away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def trunc_tf32(x):
    """What mma.sync reads of a float32 register given as TF32: its top 19
    bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x, passes=3):
    """fw::split as the MMA reads it: (hi, lo)"""
    hi = rna_tf32(x)
    return hi, (trunc_tf32(x - hi) if passes == 3 else torch.zeros_like(x))


def s_half(x, y, kb, ke, passes):
    """X Y^T over k-steps [kb, ke) as s_part: a float32 accumulator per term,
    hh + (lh + hl)."""
    (xh, xl), (yh, yl) = split(x, passes), split(y, passes)
    shape = (*x.shape[:-1], y.shape[-2])
    lh, hl, hh = (torch.zeros(shape) for _ in range(3))
    for ks in range(kb, ke):
        c = slice(ks * KS, ks * KS + KS)
        lh = lh + xl[..., c] @ yh[..., c].transpose(-1, -2)
        hl = hl + xh[..., c] @ yl[..., c].transpose(-1, -2)
        hh = hh + xh[..., c] @ yh[..., c].transpose(-1, -2)
    return hh + (lh + hl)


def pv(acc, p, v, passes):
    """acc += P V as pv: one 8-key block at a time, lo.hi, hi.lo, hi.hi."""
    (ph, pl), (vh, vl) = split(p, passes), split(v, passes)
    for k0 in range(0, p.shape[-1], KS):
        c = slice(k0, k0 + KS)
        acc = acc + pl[..., c] @ vh[..., c, :]
        acc = acc + ph[..., c] @ vl[..., c, :]
        acc = acc + ph[..., c] @ vh[..., c, :]
    return acc


def emulate_fwd(q, k, v, seg, scale, rg, passes=3):
    """(o, lse) of fwd_kernel<F32, rg> for float32 [B, h, L, d] inputs and
    segment ids [B, L]."""
    t = tile(rg)
    KQ, BK, KW = t["KQ"], t["BK"], t["KW"]
    B, h, L, d = q.shape
    nk = d // KS
    kh = (nk + 1) // 2
    same = seg[:, None, :, None] == seg[:, None, None, :]
    mask = torch.where(same, 0.0, MASK_VALUE).float()
    sl2 = np.float32(scale) * LOG2E
    m = torch.full((KQ, B, h, L), -math.inf)
    l = torch.zeros(KQ, B, h, L)
    acc = torch.zeros(KQ, B, h, L, d)
    for k0 in range(0, L, BK):
        for g in range(KQ):
            keys = slice(k0 + g * KW, k0 + (g + 1) * KW)
            kk, vv = k[:, :, keys], v[:, :, keys]
            s = s_half(q, kk, 0, kh, passes) + s_half(q, kk, kh, nk, passes)
            x = (s.double() * float(sl2) + mask[:, :, :, keys].double()).float()  # fmaf
            mx = torch.maximum(m[g], x.amax(-1))
            alpha = torch.exp2(m[g] - mx)
            p = torch.exp2(x - mx[..., None])
            l[g] = l[g] * alpha + p.sum(-1)
            m[g] = mx
            acc[g] = pv(acc[g] * alpha[..., None], p, vv, passes)
    mt = m.amax(0)
    f = torch.exp2(m - mt)
    lt, o = f[0] * l[0], f[0][..., None] * acc[0]
    for g in range(1, KQ):
        lt = lt + f[g] * l[g]
        o = o + f[g][..., None] * acc[g]
    return o * (1.0 / lt)[..., None], mt * np.float32(math.log(2.0)) + torch.log(lt)


def reference(q, k, v, seg, scale):
    """o and lse in float64"""
    o = flash_attention_plain(q.double(), k.double(), v.double(), seg, scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * scale
    same = seg[:, None, :, None] == seg[:, None, None, :]
    return o, torch.logsumexp(s + torch.where(same, 0.0, MASK_VALUE).double(), dim=-1)


def _inputs(B, h, L, d, lengths):
    q, k, v, seg, _ = _attention_inputs(L + d + 1, B, h, L, d, lengths)
    return (*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(seg), 1.0 / np.sqrt(d))


def _gaps(got, want):
    return [((g.double() - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]


@pytest.mark.parametrize("rg", [4, 2, 1])
@pytest.mark.parametrize("B,h,L,d,lengths", [(2, 2, 256, 24, (256, 150)),
                                             (1, 2, 128, 264, (97,))])
def test_emulation_matches_plain_in_float64(B, h, L, d, lengths, rg):
    q, k, v, seg, scale = _inputs(B, h, L, d, lengths)
    got = emulate_fwd(q, k, v, seg, scale, rg)
    want = reference(q, k, v, seg, scale)
    for name, gap in zip(("o", "lse"), _gaps(got, want)):
        assert gap <= 1e-4, f"{name}: {gap} x max"
    # one TF32 pass (no lo terms) misses the bound at the model's head dim
    if d == 264 and rg == 4:
        gaps = _gaps(emulate_fwd(q, k, v, seg, scale, rg, passes=1), want)
        assert gaps[0] > 1e-4, f"single-pass TF32 within the bound: {gaps}"


def test_emulation_matches_the_library_kernel():
    B, h, L, d, lengths = 1, 2, 256, 24, (201,)
    q, k, v, seg, do = _attention_inputs(9, B, h, L, d, lengths)
    want = _jax_attention(q, k, v, seg, 1.0 / np.sqrt(d), do)[0]
    for rg in (4, 1):
        got = emulate_fwd(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(seg),
                          1.0 / np.sqrt(d), rg)[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"RG {rg}")


def _smem(rg: int, d: int) -> int:
    """fw::Smem<F32, RG>(d).bytes, as the source carves it"""
    t = tile(rg)

    def take(n):
        return (n + 15) // 16 * 16

    ldq, ldv = (d + 8 if d % 16 == 0 else d), d + 4
    ntd = (_const("NT_MAX") + 1) // 2
    off = take(t["BQ"] * ldq * 4)
    k = off
    off += take(2 * t["BK"] * ldq * 4)
    off += take(2 * t["BK"] * ldv * 4)
    off = max(off, k + rg * (t["KQ"] - 1) * 2 * ntd * 32 * 4 * 4)
    off += take(_const("WARPS") * t["NS"] * 4 * 32 * 4)
    off += take(t["BQ"] * 4) + take(2 * t["BK"] * 4)
    off += take(rg * t["KQ"] * 16 * 2 * 4 if t["KQ"] > 1 else 0)
    return off


def test_the_source_holds_what_the_emulation_follows():
    """The emulated structure, read from the source: the split, the term
    order and sums of S and P V, the exchange of S's halves, the softmax in
    the log2 domain, the merge of key groups, the tiles, and a layout that
    fits in one block's shared memory at every head dim with conflict-free
    rows."""
    for line in ("  hi = tc::to_tf32(x);\n  lo = __float_as_uint(x - __uint_as_float(hi));\n",
                 "s[c][e] = hh[c][e] + (lh[c][e] + hl[c][e]);",
                 "const int nk = round_up(d, P::KS) / P::KS, kh = (nk + 1) / 2;",
                 "s[c][e] += xother[(c * 4 + e) * 32];",
                 "fmaf(s[c][e], sl2, sq[e >> 1] == sk[c * 8 + (e & 1)] ? 0.f : MASK)",
                 "alpha[r] = exp2f(m[r] - mx[r]);", "const float p = exp2f(s[c][e] - m[e >> 1]);",
                 "l[r] = l[r] * alpha[r] + ls[r];",
                 "ll += exp2f(x[w * 32] - mm) * x[w * 32 + 1];",
                 "lse[0] = mt[0] * LN2 + logf(lt[0]);"):
        assert line in FW, line
    assert re.search(r"tc::mma\(lh\[c\], a\.lo, b\.hi\);\s*tc::mma\(hl\[c\], a\.hi, b\.lo\);\s*"
                     r"tc::mma\(hh\[c\], a\.hi, b\.hi\);", FW)
    assert re.search(r"tc::mma\(acc\[i0 \+ j\], a\.lo, b\[j\]\.hi\);.*"
                     r"tc::mma\(acc\[i0 \+ j\], a\.hi, b\[j\]\.lo\);.*"
                     r"tc::mma\(acc\[i0 \+ j\], a\.hi, b\[j\]\.hi\);", FW, re.S)
    # P's C fragment {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)} as the A
    # fragment {(g, k t), (g+8, k t), (g, k t+4), (g+8, k t+4)}
    assert re.search(r"split\(p\[kb\]\[0\].*split\(p\[kb\]\[2\].*split\(p\[kb\]\[1\].*"
                     r"split\(p\[kb\]\[3\]", FW, re.S)
    assert "const float* vr = v + (kb * 8 + 2 * t) * ldv + n0 * 8 + g;" in FW
    warps, dmax, pairs = _const("WARPS"), _const("DMAX"), _const("PAIRS", FW)
    assert pairs * 2 == warps == 8
    for rg in (4, 2, 1):
        t = tile(rg)
        assert t["KQ"] * rg == pairs and t["BQ"] == 16 * rg and t["KW"] * t["KQ"] == t["BK"]
        assert t["KW"] % KS == 0 and _const("L_MULTIPLE") % t["BK"] == 0 and t["BK"] % 32 == 0
        for d in range(8, dmax + 1, 8):
            assert _smem(rg, d) <= SMEM_MAX, (rg, d, _smem(rg, d))
    for d in range(8, dmax + 1, 8):
        ldq, ldv = (d + 8 if d % 16 == 0 else d), d + 4
        assert ldq % 32 in (8, 24), d  # 8-byte loads of rows g, columns 2t on distinct banks
        banks = {(2 * tt * ldv + g) % 32 for tt in range(4) for g in range(8)}
        assert len(banks) == 32, d  # 4-byte loads of rows 2t (and 2t + 1), column g


def _breakdown():
    spec = importlib.util.spec_from_file_location("bench_k5_breakdown",
                                                  ROOT / "scripts" / "bench_k5_breakdown.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_forward_breakdown_substitutions_occur_once():
    """scripts/bench_k5_breakdown.py's forward variants (fwd_*) are copies of
    the source with a phase taken out or a design choice changed by text
    substitution: each must match exactly once, inside the forward."""
    script = _breakdown()
    names = [n for n in script.VARIANTS if n.startswith("fwd_")]
    assert {"fwd_no_s_mma", "fwd_no_pv_mma", "fwd_no_fetch"} <= set(names)
    for name in names:
        for old, _ in script.VARIANTS[name]:
            assert SOURCE.count(old) == 1, f"{name}: {old!r}"
            if name != "fwd_rows_32":  # the tile rule is the launcher's
                assert old in FW, f"{name}: {old!r} is not in namespace fw"
        assert script.variant_source(SOURCE, script.VARIANTS[name]) != SOURCE, name


def test_forward_layout_reads_its_kernels_ptxas_report(monkeypatch):
    """fa.fwd_layout: the tile rule's rows, the key groups, and the registers
    and spills of fw::fwd_kernel<P, RG> from nvcc's -Xptxas -v lines (the
    entry names as nvcc mangles them for sm_90a)."""
    from zerovox_tpu_torch.ops import _cuda
    from zerovox_tpu_torch.ops import flash_attention as fa

    lines = []
    for kind, rg, regs, spill in (("3F32", 4, 237, 0), ("3F32", 1, 203, 8), ("4BF16", 4, 224, 0),
                                  ("4BF16", 1, 156, 0)):
        name = f"_ZN2zv2fa2fw10fwd_kernelINS0_{kind}ELi{rg}EEEvNS0_4ArgsE"
        lines += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 16 barriers, 560 bytes cmem[0]"]
    monkeypatch.setitem(_cuda.build_info, "ptxas", {"flash_attn": lines})
    monkeypatch.setattr(fa, "fwd_tile", lambda B, h, L: 64 if B * h * L >= 8448 else 16)
    assert fa.fwd_layout(24, 2, 512) == {"tile_rows": 64, "key_groups": 1, "registers": 237,
                                         "spill_bytes": 0}
    assert fa.fwd_layout(1, 2, 1024) == {"tile_rows": 16, "key_groups": 4, "registers": 203,
                                         "spill_bytes": 16}
    assert fa.fwd_layout(1, 2, 1024, torch.bfloat16)["registers"] == 156
    monkeypatch.setitem(_cuda.build_info, "ptxas", {})  # a library from the build cache
    assert fa.fwd_layout(24, 2, 512)["registers"] is None
