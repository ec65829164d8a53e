"""The arithmetic of K5's bf16 cluster kernels (`cl::fwd_kernel<BF16, RG>`,
`cl::dkv_bf16_kernel`, `cl::dq_bf16_kernel` in `csrc/flash_attn.cu`), which
run a bf16 head dim above 272 up to CLUSTER_REACH[bf16] = 1408 on the card,
emulated on the CPU.

A cluster splits the head dim into parts (`ops.flash_attention.cluster_parts`
with the dtype and the kernel: the forward's parts of at most 264 columns,
the backward's of at most 176). Each rank computes its partial S (and dP)
in float32 from bf16 values over its part; the partials are summed in rank
order, so every rank holds the same S, P and dS; each rank then accumulates
its own columns of the output.
  * The forward: fw's bf16 block at the part. Its warp pairs split the
    part's k-steps of 16 columns in halves, summed within each rank (half 0
    + half 1), then the ranks in order; the online softmax in the log2
    domain over key tiles of BK = 64 keys (KQ key groups of KW keys, merged
    by their row max); P rounded to bf16 as it is packed for P.V, the row
    sums from the float32 P; o rounded to bf16 once.
  * dK/dV and dQ: wg's bf16 block at the part. S^T = K Q^T and dP^T = V dO^T
    (dK/dV), S = Q K^T and dP = dO V^T (dQ), each rank's over its part in
    k-steps of 16 columns, summed in rank order (a reduce-scatter: each
    element's sum made by one rank, in rank order, and read by the others,
    so every rank holds the same sum); P in the log2 domain, dS =
    P (dP - D) scale rounded to bf16 (P^T too, for dV); dV += P^T dO, dK +=
    dS^T Q, dQ += dS K on the rank's columns, one streamed tile of BS = 64
    rows at a time.

Bounds: one bf16 step of the largest value (forward) and two (backward)
against the JAX library kernel's bf16 forward and VJP in interpret mode on
the same bf16 inputs, at d = 528 (forward 264 + 264, backward 176 x 3) and
d = 520 (264 + 256 with a zero tail in rank 0's last k-step; 176 + 176 +
168), B = 1, h = 1, L = 256. Every rank's lse is bitwise rank 0's. The source
is read for what the emulation follows.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_attention import _attention_inputs, _jax_attention, bf16_step
from test_torch_flash_bwd_emulation import BS, bf16, p_ds_bf16, s_bf16
from test_torch_flash_fwd_emulation import FW, SMEM_MAX
from zerovox_tpu_torch.ops import flash_attention as fa

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "zerovox_tpu_torch" / "csrc" / "flash_attn.cu").read_text()
CL = SOURCE[SOURCE.index("namespace cl {"):SOURCE.index("}  // namespace cl")]
CLB = CL[CL.index("// ---- the bf16 backward on clusters"):]  # cl's bf16 backward
KS = 16  # k of mma.sync.m16n8k16 and of a bf16 wgmma
LOG2E = np.float32(1.4426950408889634)
# (d, valid length, the forward's query rows a block): d = 528 in the
# training layout (64 rows, one key group), d = 520 in the serving one (16
# rows, four key groups)
CASES = [(528, 203, 64), (520, 177, 16)]


def tile16(rg: int) -> dict:
    """fw::Tile<BF16, RG>'s KQ, BQ, BK, KW, NS, evaluated from the source."""
    body = FW[FW.index("struct Tile {"):]
    body = body[:body.index("};")]
    env = {"RG": rg, "imax": max, "PAIRS": 4}
    out = {}
    for name in ("KQ", "BQ", "BK", "KW", "NS"):
        expr = re.search(rf"static constexpr int {name} = ([^;]+);", body).group(1)
        expr = expr.replace("P::KS", str(KS)).replace("/", "//")
        out[name] = env[name] = int(eval(expr, {"__builtins__": {}}, env))
    return out


def _parts(d, kernel):
    """Each rank's (first column, width) of the bf16 `kernel`."""
    parts = fa.cluster_parts(d, torch.bfloat16, kernel)
    return list(zip(np.cumsum([0] + parts[:-1]).tolist(), parts))


def _mm(x, y):
    """X Y^T in float32 over the columns given (bf16 values: exact products)"""
    return x @ y.transpose(-1, -2)


def emulate_cluster_fwd_bf16(q, k, v, seg, scale, rg):
    """(o, the lse of every rank) of cl::fwd_kernel<BF16, rg> for [B, h, L,
    d] float32 tensors holding bf16 values."""
    t = tile16(rg)
    KQ, BK, KW = t["KQ"], t["BK"], t["KW"]
    B, h, L, d = q.shape
    parts = _parts(d, "fwd")
    n = len(parts)
    same = seg[:, None, :, None] == seg[:, None, None, :]
    mask = torch.where(same, 0.0, fa.MASK_VALUE).float()
    sl2 = float(np.float32(scale) * LOG2E)
    m = torch.full((n, KQ, B, h, L), -math.inf)
    l = torch.zeros(n, KQ, B, h, L)
    acc = [torch.zeros(KQ, B, h, L, pd) for _, pd in parts]
    for k0 in range(0, L, BK):
        for g in range(KQ):
            keys = slice(k0 + g * KW, k0 + (g + 1) * KW)
            partial = []
            for c0, pd in parts:  # each rank's two halves of its k-steps
                half = 16 * ((-(-pd // KS) + 1) // 2)
                x, y = q[..., c0:c0 + pd], k[:, :, keys, c0:c0 + pd]
                partial.append(_mm(x[..., :half], y[..., :half]) + _mm(x[..., half:], y[..., half:]))
            for me, (c0, pd) in enumerate(parts):
                s = partial[0]
                for r in range(1, n):  # in rank order
                    s = s + partial[r]
                x = (s.double() * sl2 + mask[:, :, :, keys].double()).float()  # fmaf
                mx = torch.maximum(m[me, g], x.amax(-1))
                alpha = torch.exp2(m[me, g] - mx)
                p = torch.exp2(x - mx[..., None])
                l[me, g] = l[me, g] * alpha + p.sum(-1)
                m[me, g] = mx
                acc[me][g] = acc[me][g] * alpha[..., None] + bf16(p) @ v[:, :, keys, c0:c0 + pd]
    o = torch.zeros(B, h, L, d)
    lses = []
    for me, (c0, pd) in enumerate(parts):  # the key groups merged by their row max
        mt = m[me].amax(0)
        f = torch.exp2(m[me] - mt)
        lt, om = f[0] * l[me, 0], f[0][..., None] * acc[me][0]
        for g in range(1, KQ):
            lt = lt + f[g] * l[me, g]
            om = om + f[g][..., None] * acc[me][g]
        o[..., c0:c0 + pd] = bf16(om * (1.0 / lt)[..., None])
        lses.append(mt * np.float32(math.log(2.0)) + torch.log(lt))
    return o, lses


def _summed(x, y, parts):
    """X Y^T as the cluster sums it: each rank's S wgmma loop over its part
    (k-steps of 16 columns, the zero pad completing the last), the partials
    added in rank order."""
    out = None
    for c0, pd in parts:
        part = s_bf16(x[..., c0:c0 + pd], y[..., c0:c0 + pd])
        out = part if out is None else out + part
    return out


def emulate_cluster_bwd_bf16(q, k, v, do, seg, scale):
    """(dq, dk, dv) of cl::dkv_bf16_kernel and cl::dq_bf16_kernel for [B, h,
    L, d] float32 tensors holding bf16 values: lse and o as the forward
    gives them, D in float32 as the wrapper computes it."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * np.float32(scale)
    same = seg[:, None, :, None] == seg[:, None, None, :]
    lse = torch.logsumexp(s + torch.where(same, 0.0, fa.MASK_VALUE), dim=-1)
    o = bf16(fa.flash_attention_plain(*(x.bfloat16() for x in (q, k, v)), seg, scale))
    dsum = (do * o).sum(-1)
    parts = _parts(q.shape[-1], "dkv")
    assert parts == _parts(q.shape[-1], "dq")
    dk, dv, dq = torch.zeros_like(k), torch.zeros_like(v), torch.zeros_like(q)
    for j in range(0, q.shape[2], BS):  # dK/dV: every key tile over query tile j
        qs = slice(j, j + BS)
        pt, dst = p_ds_bf16(_summed(k, q[:, :, qs], parts), _summed(v, do[:, :, qs], parts),
                            same[:, :, qs].transpose(-1, -2), lse[:, :, None, qs],
                            dsum[:, :, None, qs], scale)
        for c0, pd in parts:  # each rank's columns
            cols = slice(c0, c0 + pd)
            dv[..., cols] = dv[..., cols] + bf16(pt) @ do[:, :, qs, cols]
            dk[..., cols] = dk[..., cols] + dst @ q[:, :, qs, cols]
    for j in range(0, q.shape[2], BS):  # dQ: every query tile over key tile j
        ks = slice(j, j + BS)
        _, ds = p_ds_bf16(_summed(q, k[:, :, ks], parts), _summed(do, v[:, :, ks], parts),
                          same[:, :, :, ks], lse[..., None], dsum[..., None], scale)
        for c0, pd in parts:
            cols = slice(c0, c0 + pd)
            dq[..., cols] = dq[..., cols] + ds @ k[:, :, ks, cols]
    return bf16(dq), bf16(dk), bf16(dv)


@pytest.fixture(scope="module", params=CASES, ids=[f"d{c[0]}" for c in CASES])
def case(request):
    """bf16 inputs at [1, 1, 256, d] (as float32 tensors) and the JAX library
    kernel's bf16 o, dq, dk, dv on them (interpret mode)."""
    d, valid, rows = request.param
    q, k, v, seg, do = _attention_inputs(d + 24, 1, 1, 256, d, (valid,))
    xs = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    scale = 1.0 / np.sqrt(d)
    want = _jax_attention(xs[0], xs[1], xs[2], seg, scale, xs[3])
    ts = [torch.from_numpy(np.asarray(x, np.float32)) for x in xs]
    return {"d": d, "rows": rows, "inputs": (*ts, torch.from_numpy(seg), scale), "jax": want}


def _held(name, got, want, steps):
    err, step = np.abs(got.numpy() - want).max(), bf16_step(want)
    assert err <= steps * step, f"{name}: {err} against {steps} step(s) of {step}"


def test_bf16_cluster_forward_emulation_matches_the_library_kernel(case):
    """o of emulate_cluster_fwd_bf16 in the case's layout within one bf16
    step of the library kernel's; every rank's lse bitwise rank 0's, and
    within 1e-5 x its largest value of the float64 log-sum-exp."""
    q, k, v, _, seg, scale = case["inputs"]
    o, lses = emulate_cluster_fwd_bf16(q, k, v, seg, scale, rg=case["rows"] // 16)
    assert len(lses) == len(fa.cluster_parts(case["d"], torch.bfloat16)) == 2
    assert all(torch.equal(x, lses[0]) for x in lses[1:])
    _held("o", o, case["jax"][0], 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * scale
    same = seg[:, None, :, None] == seg[:, None, None, :]
    want_lse = torch.logsumexp(s + torch.where(same, 0.0, fa.MASK_VALUE).double(), dim=-1)
    assert (lses[0].double() - want_lse).abs().max() <= 1e-5 * want_lse.abs().max()


def test_bf16_cluster_backward_emulation_matches_the_library_kernel(case):
    """dq, dk, dv of emulate_cluster_bwd_bf16 within two bf16 steps of the
    library kernel's bf16 VJP; three ranks of the backward at both widths."""
    q, k, v, do, seg, scale = case["inputs"]
    assert len(fa.cluster_parts(case["d"], torch.bfloat16, "dkv")) == 3
    got = emulate_cluster_bwd_bf16(q, k, v, do, seg, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, case["jax"][1:]):
        _held(name, g, w, 2)


def test_bf16_cluster_parts_and_reach():
    """cluster_parts under the bf16 rule follows cl::Part at the forward's
    and the backward's widest parts, up to the bf16 reach."""
    bf = torch.bfloat16
    assert fa.CLUSTER_REACH == {torch.float32: 2112, bf: 1408} and fa.CLUSTER_PART_BF16 == 176
    assert fa.cluster_parts(528, bf) == [264, 264]
    assert fa.cluster_parts(528, bf, "dkv") == fa.cluster_parts(528, bf, "dq") == [176] * 3
    assert fa.cluster_parts(520, bf, "dkv") == [176, 176, 168]
    assert fa.cluster_parts(280, bf, "dq") == [144, 136]
    assert fa.cluster_parts(1408, bf, "dkv") == [176] * 8 and fa.cluster_parts(1416, bf) is None
    for d in range(280, 1416, 8):
        for kernel, part in (("fwd", 264), ("dkv", 176), ("dq", 176)):
            nt = d // 8
            n = (nt + part // 8 - 1) // (part // 8)
            q, m = divmod(nt, n)
            got = [8 * (q + (r < m)) for r in range(n)]
            assert got == fa.cluster_parts(d, bf, kernel), (d, kernel)
            assert all(pd <= part for pd in got) and n <= fa.CLUSTER_MAX
    path = fa.head_dim_path(528, bf)
    assert path["path"] == "cluster" and (path["ranks"], path["bwd_ranks"]) == (2, 3)
    assert path["bwd_parts"] == [176] * 3 and all(x == 1.0 for x in path["recompute"].values())
    assert fa.head_dim_path(1416, bf)["path"] == "wide" == fa.head_dim_path(2184, bf)["path"]


def _smem_bwd_bf16(dkv: bool) -> int:
    """cl::SmemB's bytes as the source carves it: wg's resident tiles,
    streamed buffers, P handover and step vectors at PART_BF16 columns,
    then two exchange buffers of both warpgroups' 64 x 64 float32 partials."""
    def take(n):
        return (n + 15) // 16 * 16

    part, br, bs = fa.CLUSTER_PART_BF16, 64, BS
    tile = br * part * 2  # a resident tile, and a streamed one (bs = br rows)
    xp = 4 * 32 * 32 * 4
    vectors = (2 * take(2 * bs * 4) if dkv else 0) + take(2 * bs * 4) + take(16)
    xch = 2 * 2 * 32 * 128 * 4
    return 2 * take(tile) + 2 * take(2 * tile) + take(xp) + vectors + take(xch)


def test_the_source_holds_what_the_bf16_cluster_emulation_follows():
    """Namespace cl's bf16 kernels: fw's bf16 block at the forward's part,
    wg's at the backward's, the partials summed in rank order through
    distributed shared memory (two exchange buffers by step parity), no
    atomics, no recomputation; the launcher's rule on d, the dtype and the
    kernel; shared memory that fits at the widest parts."""
    for line in ("template <class P, int RG>\n__global__ void __launch_bounds__(THREADS, 1) "
                 "fwd_kernel(Args a) {",
                 "else fw::s_part<NS>(s, Qs + rg * 16 * ldq, Kt, ldq, kb, ke, lane);",
                 "const int nk = (pd + 15) / 16, kh = (nk + 1) / 2, np = (nt + 1) / 2, "
                 "ph = (np + 1) / 2;",
                 "*reinterpret_cast<uint4*>(row + pd) = make_uint4(0u, 0u, 0u, 0u);",
                 "P::store2(out + nn * 8, acc[i][0] * inv0, acc[i][1] * inv0);",
                 "sum_ranks<NS>(s, slot, n, lane);"):
        assert line in CL, line
    assert "\nconstexpr int PART_BF16 = 176;" in CL
    assert "\nconstexpr int REACH_BF16 = CLUSTER_MAX * PART_BF16;" in CL
    for line in ("for (int kk = 0; kk < nk; ++kk) wg::mma_s(s, wg::desc_k(xs, kk), wg::desc_ks(ys, kk), kk);",
                 "sum_partials(s, slot + (j & 1) * XCH16, n, rank);  // S^T (dP^T) over the whole "
                 "head dim",
                 "sum_partials(s, slot + (j & 1) * XCH16, n, rank);  // S (dP) over the whole head dim",
                 # the reduce-scatter: rank r sums pieces c % n == r in rank order, its own
                 # from registers; then every other piece from the rank that summed it
                 "if (c % n != rank) continue;",
                 "const float4 p = r == rank ? x : ld_rank(slot + c * 512, r);",
                 "acc = r ? make_float4(acc.x + p.x, acc.y + p.y, acc.z + p.z, acc.w + p.w) : p;",
                 "*reinterpret_cast<float4*>(slot + c * 512) = acc;",
                 "const float4 p = ld_rank(slot + c * 512, c % n);",
                 "exp2f(fmaf(s[4 * c + e], sl2, -(lq * wg::LOG2E)))",
                 "s[4 * c + e] = xw[(4 * c + e) * 32] * (s[4 * c + e] - ((e & 1) ? d2.y : d2.x)) * a.scale;",
                 "wg::to_a(af, s);", "mma_acc(acc, af[kk], wg::desc_mn(yb, kk, 0));",
                 "mma_acc_ss(acc1, wg::desc_k(dSs, kk), wg::desc_mn(Kt, kk, NQ0 / 16));",
                 "fw::pack_bf16(s[4 * c], s[4 * c + 1]);",
                 "wg::store_cols(out, a.sl, acc, 0, pd, g, t);"):
        assert line in CLB, line
    assert "atomic" not in CL
    # every product of the bf16 backward takes the rank's part only, from base + c0
    assert CLB.count("+ pt.c0;  // this rank's columns") == 2
    assert CLB.count("tma_part(buf(j), pr, ") == 2 and "\"r\"(c0 + 16 * c)" in CLB
    host = SOURCE[SOURCE.index("// ---- host side"):]
    for line in ("if (a.d <= DMAX || (!F && a.d > cl::REACH_BF16)) return 0;",
                 "const int n = cl::ranks(a.d, F || forward ? cl::PART_MAX : cl::PART_BF16);",
                 "return n <= cl::CLUSTER_MAX ? n : 0;",
                 "launch_cluster(cl::dkv_bf16_kernel, wg::BR, n, cl::SmemB(true).bytes, a, p,",
                 "launch_cluster(cl::dq_bf16_kernel, wg::BR, n, cl::SmemB(false).bytes, a, p,",
                 "if (const int n = cluster_ranks<P>(a, true)) {"):
        assert line in host, line
    # the bf16 forward: fw<BF16, 4>'s layout at a part of 264 and a slot a pair
    t = tile16(4)
    ld = 264 + 8 + 8  # round_up(264, 16) + 8
    fwd = 2 * (t["BQ"] * ld + 4 * t["BK"] * ld) + 4 * 8 * t["NS"] * 128 \
        + 4 * (t["BQ"] + 2 * t["BK"]) + 4 * 4 * t["NS"] * 128
    assert fwd == 229_120 <= SMEM_MAX
    # the bf16 backward: 176 columns with two exchange buffers fit, 264 do not
    assert _smem_bwd_bf16(True) == 218_640 <= SMEM_MAX and _smem_bwd_bf16(False) <= SMEM_MAX
    assert 6 * 64 * 264 * 2 + 4 * 32 * 32 * 4 + 2 * 32 * 128 * 4 > SMEM_MAX
