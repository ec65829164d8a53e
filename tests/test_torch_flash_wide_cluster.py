"""The arithmetic of K5's float32 cluster kernels (`cl::fwd_kernel`,
`cl::dkv_kernel`, `cl::dq_kernel` in `csrc/flash_attn.cu`), which run a
float32 head dim above 272 on the card, emulated on the CPU.

A cluster of n = ceil(d / 264) blocks splits the head dim into parts
(`ops.flash_attention.cluster_parts`: d's n-tiles of 8 columns as even as
they go, the wider parts first). Each block is the tuned float32 kernel's
block at its part, except that its S (and dP) is a partial: the cluster sums
the ranks' partials in rank order through distributed shared memory, and
every rank applies the full sum to its own columns of the output.
  * The forward (emulated by `test_torch_flash_any_dim.emulate_wide_fwd`):
    fw's block, its warp pairs' halves of the part summed within each rank
    (half 0 + half 1), the ranks summed in order; one online softmax; o's
    columns of the rank.
  * dK/dV and dQ: tf's block. S^T = K Q^T and dP^T = V dO^T (dK/dV), S = Q
    K^T and dP = dO V^T (dQ) over each rank's part as s_tile (one k-step of
    8 at a time, the three 3xTF32 terms in their own accumulators, summed
    as hh + (lh + hl)), the ranks' partials summed in rank order; then P =
    exp(S scale + mask - lse) and dS = P (dP - D) scale; dV += P^T dO, dK +=
    dS^T Q and dQ += dS K on the rank's columns, one streamed tile of TB
    rows at a time, each term added to the one accumulator in the order
    lo.hi, hi.lo, hi.hi.
The emulations run each kernel's own order of sums; the rows of a block do
not change a row's arithmetic, so they run every row at once.

Bound: 1e-4 x each output's largest value against the JAX library kernel
(forward and VJP) in interpret mode and against float64 plain, at d = 528
(parts 264 + 264) and d = 280 (144 + 136), L = 256; a single-pass TF32
control must miss it. The source is read for what the emulations follow.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_flash_any_dim import emulate_wide_fwd
from test_torch_flash_attention import _attention_inputs, _jax_attention
from test_torch_flash_bwd_emulation import TB, accumulate, s_half
from test_torch_flash_fwd_emulation import SMEM_MAX, tile
from zerovox_tpu_torch.ops import flash_attention as fa

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "zerovox_tpu_torch" / "csrc" / "flash_attn.cu").read_text()
CL = SOURCE[SOURCE.index("namespace cl {"):SOURCE.index("}  // namespace cl")]
KS = 8  # k of mma.sync.m16n8k8 (TF32)
# (d, valid length, the forward's query rows a block): d = 528 in the
# training layout (64 rows, one key group), d = 280 in the serving one (16
# rows, four key groups)
CASES = [(528, 203, 64), (280, 177, 16)]


def _cl_const(name: str) -> int:
    m = re.search(rf"\nconstexpr int {name} = (\d+);", CL)
    assert m, f"constexpr int {name} is not in namespace cl"
    return int(m.group(1))


def _parts(d):
    """Each rank's (first column, width)."""
    parts = fa.cluster_parts(d)
    return list(zip(np.cumsum([0] + parts[:-1]).tolist(), parts))


def _summed(x, y, d, passes):
    """X Y^T as the cluster sums it: each rank's s_tile over its part, the
    partials added in rank order."""
    out = None
    for c0, pd in _parts(d):
        part = s_half(x[..., c0:c0 + pd], y[..., c0:c0 + pd], 0, pd, passes)
        out = part if out is None else out + part
    return out


def _lse_dsum(q, k, v, do, mask, seg, scale):
    """lse and D as the forward kernel and the wrapper give them (float32)"""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    lse = torch.logsumexp(s + mask, dim=-1)
    o = fa.flash_attention_plain(q, k, v, seg, scale)
    return lse, (do * o).sum(-1)


def emulate_cluster_dkv(q, k, v, do, seg, scale, passes=3):
    """(dk, dv) of cl::dkv_kernel for float32 [B, h, L, d] inputs."""
    same = seg[:, None, :, None] == seg[:, None, None, :]
    mask = torch.where(same, 0.0, fa.MASK_VALUE)
    lse, dsum = _lse_dsum(q, k, v, do, mask, seg, scale)
    d = q.shape[-1]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for j in range(0, q.shape[2], TB):  # every key tile over query tile j
        qs = slice(j, j + TB)
        st = _summed(k, q[:, :, qs], d, passes)  # S^T = K Q^T
        dpt = _summed(v, do[:, :, qs], d, passes)  # dP^T = V dO^T
        pt = torch.exp(st * scale + mask[:, :, qs].transpose(-1, -2) - lse[:, :, None, qs])
        dst = pt * (dpt - dsum[:, :, None, qs]) * scale
        for c0, pd in _parts(d):  # each rank's columns
            cols = slice(c0, c0 + pd)
            dv[..., cols] = accumulate(dv[..., cols], pt, do[:, :, qs, cols], passes)
            dk[..., cols] = accumulate(dk[..., cols], dst, q[:, :, qs, cols], passes)
    return dk, dv


def emulate_cluster_dq(q, k, v, do, seg, scale, passes=3):
    """dq of cl::dq_kernel for float32 [B, h, L, d] inputs."""
    same = seg[:, None, :, None] == seg[:, None, None, :]
    mask = torch.where(same, 0.0, fa.MASK_VALUE)
    lse, dsum = _lse_dsum(q, k, v, do, mask, seg, scale)
    d = q.shape[-1]
    dq = torch.zeros_like(q)
    for j in range(0, q.shape[2], TB):  # every query tile over key tile j
        ks = slice(j, j + TB)
        s = _summed(q, k[:, :, ks], d, passes)  # S = Q K^T
        dp = _summed(do, v[:, :, ks], d, passes)  # dP = dO V^T
        p = torch.exp(s * scale + mask[:, :, :, ks] - lse[..., None])
        ds = p * (dp - dsum[..., None]) * scale
        for c0, pd in _parts(d):
            cols = slice(c0, c0 + pd)
            dq[..., cols] = accumulate(dq[..., cols], ds, k[:, :, ks, cols], passes)
    return dq


@pytest.fixture(scope="module", params=CASES, ids=[f"d{c[0]}" for c in CASES])
def case(request):
    """Inputs at [1, 1, 256, d] and the JAX library kernel's o, dq, dk, dv
    on them (interpret mode), with autograd of float64 plain's."""
    d, valid, rows = request.param
    q, k, v, seg, do = _attention_inputs(d + 23, 1, 1, 256, d, (valid,))
    scale = 1.0 / np.sqrt(d)
    want = _jax_attention(q, k, v, seg, scale, do)
    ts = [torch.from_numpy(x) for x in (q, k, v, do)]
    qd, kd, vd = (x.double().requires_grad_(True) for x in ts[:3])
    seg_t = torch.from_numpy(seg)
    o = fa.flash_attention_plain(qd, kd, vd, seg_t, scale)
    o.backward(ts[3].double())
    plain = (o.detach(), qd.grad, kd.grad, vd.grad)
    return {"d": d, "rows": rows, "inputs": (*ts, seg_t, scale), "jax": want, "plain": plain}


def _held(name, got, jax_want, plain_want):
    bound = 1e-4 * np.abs(jax_want).max()
    np.testing.assert_allclose(got.numpy(), jax_want, rtol=0, atol=bound, err_msg=name)
    err = (got.double() - plain_want).abs().max().item()
    assert err <= 1e-4 * plain_want.abs().max().item(), f"{name}: {err} off float64 plain"
    return bound


def test_cluster_forward_emulation_matches_the_library_kernel(case):
    """o of emulate_wide_fwd in the case's layout; every rank's lse bitwise
    rank 0's; one TF32 pass misses the bound."""
    q, k, v, _, seg, scale = case["inputs"]
    o, lses = emulate_wide_fwd(q, k, v, seg, scale, rg=case["rows"] // 16)
    assert len(lses) == len(fa.cluster_parts(case["d"])) == 2
    assert all(torch.equal(x, lses[0]) for x in lses[1:])
    bound = _held("o", o, case["jax"][0], case["plain"][0])
    o1 = emulate_wide_fwd(q, k, v, seg, scale, rg=case["rows"] // 16, passes=1)[0]
    assert np.abs(o1.numpy() - case["jax"][0]).max() > bound, "one pass held"


def test_cluster_dkv_emulation_matches_the_library_kernel(case):
    q, k, v, do, seg, scale = case["inputs"]
    dk, dv = emulate_cluster_dkv(q, k, v, do, seg, scale)
    bounds = [_held(name, g, case["jax"][i], case["plain"][i])
              for name, g, i in (("dk", dk, 2), ("dv", dv, 3))]
    one = emulate_cluster_dkv(q, k, v, do, seg, scale, passes=1)
    assert any(np.abs(g.numpy() - case["jax"][i]).max() > b
               for g, i, b in zip(one, (2, 3), bounds)), "one pass held"


def test_cluster_dq_emulation_matches_the_library_kernel(case):
    q, k, v, do, seg, scale = case["inputs"]
    dq = emulate_cluster_dq(q, k, v, do, seg, scale)
    bound = _held("dq", dq, case["jax"][1], case["plain"][1])
    one = emulate_cluster_dq(q, k, v, do, seg, scale, passes=1)
    assert np.abs(one.numpy() - case["jax"][1]).max() > bound, "one pass held"


def test_cluster_parts_and_the_wrappers_rule():
    """cluster_parts follows cl::Part and its constants; head_dim_path
    sends float32 above 272 to the clusters up to CLUSTER_MAX ranks, bf16
    above 272 to the clusters up to its reach of 1408 (the backward's parts
    of at most 176 columns), and each beyond its reach to the wide
    kernels."""
    assert (_cl_const("PART_MAX"), _cl_const("PART_BF16"), _cl_const("CLUSTER_MAX")) == \
        (fa.CLUSTER_PART, fa.CLUSTER_PART_BF16, fa.CLUSTER_MAX) == (264, 176, 8)
    assert fa.cluster_parts(528) == [264, 264]
    assert fa.cluster_parts(280) == [144, 136]
    assert fa.cluster_parts(1040) == [264, 264, 256, 256]
    assert fa.cluster_parts(2112) == [264] * 8 and fa.cluster_parts(2120) is None
    for d in range(280, 2120, 8):  # cl::Part, as the source computes it
        nt = d // 8
        n = (nt + 264 // 8 - 1) // (264 // 8)
        q, m = divmod(nt, n)
        got = [(8 * (r * q + min(r, m)), 8 * (q + (r < m))) for r in range(n)]
        assert got == _parts(d), d
        assert all(pd <= 264 and pd % 8 == 0 for _, pd in got)
    assert fa.head_dim_path(528)["path"] == "cluster"
    assert fa.head_dim_path(526)["parts"] == [264, 264]  # padded to 528
    bf = fa.head_dim_path(528, torch.bfloat16)
    assert bf["path"] == "cluster" and (bf["parts"], bf["bwd_parts"]) == ([264, 264], [176] * 3)
    assert fa.head_dim_path(1416, torch.bfloat16)["path"] == "wide"
    assert fa.head_dim_path(1416)["path"] == "cluster"
    assert fa.head_dim_path(2184)["path"] == "wide" and fa.head_dim_path(272)["path"] == "tuned"
    assert all(v == 1.0 for v in fa.head_dim_path(1040)["recompute"].values())


def test_the_source_holds_what_the_cluster_emulation_follows():
    """Namespace cl: each rank's part, fw's and tf's products at the part,
    the exchange summed in rank order (pair halves first), the split
    cluster barrier, rank 0's lse, no atomics, no recomputation; the
    launcher's rule on d; shared memory that fits at the widest part and
    would not at 272, which is why parts stop at 264."""
    for line in ("c0 = 8 * (r * q + (r < m ? r : m));", "pd = 8 * (q + (r < m ? 1 : 0));",
                 "return (d / 8 + part / 8 - 1) / (part / 8);",
                 "for (int r = 0; r < n; ++r) {",
                 "const float4 y = *reinterpret_cast<const float4*>(other + c * 128 + lane * 4);",
                 "s[c][0] += y.x;", "if (dh == 0) put_slot<NS>(slot, s, lane);",
                 "x[c][0] = r ? x[c][0] + p.x : p.x;",
                 "asm volatile(\"mapa.shared::cluster.u32 %0, %1, %2;\"",
                 "ld.shared::cluster.v4.f32",
                 "barrier.cluster.arrive.release.aligned;", "barrier.cluster.wait.acquire.aligned;",
                 "if constexpr (F) fw::s_part<NS>(s, Qs + rg * 16 * ldq, Kt, ldq, kb, ke, g, t);",
                 "sum_ranks<NS>(s, slot, n, lane);",
                 "fw::pv<NS, NTD>(acc, p, Vb + ((j & 1) * BK + kq * KW) * ldv, ldv, n0, ntw, lane, g, t);",
                 "if (j > 0) pv_of(pp, j - 1);  // under the barrier", "pv_of(pp, steps - 1);",
                 "if (rank == 0 && dh == 0 && t == 0) {",
                 "tf::s_tile(s, (is_s ? xs : xd) + rg * 16 * ld, (is_s ? ys : yd) + cg * 16 * ld, ld, pd, g, t);",
                 "sum_ranks<2>(s, slot, n, lane);",
                 "const float p = expf(x - lse[qi]);",
                 "tf::store_frag(pb, r, c, p[nn][e] * (s[nn][e] - dsum[qi]) * scale);",
                 "tf::accumulate(acc, Pt, dOt, ld, nt, warp & 3, 4, lane, g, t);",
                 "tf::accumulate(acc, dSt, Qt, ld, nt, warp & 3, 4, lane, g, t);",
                 "tf::accumulate(acc, dSs, Kt, ld, nt, warp, WARPS, lane, g, t);"):
        assert line in CL, line
    assert "atomic" not in CL
    # every S and dP product takes the part (pd columns) only, from base + c0
    # (the forward, the float32 backward's two kernels, the bf16 backward's two)
    assert CL.count("+ pt.c0;  // this rank's columns") == 5
    assert "no block computes S or dP over a part it does not\n// own" in SOURCE
    host = SOURCE[SOURCE.index("// ---- host side"):]
    assert "const int n = cl::ranks(a.d, F || forward ? cl::PART_MAX : cl::PART_BF16);" in host
    assert "return n <= cl::CLUSTER_MAX ? n : 0;" in host
    assert "cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);" in host
    assert "attr.id = cudaLaunchAttributeClusterDimension;" in host
    # shared memory: fw's forward and tf's backward (plus the exchange) at the widest part
    fwd = tile(4)
    pd = fa.CLUSTER_PART
    ldq = pd + 8 if pd % 16 == 0 else pd  # tf::ld_of
    fwd_bytes = 4 * (fwd["BQ"] * ldq + 2 * fwd["BK"] * ldq + 2 * fwd["BK"] * (pd + 4)
                     + 8 * fwd["NS"] * 128 + 4 * fwd["NS"] * 128)  # + a slot a pair
    assert fwd_bytes + 4 * (fwd["BQ"] + 2 * fwd["BK"]) <= SMEM_MAX

    def bwd_bytes(pd):
        ld = pd + 8 if pd % 16 == 0 else pd
        tile_b = TB * ld * 4
        return 6 * tile_b + 2 * 2 * (TB // 8) * 256 * 4 + 2 * TB * 4 * 4 + 8 * 2 * 128 * 4

    assert "\nconstexpr int XCH_BWD = WARPS * 2 * 128;" in CL  # 8 warps x a 16 x 16 tile
    assert bwd_bytes(pd) <= SMEM_MAX < bwd_bytes(272)
