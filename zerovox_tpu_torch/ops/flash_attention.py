"""Flash attention: kernel K5, forward, dK/dV and dQ.

`flash_attention(q, k, v, segment_ids, sm_scale)` computes

    o = softmax(sm_scale * q k^T + mask) v,  mask = 0 where the query's and the
                                             key's segment ids are equal, else
                                             MASK_VALUE

on the layout of the JAX library function it stands for
(`jax.experimental.pallas.ops.tpu.flash_attention`, which the JAX package's
`models/fs2.py` calls under ZEROVOX_ATTN=flash): q, k, v [B, h, L, d],
segment ids [B, L] int32 (or None: no mask), o in q's dtype. Strided views
are taken as they are as long as the head dim is contiguous, so the model
passes `q.transpose(1, 2)` of its [B, L, h, d] projections without a copy,
and o (and on the backward dq, dk, dv) comes back with q's strides.

  * On CUDA tensors it launches the hand-written Hopper kernels of
    `csrc/flash_attn.cu` through `FlashAttention`, an autograd Function that
    saves q, k, v, o and the float32 log-sum-exp of each row, and whose
    backward launches the dK/dV kernel and the dQ kernel. They replace the
    library's three TPU kernels (forward, dK/dV, dQ). float32 runs 3xTF32
    tensor-core products, bf16 bf16 ones with float32 accumulation and P (and
    dS) rounded to bf16 before their products, as the library does;
    D = rowsum(dO * O) is a float32 reduction here, as the library computes
    it outside its kernels. Bound by operations on an H100; the design notes
    are in the source.
  * On CPU tensors it runs `flash_attention_plain`, the same function by
    masked softmax with float32 scores, differentiated by autograd.

Every head dim d >= 1 is taken, as the JAX package's flash branch takes
any d_k == d_v. On both devices, before the kernel-or-plain dispatch,
`pad_head_dim` zero-pads q, k and v to the next multiple of 8 where d is not
one (zero q and k lanes add nothing to the scores, zero v lanes are sliced
off o; the gradients go back through the pad and the slice). On the card a
head dim up to TUNED_HEAD_DIM = 272 runs the tuned kernels (namespaces fw,
tf and wg of the source). Above it, a head dim up to CLUSTER_REACH of its
dtype (float32 CLUSTER_MAX x CLUSTER_PART = 2112, bf16 CLUSTER_MAX x
CLUSTER_PART_BF16 = 1408) runs the cluster kernels (namespace cl: a thread
block cluster splits the head dim into parts, `cluster_parts`, and sums
the parts' S and dP through distributed shared memory; the bf16 backward's
parts are narrower than the rest), and one above that the wide kernels
(namespace wd), whose shared memory and registers do not grow with d.
Which runs is a rule on d, the dtype and the kernel (`head_dim_path`),
never a fallback.

There is no fallback: a CUDA tensor the kernels do not take (L not a
multiple of 64, another dtype, k or v shaped or strided unlike q) raises.
"""

from __future__ import annotations

import torch

from zerovox_tpu_torch.ops import _cuda

# the library's DEFAULT_MASK_VALUE: finite, so a row whose first key tile is
# all masked does not produce NaN in an online softmax
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM_MULTIPLE = 8  # the kernels' head dims; flash_attention pads any other
TUNED_HEAD_DIM = 272  # the largest the tuned kernels take; the cluster and wide kernels the rest
# the columns of each output a block of the wide kernels computes (csrc's
# wd::CS_FWD, CS_DKV, CS_DQ): S (and dP) are recomputed once a slice
WIDE_SLICE = {"fwd": 128, "dkv": 64, "dq": 128}
# the cluster kernels (csrc's cl::PART_MAX, cl::PART_BF16, cl::CLUSTER_MAX):
# the widest part of the head dim a block of the forward (and of the float32
# backward) takes, that of the bf16 backward, the most blocks a cluster has;
# the widest head dim of each dtype on clusters (cl::REACH_BF16 for bf16)
CLUSTER_PART = 264
CLUSTER_PART_BF16 = 176
CLUSTER_MAX = 8
CLUSTER_REACH = {torch.float32: CLUSTER_MAX * CLUSTER_PART,
                 torch.bfloat16: CLUSTER_MAX * CLUSTER_PART_BF16}
L_MULTIPLE = 64


def pad_head_dim(*ts):
    """[B, h, L, d] tensors with d zero-padded to the next multiple of
    HEAD_DIM_MULTIPLE (new contiguous tensors, differentiable), or the
    tensors as they are when d is one already."""
    pad = -ts[0].shape[-1] % HEAD_DIM_MULTIPLE
    if not pad:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, pad)).contiguous() for t in ts)


def cluster_parts(d: int, dtype=torch.float32, kernel: str = "fwd") -> list[int] | None:
    """The widths of the parts into which the cluster kernel `kernel`
    ("fwd", "dkv" or "dq") of `dtype` splits a head dim d (a multiple of 8)
    above TUNED_HEAD_DIM, rank 0 first (cl::Part: ceil(d / part) ranks at
    parts of CLUSTER_PART, or CLUSTER_PART_BF16 for the bf16 backward, the
    n-tiles of 8 columns as even as they go, the wider parts first), or None
    above the dtype's CLUSTER_REACH (the wide kernels)."""
    if d > CLUSTER_REACH[dtype]:
        return None
    part = CLUSTER_PART_BF16 if dtype == torch.bfloat16 and kernel != "fwd" else CLUSTER_PART
    nt, per = d // HEAD_DIM_MULTIPLE, part // HEAD_DIM_MULTIPLE
    n = -(-nt // per)
    q, m = divmod(nt, n)
    return [HEAD_DIM_MULTIPLE * (q + (r < m)) for r in range(n)]


def head_dim_path(d: int, dtype=torch.float32) -> dict:
    """Which kernels take head dim d of `dtype` on the card: the padded dim
    and "tuned", "cluster" or "wide". The cluster path gives the forward's
    ranks and parts and the backward's (`bwd_ranks`, `bwd_parts`: dK/dV's
    and dQ's); it computes S and dP once (recompute 1). The wide path gives the
    column slices of each kernel and the work it does over the work of the
    function (S and dP recomputed once a slice): the forward (slices + 1) /
    2, dK/dV (slices + 1) / 2, dQ (2 slices + 1) / 3, the whole backward
    (4 (dkv + 1) + 4 dq + 2) / 10."""
    dp = d + (-d % HEAD_DIM_MULTIPLE)
    if dp <= TUNED_HEAD_DIM:
        return {"head_dim": d, "padded_to": dp, "path": "tuned"}
    parts = cluster_parts(dp, dtype)
    if parts is not None:
        bwd = cluster_parts(dp, dtype, "dkv")
        return {"head_dim": d, "padded_to": dp, "path": "cluster", "ranks": len(parts),
                "parts": parts, "bwd_ranks": len(bwd), "bwd_parts": bwd,
                "recompute": {"fwd": 1.0, "dkv": 1.0, "dq": 1.0, "bwd": 1.0}}
    ns = {k: -(-dp // cs) for k, cs in WIDE_SLICE.items()}
    return {"head_dim": d, "padded_to": dp, "path": "wide", "slices": ns,
            "recompute": {"fwd": (ns["fwd"] + 1) / 2, "dkv": (ns["dkv"] + 1) / 2,
                          "dq": (2 * ns["dq"] + 1) / 3,
                          "bwd": (4 * (ns["dkv"] + 1) + 4 * ns["dq"] + 2) / 10}}


def flash_attention_plain(q, k, v, segment_ids=None, sm_scale: float = 1.0):
    """K5 in plain PyTorch: float32 scores and softmax, P rounded to v's
    dtype before P.V (float32 accumulation), o in q's dtype."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        s = s + torch.where(same, 0.0, MASK_VALUE)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _kind(name: str, q) -> str:
    if q.dtype == torch.float32:
        return "f32"
    if q.dtype == torch.bfloat16:
        return "bf16"
    raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {q.dtype}")


def _check(name: str, q, *others) -> None:
    """Raise unless q and every other [B, h, L, d] tensor are CUDA tensors of
    one dtype, shape and strides the kernels take."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on a CUDA device, got {q.device}")
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, h, L, d], got {tuple(q.shape)}")
    L, d = q.shape[2], q.shape[3]
    if d % HEAD_DIM_MULTIPLE or d < HEAD_DIM_MULTIPLE:
        raise ValueError(f"{name}: head dim {d} is not a multiple of {HEAD_DIM_MULTIPLE} "
                         f"(flash_attention pads it)")
    if L % L_MULTIPLE:
        raise ValueError(f"{name}: sequence length {L} is not a multiple of {L_MULTIPLE}")
    vec = 16 // q.element_size()
    if q.stride(3) != 1 or any(s % vec for s in q.stride()[:3]) or q.data_ptr() % 16:
        raise ValueError(f"{name}: q needs a contiguous head dim, 16-byte strides and base; "
                         f"strides {q.stride()}")
    for t in others:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: all tensors must be {q.dtype} on {q.device}, got "
                             f"{t.dtype} on {t.device}")
        if t.shape != q.shape or t.stride() != q.stride() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be shaped and strided as q "
                             f"({tuple(q.shape)}, {q.stride()}), got {tuple(t.shape)}, "
                             f"{t.stride()}")


def _segments(name: str, segment_ids, q):
    if segment_ids is None:
        return None
    B, L = q.shape[0], q.shape[2]
    if segment_ids.dtype != torch.int32 or tuple(segment_ids.shape) != (B, L) \
            or segment_ids.device != q.device or not segment_ids.is_contiguous():
        raise ValueError(f"{name}: segment ids must be a contiguous int32 [{B}, {L}] tensor on "
                         f"{q.device}, got {segment_ids.dtype} {tuple(segment_ids.shape)}")
    return segment_ids


def _dims(q) -> list[int]:
    B, h, L, d = q.shape
    return [B, h, L, d, *q.stride()[:3]]


def flash_fwd(q, k, v, segment_ids=None, sm_scale: float = 1.0):
    """K5's forward on the card: (o shaped and strided as q, lse [B, h, L]
    float32)."""
    kind = _kind("flash_fwd", q)
    _check("flash_fwd", q, k, v)
    seg = _segments("flash_fwd", segment_ids, q)
    o = torch.empty_like(q)
    lse = q.new_empty(q.shape[:3], dtype=torch.float32)
    err = getattr(_cuda.lib("flash_attn"), f"zv_flash_fwd_{kind}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        None if seg is None else seg.data_ptr(), *_dims(q), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(err, "flash_fwd")
    if kind == "f32":
        flash_fwd.launches += 1
    else:
        flash_fwd.launches_bf16 += 1
    return o, lse


def _bwd_inputs(name, q, k, v, o, lse, do, dsum):
    """do in q's layout and dsum = D = rowsum(dO * O) in float32 (computed
    here, outside the kernels as in the library, unless given), checked
    with lse."""
    if do.stride() != q.stride():
        do = torch.empty_like(q).copy_(do)
    _check(name, q, k, v, o, do)
    if dsum is None:
        dsum = (do.float() * o.float()).sum(-1).contiguous()
    for t in (lse, dsum):
        if t.dtype != torch.float32 or t.shape != q.shape[:3] or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{name}: lse and D must be contiguous float32 {tuple(q.shape[:3])} "
                             f"tensors on {q.device}, got {t.dtype} {tuple(t.shape)}")
    return do, dsum


def flash_bwd_dkv(q, k, v, o, lse, do, segment_ids=None, sm_scale: float = 1.0, dsum=None):
    """K5's dK/dV kernel on the card: (dk, dv), shaped and strided as q;
    dsum is D = rowsum(dO * O), computed here when not given."""
    kind = _kind("flash_bwd_dkv", q)
    do, dsum = _bwd_inputs("flash_bwd_dkv", q, k, v, o, lse, do, dsum)
    seg = _segments("flash_bwd_dkv", segment_ids, q)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    err = getattr(_cuda.lib("flash_attn"), f"zv_flash_dkv_{kind}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
        None if seg is None else seg.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_dims(q),
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(err, "flash_bwd_dkv")
    if kind == "f32":
        flash_bwd_dkv.launches += 1
    else:
        flash_bwd_dkv.launches_bf16 += 1
    return dk, dv


def flash_bwd_dq(q, k, v, o, lse, do, segment_ids=None, sm_scale: float = 1.0, dsum=None):
    """K5's dQ kernel on the card: dq, shaped and strided as q (dsum as in
    flash_bwd_dkv)."""
    kind = _kind("flash_bwd_dq", q)
    do, dsum = _bwd_inputs("flash_bwd_dq", q, k, v, o, lse, do, dsum)
    seg = _segments("flash_bwd_dq", segment_ids, q)
    dq = torch.empty_like(q)
    err = getattr(_cuda.lib("flash_attn"), f"zv_flash_dq_{kind}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
        None if seg is None else seg.data_ptr(), dq.data_ptr(), *_dims(q), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(err, "flash_bwd_dq")
    if kind == "f32":
        flash_bwd_dq.launches += 1
    else:
        flash_bwd_dq.launches_bf16 += 1
    return dq


def flash_bwd(q, k, v, o, lse, do, segment_ids=None, sm_scale: float = 1.0):
    """Both backward kernels: (dq, dk, dv)."""
    do, dsum = _bwd_inputs("flash_bwd", q, k, v, o, lse, do, None)
    dk, dv = flash_bwd_dkv(q, k, v, o, lse, do, segment_ids, sm_scale, dsum)
    dq = flash_bwd_dq(q, k, v, o, lse, do, segment_ids, sm_scale, dsum)
    return dq, dk, dv


KERNELS = (flash_fwd, flash_bwd_dkv, flash_bwd_dq)
for _f in KERNELS:
    _f.launches = _f.launches_bf16 = 0


def fwd_tile(B: int, h: int, L: int) -> int:
    """The query rows a block of the forward takes at these sizes on the
    current card: 16 x its row groups."""
    return _cuda.lib("flash_attn").zv_flash_fwd_tile(B, h, L)


FWD_PAIRS = 4  # warp pairs a forward block (fw::PAIRS): row groups x key groups


def fwd_layout(B: int, h: int, L: int, dtype=torch.float32) -> dict:
    """The forward's layout at these sizes on the current card: its query
    rows a block, the key groups each row group's keys are split between,
    and the registers and spill bytes of that kernel (`fw::fwd_kernel<P,
    RG>`) as ptxas reported them when this process built the library (None
    when it came from the build cache)."""
    rows = fwd_tile(B, h, L)
    rg = rows // 16
    ptxas = _cuda.build_info.get("ptxas", {}).get("flash_attn")
    kind = "3F32" if dtype == torch.float32 else "4BF16"
    found = [v for k, v in _cuda.ptxas_kernels(ptxas or []).items()
             if "2fw10fwd_kernel" in k and f"{kind}ELi{rg}E" in k]
    res = found[0] if len(found) == 1 else {}
    return {"tile_rows": rows, "key_groups": FWD_PAIRS // rg,
            "registers": res.get("registers"),
            "spill_bytes": (res["spill_stores"] + res["spill_loads"]) if res else None}


def _registers(*parts: str) -> dict:
    """The registers and spill bytes of the one kernel whose mangled name
    holds every part, as ptxas reported them when this process built the
    library (values None when it came from the build cache)."""
    ptxas = _cuda.ptxas_kernels(_cuda.build_info.get("ptxas", {}).get("flash_attn") or [])
    found = [v for k, v in ptxas.items() if all(p in k for p in parts)]
    r = found[0] if len(found) == 1 else {}
    return {"registers": r.get("registers"),
            "spill_bytes": (r["spill_stores"] + r["spill_loads"]) if r else None}


def wide_registers() -> dict:
    """_registers of the wide kernels (`wd::fwd_kernel`, `wd::dkv_kernel`,
    `wd::dq_kernel`): {"fwd_f32": {...}, "fwd_bf16": {...}, ...}."""
    return {f"{part}_{kind}": _registers(name, tag)
            for part, name in (("fwd", "2wd10fwd_kernel"), ("dkv", "2wd10dkv_kernel"),
                               ("dq", "2wd9dq_kernel"))
            for kind, tag in (("f32", "3F32"), ("bf16", "4BF16"))}


def cluster_registers(rows: int, dtype=torch.float32) -> dict:
    """_registers of the cluster kernels of `dtype`: `cl::fwd_kernel<P, RG>`
    at `rows` = 16 RG query rows a block, and the backward's (float32
    `cl::dkv_kernel`, `cl::dq_kernel`; bf16 `cl::dkv_bf16_kernel`,
    `cl::dq_bf16_kernel`): {"fwd": {...}, "dkv": {...}, "dq": {...}}."""
    if dtype == torch.float32:
        return {"fwd": _registers("2cl10fwd_kernel", f"3F32ELi{rows // 16}E"),
                "dkv": _registers("2cl10dkv_kernel"), "dq": _registers("2cl9dq_kernel")}
    return {"fwd": _registers("2cl10fwd_kernel", f"4BF16ELi{rows // 16}E"),
            "dkv": _registers("2cl15dkv_bf16_kernel"), "dq": _registers("2cl14dq_bf16_kernel")}


def bwd_bf16_registers() -> dict:
    """_registers of the bf16 backward's kernels (`wg::dkv_kernel`,
    `wg::dq_kernel`): {"dkv": {...}, "dq": {...}}."""
    return {"dkv": _registers("2wg10dkv_kernel"), "dq": _registers("2wg9dq_kernel")}


class FlashAttention(torch.autograd.Function):
    """K5 with its backward; CUDA tensors only."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, sm_scale: float):
        o, lse = flash_fwd(q, k, v, segment_ids, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, seg, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, segment_ids=None, sm_scale: float = 1.0):
    """K5; see the module docstring. The head dim is padded by
    `pad_head_dim` on both devices; CPU tensors then run
    `flash_attention_plain` under autograd."""
    d, like = q.shape[-1], q
    q, k, v = pad_head_dim(q, k, v)
    if q.device.type == "cpu":
        o = flash_attention_plain(q, k, v, segment_ids, sm_scale)
    else:
        if not (q.stride() == k.stride() == v.stride() and q.stride(-1) == 1):
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if segment_ids is not None:
            segment_ids = segment_ids.contiguous()
        o = FlashAttention.apply(q, k, v, segment_ids, sm_scale)
    if o.shape[-1] == d:
        return o
    # o in q's strides, as an unpadded call returns it: the model's reshape of
    # o.transpose(1, 2) is then a view
    return torch.empty_like(like).copy_(o[..., :d])
