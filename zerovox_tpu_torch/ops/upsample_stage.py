"""Fused HiFi-GAN upsample stage: kernel K2.

One whole vocoder stage — leaky_relu(0.1) -> ConvTranspose1d (stride s,
padding p) -> MRF mean of ResBlock1 towers — and on the last stage also
leaky_relu(0.01) -> conv_post (C_out -> 1, k=7) -> tanh. `fused_upsample_stage`
computes it in one pass over x [B, T_in, C_in]:

  * on a CUDA tensor it launches the hand-written Hopper kernel
    `csrc/upsample_stage.cu`, which replaces the TPU kernel
    `zerovox_tpu/ops/pallas/packed.py::fused_packed_stage`. On an H100 the
    stage is bound by arithmetic; the kernel runs the transposed conv as a
    polyphase GEMM and every conv on the tensor cores (3xTF32 on float32,
    bf16 tensor-core products on bf16), recomputes
    the upsampler per tower inside a time tile instead of writing the
    upsampled activation, and writes only the stage output (design notes in
    the source and in `csrc/mrf_tc.cuh`);
  * on a CPU tensor it runs `upsample_stage_plain`, the same function in
    plain PyTorch.

Float32 or bf16 (bf16 inference): on bf16 x and weights every intermediate
stays float32 and the stage's output (or waveform) is rounded to bf16 once,
as the TPU kernel does; the bf16 kernel feeds each activation to bf16 MMAs
as two bf16 terms, within one bf16 step of the plain version (as
`ops.mrf.fused_mrf`'s); bf16 launches are counted apart
(`fused_upsample_stage.launches_bf16`).

The weights come packed once per weight version (`pack_upsampler`,
`ops.mrf.pack_towers`). The kernel is built for (C_in, C_out) of (128, 64),
(64, 32), (32, 16) and (16, 8) (`KERNEL_WIDTHS`); a stage of other widths
within them runs zero-padded to the narrowest pair that holds it, as the
TPU kernel pads to its 128 lanes (the packers pad the weights once, the
wrapper pads x and conv_post's taps per call and cuts the output back).
There is no fallback: a CUDA tensor the kernel does
not take raises, and so does a tensor that requires grad while grad is
enabled (the kernel has no backward), on either device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from zerovox_tpu_torch.ops import _cuda
from zerovox_tpu_torch.ops.mrf import (LRELU_SLOPE, MrfWeights, check_towers, fragments,
                                       mma_fragments, mma_fragments_bf16, mrf_plain, pad_to,
                                       refuse_grad, tower_args, widen)

# (C_in, C_out) instantiated in the source, narrowest first
KERNEL_WIDTHS = ((16, 8), (32, 16), (64, 32), (128, 64))


def kernel_widths(C_in: int, C_out: int) -> tuple[int, int] | None:
    """The widths K2 runs a (C_in, C_out) stage at: the narrowest
    instantiated pair that holds both (the stage zero-padded up to it);
    None when none does."""
    return next(((a, b) for a, b in KERNEL_WIDTHS if a >= C_in and b >= C_out), None)


class UpsamplerWeights(NamedTuple):
    """A ConvTranspose1d in both layouts (`pack_upsampler`)."""

    w: torch.Tensor  # [k, C_in, C_out]: torch's taps (the weight (in, out, k) permuted, not flipped)
    b: torch.Tensor  # [C_out]
    stride: int
    frag: torch.Tensor | None  # taps grouped by phase, padded to `widths`, m16n8k8 order (not bf16)
    frag_b: torch.Tensor | None = None  # b padded to widths[1]
    widths: tuple[int, int] | None = None  # kernel_widths(C_in, C_out)
    frag16: torch.Tensor | None = None  # bf16: the same taps in m16n8k16 order (the bf16 K2)


def phase_taps(k: int, stride: int) -> list[int]:
    """The kernel's tap order: phase ph = (t + padding) % stride of an output
    row t takes the taps ph, ph + stride, ...; phases in order."""
    return [ph + stride * j for ph in range(stride) for j in range(max(0, -(-(k - ph) // stride)))]


def pack_upsampler(w, b, stride: int) -> UpsamplerWeights:
    """w [k, C_in, C_out] torch taps, b [C_out] -> both layouts, the
    kernel's padded to `kernel_widths`: m16n8k16 fragments for bf16 taps
    (`frag16`), m16n8k8 ones for others (`frag`); no fragment buffer when no
    kernel width holds the stage."""
    k, ci, co = w.shape
    widths = kernel_widths(ci, co)
    if widths is None:
        return UpsamplerWeights(w, b, stride, None)
    taps = pad_to(w, (k, *widths))[phase_taps(k, stride)]
    if w.dtype == torch.bfloat16:
        return UpsamplerWeights(w, b, stride, None, pad_to(b, (widths[1],)), widths,
                                mma_fragments_bf16(taps))
    return UpsamplerWeights(w, b, stride, mma_fragments(taps), pad_to(b, (widths[1],)), widths)


def upsample_stage_plain(x, up_w, up_b, stride, up_padding, towers, dilations, post=None):
    """Plain PyTorch stage. up_w [k, C_in, C_out] holds torch's taps (the
    weight (in, out, k) permuted, not flipped); post = (w [k, C_out, 1], b [1]).
    On bf16 inputs: computed in float32 on the widened inputs and rounded to
    bf16 once."""
    if x.dtype == torch.bfloat16:
        y = upsample_stage_plain(x.float(), up_w.float(), up_b.float(), stride, up_padding,
                                 widen(towers), dilations,
                                 None if post is None else tuple(t.float() for t in post))
        return y.to(torch.bfloat16)
    y = F.conv_transpose1d(F.leaky_relu(x, LRELU_SLOPE).transpose(1, 2), up_w.permute(1, 2, 0), up_b,
                           stride=stride, padding=up_padding)
    y = mrf_plain(y.transpose(1, 2), towers, dilations)
    if post is None:
        return y
    pw, pb = post
    y = F.conv1d(F.leaky_relu(y, 0.01).transpose(1, 2), pw.permute(2, 1, 0), pb,
                 padding=(pw.shape[0] - 1) // 2)
    return torch.tanh(y)[:, 0, :]


def fused_upsample_stage(x, up: UpsamplerWeights, up_padding, mrf: MrfWeights, dilations,
                         kernel_sizes, post=None):
    """x [B, T_in, C_in] -> [B, T_out, C_out], or the waveform [B, T_out]
    when post = (w [k, C_out, 1], b [1]) is given. T_out = (T_in - 1) *
    stride + k - 2 * up_padding. up: `pack_upsampler` of the transposed
    conv; mrf, dilations, kernel_sizes: the towers as in ops.mrf.fused_mrf."""
    refuse_grad("fused_upsample_stage", x, up.w, up.b, up.frag, up.frag16, mrf.w, mrf.w16, mrf.b,
                *[t for tw in mrf.towers for t in tw], *(post or ()))
    if x.device.type == "cpu":
        return upsample_stage_plain(x, up.w, up.b, up.stride, up_padding, mrf.towers, dilations,
                                    post)
    B, T_in, C_in = x.shape
    up_k, _, C_out = up.w.shape
    widths = kernel_widths(C_in, C_out)
    if widths is None:
        raise ValueError(f"fused_upsample_stage: the kernel takes (C_in, C_out) within "
                         f"{KERNEL_WIDTHS[-1]}, got {(C_in, C_out)}")
    if tuple(up.w.shape) != (up_k, C_in, C_out) or tuple(up.b.shape) != (C_out,):
        raise ValueError("fused_upsample_stage: upsampler weight must be [k, C_in, C_out]")
    if up.widths != widths:
        raise ValueError(f"fused_upsample_stage: upsampler packed at {up.widths}, not {widths}")
    Ci, Co = widths
    T_out = (T_in - 1) * up.stride + up_k - 2 * up_padding
    args = tower_args(mrf.towers, dilations, kernel_sizes)
    check_towers("fused_upsample_stage", mrf, kernel_sizes, len(dilations), C_out, Co)
    if post is not None:
        pw, pb = post
        post_k = pw.shape[0]
        if tuple(pw.shape) != (post_k, C_out, 1) or post_k % 2 == 0:
            raise ValueError("fused_upsample_stage: post weight must be [odd k, C_out, 1]")
        pw = pad_to(pw.reshape(post_k, C_out), (post_k, Co))
        out = torch.empty(B, T_out, device=x.device, dtype=x.dtype)
    else:
        pw = pb = up.frag_b  # ignored by the kernel
        post_k = 0
        out = torch.empty(B, T_out, Co, device=x.device, dtype=x.dtype)
    dtype = _cuda.float_kind("fused_upsample_stage", x)
    xk = pad_to(x, (*x.shape[:-1], Ci))
    up_frag = fragments("fused_upsample_stage", dtype, up.frag, up.frag16)
    w = fragments("fused_upsample_stage", dtype, mrf.w, mrf.w16)
    _cuda.require_cuda("fused_upsample_stage", x.device, dtype, xk, up_frag, up.frag_b, w, mrf.b,
                       pw, pb)
    lib = _cuda.lib("upsample_stage")
    rest = (mrf.b.data_ptr(), pw.data_ptr(), pb.data_ptr(), B, T_in, Ci, Co, up_k, up.stride,
            up_padding, post_k, *args, torch.cuda.current_stream(x.device).cuda_stream)
    if dtype == torch.bfloat16:
        # the towers' float32 sums, without post (with it they stay in shared memory)
        sums = (torch.empty(B, T_out, Co, device=x.device)
                if post is None and len(mrf.towers) > 1 else None)
        err = lib.zv_upsample_stage_bf16(xk.data_ptr(), out.data_ptr(),
                                         None if sums is None else sums.data_ptr(),
                                         up_frag.data_ptr(), up.frag_b.data_ptr(), w.data_ptr(),
                                         *rest)
        _cuda.check(err, "fused_upsample_stage")
        fused_upsample_stage.launches_bf16 += 1
    else:
        err = lib.zv_upsample_stage_f32(xk.data_ptr(), out.data_ptr(), up_frag.data_ptr(),
                                        up.frag_b.data_ptr(), w.data_ptr(), *rest)
        _cuda.check(err, "fused_upsample_stage")
        fused_upsample_stage.launches += 1
    fused_upsample_stage.launches_at[widths] = fused_upsample_stage.launches_at.get(widths, 0) + 1
    return out if post is not None or Co == C_out else out[..., :C_out].contiguous()


fused_upsample_stage.launches = fused_upsample_stage.launches_bf16 = 0
fused_upsample_stage.launches_at = {}  # launches (both dtypes) by the (C_in, C_out) run at
