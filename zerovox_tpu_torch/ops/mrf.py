"""Fused HiFi-GAN multi-receptive-field (MRF) stage: kernel K1.

One vocoder upsample stage averages several ResBlock1 towers (kernel sizes
3/7/11, dilations 1,3,5 each) over the same input. `fused_mrf` computes
that mean in one pass over x [B, T, C]:

  * on a CUDA tensor it launches the hand-written Hopper kernel
    `csrc/mrf.cu`, which replaces the TPU kernel
    `zerovox_tpu/ops/pallas/mrf.py::fused_mrf`. On an H100 the stage is
    bound by arithmetic (252 C^2 FLOP per row at the main path's C=128),
    not by memory; the kernel keeps every tower activation of a time tile
    in shared memory and runs each conv as tensor-core GEMMs, in 3xTF32 on
    float32 (design notes in `csrc/mrf_tc.cuh`) and on bf16 tensor-core
    products on bf16 (`csrc/mrf_bf16.cuh`);
  * on a CPU tensor it runs `mrf_plain`, the same function in plain PyTorch.

Float32 or bf16 (bf16 inference): on bf16 x and weights the kernel (and the
plain version) keeps every intermediate in float32 and rounds the stage's
output to bf16 once, as the TPU kernel does. The bf16 kernel feeds each
activation to bf16 MMAs as two bf16 terms (hi and the rest), so its result
is within one bf16 step of the plain version's, with ~0.2 % of the outputs
rounded the other way (not bitwise the float32 kernel's). The bf16 launches
are counted apart (`fused_mrf.launches_bf16`).

The weights come packed once per weight version (`pack_towers`): the plain
layout for the CPU, and the kernels' MMA fragment order (m16n8k8 for the
float32 kernels, m16n8k16 for the bf16 K1, K2 and K3). The kernel is
built for C of 8, 16, 32, 64 and 128 (`KERNEL_CHANNELS`); a stage of
another width up to 128 runs zero-padded to the next one, as the TPU kernel
pads to its 128 lanes: `pack_towers` pads the weights once, the wrapper
pads x per call and cuts the output back (zero channels stay zero through
every conv, leaky relu and residual). There is no
fallback: a CUDA tensor the kernel does not take raises, and so does a
tensor that requires grad while grad is enabled (the kernels have no
backward), on either device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from zerovox_tpu_torch.ops import _cuda

LRELU_SLOPE = 0.1
KERNEL_CHANNELS = (8, 16, 32, 64, 128)  # the widths K1 and K3 are instantiated for in their sources


def kernel_channels(C: int) -> int | None:
    """The width K1 and K3 run a C-channel stage at: the narrowest
    instantiated width >= C (the stage zero-padded up to it); None past 128."""
    return next((k for k in KERNEL_CHANNELS if k >= C), None)


def pad_to(t, shape):
    """t zero-padded at the end of each dim up to `shape` (t itself when
    it has that shape)."""
    if tuple(t.shape) == tuple(shape):
        return t
    return F.pad(t, [p for n, m in zip(reversed(shape), reversed(t.shape)) for p in (0, n - m)])


def resblock1_ncl(x, convs1, convs2, dilations):
    """One ResBlock1 tower over NCL x [B, C, T]; convs1/convs2 are lists of
    torch-layout (weight (out, in, k), bias) per dilation."""
    for (w1, b1), (w2, b2), d in zip(convs1, convs2, dilations):
        k = w1.shape[-1]
        xt = F.conv1d(F.leaky_relu(x, LRELU_SLOPE), w1, b1, padding=(k * d - d) // 2, dilation=d)
        xt = F.conv1d(F.leaky_relu(xt, LRELU_SLOPE), w2, b2, padding=(k - 1) // 2)
        x = xt + x
    return x


def _torch_convs(w, b):
    """[P, k, Cin, Cout] taps + [P, Cout] -> list of ((out, in, k), bias)."""
    return [(w[p].permute(2, 1, 0), b[p]) for p in range(w.shape[0])]


def widen(towers):
    """Every tensor of the towers as float32."""
    return [tuple(t.float() for t in tw) for tw in towers]


def mrf_plain(x, towers, dilations):
    """Plain PyTorch MRF: mean over towers (w1 [P,k,C,C], b1 [P,C], w2, b2)
    of ResBlock1 over NLC x [B, T, C]. On bf16 x and towers: computed in
    float32 on the widened inputs and rounded to bf16 once (torch's bf16
    conv1d would round every conv output)."""
    if x.dtype == torch.bfloat16:
        return mrf_plain(x.float(), widen(towers), dilations).to(torch.bfloat16)
    xc = x.transpose(1, 2)
    outs = [resblock1_ncl(xc, _torch_convs(w1, b1), _torch_convs(w2, b2), dilations)
            for w1, b1, w2, b2 in towers]
    return (sum(outs) / len(outs)).transpose(1, 2)


def refuse_grad(name, *tensors):
    """Raise when grad is enabled and a tensor requires it: a fused kernel
    has no backward, and its route (the plain version too, on weights packed
    under no_grad) would return a result autograd cannot differentiate."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the fused kernel has no backward; call it under "
                           "torch.no_grad() or inference_mode, or train through the "
                           "nn.Modules (Generator(use_pallas=False))")


def check_towers(name, weights, kernel_sizes, n_pairs, C, width):
    """Raise unless every tower of `weights` (`pack_towers`) is (w1, b1, w2,
    b2) of shapes [P, k, C, C], [P, C], [P, k, C, C], [P, C], and the flat
    buffers hold them all padded to `width` channels: the kernels read the
    buffers by these shapes."""
    for (w1, b1, w2, b2), k in zip(weights.towers, kernel_sizes):
        if (tuple(w1.shape) != (n_pairs, k, C, C) or tuple(w2.shape) != (n_pairs, k, C, C)
                or tuple(b1.shape) != (n_pairs, C) or tuple(b2.shape) != (n_pairs, C)):
            raise ValueError(f"{name}: tower weights {[tuple(t.shape) for t in (w1, b1, w2, b2)]} "
                             f"do not match C={C}, k={k}, {n_pairs} pairs")
    n_w = sum(2 * n_pairs * k * width for k in kernel_sizes)  # [k, C_in] rows of all convs
    buf, c_in = ((weights.w16, -(-width // 16) * 16) if weights.w is None else (weights.w, width))
    if (len(weights.towers) != len(kernel_sizes) or buf is None or weights.width != width
            or buf.numel() != n_w * c_in
            or weights.b.numel() != 2 * n_pairs * width * len(kernel_sizes)):
        raise ValueError(f"{name}: packed buffers do not hold {len(kernel_sizes)} towers of "
                         f"C={C} at width {width}, kernel sizes {tuple(kernel_sizes)}, "
                         f"{n_pairs} pairs")


def fragments(name, dtype, f32, bf16):
    """The fragment buffer the kernel for `dtype` reads: the m16n8k16 one
    (`bf16`) for bf16 x, the m16n8k8 one (`f32`) otherwise; raises when the
    weights were packed from the other dtype, which left it None."""
    buf = bf16 if dtype == torch.bfloat16 else f32
    if buf is None:
        raise TypeError(f"{name}: {dtype} x needs weights packed from {dtype} tensors")
    return buf


def tower_args(towers, dilations, kernel_sizes):
    """(n_towers, k0, k1, k2, n_pairs, d0, d1, d2) for the C interface."""
    if not 1 <= len(towers) <= 3 or not 1 <= len(dilations) <= 3:
        raise ValueError("the fused MRF kernels take 1-3 towers of 1-3 conv pairs")
    if len(kernel_sizes) != len(towers) or any(k % 2 == 0 for k in kernel_sizes):
        raise ValueError(f"need one odd kernel size per tower, got {kernel_sizes}")
    ks = list(kernel_sizes) + [0] * (3 - len(kernel_sizes))
    ds = list(dilations) + [0] * (3 - len(dilations))
    return [len(towers), *ks, len(dilations), *ds]


class MrfWeights(NamedTuple):
    """A stage's ResBlock1 towers in both layouts (`pack_towers`)."""

    towers: list  # (w1 [P, k, C, C], b1 [P, C], w2, b2) per tower, taps (k, in, out)
    w: torch.Tensor | None  # every conv's taps in m16n8k8 fragment order, tower by tower (not bf16)
    b: torch.Tensor  # b1 then b2 of each tower
    width: int | None = None  # the channels w and b are padded to (None: no kernel buffers)
    w16: torch.Tensor | None = None  # bf16 towers: the taps in m16n8k16 order (bf16 K1-K3)


def mma_fragments(w):
    """Conv taps w [..., k, C_in, C_out] (taps (k, in, out)) -> flat, in the
    kernels' B-fragment order of mma.m16n8k8 (csrc/mrf_tc.cuh): for each tap,
    k-step of 8 input channels and block of 8 output channels, lane l of the
    warp holds w[tap][8 ks + l % 4][8 nf + l // 4] and the same at input
    channel + 4, side by side."""
    k, ci, co = w.shape[-3:]
    f = w.reshape(-1, k, ci // 8, 2, 4, co // 8, 8)  # (.., k, ks, half, lane % 4, nf, lane // 4)
    return f.permute(0, 1, 2, 5, 6, 4, 3).reshape(-1)


def mma_fragments_bf16(w):
    """Conv taps w [..., k, C_in, C_out] -> flat, in the bf16 kernels'
    B-fragment order of mma.m16n8k16 (csrc/mrf_bf16.cuh): C_in zero-padded
    to a multiple of 16; for each tap, k-step ks of 16 input channels and
    block nf of 8 output channels, lane l of the warp holds w[tap][16 ks + 2
    (l % 4) + {0, 1}][8 nf + l // 4] and the same at input channel + 8, four
    values side by side."""
    k, ci, co = w.shape[-3:]
    c16 = -(-ci // 16) * 16
    w = pad_to(w, (*w.shape[:-2], c16, co))
    # (.., k, ks, +8, lane % 4, pair, nf, lane // 4)
    f = w.reshape(-1, k, c16 // 16, 2, 4, 2, co // 8, 8)
    return f.permute(0, 1, 2, 6, 7, 4, 3, 5).reshape(-1)


def pack_towers(towers) -> MrfWeights:
    """The towers and the kernels' buffers built from them, zero-padded to
    `kernel_channels(C)`: m16n8k16 fragments for bf16 towers (`w16`),
    m16n8k8 ones for others (`w`); no fragment buffer past C = 128, where no
    kernel takes the stage."""
    width = kernel_channels(towers[0][0].shape[-1])
    if width is None:
        b = torch.cat([t.reshape(-1) for _, b1, _, b2 in towers for t in (b1, b2)])
        return MrfWeights(list(towers), None, b)
    P = towers[0][0].shape[0]
    padded = [pad_to(t, (P, t.shape[1], width, width)) for w1, _, w2, _ in towers for t in (w1, w2)]
    b = torch.cat([pad_to(t, (P, width)).reshape(-1) for _, b1, _, b2 in towers for t in (b1, b2)])
    if b.dtype == torch.bfloat16:
        return MrfWeights(list(towers), None, b, width, torch.cat([mma_fragments_bf16(t)
                                                                   for t in padded]))
    return MrfWeights(list(towers), torch.cat([mma_fragments(t) for t in padded]), b, width)


def fused_mrf(x, weights: MrfWeights, dilations, kernel_sizes):
    """Mean over ResBlock1 towers of x [B, T, C] -> [B, T, C].

    weights: `pack_towers` of the towers, each (w1 [P, k, C, C], b1 [P, C],
    w2 [P, k, C, C], b2 [P, C]) with conv taps (k, in, out); dilations: the
    P first-conv dilations, shared by every tower; kernel_sizes: k of each
    tower."""
    refuse_grad("fused_mrf", x, weights.w, weights.w16, weights.b,
                *[t for tw in weights.towers for t in tw])
    if x.device.type == "cpu":
        return mrf_plain(x, weights.towers, dilations)
    B, T, C = x.shape
    Ck = kernel_channels(C)
    if Ck is None:
        raise ValueError(f"fused_mrf: the kernel takes C <= {KERNEL_CHANNELS[-1]}, got {C}")
    args = tower_args(weights.towers, dilations, kernel_sizes)
    check_towers("fused_mrf", weights, kernel_sizes, len(dilations), C, Ck)
    dtype = _cuda.float_kind("fused_mrf", x)
    xk = pad_to(x, (*x.shape[:-1], Ck))
    w = fragments("fused_mrf", dtype, weights.w, weights.w16)
    _cuda.require_cuda("fused_mrf", x.device, dtype, xk, w, weights.b)
    out = torch.empty_like(xk)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _cuda.lib("mrf")
    if dtype == torch.bfloat16:
        # the towers' float32 sums (the last tower's mean goes to out)
        sums = torch.empty(xk.shape, device=x.device) if len(weights.towers) > 1 else None
        err = lib.zv_mrf_bf16(xk.data_ptr(), out.data_ptr(),
                              None if sums is None else sums.data_ptr(), w.data_ptr(),
                              weights.b.data_ptr(), B, T, Ck, *args, stream)
        _cuda.check(err, "fused_mrf")
        fused_mrf.launches_bf16 += 1
    else:
        err = lib.zv_mrf_f32(xk.data_ptr(), out.data_ptr(), w.data_ptr(),
                             weights.b.data_ptr(), B, T, Ck, *args, stream)
        _cuda.check(err, "fused_mrf")
        fused_mrf.launches += 1
    fused_mrf.launches_at[Ck] = fused_mrf.launches_at.get(Ck, 0) + 1
    return out if Ck == C else out[..., :C].contiguous()


fused_mrf.launches = fused_mrf.launches_bf16 = 0
fused_mrf.launches_at = {}  # launches (both dtypes) by the width the kernel ran at
