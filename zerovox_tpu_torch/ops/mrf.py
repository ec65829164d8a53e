"""Fused HiFi-GAN multi-receptive-field (MRF) stage: kernel K1.

One vocoder upsample stage averages several ResBlock1 towers (kernel sizes
3/7/11, dilations 1,3,5 each) over the same input. `fused_mrf` computes
that mean in one pass over x [B, T, C]:

  * on a CUDA tensor it launches the hand-written Hopper kernel
    `csrc/mrf.cu`, which replaces the TPU kernel
    `zerovox_tpu/ops/pallas/mrf.py::fused_mrf`. On an H100 the stage is
    bound by arithmetic (252 C^2 FLOP per row at the main path's C=128),
    not by memory; the kernel keeps every tower activation of a time tile
    in shared memory and runs each conv as tensor-core GEMMs in 3xTF32
    (design notes in `csrc/mrf_tc.cuh`);
  * on a CPU tensor it runs `mrf_plain`, the same function in plain PyTorch.

Float32 or bf16 (bf16 inference): on bf16 x and weights the kernel (and the
plain version) keeps every intermediate in float32 and rounds the stage's
output to bf16 once, as the TPU kernel does. The bf16 launches are counted
apart (`fused_mrf.launches_bf16`).

The weights come packed once per weight version (`pack_towers`): the plain
layout for the CPU, and the kernel's MMA fragment order. There is no
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
KERNEL_CHANNELS = (32, 64, 128)  # the widths K1 and K3 are instantiated for in their sources


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


def check_towers(name, weights, kernel_sizes, n_pairs, C):
    """Raise unless every tower of `weights` (`pack_towers`) is (w1, b1, w2,
    b2) of shapes [P, k, C, C], [P, C], [P, k, C, C], [P, C], and the flat
    buffers hold them all: the kernels read the buffers by these shapes."""
    for (w1, b1, w2, b2), k in zip(weights.towers, kernel_sizes):
        if (tuple(w1.shape) != (n_pairs, k, C, C) or tuple(w2.shape) != (n_pairs, k, C, C)
                or tuple(b1.shape) != (n_pairs, C) or tuple(b2.shape) != (n_pairs, C)):
            raise ValueError(f"{name}: tower weights {[tuple(t.shape) for t in (w1, b1, w2, b2)]} "
                             f"do not match C={C}, k={k}, {n_pairs} pairs")
    n_w = sum(2 * n_pairs * k * C * C for k in kernel_sizes)
    if (len(weights.towers) != len(kernel_sizes) or weights.w is None or weights.w.numel() != n_w
            or weights.b.numel() != 2 * n_pairs * C * len(kernel_sizes)):
        raise ValueError(f"{name}: packed buffers do not hold {len(kernel_sizes)} towers of "
                         f"C={C}, kernel sizes {tuple(kernel_sizes)}, {n_pairs} pairs")


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
    w: torch.Tensor | None  # every conv's taps in MMA fragment order, tower by tower
    b: torch.Tensor  # b1 then b2 of each tower


def mma_fragments(w):
    """Conv taps w [..., k, C_in, C_out] (taps (k, in, out)) -> flat, in the
    kernels' B-fragment order of mma.m16n8k8 (csrc/mrf_tc.cuh): for each tap,
    k-step of 8 input channels and block of 8 output channels, lane l of the
    warp holds w[tap][8 ks + l % 4][8 nf + l // 4] and the same at input
    channel + 4, side by side."""
    k, ci, co = w.shape[-3:]
    f = w.reshape(-1, k, ci // 8, 2, 4, co // 8, 8)  # (.., k, ks, half, lane % 4, nf, lane // 4)
    return f.permute(0, 1, 2, 5, 6, 4, 3).reshape(-1)


def pack_towers(towers) -> MrfWeights:
    """The towers and the kernels' buffers built from them (no fragment
    buffer when a width is not a multiple of 8: the kernels do not take it)."""
    C = towers[0][0].shape[-1]
    w = (torch.cat([mma_fragments(t) for w1, _, w2, _ in towers for t in (w1, w2)])
         if C % 8 == 0 else None)
    b = torch.cat([t.reshape(-1) for _, b1, _, b2 in towers for t in (b1, b2)])
    return MrfWeights(list(towers), w, b)


def fused_mrf(x, weights: MrfWeights, dilations, kernel_sizes):
    """Mean over ResBlock1 towers of x [B, T, C] -> [B, T, C].

    weights: `pack_towers` of the towers, each (w1 [P, k, C, C], b1 [P, C],
    w2 [P, k, C, C], b2 [P, C]) with conv taps (k, in, out); dilations: the
    P first-conv dilations, shared by every tower; kernel_sizes: k of each
    tower."""
    refuse_grad("fused_mrf", x, weights.w, weights.b, *[t for tw in weights.towers for t in tw])
    if x.device.type == "cpu":
        return mrf_plain(x, weights.towers, dilations)
    B, T, C = x.shape
    if C not in KERNEL_CHANNELS:
        raise ValueError(f"fused_mrf: the kernel takes C in {KERNEL_CHANNELS}, got {C}")
    args = tower_args(weights.towers, dilations, kernel_sizes)
    check_towers("fused_mrf", weights, kernel_sizes, len(dilations), C)
    dtype = _cuda.float_kind("fused_mrf", x)
    _cuda.require_cuda("fused_mrf", x.device, dtype, x, weights.w, weights.b)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _cuda.lib("mrf")
    if dtype == torch.bfloat16:
        # the towers' float32 sums (the last tower's mean goes to out)
        sums = torch.empty(x.shape, device=x.device) if len(weights.towers) > 1 else None
        err = lib.zv_mrf_bf16(x.data_ptr(), out.data_ptr(),
                              None if sums is None else sums.data_ptr(), weights.w.data_ptr(),
                              weights.b.data_ptr(), B, T, C, *args, stream)
        _cuda.check(err, "fused_mrf")
        fused_mrf.launches_bf16 += 1
        return out
    err = lib.zv_mrf_f32(x.data_ptr(), out.data_ptr(), weights.w.data_ptr(),
                         weights.b.data_ptr(), B, T, C, *args, stream)
    _cuda.check(err, "fused_mrf")
    fused_mrf.launches += 1
    return out


fused_mrf.launches = fused_mrf.launches_bf16 = 0
