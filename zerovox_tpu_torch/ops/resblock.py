"""Fused HiFi-GAN ResBlock1 (one tower): kernel K3.

A ResBlock1 tower is P pairs of leaky(0.1) -> dilated conv(k, d_p) -> leaky
-> conv(k, 1) -> + residual. `fused_resblock1` computes one tower over
x [B, T, C]:

  * on a CUDA tensor it launches the hand-written Hopper kernel
    `csrc/resblock.cu`, which replaces the TPU kernel
    `zerovox_tpu/ops/pallas/resblock.py::fused_resblock1`. On an H100 the
    tower is bound by arithmetic (36 C^2 FLOP per row at k=3, P=3); the
    kernel keeps a time tile and the tower's halo in shared memory across
    all 2P convs, runs each conv as tensor-core GEMMs on K1's tile, in
    3xTF32 on float32 (`csrc/mrf_tc.cuh`) and on bf16 tensor-core products
    on bf16 (`csrc/mrf_bf16.cuh`), and writes the output once (design notes
    in the source);
  * on a CPU tensor it runs `resblock1_plain`, the same function in plain
    PyTorch.

Float32 or bf16 (bf16 inference): on bf16 x and weights every intermediate
stays float32 and the tower's output is rounded to bf16 once, as the TPU
kernel does. The bf16 kernel feeds each activation to bf16 MMAs as two bf16
terms (hi and the rest), as the bf16 K1 does: its result is within one bf16
step of the plain version's, with at most 1 % of the outputs (chip_smoke.py's
BF16X2_SHARE) rounded the other way; it is not bitwise the float32 kernel's.
bf16 launches are counted apart (`fused_resblock1.launches_bf16`).

The kernel reads the tower's weights in MMA fragment order (m16n8k8 on
float32, m16n8k16 on bf16), `ops.mrf.pack_towers([tower])`: a caller that
runs one weight version many times (the vocoder) packs once and passes
`packed=`. Like K1 the kernel is
built for C of 8, 16, 32, 64 and 128; other widths up to 128 run
zero-padded to the next (weights padded by `pack_towers`, x per call, the
output cut back). There is no fallback:
a CUDA tensor the kernel does not take raises, and so does a tensor that
requires grad while grad is enabled (the kernel has no backward), on either
device.
"""

from __future__ import annotations

import torch

from zerovox_tpu_torch.ops import _cuda
from zerovox_tpu_torch.ops.mrf import (KERNEL_CHANNELS, MrfWeights, _torch_convs, check_towers,
                                       fragments, kernel_channels, pack_towers, pad_to,
                                       refuse_grad, resblock1_ncl)


def resblock1_plain(x, w1, b1, w2, b2, dilations):
    """Plain PyTorch ResBlock1 over NLC x [B, T, C]; w1/w2 [P, k, C, C]
    taps (k, in, out), b1/b2 [P, C]. On bf16 inputs: computed in float32 on
    the widened inputs and rounded to bf16 once."""
    if x.dtype == torch.bfloat16:
        return resblock1_plain(x.float(), w1.float(), b1.float(), w2.float(), b2.float(),
                               dilations).to(torch.bfloat16)
    y = resblock1_ncl(x.transpose(1, 2), _torch_convs(w1, b1), _torch_convs(w2, b2), dilations)
    return y.transpose(1, 2)


def fused_resblock1(x, w1, b1, w2, b2, dilations, packed: MrfWeights | None = None):
    """One ResBlock1 tower of x [B, T, C] -> [B, T, C].

    w1, w2: [P, k, C, C] conv taps (k, in, out) of the dilated and the plain
    convs; b1, b2: [P, C]; dilations: the P first-conv dilations; packed:
    `pack_towers([(w1, b1, w2, b2)])`, built here when not given."""
    refuse_grad("fused_resblock1", x, w1, b1, w2, b2,
                *((packed.w, packed.w16, packed.b) if packed is not None else ()))
    if x.device.type == "cpu":
        return resblock1_plain(x, w1, b1, w2, b2, dilations)
    if x.dim() != 3:
        raise ValueError(f"fused_resblock1: x must be [B, T, C], got {tuple(x.shape)}")
    B, T, C = x.shape
    Ck = kernel_channels(C)
    if Ck is None:
        raise ValueError(f"fused_resblock1: the kernel takes C <= {KERNEL_CHANNELS[-1]}, got {C}")
    P, k = w1.shape[0], w1.shape[1]
    if not 1 <= P <= 3 or len(dilations) != P:
        raise ValueError(f"fused_resblock1: need 1-3 conv pairs and one dilation each, "
                         f"got {P} pairs and dilations {tuple(dilations)}")
    if k % 2 == 0:
        raise ValueError(f"fused_resblock1: the kernel takes an odd kernel size, got {k}")
    if packed is None:
        packed = pack_towers([(w1, b1, w2, b2)])
    check_towers("fused_resblock1", packed, (k,), P, C, Ck)
    dtype = _cuda.float_kind("fused_resblock1", x)
    xk = pad_to(x, (*x.shape[:-1], Ck))
    w = fragments("fused_resblock1", dtype, packed.w, packed.w16)
    _cuda.require_cuda("fused_resblock1", x.device, dtype, xk, w, packed.b)
    ds = list(dilations) + [0] * (3 - P)
    out = torch.empty_like(xk)
    lib = _cuda.lib("resblock")
    fn = lib.zv_resblock1_bf16 if dtype == torch.bfloat16 else lib.zv_resblock1_f32
    err = fn(xk.data_ptr(), out.data_ptr(), w.data_ptr(), packed.b.data_ptr(), B, T, Ck, k,
             P, *ds, torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(err, "fused_resblock1")
    if dtype == torch.bfloat16:
        fused_resblock1.launches_bf16 += 1
    else:
        fused_resblock1.launches += 1
    fused_resblock1.launches_at[Ck] = fused_resblock1.launches_at.get(Ck, 0) + 1
    return out if Ck == C else out[..., :C].contiguous()


fused_resblock1.launches = fused_resblock1.launches_bf16 = 0
fused_resblock1.launches_at = {}  # launches (both dtypes) by the width the kernel ran at
