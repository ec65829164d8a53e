"""Fused speaker-encoder stage-1 conv pass: kernel K4, forward and backward.

ResNetSE34V2's stage 1 is three stride-1 SE-ResNet blocks at C=32 and full
resolution. In training, each of its six 3x3 convs runs as one pass

    u = x*s + t                 (the pending BatchNorm affine; zero outside
                                 the image: the SAME conv pads u, not x)
    y = relu?(conv3x3(u))
    -> (y, sum[c] = S y, sq[c] = S y^2, m[b, c] = S_hw y)

whose sums give the next BatchNorm's batch statistics and the SE squeeze
(models/resnetse.py). `se_conv` computes it over canonical NCHW x [B, 32, H, W]
with torch-layout taps w [32, 32, 3, 3]:

  * on CUDA tensors it launches the hand-written Hopper kernels of
    `csrc/se_conv.cu` through `SeConv`, an autograd Function whose backward
    is the fused backward kernel (dgrad, wgrad, the statistics' cotangents
    and the affine's gradients in one pass). They replace the TPU kernels
    `zerovox_tpu/ops/pallas/se_fused.py::se_conv` (`_fwd_call`,
    `_bwd_call`). Every product of the conv runs on the tensor cores in
    3xTF32 (implicit GEMMs on `mma.sync`); on an H100 both are bound by
    operations (72 FLOP per byte at [24, 32, 80, 500]); design notes are in
    the source;
  * on CPU tensors it runs `se_conv_plain`, the same function in plain
    PyTorch, differentiated by autograd.

bf16-mixed training runs the pass on bf16 x and w (s and t stay float32),
with the JAX kernel's rounding points: u = bf16(x*s + t); y accumulated in
float32, its sums taken before y is stored as bf16; backward g =
bf16((dy + dsum + 2*y*dsq + dm) * relu'(y)) from the bf16 y, dx = bf16(du*s),
and dw, ds, dt in float32 (dw cast to w's dtype, as the JAX VJP does). On
CUDA tensors `se_conv_fwd_bf16` / `se_conv_bwd_bf16` launch the bf16
tensor-core kernels of the same source (bound by bytes); on the CPU
`se_conv_plain` and `se_conv_bwd_plain` round where those kernels round.

There is no fallback: a CUDA tensor the kernels do not take raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zerovox_tpu_torch.ops import _cuda

CHANNELS = 32  # the kernels' channel count (ResNetSE34V2 num_filters[0])


def _bcast(v):
    return v[None, :, None, None]


def se_conv_plain(x, w, s, t, relu_out: bool):
    """Plain PyTorch K4: x [B, C, H, W], w [C, C, 3, 3], s, t [C] ->
    (y [B, C, H, W], sum [C], sq [C], m [B, C]). On bf16 x and w the conv
    runs in float32 on the bf16 values (exact products, float32 sums) and y
    is rounded to bf16 after its sums are taken."""
    if x.dtype == torch.bfloat16:
        u = (x.float() * _bcast(s) + _bcast(t)).to(torch.bfloat16)
        y = F.conv2d(u.float(), w.float(), padding=1)
        if relu_out:
            y = torch.relu(y)
        return (y.to(torch.bfloat16), y.sum(dim=(0, 2, 3)), (y * y).sum(dim=(0, 2, 3)),
                y.sum(dim=(2, 3)))
    u = x * _bcast(s) + _bcast(t)
    y = F.conv2d(u, w, padding=1)  # zero padding of u: the kernel's u-space padding
    if relu_out:
        y = torch.relu(y)
    return y, y.sum(dim=(0, 2, 3)), (y * y).sum(dim=(0, 2, 3)), y.sum(dim=(2, 3))


def se_conv_bwd_plain(x, y, dy, w, s, t, dsum, dsq, dm, relu_out: bool):
    """Plain PyTorch K4-bwd: the gradients (dx, dw, ds, dt) of one pass
    given the cotangents (dy, dsum, dsq, dm), rounded where the kernel
    rounds (g and u to x's dtype, dx after its scale by s); dw, ds and dt
    float32."""
    dt_ = x.dtype
    yf = y.float()
    g = dy.float() + _bcast(dsum) + 2.0 * yf * _bcast(dsq) + dm[:, :, None, None]
    if relu_out:
        g = g * (yf > 0)
    g = g.to(dt_).float()
    u = (x.float() * _bcast(s) + _bcast(t)).to(dt_).float()
    du = torch.nn.grad.conv2d_input(x.shape, w.float(), g, padding=1)
    dw = torch.nn.grad.conv2d_weight(u, w.shape, g, padding=1)
    return ((du * _bcast(s)).to(dt_), dw, (du * x.float()).sum(dim=(0, 2, 3)),
            du.sum(dim=(0, 2, 3)))


def _check(name, dtype, x, w, s, t):
    _cuda.require_cuda(name, x.device, dtype, x, w)
    _cuda.require_cuda(name, x.device, torch.float32, s, t)
    if x.dim() != 4 or x.shape[1] != CHANNELS:
        raise ValueError(f"{name}: x must be [B, {CHANNELS}, H, W], got {tuple(x.shape)}")
    if tuple(w.shape) != (CHANNELS, CHANNELS, 3, 3):
        raise ValueError(f"{name}: w must be [{CHANNELS}, {CHANNELS}, 3, 3], got {tuple(w.shape)}")
    if tuple(s.shape) != (CHANNELS,) or tuple(t.shape) != (CHANNELS,):
        raise ValueError(f"{name}: s and t must be [{CHANNELS}]")


def _check_bwd(name, dtype, x, y, dy, dsum, dsq, dm):
    _cuda.require_cuda(name, x.device, dtype, y, dy)
    _cuda.require_cuda(name, x.device, torch.float32, dsum, dsq, dm)
    B, C = x.shape[:2]
    if y.shape != x.shape or dy.shape != x.shape or tuple(dm.shape) != (B, C):
        raise ValueError(f"{name}: y and dy must be shaped as x, dm as [B, 32]")


def se_conv_fwd(x, w, s, t, relu_out: bool):
    """K4-fwd on the card: (y, sum, sq, m) of `se_conv_plain`."""
    _check("se_conv_fwd", torch.float32, x, w, s, t)
    B, C, H, W = x.shape
    lib = _cuda.lib("se_conv")
    y = torch.empty_like(x)
    ssum, ssq = x.new_empty(C), x.new_empty(C)
    m = x.new_empty(B, C)
    part = x.new_empty(lib.zv_se_conv_fwd_tiles(B, H, W) * 2 * C)
    err = lib.zv_se_conv_fwd_f32(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), t.data_ptr(), y.data_ptr(), ssum.data_ptr(),
        ssq.data_ptr(), m.data_ptr(), part.data_ptr(), B, H, W, int(relu_out),
        torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(err, "se_conv_fwd")
    se_conv_fwd.launches += 1
    return y, ssum, ssq, m


def se_conv_bwd(x, y, dy, w, s, t, dsum, dsq, dm, relu_out: bool):
    """K4-bwd on the card: the gradients (dx, dw, ds, dt) of one pass given
    the cotangents (dy, dsum, dsq, dm) of its four outputs."""
    _check("se_conv_bwd", torch.float32, x, w, s, t)
    _check_bwd("se_conv_bwd", torch.float32, x, y, dy, dsum, dsq, dm)
    B, C, H, W = x.shape
    lib = _cuda.lib("se_conv")
    dx = torch.empty_like(x)
    out = x.new_empty(C * C * 9 + 2 * C)
    part = x.new_empty(lib.zv_se_conv_bwd_blocks(B, H, W) * out.numel())
    err = lib.zv_se_conv_bwd_f32(
        x.data_ptr(), y.data_ptr(), dy.data_ptr(), w.data_ptr(), s.data_ptr(), t.data_ptr(),
        dsum.data_ptr(), dsq.data_ptr(), dm.data_ptr(), dx.data_ptr(), out.data_ptr(),
        part.data_ptr(), B, H, W, int(relu_out), torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(err, "se_conv_bwd")
    se_conv_bwd.launches += 1
    n = C * C * 9
    return dx, out[:n].view(C, C, 3, 3), out[n:n + C], out[n + C:]


def se_conv_fwd_bf16(x, w, s, t, relu_out: bool):
    """K4-fwd in bf16 on the card: y (bf16) and the float32 sum, sq and m of
    `se_conv_plain` on bf16 x and w."""
    _check("se_conv_fwd_bf16", torch.bfloat16, x, w, s, t)
    B, C, H, W = x.shape
    lib = _cuda.lib("se_conv")
    y = torch.empty_like(x)
    ssum, ssq = s.new_empty(C), s.new_empty(C)
    m = s.new_empty(B, C)
    part = s.new_empty(lib.zv_se_conv_fwd_tiles(B, H, W) * 2 * C)
    err = lib.zv_se_conv_fwd_bf16(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), t.data_ptr(), y.data_ptr(), ssum.data_ptr(),
        ssq.data_ptr(), m.data_ptr(), part.data_ptr(), B, H, W, int(relu_out),
        torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(err, "se_conv_fwd_bf16")
    se_conv_fwd_bf16.launches += 1
    return y, ssum, ssq, m


def se_conv_bwd_bf16(x, y, dy, w, s, t, dsum, dsq, dm, relu_out: bool):
    """K4-bwd in bf16 on the card: dx (bf16) and the float32 dw, ds, dt of
    `se_conv_bwd_plain` on bf16 x, y, dy and w."""
    _check("se_conv_bwd_bf16", torch.bfloat16, x, w, s, t)
    _check_bwd("se_conv_bwd_bf16", torch.bfloat16, x, y, dy, dsum, dsq, dm)
    B, C, H, W = x.shape
    lib = _cuda.lib("se_conv")
    dx = torch.empty_like(x)
    out = s.new_empty(C * C * 9 + 2 * C)
    part = s.new_empty(lib.zv_se_conv_bf16_blocks(B, H, W, 1) * out.numel())
    err = lib.zv_se_conv_bwd_bf16(
        x.data_ptr(), y.data_ptr(), dy.data_ptr(), w.data_ptr(), s.data_ptr(), t.data_ptr(),
        dsum.data_ptr(), dsq.data_ptr(), dm.data_ptr(), dx.data_ptr(), out.data_ptr(),
        part.data_ptr(), B, H, W, int(relu_out), torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(err, "se_conv_bwd_bf16")
    se_conv_bwd_bf16.launches += 1
    n = C * C * 9
    return dx, out[:n].view(C, C, 3, 3), out[n:n + C], out[n + C:]


se_conv_fwd.launches = se_conv_bwd.launches = 0
se_conv_fwd_bf16.launches = se_conv_bwd_bf16.launches = 0


class SeConv(torch.autograd.Function):
    """One pass with its backward pass; forward returns (y, sum, sq, m). On
    CUDA tensors both are the kernels of x's dtype; on the CPU (bf16 only)
    the plain versions, so that the CPU rounds where the kernels do."""

    @staticmethod
    def forward(ctx, x, w, s, t, relu_out: bool):
        if x.device.type == "cpu":
            fwd = se_conv_plain
        else:
            fwd = se_conv_fwd_bf16 if x.dtype == torch.bfloat16 else se_conv_fwd
        y, ssum, ssq, m = fwd(x, w, s, t, relu_out)
        ctx.save_for_backward(x, y, w, s, t)
        ctx.relu_out = relu_out
        return y, ssum, ssq, m

    @staticmethod
    def backward(ctx, dy, dsum, dsq, dm):
        x, y, w, s, t = ctx.saved_tensors
        if x.device.type == "cpu":
            bwd = se_conv_bwd_plain
        else:
            bwd = se_conv_bwd_bf16 if x.dtype == torch.bfloat16 else se_conv_bwd
        dx, dw, ds, dt = bwd(x, y, dy.contiguous(), w, s, t, dsum.contiguous(),
                             dsq.contiguous(), dm.contiguous(), ctx.relu_out)
        return dx, dw.to(w.dtype), ds, dt, None


def se_conv(x, w, s, t, relu_out: bool):
    """One fused stage-1 pass; see the module docstring. Float32 CPU tensors
    run `se_conv_plain` under autograd."""
    if x.device.type == "cpu" and x.dtype != torch.bfloat16:
        return se_conv_plain(x, w, s, t, relu_out)
    return SeConv.apply(x.contiguous(), w.contiguous(), s.contiguous(), t.contiguous(),
                        relu_out)
