"""ResNetSE34V2 zero-shot speaker encoder.

The PyTorch counterpart of the JAX package's `models/resnetse.py`: log-mel
[B, T, n_mels] -> per-bin instance norm over time -> Conv2d stem -> four
SE-ResNet stages (strides 1,2,2,2) -> attentive statistics pooling -> FC ->
L2-normalized embedding [B, 1, n_out]. Convolutions run in NCHW with
frequency as height and time as width. The JAX package's 2x2 lane packing is
a TPU layout of the same math and has no counterpart here.

`forward(x, train)`: in train mode the BatchNorms normalize with batch
statistics and update their running statistics (momentum 0.1, running_var
from the unbiased variance), as the JAX package's BatchNorm does; otherwise
they use the running statistics.

With `fused_stage1`, stage 1 runs as six passes of kernel K4
(ops/se_conv.py), as the JAX package's fused path does
(`SEBasicBlock._fused_call`): each BatchNorm affine rides the next conv's
prologue, its batch statistics come from the previous conv's sums, and the
SE squeeze is the per-sample sum of conv2's output. The parameters and
running statistics are the unfused module's.

In bf16 (bf16-mixed training) the running statistics stay float32 and the
fused path computes in the JAX package's types: float32 BatchNorm affines
and SE gate, bf16 conv outputs, the block boundary in float32 rounded to
bf16. `remat` recomputes each unfused SEBasicBlock in the backward
(`layers.remat`); the fused stage 1 is not recomputed, as in the JAX
package.

Under data parallelism (`group`, a process group whose ranks hold equal
shards of one batch: a mesh's `data_group`, never the whole world of a
data x model mesh, whose model ranks hold the same rows) the train-mode
statistics are the global batch's, as the JAX package's over a
`data`-sharded batch: K4's and the stem's sums are
all-reduced before each affine is formed, and the unfused BatchNorms (the
attention pool's too) all-reduce their sums when the group has more than
one rank. Each all-reduce is differentiable, so K4's backward receives the
global statistics' cotangents; under `remat` every rank replays them in the
same order, and the running statistics still move once a step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from zerovox_tpu_torch.models.layers import instance_norm_time, remat
from zerovox_tpu_torch.ops.se_conv import CHANNELS, se_conv
from zerovox_tpu_torch.parallel.mesh import all_reduce_sum


def _update_running(bn, mean, var, n) -> None:
    """torch's train-mode update of the running statistics from a batch's
    mean and biased variance over n positions."""
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean.float(), alpha=m)
        bn.running_var.mul_(1 - m).add_(var.float() * (n / max(n - 1, 1)), alpha=m)


def _global_batch_norm(bn, x, group):
    """Train-mode `bn` over the group's global batch: the JAX package's
    two-pass statistics (mean, then the mean of squared deviations), each
    from float32 sums all-reduced over the ranks, rounded to x's dtype."""
    dims = (0,) + tuple(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    n = x.numel() // x.shape[1] * dist.get_world_size(group)
    mean = (all_reduce_sum(x.sum(dim=dims, dtype=torch.float32), group) / n).to(x.dtype)
    d = x - mean.view(shape)
    var = (all_reduce_sum((d * d).sum(dim=dims, dtype=torch.float32), group) / n).to(x.dtype)
    _update_running(bn, mean, var, n)
    inv = torch.rsqrt(var + bn.eps)
    return d * inv.view(shape) * bn.weight.view(shape).to(x.dtype) + bn.bias.view(shape).to(x.dtype)


def batch_norm(bn: nn.BatchNorm2d | nn.BatchNorm1d, x, train: bool, group=None):
    """`bn` over x with batch statistics (updating the running ones) in
    train mode, with its running statistics otherwise. On a bf16 x it
    computes as the JAX package's BatchNorm does: batch statistics in x's
    dtype, float32 running statistics, the result in x's dtype. With a
    `group` of more than one rank the batch statistics are the global
    batch's (one rank's batch is the global one)."""
    if train and group is not None and dist.get_world_size(group) > 1:
        return _global_batch_norm(bn, x, group)
    if x.dtype == bn.running_mean.dtype:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, train,
                            bn.momentum, bn.eps)
    dims = (0,) + tuple(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if train:
        mean = x.mean(dim=dims)
        var = ((x - mean.view(shape)) ** 2).mean(dim=dims)
        _update_running(bn, mean, var, x.numel() // x.shape[1])
    else:
        mean, var = bn.running_mean.to(x.dtype), bn.running_var.to(x.dtype)
    inv = torch.rsqrt(var + bn.eps)
    return ((x - mean.view(shape)) * inv.view(shape) * bn.weight.view(shape)
            + bn.bias.view(shape))


def linear(layer: nn.Module, x):
    """`layer` on x in x's dtype (the JAX package's Dense promotes a bf16
    kernel to a float32 input's type). A layer split over the model axis
    (parallel/tensor.py) computes in x's dtype itself."""
    if not isinstance(layer, nn.Linear):
        return layer(x)
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def fused_bn_affine(bn: nn.BatchNorm2d, ssum, ssq, n: int, train: bool, group=None):
    """(scale, shift) [C] of `bn` for a conv output whose per-channel sum and
    sum of squares over its n positions are ssum, ssq. In train mode the
    batch statistics are the single-pass mean and E[y^2] - mean^2 of the
    JAX package's fused path, and the running statistics take torch's
    update; gradients flow through the sums. Under a `group` the sums are
    all-reduced first (every rank holding n positions), the arithmetic
    after them unchanged."""
    if train:
        if group is not None:
            C = ssum.shape[0]
            both = all_reduce_sum(torch.cat([ssum, ssq]), group)
            ssum, ssq, n = both[:C], both[C:], n * dist.get_world_size(group)
        mean = ssum / n
        var = ssq / n - mean * mean
        _update_running(bn, mean, var, n)
    else:
        mean, var = bn.running_mean, bn.running_var
    scale = bn.weight * torch.rsqrt(var + bn.eps)
    # float32 for K4, as the JAX package's affine_packed (computed in the
    # statistics' dtype: bf16 under bf16 inference)
    return scale.float(), (bn.bias - mean * scale).float()


class SELayer(nn.Module):
    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        hidden = max(1, channels // reduction)
        # upstream keys: se.fc.0 (Linear), se.fc.2 (Linear)
        self.fc = nn.Sequential(nn.Linear(channels, hidden), nn.ReLU(),
                                nn.Linear(hidden, channels), nn.Sigmoid())

    def forward(self, x):  # [B, C, H, W]
        y = self.fc(x.mean(dim=(2, 3)))
        return x * y[:, :, None, None]


class SEBasicBlock(nn.Module):
    """conv-relu-bn-conv-bn-se + residual, relu (upstream order: relu before bn1)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.se = SELayer(planes)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                                         nn.BatchNorm2d(planes))
                           if downsample else None)

    def forward(self, x, train: bool = False, group=None):
        out = batch_norm(self.bn1, torch.relu(self.conv1(x)), train, group)
        out = self.se(batch_norm(self.bn2, self.conv2(out), train, group))
        if self.downsample is not None:
            residual = batch_norm(self.downsample[1], self.downsample[0](x), train, group)
        else:
            residual = x
        return torch.relu(out + residual)

    def fused_forward(self, x, s_in, t_in, train: bool, group=None):
        """The block as two K4 passes plus one elementwise boundary. x is the
        block input before its pending affine (s_in, t_in) [C]: the stem BN
        on block 0, the identity after."""
        B, _, H, W = x.shape
        n = B * H * W
        t1, ssum, ssq, _ = se_conv(x, self.conv1.weight, s_in, t_in, relu_out=True)
        s1, tt1 = fused_bn_affine(self.bn1, ssum, ssq, n, train, group)
        t2, ssum2, ssq2, m = se_conv(t1, self.conv2.weight, s1, tt1, relu_out=False)
        s2, tt2 = fused_bn_affine(self.bn2, ssum2, ssq2, n, train, group)
        # SE squeeze by linearity: mean_hw(bn2(t2)) = bn2(mean_hw(t2)), in float32
        fc = self.se.fc
        gate = torch.sigmoid(linear(fc[2], torch.relu(linear(fc[0], m / (H * W) * s2 + tt2))))
        # residual: the block input as its convs see it (pending affine applied);
        # float32, rounded to x's dtype
        out = ((t2 * s2[:, None, None] + tt2[:, None, None]) * gate[:, :, None, None]
               + x * s_in[:, None, None] + t_in[:, None, None])
        return torch.relu(out).to(x.dtype)


class ResNetSE34V2(nn.Module):
    def __init__(self, layers=(3, 4, 6, 3), num_filters=(32, 64, 128, 256), n_out: int = 528,
                 encoder_type: str = "ASP", n_mels: int = 80, fused_stage1: bool = False,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        if encoder_type not in ("ASP", "SAP"):
            raise ValueError(f"undefined encoder type {encoder_type!r}")
        if fused_stage1 and (num_filters[0] != CHANNELS or layers[0] < 1):
            raise ValueError(f"the fused stage 1 needs num_filters[0] == {CHANNELS} and "
                             f"layers[0] >= 1, got {num_filters[0]}, {layers[0]}")
        self.encoder_type = encoder_type
        self.fused_stage1 = fused_stage1
        self.conv1 = nn.Conv2d(1, num_filters[0], 3, padding=1)
        self.bn1 = nn.BatchNorm2d(num_filters[0])
        inplanes = num_filters[0]
        for stage, (blocks, planes) in enumerate(zip(layers, num_filters)):
            stride = 1 if stage == 0 else 2
            seq = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                seq.append(SEBasicBlock(inplanes, planes, s,
                                        downsample=b == 0 and (s != 1 or inplanes != planes)))
                inplanes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*seq))
        self.n_stages = len(layers)
        outmap = num_filters[-1] * (n_mels // 8)
        # upstream keys: attention.0 (Conv1d), attention.2 (BatchNorm1d), attention.3 (Conv1d)
        self.attention = nn.Sequential(
            nn.Conv1d(outmap, 128, 1), nn.ReLU(), nn.BatchNorm1d(128),
            nn.Conv1d(128, outmap, 1), nn.Softmax(dim=2))
        self.fc = nn.Linear(outmap * (2 if encoder_type == "ASP" else 1), n_out)

    def _stage1_fused(self, x, train: bool, group=None):
        """Stem BN + stage 1 through K4: the stem BN's statistics come from
        one reduction over the stem output, its affine rides block 0's conv1."""
        B, _, H, W = x.shape
        n = B * H * W
        xf = x.float()  # the stem BN's sums in float32 whatever x's dtype
        s_in, t_in = fused_bn_affine(self.bn1, xf.sum(dim=(0, 2, 3)),
                                     (xf * xf).sum(dim=(0, 2, 3)), n, train, group)
        ones, zeros = torch.ones_like(s_in), torch.zeros_like(t_in)
        for block in self.layer1:
            x = block.fused_forward(x, s_in, t_in, train, group)
            s_in, t_in = ones, zeros
        return x

    def forward(self, x, train: bool = False, group=None):
        """x [B, T, n_mels] log-mel -> [B, 1, n_out]; `group`: the data-parallel
        process group whose global batch the train-mode statistics cover."""
        x = instance_norm_time(x).transpose(1, 2)[:, None]  # [B, 1, n_mels, T]

        x = torch.relu(self.conv1(x))
        if self.fused_stage1:
            x = self._stage1_fused(x, train, group)
        else:
            x = batch_norm(self.bn1, x, train, group)
        checkpointed = self.remat and torch.is_grad_enabled()
        for stage in range(1 if self.fused_stage1 else 0, self.n_stages):
            for block in getattr(self, f"layer{stage + 1}"):
                x = remat(block, x, train, group) if checkpointed else block(x, train, group)

        B, C, H, W = x.shape
        x = x.reshape(B, C * H, W)
        att = self.attention
        w = att[4](att[3](batch_norm(att[2], att[1](att[0](x)), train, group)))
        if self.encoder_type == "SAP":
            pooled = torch.sum(x * w, dim=2)
        else:
            mu = torch.sum(x * w, dim=2)
            sg = torch.sqrt(torch.clamp(torch.sum(x * x * w, dim=2) - mu * mu, min=1e-5))
            pooled = torch.cat([mu, sg], dim=1)
        out = self.fc(pooled)
        out = out / torch.clamp(torch.linalg.vector_norm(out, dim=1, keepdim=True), min=1e-12)
        return out[:, None, :]
