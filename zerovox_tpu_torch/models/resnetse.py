"""ResNetSE34V2 zero-shot speaker encoder, eval mode.

The PyTorch counterpart of the JAX package's `models/resnetse.py`: log-mel
[B, T, n_mels] -> per-bin instance norm over time -> Conv2d stem -> four
SE-ResNet stages (strides 1,2,2,2) -> attentive statistics pooling -> FC ->
L2-normalized embedding [B, 1, n_out]. Convolutions run in NCHW with
frequency as height and time as width. The JAX package's 2x2 lane packing is
a TPU layout of the same math and has no counterpart here. BatchNorms use
their running statistics.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from zerovox_tpu_torch.models.layers import instance_norm_time


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

    def forward(self, x):
        out = self.bn1(torch.relu(self.conv1(x)))
        out = self.se(self.bn2(self.conv2(out)))
        residual = self.downsample(x) if self.downsample is not None else x
        return torch.relu(out + residual)


class ResNetSE34V2(nn.Module):
    def __init__(self, layers=(3, 4, 6, 3), num_filters=(32, 64, 128, 256), n_out: int = 528,
                 encoder_type: str = "ASP", n_mels: int = 80):
        super().__init__()
        if encoder_type not in ("ASP", "SAP"):
            raise ValueError(f"undefined encoder type {encoder_type!r}")
        self.encoder_type = encoder_type
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

    def forward(self, x):
        """x [B, T, n_mels] log-mel -> [B, 1, n_out]."""
        x = instance_norm_time(x).transpose(1, 2)[:, None]  # [B, 1, n_mels, T]

        x = self.bn1(torch.relu(self.conv1(x)))
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)

        B, C, H, W = x.shape
        x = x.reshape(B, C * H, W)
        w = self.attention(x)
        if self.encoder_type == "SAP":
            pooled = torch.sum(x * w, dim=2)
        else:
            mu = torch.sum(x * w, dim=2)
            sg = torch.sqrt(torch.clamp(torch.sum(x * x * w, dim=2) - mu * mu, min=1e-5))
            pooled = torch.cat([mu, sg], dim=1)
        out = self.fc(pooled)
        out = out / torch.clamp(torch.linalg.vector_norm(out, dim=1, keepdim=True), min=1e-12)
        return out[:, None, :]
