"""StyleTTS AdaIN residual-conv mel decoder (the alternative to FS2Decoder).

The PyTorch counterpart of the JAX package's `models/styletts.py`: encode =
2 ResBlk1d to twice the hidden width; decode = 5 AdainResBlk1d conditioned
on the speaker style through AdaIN, with the `asr_res` skip concatenated up
to the block flagged `upsample` (the flag resamples nothing: it only ends
the concatenation); a 1x1 conv to n_mels. Every conv is weight-normed, with
g and v kept as parameters.

Activations are NLC. Module names follow the upstream `_mel_decoder.*` keys
(`encode.0.conv1`, `encode.0.norm1`, `asr_res.0`, `asr_res.1`,
`decode.i.norm1.fc`, `to_out.0`), so an upstream checkpoint loads as it is.

The decoder never reads `mel_mask`: its InstanceNorms take statistics over
the whole mel bucket, padded frames included, so its output depends on the
bucket it runs at, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from zerovox_tpu_torch.models.layers import Dropout, InstanceNorm, WeightNormConv1d


class ResBlk1d(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, normalize: bool = False,
                 dropout_p: float = 0.2):
        super().__init__()
        self.normalize = normalize
        self.learned_sc = dim_in != dim_out
        self.conv1 = WeightNormConv1d(dim_in, dim_in, 3, padding=1)
        self.conv2 = WeightNormConv1d(dim_in, dim_out, 3, padding=1)
        if normalize:
            self.norm1 = InstanceNorm(dim_in, affine=True)
            self.norm2 = InstanceNorm(dim_in, affine=True)
        if self.learned_sc:
            self.conv1x1 = WeightNormConv1d(dim_in, dim_out, 1, bias=False)
        self.dropout = Dropout(dropout_p)

    def forward(self, x):
        sc = self.conv1x1(x) if self.learned_sc else x
        h = self.norm1(x) if self.normalize else x
        h = self.conv1(self.dropout(F.leaky_relu(h, 0.2)))
        if self.normalize:
            h = self.norm2(h)
        h = self.conv2(self.dropout(F.leaky_relu(h, 0.2)))
        return (sc + h) / math.sqrt(2)


class AdaIN1d(nn.Module):
    """(1 + gamma(s)) * InstanceNorm(x) + beta(s)."""

    def __init__(self, style_dim: int, num_features: int):
        super().__init__()
        self.num_features = num_features
        self.norm = InstanceNorm(num_features, affine=False)
        self.fc = nn.Linear(style_dim, 2 * num_features)

    def forward(self, x, s):  # x [B, L, C], s [B, style_dim]
        gamma, beta = torch.split(self.fc(s), self.num_features, dim=-1)
        return (1 + gamma[:, None, :]) * self.norm(x) + beta[:, None, :]


class AdainResBlk1d(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, style_dim: int, upsample: bool = False,
                 dropout_p: float = 0.0):
        super().__init__()
        self.upsample = upsample
        self.learned_sc = dim_in != dim_out
        self.conv1 = WeightNormConv1d(dim_in, dim_out, 3, padding=1)
        self.conv2 = WeightNormConv1d(dim_out, dim_out, 3, padding=1)
        self.norm1 = AdaIN1d(style_dim, dim_in)
        self.norm2 = AdaIN1d(style_dim, dim_out)
        if self.learned_sc:
            self.conv1x1 = WeightNormConv1d(dim_in, dim_out, 1, bias=False)
        self.dropout = Dropout(dropout_p)

    def forward(self, x, s):
        sc = self.conv1x1(x) if self.learned_sc else x
        h = self.conv1(self.dropout(F.leaky_relu(self.norm1(x, s), 0.2)))
        h = self.conv2(self.dropout(F.leaky_relu(self.norm2(h, s), 0.2)))
        return (h + sc) / math.sqrt(2)


class StyleTTSDecoder(nn.Module):
    """enc_seq [B, T, dim_in], spk_emb [B, 1, style_dim] -> mel [B, T, dim_out];
    the same call as FS2Decoder (mel_mask is not read)."""

    def __init__(self, dim_in: int, style_dim: int, residual_dim: int = 64, dim_out: int = 80):
        super().__init__()
        bottleneck = 2 * dim_in
        self.encode = nn.ModuleList([ResBlk1d(dim_in, bottleneck, normalize=True),
                                     ResBlk1d(bottleneck, bottleneck, normalize=True)])
        self.asr_res = nn.Sequential(WeightNormConv1d(dim_in, residual_dim, 1),
                                     InstanceNorm(residual_dim, affine=True))
        specs = [(bottleneck + residual_dim, bottleneck, False),
                 (bottleneck + residual_dim, bottleneck, False),
                 (bottleneck + residual_dim, dim_in, True),
                 (dim_in, dim_in, False),
                 (dim_in, dim_in, False)]
        self.decode = nn.ModuleList(AdainResBlk1d(din, dout, style_dim, upsample=ups)
                                    for din, dout, ups in specs)
        self.to_out = nn.Sequential(WeightNormConv1d(dim_in, dim_out, 1))

    def forward(self, enc_seq, mel_mask, spk_emb):
        s = spk_emb[:, 0, :]
        x = enc_seq
        for blk in self.encode:
            x = blk(x)
        asr_res = self.asr_res(enc_seq)
        res = True
        for blk in self.decode:
            if res:
                x = torch.cat([x, asr_res], dim=-1)
            x = blk(x, s)
            if blk.upsample:
                res = False
        return self.to_out(x)
