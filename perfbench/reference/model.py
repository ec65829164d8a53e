"""Plain PyTorch reference of ZeroVox (acoustic model) and its HiFi-GAN V1
vocoder, float32, no kernel, no cache, no batching tricks.

It follows the published models (FastSpeech 2 encoder and variance adaptor
with the ZeroVox speaker-conditional LayerNorm decoder or the StyleTTS AdaIN
decoder, the ResNetSE34V2 speaker encoder, the HiFi-GAN V1 generator) as the
port computes them, and carries the port's state_dict keys, so one set of
seeded weights loads into both. It imports nothing of the port: every
module is written out here with its plain path only (no flash attention, no
fused speaker stage, no fused vocoder stages, no tensor parallelism).

Activations are NLC ([batch, length, channels]) as in the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1


# ----------------------------------------------------------------- layers


def plain_f32(tf32: bool = False) -> None:
    """float32 matmuls and cuDNN convolutions; `tf32=True` is the control's
    lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def torch_std(x, dim=-1):
    n = x.shape[dim]
    mu = x.mean(dim=dim, keepdim=True)
    var = ((x - mu) ** 2).sum(dim=dim, keepdim=True) / max(n - 1, 1)
    return torch.sqrt(var + 1e-12)


class Dropout(nn.Module):
    """flax's rule: keep with probability 1 - rate, scale by 1 / (1 - rate);
    draws from `generator` (the training step's, seeded per step)."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Conv(nn.Module):
    def __init__(self, cin, cout, k, padding):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, padding=padding)

    def forward(self, x):
        return self.conv(x.transpose(1, 2)).transpose(1, 2)


class NLCConv1d(nn.Conv1d):
    def forward(self, x):
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class LinearNorm(nn.Module):
    def __init__(self, cin, cout, bias=False):
        super().__init__()
        self.linear = nn.Linear(cin, cout, bias=bias)

    def forward(self, x):
        return self.linear(x)


class SCLN(nn.Module):
    def __init__(self, hidden, eps=1e-8):
        super().__init__()
        self.hidden = hidden
        self.eps = eps
        self.affine_layer = LinearNorm(hidden, 2 * hidden)

    def forward(self, x, s):
        mu = x.mean(dim=-1, keepdim=True)
        y = (x - mu) / (torch_std(x) + self.eps)
        b, g = torch.split(self.affine_layer(s), self.hidden, dim=-1)
        return g * y + b


def instance_norm_time(x, eps=1e-5):
    mu = x.mean(dim=1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


class InstanceNorm(nn.Module):
    def __init__(self, features, affine=False):
        super().__init__()
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        y = instance_norm_time(x)
        return y if self.weight is None else y * self.weight + self.bias


class WeightNormConv1d(nn.Module):
    def __init__(self, cin, cout, k, padding=0, bias=True):
        super().__init__()
        self.padding = padding
        self.weight_g = nn.Parameter(torch.ones(cout, 1, 1))
        self.weight_v = nn.Parameter(torch.zeros(cout, cin, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        v = self.weight_v
        w = v * (self.weight_g / torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True) + 1e-12))
        return F.conv1d(x.transpose(1, 2), w, self.bias, padding=self.padding).transpose(1, 2)


def position_table(n, d, device):
    """Sinusoid positions, computed in float64 then cast to float32."""
    pos = np.arange(n)[:, None]
    hid = np.arange(d)[None, :]
    angle = pos / np.power(10000, 2 * (hid // 2) / d)
    t = np.zeros((n, d))
    t[:, 0::2] = np.sin(angle[:, 0::2])
    t[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.tensor(t.astype(np.float32), device=device)


def length_regulate(x, durations, T):
    """Phone features [B, L, H] repeated durations[b, i] times into T frames."""
    durations = durations.to(torch.int32)
    ends = torch.cumsum(durations, dim=1, dtype=torch.int32)
    mel_len = torch.clamp(ends[:, -1], max=T)
    t = torch.arange(T, dtype=torch.int32, device=x.device)
    idx = torch.clamp((ends[:, None, :] <= t[None, :, None]).sum(-1), max=x.shape[1] - 1)
    frames = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    mask = torch.arange(T, device=x.device)[None, :] >= mel_len[:, None]
    return frames.masked_fill(mask[..., None], 0.0), mel_len, mask


# ------------------------------------------------------------ FastSpeech 2


class MultiHeadAttention(nn.Module):
    def __init__(self, n_head, d_model, scln, dropout):
        super().__init__()
        self.d_k = d_model // n_head
        self.w_qs = nn.Linear(d_model, d_model)
        self.w_ks = nn.Linear(d_model, d_model)
        self.w_vs = nn.Linear(d_model, d_model)
        self.fc = nn.Linear(d_model, d_model)
        self.dropout = Dropout(dropout)
        self.scln = scln
        self.layer_norm = SCLN(d_model) if scln else nn.LayerNorm(d_model)

    def forward(self, x, s, attn_mask):
        B, L, D = x.shape
        h = D // self.d_k
        q = self.w_qs(x).view(B, L, h, self.d_k)
        k = self.w_ks(x).view(B, L, h, self.d_k)
        v = self.w_vs(x).view(B, L, h, self.d_k)
        a = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / float(self.d_k) ** 0.5)
        a = torch.softmax(a.masked_fill(attn_mask[:, None], float("-inf")), dim=-1)
        out = self.dropout(self.fc(torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, L, D))) + x
        return self.layer_norm(out, s) if self.scln else self.layer_norm(out)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d, d_hid, ks, scln, dropout):
        super().__init__()
        self.w_1 = NLCConv1d(d, d_hid, ks[0], padding=(ks[0] - 1) // 2)
        self.w_2 = NLCConv1d(d_hid, d, ks[1], padding=(ks[1] - 1) // 2)
        self.dropout = Dropout(dropout)
        self.scln = scln
        self.layer_norm = SCLN(d) if scln else nn.LayerNorm(d)

    def forward(self, x, s):
        out = self.dropout(self.w_2(torch.relu(self.w_1(x)))) + x
        return self.layer_norm(out, s) if self.scln else self.layer_norm(out)


class FFTBlock(nn.Module):
    def __init__(self, d, n_head, d_inner, ks, scln, dropout):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d, scln, dropout)
        self.pos_ffn = PositionwiseFeedForward(d, d_inner, ks, scln, dropout)

    def forward(self, x, s, pad, attn_mask):
        out = self.slf_attn(x, s, attn_mask).masked_fill(pad[..., None], 0.0)
        return self.pos_ffn(out, s).masked_fill(pad[..., None], 0.0)


class Encoder(nn.Module):
    def __init__(self, n_phones, n_puncts, emb, pemb, layers, heads, filt, ks, dropout):
        super().__init__()
        self.d = emb + pemb
        self.pemb = pemb
        self.src_word_emb = nn.Embedding(n_phones + 1, emb)
        self.punct_embed = nn.Embedding(n_puncts + 1, pemb or emb)
        self.layer_stack = nn.ModuleList(FFTBlock(self.d, heads, filt, ks, False, dropout)
                                         for _ in range(layers))

    def forward(self, phonemes, puncts, pad):
        B, L = phonemes.shape
        e = self.src_word_emb(phonemes).masked_fill((phonemes == 0)[..., None], 0.0)
        p = self.punct_embed(puncts).masked_fill((puncts == 0)[..., None], 0.0)
        x = torch.cat([e, p], -1) if self.pemb > 0 else e + p
        x = x + position_table(L, self.d, x.device)[None]
        m = pad[:, None, :].expand(B, L, L)
        for layer in self.layer_stack:
            x = layer(x, None, pad, m)
        return x


class _ConvLayer(nn.Module):
    def __init__(self, d, filt, k, dropout):
        super().__init__()
        self.conv1d_1 = Conv(d, filt, k, (k - 1) // 2)
        self.layer_norm_1 = nn.LayerNorm(filt)
        self.conv1d_2 = Conv(filt, filt, k, 1)  # upstream pads by 1 whatever k
        self.layer_norm_2 = nn.LayerNorm(filt)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        x = self.dropout(self.layer_norm_1(torch.relu(self.conv1d_1(x))))
        return self.dropout(self.layer_norm_2(torch.relu(self.conv1d_2(x))))


class VariancePredictor(nn.Module):
    def __init__(self, d, filt, k, dropout):
        super().__init__()
        self.conv_layer = _ConvLayer(d, filt, k, dropout)
        self.linear_layer = nn.Linear(filt, 1)

    def forward(self, x, pad):
        return self.linear_layer(self.conv_layer(x))[..., 0].masked_fill(pad, 0.0)


class VarianceAdaptor(nn.Module):
    def __init__(self, d, filt, k, n_bins, dropout):
        super().__init__()
        self.n_bins = n_bins
        self.duration_predictor = VariancePredictor(d, filt, k, dropout)
        self.pitch_predictor = VariancePredictor(d, filt, k, dropout)
        self.energy_predictor = VariancePredictor(d, filt, k, dropout)
        self.pitch_embedding = nn.Embedding(n_bins, d)
        self.energy_embedding = nn.Embedding(n_bins, d)

    def _bins(self, v):
        return torch.clamp(torch.round(v * (self.n_bins - 1)).to(torch.int64), 0, self.n_bins - 1)

    def _flipped(self, bins, flips):
        """bins with row 0's phones i moved by flips[i] (the other rounding
        at a rounding edge), kept in range."""
        if flips:
            bins = bins.clone()
            for i, d in flips.items():
                bins[0, i] = min(max(int(bins[0, i]) + d, 0), self.n_bins - 1)
        return bins

    def forward(self, x, pad, pitch_t=None, energy_t=None, flips=None):
        """-> (x, log_duration, pitch, energy); the durations are the caller's.
        `flips`: {"pitch": {phone: +-1}, "energy": {...}} for row 0's bins."""
        flips = flips or {}
        log_d = self.duration_predictor(x, pad)
        pitch = self.pitch_predictor(x, pad)
        bins = self._bins(pitch if pitch_t is None else pitch_t)
        x = x + self.pitch_embedding(self._flipped(bins, flips.get("pitch")))
        energy = self.energy_predictor(x, pad)
        bins = self._bins(energy if energy_t is None else energy_t)
        x = x + self.energy_embedding(self._flipped(bins, flips.get("energy")))
        return x, log_d, pitch, energy


class PhonemeEncoder(nn.Module):
    def __init__(self, m, n_phones, n_puncts):
        super().__init__()
        e, dec = m["encoder"], m["decoder"]
        self._encoder = Encoder(n_phones, n_puncts, m["emb_dim"], m["punct_emb_dim"],
                                e["fs2_layer"], e["fs2_head"], dec["conv_filter_size"],
                                tuple(dec["conv_kernel_size"]), e["fs2_dropout"])
        self._variance_adaptor = VarianceAdaptor(m["emb_dim"] + m["punct_emb_dim"],
                                                 e["vp_filter_size"], e["vp_kernel_size"],
                                                 e["ve_n_bins"], e["vp_dropout"])


class FS2Decoder(nn.Module):
    def __init__(self, dec, d, n_mels):
        super().__init__()
        self.layer_stack = nn.ModuleList(
            FFTBlock(d, dec["n_head"], dec["conv_filter_size"], tuple(dec["conv_kernel_size"]),
                     dec["scln"], dec["dropout"]) for _ in range(dec["n_layers"]))
        self.mel_linear = nn.Linear(d, n_mels)

    def forward(self, x, mask, s):
        B, T, D = x.shape
        x = x + position_table(T, D, x.device)[None]
        m = mask[:, None, :].expand(B, T, T)
        for layer in self.layer_stack:
            x = layer(x, s, mask, m)
        return self.mel_linear(x)


# ------------------------------------------------------- StyleTTS decoder


class ResBlk1d(nn.Module):
    def __init__(self, din, dout, normalize=False, dropout=0.2):
        super().__init__()
        self.normalize = normalize
        self.learned_sc = din != dout
        self.conv1 = WeightNormConv1d(din, din, 3, 1)
        self.conv2 = WeightNormConv1d(din, dout, 3, 1)
        if normalize:
            self.norm1 = InstanceNorm(din, True)
            self.norm2 = InstanceNorm(din, True)
        if self.learned_sc:
            self.conv1x1 = WeightNormConv1d(din, dout, 1, bias=False)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        sc = self.conv1x1(x) if self.learned_sc else x
        h = self.norm1(x) if self.normalize else x
        h = self.conv1(self.dropout(F.leaky_relu(h, 0.2)))
        if self.normalize:
            h = self.norm2(h)
        h = self.conv2(self.dropout(F.leaky_relu(h, 0.2)))
        return (sc + h) / math.sqrt(2)


class AdaIN1d(nn.Module):
    def __init__(self, style_dim, c):
        super().__init__()
        self.c = c
        self.norm = InstanceNorm(c)
        self.fc = nn.Linear(style_dim, 2 * c)

    def forward(self, x, s):
        g, b = torch.split(self.fc(s), self.c, dim=-1)
        return (1 + g[:, None]) * self.norm(x) + b[:, None]


class AdainResBlk1d(nn.Module):
    def __init__(self, din, dout, style_dim, upsample=False):
        super().__init__()
        self.upsample = upsample
        self.learned_sc = din != dout
        self.conv1 = WeightNormConv1d(din, dout, 3, 1)
        self.conv2 = WeightNormConv1d(dout, dout, 3, 1)
        self.norm1 = AdaIN1d(style_dim, din)
        self.norm2 = AdaIN1d(style_dim, dout)
        if self.learned_sc:
            self.conv1x1 = WeightNormConv1d(din, dout, 1, bias=False)
        self.dropout = Dropout(0.0)

    def forward(self, x, s):
        sc = self.conv1x1(x) if self.learned_sc else x
        h = self.conv1(self.dropout(F.leaky_relu(self.norm1(x, s), 0.2)))
        h = self.conv2(self.dropout(F.leaky_relu(self.norm2(h, s), 0.2)))
        return (h + sc) / math.sqrt(2)


class StyleTTSDecoder(nn.Module):
    def __init__(self, d, style_dim, residual_dim=64, dout=80):
        super().__init__()
        bn = 2 * d
        self.encode = nn.ModuleList([ResBlk1d(d, bn, True), ResBlk1d(bn, bn, True)])
        self.asr_res = nn.Sequential(WeightNormConv1d(d, residual_dim, 1),
                                     InstanceNorm(residual_dim, True))
        specs = [(bn + residual_dim, bn, False), (bn + residual_dim, bn, False),
                 (bn + residual_dim, d, True), (d, d, False), (d, d, False)]
        self.decode = nn.ModuleList(AdainResBlk1d(a, b, style_dim, u) for a, b, u in specs)
        self.to_out = nn.Sequential(WeightNormConv1d(d, dout, 1))

    def forward(self, enc, mask, spk):
        s = spk[:, 0, :]
        x = enc
        for blk in self.encode:
            x = blk(x)
        res = self.asr_res(enc)
        cat = True
        for blk in self.decode:
            if cat:
                x = torch.cat([x, res], -1)
            x = blk(x, s)
            if blk.upsample:
                cat = False
        return self.to_out(x)


# ------------------------------------------------------ speaker encoder


def batch_norm(bn, x, train):
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, train,
                        bn.momentum, bn.eps)


class SELayer(nn.Module):
    def __init__(self, c, reduction=8):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(c, max(1, c // reduction)), nn.ReLU(),
                                nn.Linear(max(1, c // reduction), c), nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class SEBasicBlock(nn.Module):
    def __init__(self, cin, c, stride=1, downsample=False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, c, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(c)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(c)
        self.se = SELayer(c)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, c, 1, stride=stride, bias=False),
                                         nn.BatchNorm2d(c)) if downsample else None)

    def forward(self, x, train):
        out = batch_norm(self.bn1, torch.relu(self.conv1(x)), train)
        out = self.se(batch_norm(self.bn2, self.conv2(out), train))
        res = x if self.downsample is None else batch_norm(self.downsample[1],
                                                            self.downsample[0](x), train)
        return torch.relu(out + res)


class ResNetSE34V2(nn.Module):
    def __init__(self, layers, filters, n_out, encoder_type, n_mels):
        super().__init__()
        self.encoder_type = encoder_type
        self.conv1 = nn.Conv2d(1, filters[0], 3, padding=1)
        self.bn1 = nn.BatchNorm2d(filters[0])
        cin = filters[0]
        self.stages = len(layers)
        for i, (n, c) in enumerate(zip(layers, filters)):
            stride = 1 if i == 0 else 2
            blocks = []
            for b in range(n):
                s = stride if b == 0 else 1
                blocks.append(SEBasicBlock(cin, c, s, b == 0 and (s != 1 or cin != c)))
                cin = c
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        outmap = filters[-1] * (n_mels // 8)
        self.attention = nn.Sequential(nn.Conv1d(outmap, 128, 1), nn.ReLU(), nn.BatchNorm1d(128),
                                       nn.Conv1d(128, outmap, 1), nn.Softmax(dim=2))
        self.fc = nn.Linear(outmap * (2 if encoder_type == "ASP" else 1), n_out)

    def forward(self, x, train=False):
        x = instance_norm_time(x).transpose(1, 2)[:, None]
        x = batch_norm(self.bn1, torch.relu(self.conv1(x)), train)
        for i in range(self.stages):
            for blk in getattr(self, f"layer{i + 1}"):
                x = blk(x, train)
        B, C, H, W = x.shape
        x = x.reshape(B, C * H, W)
        a = self.attention
        w = a[4](a[3](batch_norm(a[2], a[1](a[0](x)), train)))
        if self.encoder_type == "SAP":
            pooled = torch.sum(x * w, dim=2)
        else:
            mu = torch.sum(x * w, dim=2)
            sg = torch.sqrt(torch.clamp(torch.sum(x * x * w, dim=2) - mu * mu, min=1e-5))
            pooled = torch.cat([mu, sg], dim=1)
        out = self.fc(pooled)
        out = out / torch.clamp(torch.linalg.vector_norm(out, dim=1, keepdim=True), min=1e-12)
        return out[:, None, :]


# ------------------------------------------------------------ ZeroVox


class ZeroVox(nn.Module):
    """The acoustic model; `cfg` is a configuration file's dict."""

    def __init__(self, cfg):
        super().__init__()
        m, a = cfg["model"], cfg["audio"]
        n_phones, n_puncts = len(m["phones"]), len(m["puncts"]) + 1
        self.d = m["emb_dim"] + m["punct_emb_dim"]
        self._phoneme_encoder = PhonemeEncoder(m, n_phones, n_puncts)
        r = m["resnet"]
        self._spkemb = ResNetSE34V2(tuple(r["layers"]), tuple(r["num_filters"]), self.d,
                                    r["encoder_type"], a["num_mels"])
        dec = m["decoder"]
        if dec["kind"] == "fastspeech2":
            self._mel_decoder = FS2Decoder(dec, self.d, a["num_mels"])
        else:
            self._mel_decoder = StyleTTSDecoder(self.d, self.d, 64, a["num_mels"])

    def encode(self, phonemes, puncts, spk, pad, pitch_t=None, energy_t=None, flips=None):
        """-> (x, log_duration, pitch, energy) at the text bucket."""
        enc = self._phoneme_encoder
        x = enc._encoder(phonemes, puncts, pad) + spk
        return enc._variance_adaptor(x, pad, pitch_t, energy_t, flips)

    def decode(self, x, durations, spk, T, mel_mask=None):
        frames, mel_len, mask = length_regulate(x, durations, T)
        if mel_mask is not None:
            mask = mel_mask
        mel = self._mel_decoder(frames, mask, spk)
        return mel.masked_fill(mask[..., None], 0.0), mel_len


def round_durations(log_d, pad):
    """The inference rule: round(exp(log d) - 1), half to even, floored at 0."""
    d = torch.clamp(torch.round(torch.exp(log_d) - 1.0), min=0.0)
    return d.to(torch.int32).masked_fill(pad, 0)


def zerovox_loss(pred, batch):
    """Masked L1 on mel, masked MSE on pitch, energy and log(d + 1), weighted 10/2/2/1."""
    def mmean(v, keep):
        keep = keep.expand(v.shape).to(v.dtype)
        return torch.sum(v * keep) / torch.clamp(torch.sum(keep), min=1.0)

    mk, pk = ~batch["mel_mask"], ~batch["phoneme_mask"]
    mel = mmean(torch.abs(pred["mel"] - batch["mel"]), mk[..., None])
    pitch = mmean((pred["pitch"] - batch["pitch"]) ** 2, pk)
    energy = mmean((pred["energy"] - batch["energy"]) ** 2, pk)
    dur = mmean((pred["log_duration"] - torch.log(batch["duration"].float() + 1.0)) ** 2, pk)
    return 10.0 * mel + 2.0 * pitch + 2.0 * energy + dur


def train_forward(model, batch):
    """The teacher-forced training forward -> prediction dict."""
    spk = model._spkemb(batch["ref_mel"], train=True)
    x, log_d, pitch, energy = model.encode(batch["phoneme"], batch["puncts"], spk,
                                           batch["phoneme_mask"], batch["pitch"], batch["energy"])
    mel, _ = model.decode(x, batch["duration"], spk, batch["mel_mask"].shape[1],
                          mel_mask=batch["mel_mask"])
    return {"mel": mel, "pitch": pitch, "energy": energy, "log_duration": log_d}


# ------------------------------------------------------------ HiFi-GAN


def _pad(k, d=1):
    return (k * d - d) // 2


class ResBlock1(nn.Module):
    def __init__(self, c, k, dils):
        super().__init__()
        self.dils = tuple(dils)
        self.convs1 = nn.ModuleList(nn.Conv1d(c, c, k, padding=_pad(k, d), dilation=d)
                                    for d in dils)
        self.convs2 = nn.ModuleList(nn.Conv1d(c, c, k, padding=_pad(k)) for _ in dils)

    def forward(self, x):  # NCL
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE)) + x
        return x


class Generator(nn.Module):
    def __init__(self, h):
        super().__init__()
        self.h = h
        c0 = h["upsample_initial_channel"]
        self.nk = len(h["resblock_kernel_sizes"])
        self.conv_pre = nn.Conv1d(h["num_mels"], c0, 7, padding=3)
        self.ups = nn.ModuleList(
            nn.ConvTranspose1d(c0 // 2 ** i, c0 // 2 ** (i + 1), k, stride=u, padding=(k - u) // 2)
            for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])))
        self.resblocks = nn.ModuleList(
            ResBlock1(c0 // 2 ** (i + 1), k, d) for i in range(len(h["upsample_rates"]))
            for k, d in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]))
        self.conv_post = nn.Conv1d(c0 // 2 ** len(h["upsample_rates"]), 1, 7, padding=3)

    def forward(self, mel):  # [B, T, n_mels] -> [B, T * hop]
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            x = sum(self.resblocks[i * self.nk + j](x) for j in range(self.nk)) / self.nk
        return torch.tanh(self.conv_post(F.leaky_relu(x, 0.01)))[:, 0, :]


class MelDec(nn.Module):
    def __init__(self, h):
        super().__init__()
        self.generator = Generator(h)
        self.register_buffer("mean", torch.zeros(h["num_mels"]))
        self.register_buffer("scale", torch.ones(h["num_mels"]))

    def forward(self, mel):
        return self.generator(mel)


# ------------------------------------------------------------ mel frontend


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    sp, lo = 200.0 / 3, 1000.0
    step = np.log(6.4) / 27.0
    return np.where(f >= lo, lo / sp + np.log(np.maximum(f, 1e-10) / lo) / step, f / sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    sp, lo = 200.0 / 3, 1000.0
    step = np.log(6.4) / 27.0
    return np.where(m >= lo / sp, lo * np.exp(step * (m - lo / sp)), m * sp)


def mel_filterbank(sr, n_fft, n_mels, fmin, fmax):
    """Slaney-scale, area-normalized filterbank [n_mels, 1 + n_fft // 2] (librosa's default)."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fd = np.diff(mel_f)
    ramps = mel_f[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fd[:-1, None], ramps[2:] / fd[1:, None]))
    w *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return w.astype(np.float32)


def log_mel(wav, audio, device):
    """wav [N] -> log-mel [T, n_mels]: reflect pad (fft - hop) / 2, periodic
    Hann frames (center off), |rfft|, Slaney mel, log(max(., 1e-5))."""
    n_fft, hop = audio["fft_size"], audio["hop_size"]
    pad = (n_fft - hop) // 2
    x = torch.tensor(np.pad(np.asarray(wav, np.float32), (pad, pad), mode="reflect"),
                     device=device)
    n = np.arange(audio["win_length"], dtype=np.float64)
    win = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / audio["win_length"])).astype(np.float32)
    lp = (n_fft - audio["win_length"]) // 2
    win = torch.tensor(np.pad(win, (lp, n_fft - audio["win_length"] - lp)), device=device)
    fb = torch.tensor(mel_filterbank(audio["sampling_rate"], n_fft, audio["num_mels"],
                                     audio["fmin"], audio["fmax"]), device=device)
    mags = torch.abs(torch.fft.rfft(x.unfold(0, n_fft, hop) * win[None], n=n_fft, dim=-1)).T
    return torch.log(torch.clamp(fb @ mags, min=1e-5)).T


def trim_silence(audio, top_db=40.0, frame=2048, hop=512):
    """librosa.effects.trim: drop leading and trailing frames more than
    top_db below the loudest frame's power (centered RMS frames)."""
    yp = np.pad(audio, (frame // 2, frame // 2))
    nf = 1 + (len(yp) - frame) // hop
    if nf <= 0:
        return audio
    idx = (np.arange(nf) * hop)[:, None] + np.arange(frame)[None, :]
    power = np.mean(yp[idx] ** 2, axis=1)
    if power.max() <= 0:
        return audio
    db = 10.0 * np.log10(np.maximum(power / power.max(), 1e-20))
    keep = np.flatnonzero(db > -top_db)
    if keep.size == 0:
        return audio
    return audio[int(keep[0]) * hop: min(len(audio), int(keep[-1] + 1) * hop)]
