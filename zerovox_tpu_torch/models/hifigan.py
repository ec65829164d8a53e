"""HiFi-GAN vocoder ("meldec"): the generator, and the discriminators and
GAN losses its training uses.

The PyTorch counterpart of the JAX package's `models/hifigan.py`: conv_pre
-> per stage [leaky-relu, ConvTranspose1d upsample, multi-receptive-field
(MRF) mean of dilated ResBlocks] -> leaky-relu(0.01) -> conv_post -> tanh.
Module names follow the upstream generator state_dict (`conv_pre`, `ups.i`,
`resblocks.n.convs1.c`, `conv_post`), with weight norm already folded.

`Generator(cfg)` runs its `nn.Module`s (differentiable on both devices; on
the card, cuDNN). `Generator(cfg, use_pallas=True)`, the reference's switch,
routes stages to the fused kernels by the JAX Generator's rules, so both
packages send the same stage to the same kernel:

  * a stage whose channels satisfy the lane-packing condition (C_out <= 64,
    128 % C_in == 0, stride * (128 // C_in) * C_out == 128) runs as one
    fused upsample stage (ops/upsample_stage.py); the last stage also folds
    in leaky(0.01) + conv_post + tanh;
  * else a stage with C <= 128 at batch 1 (any batch with
    `pallas_all_batches`) runs its MRF as one fused kernel (ops/mrf.py);
  * else, for ResBlock1 towers at C <= 128 under the same batch rule, each
    tower is one fused ResBlock1 kernel (ops/resblock.py) and the stage
    averages them;
  * else plain convolutions.

Every stage these rules send to a kernel runs on it, at any width: the
kernels are built for C of 8, 16, 32, 64 and 128 (K1, K3) and (16, 8) to
(128, 64) (K2), and a stage between them runs zero-padded to the next, as
the JAX kernels pad to their 128 lanes (the weights once, in
`_stage_kernel_params`' cache; the activations per call). HiFi-GAN V2
(128 channels) takes K1 at 64 and 32 and K2 at (32, 16) and (16, 8).

The two MRF-wide paths need identical dilation schedules across several
towers (`mrf_fusable`). With the default config (512 channels, rates
8,8,2,2) stage 0 is plain, stage 1 takes the MRF kernel and stages 2-3 the
upsample-stage kernel. A single-tower vocoder (or one whose towers'
dilations differ) runs stages of C <= 128 tower by tower through the
ResBlock1 kernel. The kernels have no backward: their route raises when
grad is enabled and the stage's input or a parameter requires grad.

`MultiPeriodDiscriminator`, `MultiScaleDiscriminator` and the LSGAN
losses are the upstream HiFi-GAN ones, keyed as its state_dict
(`discriminators.{i}.convs.{j}`, `conv_post`; Conv2d for the period
discriminators, grouped Conv1d for the scale ones), for
`training/vocoder.py`.

The Generator runs in the dtype of its parameters: cast to bf16 (the
engine's bf16 inference), the plain stages run torch's bf16 convolutions and
the kernels their bf16 variants (float32 inside, each stage's output rounded
to bf16), as the JAX Generator does under bf16 variables.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F

from zerovox_tpu_torch.ops.mrf import LRELU_SLOPE, fused_mrf, pack_towers, resblock1_ncl
from zerovox_tpu_torch.ops.resblock import fused_resblock1
from zerovox_tpu_torch.ops.upsample_stage import fused_upsample_stage, pack_upsampler


@dataclass(frozen=True)
class HifiGanConfig:
    """The part of the HiFi-GAN config.json contract the generator needs."""

    resblock: str = "1"
    upsample_rates: tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80
    sampling_rate: int = 22050

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "HifiGanConfig":
        def tt(v):
            return tuple(tuple(x) if isinstance(x, list) else x for x in v)

        return HifiGanConfig(
            resblock=str(d.get("resblock", "1")),
            upsample_rates=tuple(d.get("upsample_rates", (8, 8, 2, 2))),
            upsample_kernel_sizes=tuple(d.get("upsample_kernel_sizes", (16, 16, 4, 4))),
            upsample_initial_channel=int(d.get("upsample_initial_channel", 512)),
            resblock_kernel_sizes=tuple(d.get("resblock_kernel_sizes", (3, 7, 11))),
            resblock_dilation_sizes=tt(d.get("resblock_dilation_sizes", ((1, 3, 5),) * 3)),
            num_mels=int(d.get("num_mels", 80)),
            sampling_rate=int(d.get("sampling_rate", 22050)),
        )

    @property
    def total_upsample(self) -> int:
        return math.prod(self.upsample_rates)

    def receptive_field_frames(self) -> int:
        """Halo in mel frames that a streamed window needs on each side so
        its interior samples equal a full-utterance render (conservative)."""
        halo = 3.0  # conv_pre k=7
        up = 1.0
        for r, k in zip(self.upsample_rates, self.upsample_kernel_sizes):
            up *= r
            halo += (k - r) / 2 / up * 2
            for ks, dils in zip(self.resblock_kernel_sizes, self.resblock_dilation_sizes):
                halo += (sum((ks - 1) * d for d in dils) + len(dils) * (ks - 1)) / up
        halo += 3.0 / up  # conv_post
        return int(math.ceil(halo))


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilation=(1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, d),
                      dilation=d) for d in self.dilation)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size))
            for _ in self.dilation)

    def forward(self, x):  # NCL
        return resblock1_ncl(x, [(c.weight, c.bias) for c in self.convs1],
                             [(c.weight, c.bias) for c in self.convs2], self.dilation)

    def tower(self):
        """(w1 [P, k, C, C], b1 [P, C], w2, b2) with taps (k, in, out), the
        layout of the fused kernels."""
        def stack(convs):
            return (torch.stack([c.weight.permute(2, 1, 0) for c in convs]).contiguous(),
                    torch.stack([c.bias for c in convs]).contiguous())

        return stack(self.convs1) + stack(self.convs2)


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilation=(1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, d),
                      dilation=d) for d in dilation)

    def forward(self, x):  # NCL
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


class Generator(nn.Module):
    """mel [B, T, n_mels] (NLC) -> waveform [B, T * prod(upsample_rates)].

    `use_pallas` and `pallas_all_batches` keep the JAX Generator's names:
    here they route stages to the port's CUDA kernels (on a CPU tensor, to
    the kernels' plain versions), at batch 1 or, with `pallas_all_batches`,
    at every batch size. Off (the default), every stage runs the
    nn.Modules."""

    def __init__(self, cfg: HifiGanConfig, use_pallas: bool = False,
                 pallas_all_batches: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_pallas = use_pallas
        self.pallas_all_batches = pallas_all_batches
        nk = len(cfg.resblock_kernel_sizes)
        c0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, c0, 7, padding=3)
        self.ups = nn.ModuleList(
            nn.ConvTranspose1d(c0 // 2 ** i, c0 // 2 ** (i + 1), k, stride=u, padding=(k - u) // 2)
            for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)))
        block = ResBlock1 if cfg.resblock == "1" else ResBlock2
        self.resblocks = nn.ModuleList(
            block(c0 // 2 ** (i + 1), k, tuple(d))
            for i in range(len(cfg.upsample_rates))
            for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))
        self.conv_post = nn.Conv1d(c0 // 2 ** len(cfg.upsample_rates), 1, 7, padding=3)
        dil0 = tuple(cfg.resblock_dilation_sizes[0])
        self._dil0 = dil0
        self._mrf_fusable = (cfg.resblock == "1" and nk > 1
                             and all(tuple(d) == dil0 for d in cfg.resblock_dilation_sizes))
        self._kcache: dict[int, tuple] = {}

    def _stage_kernel_params(self, i: int, post: bool, x: torch.Tensor):
        """Kernel-layout weights of stage i (the plain layouts and the
        kernels' MMA fragment order, zero-padded to the kernel's width: all
        towers for K1/K2, each tower for K3, in the parameters' dtype),
        rebuilt only when a parameter was
        replaced or written to (device move, dtype cast, load_state_dict).
        Raises when autograd would need the stage's gradients: the kernels
        have none."""
        nk = len(self.cfg.resblock_kernel_sizes)
        blocks = [self.resblocks[i * nk + j] for j in range(nk)]
        mods = [self.ups[i], *blocks] + ([self.conv_post] if post else [])
        if torch.is_grad_enabled() and (x.requires_grad or any(
                p.requires_grad for m in mods for p in m.parameters())):
            raise RuntimeError(
                f"Generator(use_pallas=True): stage {i} runs a fused kernel, which has no "
                "backward; run it under torch.no_grad() or inference_mode, or build the "
                "Generator with use_pallas=False to train")
        key = tuple((p.data_ptr(), p._version, p.dtype) for m in mods for p in m.parameters())
        hit = self._kcache.get(i)
        if hit is not None and hit[0] == key:
            return hit[1]
        with torch.no_grad():
            up = self.ups[i]
            towers = [b.tower() for b in blocks]
            params = {
                # torch (in, out, k) -> taps (k, in, out), not flipped
                "up": pack_upsampler(up.weight.permute(2, 0, 1).contiguous(), up.bias.detach(),
                                     up.stride[0]),
                "mrf": pack_towers(towers) if self._mrf_fusable else None,
                "towers": [pack_towers([t]) for t in towers] if not self._mrf_fusable else None,
                "post": ((self.conv_post.weight.permute(2, 1, 0).contiguous(),
                          self.conv_post.bias.detach()) if post else None),
            }
        self._kcache[i] = (key, params)
        return params

    def forward(self, mel):
        cfg = self.cfg
        nk = len(cfg.resblock_kernel_sizes)
        ksizes = tuple(cfg.resblock_kernel_sizes)
        n_stages = len(cfg.upsample_rates)
        x = self.conv_pre(mel.transpose(1, 2))  # NCL until a fused stage takes over
        nlc = False
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            in_ch = x.shape[-1] if nlc else x.shape[1]
            ch = cfg.upsample_initial_channel // 2 ** (i + 1)
            packed_ok = (self.use_pallas and self._mrf_fusable and ch <= 64
                         and 128 % in_ch == 0 and u * (128 // in_ch) * ch == 128)
            if packed_ok:
                last = i == n_stages - 1
                p = self._stage_kernel_params(i, last, x)
                if not nlc:
                    x, nlc = x.transpose(1, 2).contiguous(), True
                x = fused_upsample_stage(x, p["up"], (k - u) // 2, p["mrf"], self._dil0, ksizes,
                                         post=p["post"])
                if last:
                    return x
                continue

            if nlc:
                x, nlc = x.transpose(1, 2), False
            x = self.ups[i](F.leaky_relu(x, LRELU_SLOPE))
            pallas_ok = (self.use_pallas and ch <= 128
                         and (mel.shape[0] == 1 or self.pallas_all_batches))
            if pallas_ok and self._mrf_fusable:
                mrf = self._stage_kernel_params(i, False, x)["mrf"]
                x, nlc = fused_mrf(x.transpose(1, 2).contiguous(), mrf, self._dil0, ksizes), True
                continue
            if pallas_ok and cfg.resblock == "1":
                xn = x.transpose(1, 2).contiguous()
                xs = None
                for pk, dil in zip(self._stage_kernel_params(i, False, x)["towers"],
                                   cfg.resblock_dilation_sizes):
                    r = fused_resblock1(xn, *pk.towers[0], tuple(dil), packed=pk)
                    xs = r if xs is None else xs + r
                x, nlc = xs / nk, True
                continue
            xs = None
            for j in range(nk):
                r = self.resblocks[i * nk + j](x)
                xs = r if xs is None else xs + r
            x = xs / nk

        if nlc:
            x = x.transpose(1, 2)
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0, :]


class MelDec(nn.Module):
    """Vocoder wrapper carrying the mel normalization stats some upstream
    checkpoints embed (`mean`, `scale`; identity by default). The synthesis
    path calls it with normalize_before=False, as the JAX package does.
    `use_pallas`, `pallas_all_batches`: the Generator's kernel route.
    `subbands` > 1: the generator emits that many stacked subband signals,
    which PQMF synthesis (ops/pqmf.py) recombines into the full-band
    waveform, as legacy multi-band MelGAN-family vocoders do."""

    def __init__(self, cfg: HifiGanConfig, use_pallas: bool = False,
                 pallas_all_batches: bool = False, subbands: int = 1):
        super().__init__()
        self.cfg = cfg
        self.subbands = subbands
        self.generator = Generator(cfg, use_pallas, pallas_all_batches)
        self.register_buffer("mean", torch.zeros(cfg.num_mels))
        self.register_buffer("scale", torch.ones(cfg.num_mels))
        self._pqmf = None

    def forward(self, mel, normalize_before: bool = False):
        if normalize_before:
            mel = (mel - self.mean) / self.scale
        wav = self.generator(mel)
        if self.subbands > 1:
            from zerovox_tpu_torch.ops.pqmf import PQMF

            if self._pqmf is None:
                self._pqmf = PQMF(self.subbands)
            # stacked subband signals [B, T * S] -> [B, T, S]
            B, N = wav.shape
            wav = self._pqmf.synthesis(wav.reshape(B, N // self.subbands, self.subbands))
        return wav


# --------------------------------------------------------------- discriminators


class DiscriminatorP(nn.Module):
    """Period discriminator (upstream HiFi-GAN): the waveform [B, T] folded
    into [B, 1, T / period, period] (reflect-padded to a multiple of the
    period), five Conv2d over time and a 3-tap conv_post. Returns (logits
    [B, -1], the six feature maps in NCHW)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        chans = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            nn.Conv2d(ci, co, (kernel_size, 1), (stride, 1), padding=(get_padding(5, 1), 0))
            for ci, co in zip(chans, chans[1:]))
        self.convs.append(nn.Conv2d(1024, 1024, (kernel_size, 1), 1, padding=(2, 0)))
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), 1, padding=(1, 0))

    def forward(self, x):
        fmap = []
        B, t = x.shape
        if t % self.period != 0:
            n_pad = self.period - t % self.period
            x = F.pad(x[:, None], (0, n_pad), mode="reflect")[:, 0]
            t += n_pad
        x = x.reshape(B, 1, t // self.period, self.period)
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(B, -1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator (upstream HiFi-GAN): seven (grouped) Conv1d over
    the waveform [B, T] and a 3-tap conv_post. Returns (logits [B, -1], the
    eight feature maps in NCL)."""

    # (out channels, kernel, stride, groups, padding) of each conv
    SPECS = ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20),
             (512, 41, 4, 16, 20), (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20),
             (1024, 5, 1, 1, 2))

    def __init__(self):
        super().__init__()
        ins = (1,) + tuple(sp[0] for sp in self.SPECS[:-1])
        self.convs = nn.ModuleList(nn.Conv1d(ci, co, k, s, groups=g, padding=p)
                                   for ci, (co, k, s, g, p) in zip(ins, self.SPECS))
        self.conv_post = nn.Conv1d(1024, 1, 3, 1, padding=1)

    def forward(self, x):
        fmap = []
        y = x[:, None]
        for conv in self.convs:
            y = F.leaky_relu(conv(y), LRELU_SLOPE)
            fmap.append(y)
        y = self.conv_post(y)
        fmap.append(y)
        return y.reshape(y.shape[0], -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """One DiscriminatorP per period over the real y and the generated
    y_hat [B, T]: (real logits, fake logits, real fmaps, fake fmaps), one
    entry per period."""

    def __init__(self, periods: tuple[int, ...] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.periods = tuple(periods)
        self.discriminators = nn.ModuleList(DiscriminatorP(p) for p in self.periods)

    def forward(self, y, y_hat):
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            r, fr = d(y)
            g, fg = d(y_hat)
            y_d_rs.append(r)
            y_d_gs.append(g)
            fmap_rs.append(fr)
            fmap_gs.append(fg)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


def _avg_pool1d(x):
    """torch AvgPool1d(4, 2, padding=2) with count_include_pad=True over [B, T]."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=2, count_include_pad=True)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    """One DiscriminatorS per scale, scale i on the waveforms average-pooled
    i times; outputs as MultiPeriodDiscriminator's."""

    def __init__(self, num_scales: int = 3):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorS() for _ in range(num_scales))

    def forward(self, y, y_hat):
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for i, d in enumerate(self.discriminators):
            if i != 0:
                y, y_hat = _avg_pool1d(y), _avg_pool1d(y_hat)
            r, fr = d(y)
            g, fg = d(y_hat)
            y_d_rs.append(r)
            y_d_gs.append(g)
            fmap_rs.append(fr)
            fmap_gs.append(fg)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


# --------------------------------------------------------------------- losses


def feature_loss(fmap_r, fmap_g):
    """2 x the sum over discriminators and layers of mean |real - fake|."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    """LSGAN discriminator loss: sum of mean (1 - real)^2 + mean fake^2;
    returns (loss, real terms, fake terms)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1 - dr) ** 2)
        g_loss = torch.mean(dg ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """LSGAN generator loss: sum of mean (1 - fake)^2; returns (loss, terms)."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        term = torch.mean((1 - dg) ** 2)
        gen_losses.append(term)
        loss = loss + term
    return loss, gen_losses
