"""FastSpeech2-style acoustic model: FFT-block encoder, variance adaptor with
static-shape length regulation, and FFT-block mel decoder with
speaker-conditional LayerNorm.

The PyTorch counterpart of the JAX package's `models/fs2.py` with
its training forward: dropout (flax's rule, `layers.Dropout`, active in
train mode), teacher pitch, energy and duration, and `remat` (each FFT
block recomputed in the backward, `layers.remat`). It runs in the dtype of
its parameters and inputs (bf16 in bf16-mixed training): the position
tables are cast to the activations' dtype, as the JAX module does, and the
pitch/energy bins come from the targets in that dtype. Module names follow the
upstream state_dict keys (`_phoneme_encoder._encoder.layer_stack.0.slf_attn.w_qs.weight`,
...). Attention runs the heads its q, k, v projections give it (this rank's
under tensor parallelism, parallel/tensor.py) on one of two paths, chosen
as the JAX module chooses (`flash_eligible`): the einsum path (-inf key
mask, softmax in float32), or under ZEROVOX_ATTN=flash at lengths that are
multiples of 128 from 256 up, flash attention (`ops.flash_attention`, kernel
K5 on the card) with the pad mask as segment ids. The two agree on valid
positions; padded positions are zeroed after every block.
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn

from zerovox_tpu_torch.config import DecoderConfig, ModelConfig
from zerovox_tpu_torch.models.layers import SCLN, Conv, Dropout, NLCConv1d, position_table, remat
from zerovox_tpu_torch.ops.flash_attention import flash_attention
from zerovox_tpu_torch.ops.length_regulator import length_regulate
from zerovox_tpu_torch.symbols import Symbols


def flash_eligible(seq_len: int) -> bool:
    """Whether attention over seq_len positions takes flash attention:
    only under ZEROVOX_ATTN=flash (unset, `auto`, `einsum` or any other
    value: the einsum path), at lengths that are multiples of 128 from 256
    up (the JAX package's `_flash_eligible`)."""
    if os.environ.get("ZEROVOX_ATTN", "auto") != "flash":
        return False
    return seq_len % 128 == 0 and seq_len >= 256


class MultiHeadAttention(nn.Module):
    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int, scln: bool,
                 dropout: float = 0.0):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_qs = nn.Linear(d_model, n_head * d_k)
        self.w_ks = nn.Linear(d_model, n_head * d_k)
        self.w_vs = nn.Linear(d_model, n_head * d_v)
        self.fc = nn.Linear(n_head * d_v, d_model)
        self.dropout = Dropout(dropout)
        self.scln = scln
        self.layer_norm = SCLN(d_model) if scln else nn.LayerNorm(d_model)

    def forward(self, x, spk_emb, attn_mask, pad_mask=None):
        B, L, _ = x.shape
        q = self.w_qs(x)
        # the heads present: all of them, or this rank's under tensor parallelism
        h = q.shape[-1] // self.d_k
        q = q.view(B, L, h, self.d_k)
        k = self.w_ks(x).view(B, L, h, self.d_k)
        v = self.w_vs(x).view(B, L, h, self.d_v)
        scale = 1.0 / float(self.d_k) ** 0.5
        if self.d_k == self.d_v and pad_mask is not None and flash_eligible(L):
            # pads form their own segment: valid queries never see them, pad
            # queries see pads only (their rows are zeroed by the caller)
            o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                pad_mask.to(torch.int32), scale)
            out = o.transpose(1, 2).reshape(B, L, h * self.d_v)
        else:
            attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
            if attn_mask is not None:
                attn = attn.masked_fill(attn_mask[:, None, :, :], float("-inf"))
            attn = torch.softmax(attn, dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, L, h * self.d_v)
        out = self.dropout(self.fc(out)) + x
        return self.layer_norm(out, spk_emb) if self.scln else self.layer_norm(out)


class PositionwiseFeedForward(nn.Module):
    """conv(k0) -> relu -> conv(k1), residual, (SC)LN."""

    def __init__(self, d_in: int, d_hid: int, kernel_size, scln: bool, dropout: float = 0.0):
        super().__init__()
        self.w_1 = NLCConv1d(d_in, d_hid, kernel_size[0], padding=(kernel_size[0] - 1) // 2)
        self.w_2 = NLCConv1d(d_hid, d_in, kernel_size[1], padding=(kernel_size[1] - 1) // 2)
        self.dropout = Dropout(dropout)
        self.scln = scln
        self.layer_norm = SCLN(d_in) if scln else nn.LayerNorm(d_in)

    def forward(self, x, spk_emb):
        out = self.dropout(self.w_2(torch.relu(self.w_1(x)))) + x
        return self.layer_norm(out, spk_emb) if self.scln else self.layer_norm(out)


def run_blocks(layers, x, spk_emb, pad_mask, attn_mask, checkpointed: bool):
    for layer in layers:
        if checkpointed:
            x = remat(layer, x, spk_emb, pad_mask, attn_mask)
        else:
            x = layer(x, spk_emb, pad_mask, attn_mask)
    return x


class FFTBlock(nn.Module):
    def __init__(self, d_model, n_head, d_k, d_v, d_inner, kernel_size, scln, dropout=0.0):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, d_k, d_v, scln, dropout)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, kernel_size, scln, dropout)

    def forward(self, x, spk_emb, pad_mask, attn_mask):
        out = self.slf_attn(x, spk_emb, attn_mask, pad_mask).masked_fill(pad_mask[..., None], 0.0)
        return self.pos_ffn(out, spk_emb).masked_fill(pad_mask[..., None], 0.0)


class Encoder(nn.Module):
    """Phone + punctuation embedding -> positions -> FFT blocks (no SCLN)."""

    def __init__(self, num_phones, num_puncts, embed_dim, punct_embed_dim, n_layers,
                 n_head, conv_filter_size, conv_kernel_size, dropout: float = 0.0,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.d_model = embed_dim + punct_embed_dim
        self.punct_embed_dim = punct_embed_dim
        d_k = self.d_model // n_head
        self.src_word_emb = nn.Embedding(num_phones + 1, embed_dim)
        # punct_emb_dim 0: punctuation is added to the phone embedding
        self.punct_embed = nn.Embedding(num_puncts + 1, punct_embed_dim or embed_dim)
        self.layer_stack = nn.ModuleList(
            FFTBlock(self.d_model, n_head, d_k, d_k, conv_filter_size,
                     tuple(conv_kernel_size), scln=False, dropout=dropout)
            for _ in range(n_layers))

    def forward(self, phonemes, puncts, pad_mask):
        B, L = phonemes.shape
        # upstream padding_idx=0: id 0 embeds to zero whatever the table's row 0 holds
        emb = self.src_word_emb(phonemes).masked_fill((phonemes == 0)[..., None], 0.0)
        pemb = self.punct_embed(puncts).masked_fill((puncts == 0)[..., None], 0.0)
        x = torch.cat([emb, pemb], dim=-1) if self.punct_embed_dim > 0 else emb + pemb
        x = x + position_table(L, self.d_model, x.device, x.dtype)[None]
        attn_mask = pad_mask[:, None, :].expand(B, L, L)
        return run_blocks(self.layer_stack, x, None, pad_mask, attn_mask,
                          self.remat and torch.is_grad_enabled())


class _ConvLayer(nn.Module):
    """The upstream predictor's `conv_layer` Sequential, by child name."""

    def __init__(self, d_in: int, filter_size: int, kernel_size: int, dropout: float):
        super().__init__()
        self.conv1d_1 = Conv(d_in, filter_size, kernel_size, padding=(kernel_size - 1) // 2)
        self.layer_norm_1 = nn.LayerNorm(filter_size)
        # upstream quirk: conv1d_2 pads by 1 whatever the kernel size
        self.conv1d_2 = Conv(filter_size, filter_size, kernel_size, padding=1)
        self.layer_norm_2 = nn.LayerNorm(filter_size)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        x = self.dropout(self.layer_norm_1(torch.relu(self.conv1d_1(x))))
        return self.dropout(self.layer_norm_2(torch.relu(self.conv1d_2(x))))


class VariancePredictor(nn.Module):
    def __init__(self, d_in: int, filter_size: int, kernel_size: int, dropout: float = 0.0):
        super().__init__()
        self.conv_layer = _ConvLayer(d_in, filter_size, kernel_size, dropout)
        self.linear_layer = nn.Linear(filter_size, 1)

    def forward(self, x, pad_mask):
        out = self.linear_layer(self.conv_layer(x))[..., 0]
        return out.masked_fill(pad_mask, 0.0)


class VarianceAdaptor(nn.Module):
    """Duration/pitch/energy predictors and pitch/energy embeddings; with
    `forward`, length regulation too. Pitch is embedded before the energy
    predictor runs; given targets, the embeddings bucketize the targets
    rather than the predictions."""

    def __init__(self, emb_size, vp_filter_size, vp_kernel_size, ve_n_bins, vp_dropout=0.0):
        super().__init__()
        self.n_bins = ve_n_bins
        self.duration_predictor = VariancePredictor(emb_size, vp_filter_size, vp_kernel_size,
                                                    vp_dropout)
        self.pitch_predictor = VariancePredictor(emb_size, vp_filter_size, vp_kernel_size,
                                                 vp_dropout)
        self.energy_predictor = VariancePredictor(emb_size, vp_filter_size, vp_kernel_size,
                                                  vp_dropout)
        self.pitch_embedding = nn.Embedding(ve_n_bins, emb_size)
        self.energy_embedding = nn.Embedding(ve_n_bins, emb_size)

    def _bins(self, value):
        idx = torch.round(value * (self.n_bins - 1)).to(torch.int64)
        return torch.clamp(idx, 0, self.n_bins - 1)

    def variance_embed(self, x, src_mask, duration_target=None, pitch_target=None,
                       energy_target=None):
        log_duration = self.duration_predictor(x, src_mask)
        pitch = self.pitch_predictor(x, src_mask)
        x = x + self.pitch_embedding(self._bins(pitch if pitch_target is None else pitch_target))
        energy = self.energy_predictor(x, src_mask)
        x = x + self.energy_embedding(
            self._bins(energy if energy_target is None else energy_target))
        if duration_target is not None:
            duration = duration_target.to(torch.int32)
        else:
            # torch.round is half-to-even, as jnp.round
            duration = torch.clamp(torch.round(torch.exp(log_duration) - 1.0), min=0.0)
            duration = duration.to(torch.int32).masked_fill(src_mask, 0)
        return {"x": x, "pitch": pitch, "energy": energy,
                "log_duration": log_duration, "duration_rounded": duration}

    def forward(self, x, src_mask, max_mel_len: int, pitch_target=None, energy_target=None,
                duration_target=None, mel_mask=None):
        """variance_embed, then length regulation into max_mel_len frames;
        a given mel_mask replaces the regulator's."""
        va = self.variance_embed(x, src_mask, duration_target, pitch_target, energy_target)
        frames, mel_len, lr_mask = length_regulate(va["x"], va["duration_rounded"], max_mel_len)
        return {"features": frames, "pitch": va["pitch"], "energy": va["energy"],
                "log_duration": va["log_duration"], "duration_rounded": va["duration_rounded"],
                "mel_len": mel_len, "mel_mask": lr_mask if mel_mask is None else mel_mask}


class FS2Encoder(nn.Module):
    """`_phoneme_encoder`: encoder + speaker-embedding broadcast + variance
    adaptor (`encode_variance`: stage A of bucketed inference; `forward`:
    the training forward, through length regulation)."""

    def __init__(self, m: ModelConfig):
        super().__init__()
        syms = Symbols(m.phones, m.puncts)
        enc = m.encoder
        self._encoder = Encoder(syms.num_phones, syms.num_puncts, m.emb_dim, m.punct_emb_dim,
                                enc.fs2_layer, enc.fs2_head, m.decoder.conv_filter_size,
                                m.decoder.conv_kernel_size, enc.fs2_dropout, remat=m.remat)
        self._variance_adaptor = VarianceAdaptor(m.emb_size, enc.vp_filter_size,
                                                 enc.vp_kernel_size, enc.ve_n_bins,
                                                 enc.vp_dropout)

    def encode_variance(self, phonemes, puncts, style_embed, phoneme_mask=None,
                        duration_target=None):
        if phoneme_mask is None:
            phoneme_mask = torch.zeros_like(phonemes, dtype=torch.bool)
        features = self._encoder(phonemes, puncts, phoneme_mask) + style_embed
        return self._variance_adaptor.variance_embed(features, phoneme_mask, duration_target)

    def forward(self, phonemes, puncts, style_embed, max_mel_len: int, phoneme_mask=None,
                pitch_target=None, energy_target=None, duration_target=None, mel_mask=None):
        if phoneme_mask is None:
            phoneme_mask = torch.zeros_like(phonemes, dtype=torch.bool)
        features = self._encoder(phonemes, puncts, phoneme_mask) + style_embed
        return self._variance_adaptor(features, phoneme_mask, max_mel_len, pitch_target,
                                      energy_target, duration_target, mel_mask)


class FS2Decoder(nn.Module):
    """`_mel_decoder`: positions + FFT blocks with SCLN + linear head."""

    def __init__(self, dec: DecoderConfig, d_model: int, n_mels: int, remat: bool = False):
        super().__init__()
        self.remat = remat
        d_k = d_model // dec.n_head
        self.layer_stack = nn.ModuleList(
            FFTBlock(d_model, dec.n_head, d_k, d_k, dec.conv_filter_size,
                     tuple(dec.conv_kernel_size), scln=dec.scln, dropout=dec.dropout)
            for _ in range(dec.n_layers))
        self.mel_linear = nn.Linear(d_model, n_mels)

    def forward(self, x, mel_mask, spk_emb):
        B, T, d_model = x.shape
        x = x + position_table(T, d_model, x.device, x.dtype)[None]
        attn_mask = mel_mask[:, None, :].expand(B, T, T)
        x = run_blocks(self.layer_stack, x, spk_emb, mel_mask, attn_mask,
                       self.remat and torch.is_grad_enabled())
        return self.mel_linear(x)
