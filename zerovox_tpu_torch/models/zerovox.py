"""The composite ZeroVox acoustic model and its training loss.

The PyTorch counterpart of the JAX package's `models/zerovox.py`:

  * ``forward``       — training forward: teacher pitch/energy/duration,
                        returns the prediction dict the loss consumes.
  * ``speaker_embed`` — reference mel -> [B, 1, emb] (run once per voice).
  * ``encode``        — stage A of bucketed inference (text-bucket shaped).
  * ``decode``        — stage B: length-regulate into a static mel bucket and
                        run the mel decoder.

The mel decoder is the FS2 decoder (`decoder.kind: fastspeech2`) or the
StyleTTS AdaIN decoder (`styletts`, models/styletts.py). Submodules carry
the upstream state_dict prefixes (`_phoneme_encoder`,
`_spkemb`, `_mel_decoder`), so an upstream checkpoint's keys load as they
are. The vocoder is a separate module (models/hifigan.py), as upstream
ships it as a separate artifact.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from zerovox_tpu_torch.config import ZeroVoxConfig
from zerovox_tpu_torch.models.fs2 import FS2Decoder, FS2Encoder
from zerovox_tpu_torch.models.resnetse import ResNetSE34V2
from zerovox_tpu_torch.models.styletts import StyleTTSDecoder
from zerovox_tpu_torch.ops.length_regulator import length_regulate
from zerovox_tpu_torch.parallel.mesh import all_reduce_sum


class ZeroVox(nn.Module):
    def __init__(self, cfg: ZeroVoxConfig):
        super().__init__()
        m = cfg.model
        if m.fused_speaker and m.packed_speaker < 1:
            raise ValueError("fused_speaker requires packed_speaker >= 1, as in the JAX package")
        self._phoneme_encoder = FS2Encoder(m)
        self._spkemb = ResNetSE34V2(tuple(m.resnet.layers), tuple(m.resnet.num_filters),
                                    n_out=m.emb_size, encoder_type=m.resnet.encoder_type,
                                    n_mels=cfg.audio.num_mels, fused_stage1=m.fused_speaker,
                                    remat=m.remat_speaker)
        if m.decoder.kind == "fastspeech2":
            self._mel_decoder = FS2Decoder(m.decoder, m.emb_size, cfg.audio.num_mels,
                                           remat=m.remat)
        elif m.decoder.kind == "styletts":
            self._mel_decoder = StyleTTSDecoder(m.emb_size, m.emb_size, residual_dim=64,
                                                dim_out=cfg.audio.num_mels)
        else:
            raise ValueError(f"unknown decoder kind: {m.decoder.kind!r}")

    def speaker_embed(self, ref_mel, train: bool = False):
        """ref_mel [B, T, n_mels] -> [B, 1, emb_size], L2-normalized."""
        return self._spkemb(ref_mel, train=train)

    def encode(self, phonemes, puncts, style_embed, phoneme_mask=None, duration_target=None):
        return self._phoneme_encoder.encode_variance(
            phonemes, puncts, style_embed, phoneme_mask=phoneme_mask,
            duration_target=duration_target)

    def decode(self, x, durations, style_embed, max_mel_len: int):
        """Returns (mel [B, T, n_mels], mel_len [B], mel_mask [B, T])."""
        frames, mel_len, mel_mask = length_regulate(x, durations, max_mel_len)
        mel = self._mel_decoder(frames, mel_mask, style_embed)
        return mel.masked_fill(mel_mask[..., None], 0.0), mel_len, mel_mask

    def forward(self, batch: dict, train: bool = True, force_duration: bool = False,
                spkemb_train: bool | None = None, group=None):
        """Training/teacher forward over a collated batch (phoneme, puncts,
        phoneme_mask, pitch, energy, duration, mel_mask, ref_mel). `train`
        feeds the teacher targets and gives the speaker encoder's BatchNorms
        batch statistics (`spkemb_train=False` keeps them on their running
        statistics, the decoder-only finetune); dropout follows the module's
        own train mode. `group`: the data-parallel process group, whose
        global batch those statistics cover."""
        spk_train = train if spkemb_train is None else (train and spkemb_train)
        style_embed = self._spkemb(batch["ref_mel"], train=spk_train, group=group)
        teacher = train or force_duration
        pred = self._phoneme_encoder(
            batch["phoneme"], batch["puncts"], style_embed,
            max_mel_len=batch["mel_mask"].shape[1],
            phoneme_mask=batch.get("phoneme_mask"),
            pitch_target=batch["pitch"] if train else None,
            energy_target=batch["energy"] if train else None,
            duration_target=batch["duration"] if teacher else None,
            mel_mask=batch.get("mel_mask") if teacher else None)
        mel = self._mel_decoder(pred["features"], pred["mel_mask"], style_embed)
        pred["mel"] = mel.masked_fill(pred["mel_mask"][..., None], 0.0)
        return pred


def masked_mean(values: torch.Tensor, keep: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the elements where `keep` is True. Under a data-parallel
    `group` (a mesh's `data_group`) the denominator is the count over every
    rank's shard, so the ranks' results sum to the mean over the global
    batch (the gradients' sum over the ranks is then the global mean's
    gradient). Over the whole world of a data x model mesh it would count
    every row once a model rank."""
    keep = keep.expand(values.shape).to(values.dtype)
    count = torch.sum(keep)
    if group is not None:
        count = all_reduce_sum(count, group)
    return torch.sum(values * keep) / torch.clamp(count, min=1.0)


def zerovox_loss(pred: dict, batch: dict, group=None) -> dict[str, torch.Tensor]:
    """Masked L1 on mel, masked MSE on pitch, energy and log(d + 1)
    duration, weighted 10/2/2/1. Under a `group` each term is this rank's
    share of the global batch's masked mean (see `masked_mean`)."""
    mel_keep = ~batch["mel_mask"]
    phon_keep = ~batch["phoneme_mask"]
    mel_loss = masked_mean(torch.abs(pred["mel"] - batch["mel"]), mel_keep[..., None], group)
    pitch_loss = masked_mean((pred["pitch"] - batch["pitch"]) ** 2, phon_keep, group)
    energy_loss = masked_mean((pred["energy"] - batch["energy"]) ** 2, phon_keep, group)
    log_dur_target = torch.log(batch["duration"].to(torch.float32) + 1.0)
    duration_loss = masked_mean((pred["log_duration"] - log_dur_target) ** 2, phon_keep, group)
    loss = 10.0 * mel_loss + 2.0 * pitch_loss + 2.0 * energy_loss + duration_loss
    return {"loss": loss, "mel_loss": mel_loss, "pitch_loss": pitch_loss,
            "energy_loss": energy_loss, "duration_loss": duration_loss}
