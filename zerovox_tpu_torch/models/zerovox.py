"""The composite ZeroVox acoustic model (inference entry points).

The PyTorch counterpart of the JAX package's `models/zerovox.py`:

  * ``speaker_embed`` — reference mel -> [B, 1, emb] (run once per voice).
  * ``encode``        — stage A of bucketed inference (text-bucket shaped).
  * ``decode``        — stage B: length-regulate into a static mel bucket and
                        run the mel decoder.

Submodules carry the upstream state_dict prefixes (`_phoneme_encoder`,
`_spkemb`, `_mel_decoder`), so an upstream checkpoint's keys load as they
are. The vocoder is a separate module (models/hifigan.py), as upstream
ships it as a separate artifact.
"""

from __future__ import annotations

import torch.nn as nn

from zerovox_tpu_torch.config import ZeroVoxConfig
from zerovox_tpu_torch.models.fs2 import FS2Decoder, FS2Encoder
from zerovox_tpu_torch.models.resnetse import ResNetSE34V2
from zerovox_tpu_torch.ops.length_regulator import length_regulate


class ZeroVox(nn.Module):
    def __init__(self, cfg: ZeroVoxConfig):
        super().__init__()
        m = cfg.model
        if m.decoder.kind != "fastspeech2":
            raise NotImplementedError(
                f"decoder kind {m.decoder.kind!r} is not ported yet (fastspeech2 only)")
        self._phoneme_encoder = FS2Encoder(m)
        self._spkemb = ResNetSE34V2(tuple(m.resnet.layers), tuple(m.resnet.num_filters),
                                    n_out=m.emb_size, encoder_type=m.resnet.encoder_type,
                                    n_mels=cfg.audio.num_mels)
        self._mel_decoder = FS2Decoder(m.decoder, m.emb_size, cfg.audio.num_mels)

    def speaker_embed(self, ref_mel):
        """ref_mel [B, T, n_mels] -> [B, 1, emb_size], L2-normalized."""
        return self._spkemb(ref_mel)

    def encode(self, phonemes, puncts, style_embed, phoneme_mask=None, duration_target=None):
        return self._phoneme_encoder.encode_variance(
            phonemes, puncts, style_embed, phoneme_mask=phoneme_mask,
            duration_target=duration_target)

    def decode(self, x, durations, style_embed, max_mel_len: int):
        """Returns (mel [B, T, n_mels], mel_len [B], mel_mask [B, T])."""
        frames, mel_len, mel_mask = length_regulate(x, durations, max_mel_len)
        mel = self._mel_decoder(frames, mel_mask, style_embed)
        return mel.masked_fill(mel_mask[..., None], 0.0), mel_len, mel_mask
