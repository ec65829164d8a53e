"""Model configuration: the `modelcfg.yaml` contract.

The trained-artifact contract matches the reference: a single merged yaml with
`audio`, `model` (incl. `encoder`, `decoder`, `resnet` sections), `training`,
plus train-time computed `stats` and `lang` keys (reference
utils/train_tts.py:150-191, consumed at inference by
zerovox/tts/synthesize.py:310-326).

We parse it into typed dataclasses once and thread those through the
framework; the raw dict is preserved for round-tripping. This module is the
PyTorch package's own copy of the JAX package's config, so a modelcfg.yaml
means the same in both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class AudioConfig:
    sampling_rate: int = 22050
    fft_size: int = 1024
    hop_size: int = 256
    win_length: int = 1024
    num_mels: int = 80
    fmin: int = 0
    fmax: int = 8000


@dataclass(frozen=True)
class EncoderConfig:
    fs2_layer: int = 4
    fs2_head: int = 2
    fs2_dropout: float = 0.2
    vp_filter_size: int = 256
    vp_kernel_size: int = 3
    vp_dropout: float = 0.5
    ve_n_bins: int = 256


@dataclass(frozen=True)
class DecoderConfig:
    kind: str = "fastspeech2"  # "fastspeech2" | "styletts"
    n_layers: int = 6
    n_head: int = 2
    conv_filter_size: int = 1024
    conv_kernel_size: tuple[int, int] = (9, 1)
    dropout: float = 0.2
    scln: bool = True


@dataclass(frozen=True)
class ResNetConfig:
    layers: tuple[int, ...] = (3, 4, 6, 3)
    num_filters: tuple[int, ...] = (32, 64, 128, 256)
    encoder_type: str = "ASP"  # "ASP" | "SAP"


@dataclass(frozen=True)
class ModelConfig:
    max_txt_len: int = 512
    min_mel_len: int = 100
    max_mel_len: int = 1750
    phones: str = "'-abcdefghijklmnopqrstuvwxyz"
    puncts: str = " ,.;:-!?\""
    emb_dim: int = 512
    emb_reduction: int = 1
    punct_emb_dim: int = 16
    dpe_emb_dim: int = 32
    # Training and TPU-layout options of the JAX package; the model computes
    # the same function whatever they say. `remat` / `remat_speaker`
    # recompute the FFT blocks / the unfused speaker-encoder blocks in the
    # backward (models/layers.py `remat`). `fused_speaker` (which needs
    # packed_speaker >= 1, as in the JAX package) runs the speaker encoder's
    # stage 1 through kernel K4 (ops/se_conv.py); the packing itself has no
    # counterpart in the port's NCHW layout.
    remat: bool = False
    remat_speaker: bool = False
    packed_speaker: int = 0
    fused_speaker: bool = False
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    resnet: ResNetConfig = field(default_factory=ResNetConfig)

    @property
    def emb_size(self) -> int:
        """Hidden width of the acoustic model (phone + punct embedding)."""
        return self.emb_dim + self.punct_emb_dim


@dataclass(frozen=True)
class TrainingConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    betas: tuple[float, float] = (0.0, 0.99)
    eps: float = 1e-9
    grad_clip: float = 1.0


@dataclass(frozen=True)
class Stats:
    """Corpus pitch/energy min/max, merged across corpora at train time."""

    pitch_min: float = 0.0
    pitch_max: float = 1.0
    energy_min: float = 0.0
    energy_max: float = 1.0


@dataclass(frozen=True)
class ZeroVoxConfig:
    audio: AudioConfig = field(default_factory=AudioConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    stats: Stats = field(default_factory=Stats)
    langs: tuple[str, ...] = ("en",)
    raw: dict[str, Any] | None = field(default=None, compare=False, hash=False)

    # ------------------------------------------------------------------ I/O

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ZeroVoxConfig":
        a = d.get("audio", {})
        m = d.get("model", {})
        e = m.get("encoder", {})
        dec = m.get("decoder", {})
        r = m.get("resnet", {})
        t = d.get("training", {})
        s = d.get("stats", {})

        def pick(cls, src: dict, **renames):
            kw = {}
            for f in dataclasses.fields(cls):
                key = renames.get(f.name, f.name)
                if key in src:
                    v = src[key]
                    if isinstance(v, list):
                        v = tuple(v)
                    kw[f.name] = v
            return cls(**kw)

        langs = d.get("lang", ["en"])
        if isinstance(langs, str):
            langs = [langs]
        return ZeroVoxConfig(
            audio=pick(AudioConfig, a),
            model=dataclasses.replace(
                pick(ModelConfig, m),
                encoder=pick(EncoderConfig, e),
                decoder=pick(DecoderConfig, dec),
                resnet=pick(ResNetConfig, r),
            ),
            training=pick(TrainingConfig, t),
            stats=pick(Stats, s),
            langs=tuple(langs),
            raw=d,
        )

    @staticmethod
    def from_yaml(path) -> "ZeroVoxConfig":
        import yaml  # not installed everywhere the port runs; only YAML I/O needs it

        with open(path) as f:
            return ZeroVoxConfig.from_dict(yaml.load(f, Loader=yaml.FullLoader))

    def to_dict(self) -> dict[str, Any]:
        """Serialize back to the reference modelcfg.yaml layout."""
        d = dict(self.raw) if self.raw else {}
        d["audio"] = {
            "sampling_rate": self.audio.sampling_rate,
            "fft_size": self.audio.fft_size,
            "hop_size": self.audio.hop_size,
            "win_length": self.audio.win_length,
            "num_mels": self.audio.num_mels,
            "fmin": self.audio.fmin,
            "fmax": self.audio.fmax,
        }
        d["model"] = {
            "max_txt_len": self.model.max_txt_len,
            "min_mel_len": self.model.min_mel_len,
            "max_mel_len": self.model.max_mel_len,
            "phones": self.model.phones,
            "puncts": self.model.puncts,
            "emb_dim": self.model.emb_dim,
            "emb_reduction": self.model.emb_reduction,
            "punct_emb_dim": self.model.punct_emb_dim,
            "dpe_emb_dim": self.model.dpe_emb_dim,
            "encoder": dataclasses.asdict(self.model.encoder),
            "decoder": {
                **dataclasses.asdict(self.model.decoder),
                "conv_kernel_size": list(self.model.decoder.conv_kernel_size),
            },
            "resnet": {
                "layers": list(self.model.resnet.layers),
                "num_filters": list(self.model.resnet.num_filters),
                "encoder_type": self.model.resnet.encoder_type,
            },
        }
        d["training"] = {
            "learning_rate": self.training.learning_rate,
            "weight_decay": self.training.weight_decay,
            "betas": list(self.training.betas),
            "eps": self.training.eps,
            "grad_clip": self.training.grad_clip,
        }
        d["stats"] = dataclasses.asdict(self.stats)
        d["lang"] = list(self.langs)
        return d

    def to_yaml(self, path) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.dump(self.to_dict(), f, default_flow_style=False)

    def symbols(self):
        from zerovox_tpu_torch.symbols import Symbols

        return Symbols(phones=self.model.phones, puncts=self.model.puncts)
