"""Weights into the PyTorch modules.

* `from_jax_variables` / `meldec_from_jax_variables` carry the JAX package's
  variable trees (nested dicts of numpy arrays) over to this package's
  state_dicts, so both packages can run the same weights. The layout
  changes are the inverse of the JAX package's torch importer:

    Dense (in, out)                 -> Linear (out, in)
    Conv1d (k, in, out)             -> (out, in, k)
    WeightNormConv1d v (k, in, out), g (out,)
                                    -> weight_v (out, in, k), weight_g (out, 1, 1)
    InstanceNorm, LayerNorm scale/bias -> weight/bias
    Conv2d (kh, kw, in, out)        -> (out, in, kh, kw)
    ConvTranspose1d (k, in, out),
      stored flipped on the taps    -> flip taps, then (in, out, k)
    BatchNorm scale/bias + batch_stats mean/var -> weight/bias/running_*

* `upstream_state_dict` / `upstream_generator_state_dict` take the
  upstream gooofy/zerovox torch checkpoints, whose keys the modules already
  use, and fold HiFi-GAN weight norm (w = g * v / ||v||, dim 0); the
  StyleTTS decoder keeps its `weight_g`/`weight_v` as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from zerovox_tpu_torch.config import ZeroVoxConfig


def _t(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _dense(p, prefix: str, out: dict, bias: bool = True) -> None:
    out[prefix + "weight"] = _t(np.asarray(p["kernel"]).T)
    if bias:
        out[prefix + "bias"] = _t(p["bias"])


def _conv1d(p, prefix: str, out: dict) -> None:
    out[prefix + "weight"] = _t(np.transpose(p["kernel"], (2, 1, 0)))
    if "bias" in p:
        out[prefix + "bias"] = _t(p["bias"])


def _conv2d(p, prefix: str, out: dict) -> None:
    out[prefix + "weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    if "bias" in p:
        out[prefix + "bias"] = _t(p["bias"])


def _norm(p, prefix: str, out: dict) -> None:
    out[prefix + "weight"] = _t(p["scale"])
    out[prefix + "bias"] = _t(p["bias"])


def _bn(p, s, prefix: str, out: dict) -> None:
    _norm(p, prefix, out)
    out[prefix + "running_mean"] = _t(s["mean"])
    out[prefix + "running_var"] = _t(s["var"])
    out[prefix + "num_batches_tracked"] = torch.tensor(0)


def _fft_block(p, prefix: str, scln: bool, out: dict) -> None:
    a = p["slf_attn"]
    for name in ("w_qs", "w_ks", "w_vs", "fc"):
        _dense(a[name], f"{prefix}slf_attn.{name}.", out)
    f = p["pos_ffn"]
    _conv1d(f["w_1"], prefix + "pos_ffn.w_1.", out)
    _conv1d(f["w_2"], prefix + "pos_ffn.w_2.", out)
    for ln, sub in ((a["layer_norm"], "slf_attn"), (f["layer_norm"], "pos_ffn")):
        if scln:
            _dense(ln["affine_layer"], f"{prefix}{sub}.layer_norm.affine_layer.linear.", out,
                   bias=False)
        else:
            _norm(ln, f"{prefix}{sub}.layer_norm.", out)


def _variance_predictor(p, prefix: str, out: dict) -> None:
    _conv1d(p["conv1d_1"], prefix + "conv_layer.conv1d_1.conv.", out)
    _norm(p["layer_norm_1"], prefix + "conv_layer.layer_norm_1.", out)
    _conv1d(p["conv1d_2"], prefix + "conv_layer.conv1d_2.conv.", out)
    _norm(p["layer_norm_2"], prefix + "conv_layer.layer_norm_2.", out)
    _dense(p["linear_layer"], prefix + "linear_layer.", out)


def _resnetse(p, s, prefix: str, layers, out: dict) -> None:
    _conv2d(p["conv1"], prefix + "conv1.", out)
    _bn(p["bn1"], s["bn1"], prefix + "bn1.", out)
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            name = f"layer{stage + 1}_{b}"
            bp, bs, pre = p[name], s[name], f"{prefix}layer{stage + 1}.{b}."
            _conv2d(bp["conv1"], pre + "conv1.", out)
            _bn(bp["bn1"], bs["bn1"], pre + "bn1.", out)
            _conv2d(bp["conv2"], pre + "conv2.", out)
            _bn(bp["bn2"], bs["bn2"], pre + "bn2.", out)
            _dense(bp["se"]["fc1"], pre + "se.fc.0.", out)
            _dense(bp["se"]["fc2"], pre + "se.fc.2.", out)
            if "downsample_conv" in bp:
                _conv2d(bp["downsample_conv"], pre + "downsample.0.", out)
                _bn(bp["downsample_bn"], bs["downsample_bn"], pre + "downsample.1.", out)
    # attention: Dense pair around BatchNorm -> Conv1d(k=1) pair
    for name, key in (("att_conv1", "attention.0."), ("att_conv2", "attention.3.")):
        out[prefix + key + "weight"] = _t(np.asarray(p[name]["kernel"]).T[:, :, None])
        out[prefix + key + "bias"] = _t(p[name]["bias"])
    _bn(p["att_bn"], s["att_bn"], prefix + "attention.2.", out)
    _dense(p["fc"], prefix + "fc.", out)


def _wn_conv(p, prefix: str, out: dict) -> None:
    """WeightNormConv1d {v (k, in, out), g (out,), bias} -> weight_v
    (out, in, k), weight_g (out, 1, 1), bias."""
    out[prefix + "weight_v"] = _t(np.transpose(p["v"], (2, 1, 0)))
    out[prefix + "weight_g"] = _t(np.asarray(p["g"]).reshape(-1, 1, 1))
    if "bias" in p:
        out[prefix + "bias"] = _t(p["bias"])


def _resblk1d(p, prefix: str, out: dict) -> None:
    """ResBlk1d or AdainResBlk1d (whose norms are AdaIN1d with a Dense `fc`)."""
    for name in ("conv1", "conv2", "conv1x1"):
        if name in p:
            _wn_conv(p[name], f"{prefix}{name}.", out)
    for name in ("norm1", "norm2"):
        if name in p and "fc" in p[name]:
            _dense(p[name]["fc"], f"{prefix}{name}.fc.", out)
        elif name in p:
            _norm(p[name], f"{prefix}{name}.", out)


def _styletts_decoder(p, prefix: str, out: dict) -> None:
    for i in range(2):
        _resblk1d(p[f"encode_{i}"], f"{prefix}encode.{i}.", out)
    _wn_conv(p["asr_res_conv"], prefix + "asr_res.0.", out)
    _norm(p["asr_res_norm"], prefix + "asr_res.1.", out)
    for i in range(5):
        _resblk1d(p[f"decode_{i}"], f"{prefix}decode.{i}.", out)
    _wn_conv(p["to_out"], prefix + "to_out.0.", out)


def from_jax_variables(variables: dict, cfg: ZeroVoxConfig) -> dict[str, torch.Tensor]:
    """JAX `ZeroVox` variables {"params", "batch_stats"} -> state_dict of
    models.zerovox.ZeroVox."""
    m = cfg.model
    params, stats = variables["params"], variables["batch_stats"]
    out: dict[str, torch.Tensor] = {}

    pe = params["phoneme_encoder"]
    enc, va = pe["encoder"], pe["variance_adaptor"]
    out["_phoneme_encoder._encoder.src_word_emb.weight"] = _t(enc["src_word_emb"]["embedding"])
    out["_phoneme_encoder._encoder.punct_embed.weight"] = _t(enc["punct_embed"]["embedding"])
    for i in range(m.encoder.fs2_layer):
        _fft_block(enc[f"layer_{i}"], f"_phoneme_encoder._encoder.layer_stack.{i}.", False, out)
    for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        _variance_predictor(va[name], f"_phoneme_encoder._variance_adaptor.{name}.", out)
    for name in ("pitch_embedding", "energy_embedding"):
        out[f"_phoneme_encoder._variance_adaptor.{name}.weight"] = _t(va[name]["embedding"])

    _resnetse(params["spkemb"], stats["spkemb"], "_spkemb.", tuple(m.resnet.layers), out)

    dec = params["mel_decoder"]
    if m.decoder.kind == "styletts":
        _styletts_decoder(dec, "_mel_decoder.", out)
        return out
    for i in range(m.decoder.n_layers):
        _fft_block(dec[f"layer_{i}"], f"_mel_decoder.layer_stack.{i}.", m.decoder.scln, out)
    _dense(dec["mel_linear"], "_mel_decoder.mel_linear.", out)
    return out


def meldec_from_jax_variables(variables: dict, cfg) -> dict[str, torch.Tensor]:
    """JAX `MelDec` variables -> state_dict of models.hifigan.MelDec."""
    params = variables["params"]
    g = params["generator"]
    out: dict[str, torch.Tensor] = {}
    _conv1d(g["conv_pre"], "generator.conv_pre.", out)
    _conv1d(g["conv_post"], "generator.conv_post.", out)
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        up = g[f"ups_{i}"]
        out[f"generator.ups.{i}.weight"] = _t(np.transpose(np.flip(up["kernel"], 0), (1, 2, 0)))
        out[f"generator.ups.{i}.bias"] = _t(up["bias"])
        for j in range(nk):
            n = i * nk + j
            blk = g[f"resblocks_{n}"]
            for c in range(len(cfg.resblock_dilation_sizes[j])):
                if cfg.resblock == "1":
                    _conv1d(blk[f"convs1_{c}"], f"generator.resblocks.{n}.convs1.{c}.", out)
                    _conv1d(blk[f"convs2_{c}"], f"generator.resblocks.{n}.convs2.{c}.", out)
                else:
                    _conv1d(blk[f"convs_{c}"], f"generator.resblocks.{n}.convs.{c}.", out)
    out["mean"] = _t(params.get("mean", np.zeros(cfg.num_mels)))
    out["scale"] = _t(params.get("scale", np.ones(cfg.num_mels)))
    return out


def fold_weight_norm(sd: dict) -> dict[str, torch.Tensor]:
    """Replace every (`x.weight_g`, `x.weight_v`) pair by `x.weight` =
    g * v / ||v|| with the norm over all dims but 0."""
    out = {}
    for key, val in sd.items():
        if key.endswith(".weight_g"):
            base = key[: -len("_g")]
            v = sd[base + "_v"].float()
            norm = torch.sqrt((v ** 2).sum(dim=tuple(range(1, v.dim())), keepdim=True))
            out[base] = val.float() * v / torch.clamp(norm, min=1e-12)
        elif not key.endswith(".weight_v"):
            out[key] = val
    return out


def upstream_state_dict(sd: dict, model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """An upstream ZeroVox Lightning state_dict, restricted to the keys of
    `model` (the upstream dead MelSpectrogram frontend and the position
    table buffers are dropped). Raises on a missing key."""
    keys = model.state_dict().keys()
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. {missing[:3]}")
    return {k: sd[k].float() if sd[k].is_floating_point() else sd[k] for k in keys}


def upstream_generator_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """An upstream HiFi-GAN generator state_dict (weight-normed or folded)
    -> state_dict of models.hifigan.MelDec (identity mel normalization
    unless the dict carries `mean`/`scale`)."""
    sd = fold_weight_norm(sd)
    out = {"generator." + k: v.float() for k, v in sd.items() if k not in ("mean", "scale")}
    for k in ("mean", "scale"):
        if k in sd:
            out[k] = torch.as_tensor(sd[k], dtype=torch.float32)
    return out
