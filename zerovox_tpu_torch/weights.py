"""Weights into the PyTorch modules.

* `from_jax_variables` / `meldec_from_jax_variables` carry the JAX package's
  variable trees (nested dicts of numpy arrays) over to this package's
  state_dicts, so both packages can run the same weights, and
  `to_jax_variables` / `meldec_to_jax_variables` carry them back (one walk
  of the modules serves both directions). The layout changes are the
  inverse of the JAX package's torch importer:

    Dense (in, out)                 -> Linear (out, in)
    Conv1d (k, in, out)             -> (out, in, k)
    WeightNormConv1d v (k, in, out), g (out,)
                                    -> weight_v (out, in, k), weight_g (out, 1, 1)
    InstanceNorm, LayerNorm scale/bias -> weight/bias
    Conv2d (kh, kw, in, out)        -> (out, in, kh, kw)
    ConvTranspose1d (k, in, out),
      stored flipped on the taps    -> flip taps, then (in, out, k)
    BatchNorm scale/bias + batch_stats mean/var -> weight/bias/running_*

* `generator_*`, `mpd_*` and `msd_*` carry the vocoder trainer's three
  nets both ways (the bare Generator's params, and the discriminators'
  params, whose upstream keys the JAX package's `convert_hifigan_mpd` /
  `convert_hifigan_msd` read).

* `tone_ctc_from_flax` / `tone_ctc_to_flax` carry the bundled tone-speak
  CTC aligner's flax params ({"Conv1d_0": ..., "Dense_0": ...}, the layout
  of `preprocess/tone_ctc_weights.npz`) both ways.

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


# layouts: (JAX array -> torch tensor, torch tensor -> JAX array), on numpy
_SAME = (lambda a: a, lambda w: w)
_DENSE = (lambda a: a.T, lambda w: w.T)
_CONV1D = (lambda a: a.transpose(2, 1, 0), lambda w: w.transpose(2, 1, 0))
_CONV2D = (lambda a: a.transpose(3, 2, 0, 1), lambda w: w.transpose(2, 3, 1, 0))
_WN_G = (lambda a: a.reshape(-1, 1, 1), lambda w: w.reshape(-1))
_ATT = (lambda a: a.T[:, :, None], lambda w: w[:, :, 0].T)  # Dense <-> Conv1d(k=1)
_UPS = (lambda a: np.flip(a, 0).transpose(1, 2, 0), lambda w: np.flip(w.transpose(2, 0, 1), 0))


class _ToTorch:
    """Walks a JAX variable tree into a state_dict."""

    def __init__(self, variables: dict):
        self.tree, self.out = variables, {}

    def _node(self, path):
        node = self.tree
        for p in path:
            if not isinstance(node, dict) or p not in node:
                return None
            node = node[p]
        return node

    def has(self, path, key) -> bool:
        return self._node(path) is not None

    def put(self, path, key, layout) -> None:
        self.out[key] = _t(layout[0](np.asarray(self._node(path))))

    def torch_only(self, key, value) -> None:
        self.out[key] = value

    def walk(self, fn, *args) -> dict:
        fn(self, *args)
        return self.out


class _ToJax:
    """Walks a state_dict into a JAX variable tree of float32 numpy arrays."""

    def __init__(self, sd: dict):
        self.sd, self.tree = sd, {}

    def has(self, path, key) -> bool:
        return key in self.sd

    def put(self, path, key, layout) -> None:
        node = self.tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        w = self.sd[key].detach().cpu().numpy().astype(np.float32)
        node[path[-1]] = np.ascontiguousarray(layout[1](w))

    def torch_only(self, key, value) -> None:
        pass

    def walk(self, fn, *args) -> dict:
        fn(self, *args)
        return self.tree


def _dense(m, path, prefix: str, bias: bool = True) -> None:
    m.put(path + ("kernel",), prefix + "weight", _DENSE)
    if bias:
        m.put(path + ("bias",), prefix + "bias", _SAME)


def _conv(m, path, prefix: str, layout) -> None:
    m.put(path + ("kernel",), prefix + "weight", layout)
    if m.has(path + ("bias",), prefix + "bias"):
        m.put(path + ("bias",), prefix + "bias", _SAME)


def _norm(m, path, prefix: str) -> None:
    m.put(path + ("scale",), prefix + "weight", _SAME)
    m.put(path + ("bias",), prefix + "bias", _SAME)


def _bn(m, path, stats, prefix: str) -> None:
    _norm(m, path, prefix)
    m.put(stats + ("mean",), prefix + "running_mean", _SAME)
    m.put(stats + ("var",), prefix + "running_var", _SAME)
    m.torch_only(prefix + "num_batches_tracked", torch.tensor(0))


def _fft_block(m, path, prefix: str, scln: bool) -> None:
    a = path + ("slf_attn",)
    for name in ("w_qs", "w_ks", "w_vs", "fc"):
        _dense(m, a + (name,), f"{prefix}slf_attn.{name}.")
    f = path + ("pos_ffn",)
    _conv(m, f + ("w_1",), prefix + "pos_ffn.w_1.", _CONV1D)
    _conv(m, f + ("w_2",), prefix + "pos_ffn.w_2.", _CONV1D)
    for ln, sub in ((a + ("layer_norm",), "slf_attn"), (f + ("layer_norm",), "pos_ffn")):
        if scln:
            _dense(m, ln + ("affine_layer",), f"{prefix}{sub}.layer_norm.affine_layer.linear.",
                   bias=False)
        else:
            _norm(m, ln, f"{prefix}{sub}.layer_norm.")


def _variance_predictor(m, path, prefix: str) -> None:
    _conv(m, path + ("conv1d_1",), prefix + "conv_layer.conv1d_1.conv.", _CONV1D)
    _norm(m, path + ("layer_norm_1",), prefix + "conv_layer.layer_norm_1.")
    _conv(m, path + ("conv1d_2",), prefix + "conv_layer.conv1d_2.conv.", _CONV1D)
    _norm(m, path + ("layer_norm_2",), prefix + "conv_layer.layer_norm_2.")
    _dense(m, path + ("linear_layer",), prefix + "linear_layer.")


def _resnetse(m, p, s, prefix: str, layers) -> None:
    _conv(m, p + ("conv1",), prefix + "conv1.", _CONV2D)
    _bn(m, p + ("bn1",), s + ("bn1",), prefix + "bn1.")
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            name = f"layer{stage + 1}_{b}"
            bp, bs, pre = p + (name,), s + (name,), f"{prefix}layer{stage + 1}.{b}."
            _conv(m, bp + ("conv1",), pre + "conv1.", _CONV2D)
            _bn(m, bp + ("bn1",), bs + ("bn1",), pre + "bn1.")
            _conv(m, bp + ("conv2",), pre + "conv2.", _CONV2D)
            _bn(m, bp + ("bn2",), bs + ("bn2",), pre + "bn2.")
            _dense(m, bp + ("se", "fc1"), pre + "se.fc.0.")
            _dense(m, bp + ("se", "fc2"), pre + "se.fc.2.")
            if m.has(bp + ("downsample_conv",), pre + "downsample.0.weight"):
                _conv(m, bp + ("downsample_conv",), pre + "downsample.0.", _CONV2D)
                _bn(m, bp + ("downsample_bn",), bs + ("downsample_bn",), pre + "downsample.1.")
    # attention: Dense pair around BatchNorm -> Conv1d(k=1) pair
    for name, key in (("att_conv1", "attention.0."), ("att_conv2", "attention.3.")):
        m.put(p + (name, "kernel"), prefix + key + "weight", _ATT)
        m.put(p + (name, "bias"), prefix + key + "bias", _SAME)
    _bn(m, p + ("att_bn",), s + ("att_bn",), prefix + "attention.2.")
    _dense(m, p + ("fc",), prefix + "fc.")


def _wn_conv(m, path, prefix: str) -> None:
    """WeightNormConv1d {v (k, in, out), g (out,), bias} <-> weight_v
    (out, in, k), weight_g (out, 1, 1), bias."""
    m.put(path + ("v",), prefix + "weight_v", _CONV1D)
    m.put(path + ("g",), prefix + "weight_g", _WN_G)
    if m.has(path + ("bias",), prefix + "bias"):
        m.put(path + ("bias",), prefix + "bias", _SAME)


def _resblk1d(m, path, prefix: str) -> None:
    """ResBlk1d or AdainResBlk1d (whose norms are AdaIN1d with a Dense `fc`)."""
    for name in ("conv1", "conv2", "conv1x1"):
        if m.has(path + (name,), f"{prefix}{name}.weight_v"):
            _wn_conv(m, path + (name,), f"{prefix}{name}.")
    for name in ("norm1", "norm2"):
        if m.has(path + (name, "fc"), f"{prefix}{name}.fc.weight"):
            _dense(m, path + (name, "fc"), f"{prefix}{name}.fc.")
        elif m.has(path + (name,), f"{prefix}{name}.weight"):
            _norm(m, path + (name,), f"{prefix}{name}.")


def _styletts_decoder(m, path, prefix: str) -> None:
    for i in range(2):
        _resblk1d(m, path + (f"encode_{i}",), f"{prefix}encode.{i}.")
    _wn_conv(m, path + ("asr_res_conv",), prefix + "asr_res.0.")
    _norm(m, path + ("asr_res_norm",), prefix + "asr_res.1.")
    for i in range(5):
        _resblk1d(m, path + (f"decode_{i}",), f"{prefix}decode.{i}.")
    _wn_conv(m, path + ("to_out",), prefix + "to_out.0.")


def _zerovox(m, cfg: ZeroVoxConfig) -> None:
    md = cfg.model
    enc = ("params", "phoneme_encoder", "encoder")
    va = ("params", "phoneme_encoder", "variance_adaptor")
    m.put(enc + ("src_word_emb", "embedding"), "_phoneme_encoder._encoder.src_word_emb.weight", _SAME)
    m.put(enc + ("punct_embed", "embedding"), "_phoneme_encoder._encoder.punct_embed.weight", _SAME)
    for i in range(md.encoder.fs2_layer):
        _fft_block(m, enc + (f"layer_{i}",), f"_phoneme_encoder._encoder.layer_stack.{i}.", False)
    for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        _variance_predictor(m, va + (name,), f"_phoneme_encoder._variance_adaptor.{name}.")
    for name in ("pitch_embedding", "energy_embedding"):
        m.put(va + (name, "embedding"), f"_phoneme_encoder._variance_adaptor.{name}.weight", _SAME)

    _resnetse(m, ("params", "spkemb"), ("batch_stats", "spkemb"), "_spkemb.",
              tuple(md.resnet.layers))

    dec = ("params", "mel_decoder")
    if md.decoder.kind == "styletts":
        _styletts_decoder(m, dec, "_mel_decoder.")
        return
    for i in range(md.decoder.n_layers):
        _fft_block(m, dec + (f"layer_{i}",), f"_mel_decoder.layer_stack.{i}.", md.decoder.scln)
    _dense(m, dec + ("mel_linear",), "_mel_decoder.mel_linear.")


def _meldec(m, cfg) -> None:
    g = ("params", "generator")
    _conv(m, g + ("conv_pre",), "generator.conv_pre.", _CONV1D)
    _conv(m, g + ("conv_post",), "generator.conv_post.", _CONV1D)
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        m.put(g + (f"ups_{i}", "kernel"), f"generator.ups.{i}.weight", _UPS)
        m.put(g + (f"ups_{i}", "bias"), f"generator.ups.{i}.bias", _SAME)
        for j in range(nk):
            n = i * nk + j
            blk = g + (f"resblocks_{n}",)
            for c in range(len(cfg.resblock_dilation_sizes[j])):
                pre = f"generator.resblocks.{n}."
                if cfg.resblock == "1":
                    _conv(m, blk + (f"convs1_{c}",), f"{pre}convs1.{c}.", _CONV1D)
                    _conv(m, blk + (f"convs2_{c}",), f"{pre}convs2.{c}.", _CONV1D)
                else:
                    _conv(m, blk + (f"convs_{c}",), f"{pre}convs.{c}.", _CONV1D)
    for name, fill in (("mean", np.zeros), ("scale", np.ones)):
        if m.has(("params", name), name):
            m.put(("params", name), name, _SAME)
        else:
            m.torch_only(name, _t(fill(cfg.num_mels)))


def from_jax_variables(variables: dict, cfg: ZeroVoxConfig) -> dict[str, torch.Tensor]:
    """JAX `ZeroVox` variables {"params", "batch_stats"} -> state_dict of
    models.zerovox.ZeroVox."""
    m = _ToTorch(variables)
    _zerovox(m, cfg)
    return m.out


def to_jax_variables(state_dict: dict, cfg: ZeroVoxConfig) -> dict:
    """The inverse of `from_jax_variables`: a models.zerovox.ZeroVox
    state_dict -> JAX `ZeroVox` variables {"params", "batch_stats"} of
    float32 numpy arrays (BatchNorm's `num_batches_tracked` has no JAX
    counterpart and is dropped)."""
    m = _ToJax(state_dict)
    _zerovox(m, cfg)
    return {"params": m.tree["params"], "batch_stats": m.tree["batch_stats"]}


def meldec_from_jax_variables(variables: dict, cfg) -> dict[str, torch.Tensor]:
    """JAX `MelDec` variables -> state_dict of models.hifigan.MelDec
    (identity mel normalization where the tree has no `mean`/`scale`)."""
    m = _ToTorch(variables)
    _meldec(m, cfg)
    return m.out


def meldec_to_jax_variables(state_dict: dict, cfg) -> dict:
    """The inverse of `meldec_from_jax_variables`: a models.hifigan.MelDec
    state_dict -> JAX `MelDec` variables {"params": {"generator", "mean",
    "scale"}}."""
    m = _ToJax(state_dict)
    _meldec(m, cfg)
    return m.tree


def generator_from_jax_params(params: dict, cfg) -> dict[str, torch.Tensor]:
    """The JAX `Generator`'s params (the vocoder trainer's `g_params`) ->
    state_dict of models.hifigan.Generator."""
    sd = meldec_from_jax_variables({"params": {"generator": params}}, cfg)
    return {k[len("generator."):]: v for k, v in sd.items() if k.startswith("generator.")}


def generator_to_jax_params(state_dict: dict, cfg) -> dict:
    """The inverse of `generator_from_jax_params`."""
    sd = {"generator." + k: v for k, v in state_dict.items()}
    return _ToJax(sd).walk(_meldec, cfg)["params"]["generator"]


def _mpd(m, periods) -> None:
    for i, p in enumerate(periods):
        for j in range(5):
            _conv(m, (f"disc_p{p}", f"convs_{j}"), f"discriminators.{i}.convs.{j}.", _CONV2D)
        _conv(m, (f"disc_p{p}", "conv_post"), f"discriminators.{i}.conv_post.", _CONV2D)


def _msd(m, num_scales: int) -> None:
    for i in range(num_scales):
        for j in range(7):
            _conv(m, (f"disc_s{i}", f"convs_{j}"), f"discriminators.{i}.convs.{j}.", _CONV1D)
        _conv(m, (f"disc_s{i}", "conv_post"), f"discriminators.{i}.conv_post.", _CONV1D)


def mpd_from_jax_variables(params: dict, periods=(2, 3, 5, 7, 11)) -> dict[str, torch.Tensor]:
    """The JAX `MultiPeriodDiscriminator`'s params ({"disc_p2": ...}) ->
    state_dict of models.hifigan.MultiPeriodDiscriminator(periods)."""
    return _ToTorch(params).walk(_mpd, periods)


def mpd_to_jax_variables(state_dict: dict, periods=(2, 3, 5, 7, 11)) -> dict:
    """The inverse of `mpd_from_jax_variables`."""
    return _ToJax(state_dict).walk(_mpd, periods)


def msd_from_jax_variables(params: dict, num_scales: int = 3) -> dict[str, torch.Tensor]:
    """The JAX `MultiScaleDiscriminator`'s params ({"disc_s0": ...}) ->
    state_dict of models.hifigan.MultiScaleDiscriminator(num_scales)."""
    return _ToTorch(params).walk(_msd, num_scales)


def msd_to_jax_variables(state_dict: dict, num_scales: int = 3) -> dict:
    """The inverse of `msd_from_jax_variables`."""
    return _ToJax(state_dict).walk(_msd, num_scales)


def _tone_ctc(m) -> None:
    for i in range(2):
        _conv(m, (f"Conv1d_{i}",), f"convs.{i}.", _CONV1D)
    _dense(m, ("Dense_0",), "dense.")


def tone_ctc_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """The flax `ToneCTCNet`'s params -> state_dict of
    preprocess.tone_ctc.ToneCTCNet."""
    return _ToTorch(params).walk(_tone_ctc)


def tone_ctc_to_flax(state_dict: dict) -> dict:
    """The inverse of `tone_ctc_from_flax`."""
    return _ToJax(state_dict).walk(_tone_ctc)


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
