"""Operations (FLOP, a multiply-add counted as 2) and bytes of the models,
from their shapes alone: what the mathematics needs, whatever kernel runs
it. Lengths are the unpadded ones unless a caller passes a bucket.
"""

from __future__ import annotations


def conv1d(T: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * T * cin * cout * k


def fft_block(n: int, d: int, filt: int, ks) -> float:
    """Self-attention (q, k, v, out projections; scores and values over n
    positions) and the conv feed-forward of one FFT block."""
    return 4 * 2.0 * n * d * d + 4.0 * n * n * d + conv1d(n, d, filt, ks[0]) + conv1d(n, filt, d, ks[1])


def encoder(cfg: dict, n: int) -> float:
    """Phone encoder and variance adaptor over n phones."""
    m = cfg["model"]
    d = m["emb_dim"] + m["punct_emb_dim"]
    e, dec = m["encoder"], m["decoder"]
    vp, k = e["vp_filter_size"], e["vp_kernel_size"]
    blocks = e["fs2_layer"] * fft_block(n, d, dec["conv_filter_size"], dec["conv_kernel_size"])
    predictors = 3 * (conv1d(n, d, vp, k) + conv1d(n, vp, vp, k) + 2.0 * n * vp)
    return blocks + predictors


def decoder(cfg: dict, T: int) -> float:
    """The mel decoder over T frames."""
    m = cfg["model"]
    d = m["emb_dim"] + m["punct_emb_dim"]
    dec = m["decoder"]
    n_mels = cfg["audio"]["num_mels"]
    if dec["kind"] == "fastspeech2":
        return (dec["n_layers"] * fft_block(T, d, dec["conv_filter_size"], dec["conv_kernel_size"])
                + 2.0 * T * d * n_mels)
    b, r = 2 * d, 64  # StyleTTS: bottleneck 2d, residual 64
    f = conv1d(T, d, d, 3) + conv1d(T, d, b, 3) + conv1d(T, d, b, 1)  # ResBlk1d(d, 2d)
    f += conv1d(T, b, b, 3) * 2  # ResBlk1d(2d, 2d)
    f += conv1d(T, d, r, 1)  # asr_res
    for din, dout in ((b + r, b), (b + r, b), (b + r, d), (d, d), (d, d)):
        f += conv1d(T, din, dout, 3) + conv1d(T, dout, dout, 3)
        f += conv1d(T, din, dout, 1) if din != dout else 0.0
    return f + conv1d(T, d, n_mels, 1)


def vocoder_stages(h: dict, T: int) -> list[tuple[str, float]]:
    """(stage, FLOP) of HiFi-GAN's generator over T mel frames: conv_pre,
    each upsampler and each multi-receptive-field stage, conv_post."""
    c = h["upsample_initial_channel"]
    out = [("conv_pre", conv1d(T, h["num_mels"], c, 7))]
    t = T
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        cin, cout = c // 2 ** i, c // 2 ** (i + 1)
        out.append((f"up{i}", 2.0 * t * cin * cout * k))
        t *= u
        mrf = sum(len(d) * 2 * conv1d(t, cout, cout, ks)
                  for ks, d in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]))
        out.append((f"mrf{i}", mrf))
    out.append(("conv_post", conv1d(t, c // 2 ** len(h["upsample_rates"]), 1, 7)))
    return out


def vocoder(h: dict, T: int) -> float:
    return sum(f for _, f in vocoder_stages(h, T))


def vocoder_params(h: dict) -> int:
    c = h["upsample_initial_channel"]
    n = h["num_mels"] * c * 7 + c
    for i, k in enumerate(h["upsample_kernel_sizes"]):
        cin, cout = c // 2 ** i, c // 2 ** (i + 1)
        n += cin * cout * k + cout
        n += sum(len(d) * 2 * (cout * cout * ks + cout)
                 for ks, d in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]))
    return n + (c // 2 ** len(h["upsample_kernel_sizes"])) * 7 + 1


def vocoder_bytes(h: dict, B: int, T: int, itemsize: int = 4) -> float:
    """Each input byte read once and each output byte written once: the
    mel, the weights, the waveform."""
    hop = 1
    for u in h["upsample_rates"]:
        hop *= u
    return itemsize * (B * T * h["num_mels"] + vocoder_params(h) + B * T * hop)


def speaker_encoder(cfg: dict, W: int) -> float:
    """ResNetSE34V2 over one reference mel of W frames (n_mels x W input)."""
    r = cfg["model"]["resnet"]
    H = cfg["audio"]["num_mels"]
    f = 2.0 * H * W * r["num_filters"][0] * 9
    cin = r["num_filters"][0]
    for stage, (n, c) in enumerate(zip(r["layers"], r["num_filters"])):
        for b in range(n):
            if b == 0 and stage > 0:
                H, W = (H + 1) // 2, (W + 1) // 2
            f += 2.0 * H * W * cin * c * 9 + 2.0 * H * W * c * c * 9
            f += 2 * 2.0 * c * max(1, c // 8)  # the squeeze-excitation's two linears
            if b == 0 and (stage > 0 or cin != c):
                f += 2.0 * H * W * cin * c
            cin = c
    outmap = cin * H
    f += 2 * 2.0 * W * outmap * 128
    return f + 2.0 * 2 * outmap * (cfg["model"]["emb_dim"] + cfg["model"]["punct_emb_dim"])


def synthesis(cfg: dict, n_phones: int, frames: int) -> float:
    """One utterance: encoder and variance adaptor, decoder, vocoder."""
    return encoder(cfg, n_phones) + decoder(cfg, frames) + vocoder(cfg["vocoder"], frames)


def train_step(cfg: dict, phones, frames, ref_frames: int) -> float:
    """One step over a batch at its items' lengths: the forward of the
    speaker encoder, encoder, variance adaptor and decoder, times 3 for
    the backward's two products a forward product."""
    fwd = sum(speaker_encoder(cfg, ref_frames) + encoder(cfg, n) + decoder(cfg, t)
              for n, t in zip(phones, frames))
    return 3.0 * fwd
