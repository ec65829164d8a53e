"""Seeded random weights, made on the device in a few large calls.

The keys and shapes come from the benchmark's own reference modules
(`reference/model.py`), which carry the port's state_dict keys, so one set
of tensors loads into the program and into the reference alike. The rule
is the port's `random_init_`: LeCun-normal matrices and kernels (a
transposed convolution's fan-in is in x k), embeddings with std dim^-1/2,
zero biases, identity norms, weight-norm gains of 1, BatchNorm statistics
at (0, 1).

Random weights predict durations near zero, and how far from it depends on
the seed, so the duration predictor's output layer is set apart (the
configuration's `assumed.duration`): its weights are drawn, then scaled
and its bias set so that over the cell's own texts, each with the voice
the traffic gives it, the predicted log(d + 1) has the standard deviation
`log_std` and the rounded durations (the inference rule), each text's
capped at `max_mel_len` as the engine caps them, average
`frames_per_phone` over the texts' phones. Every seed then speaks its traffic at the same rate
and renders about the same seconds of audio from the same texts' sizes.
The calibration is worked out once a run and handed to the reference
with the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from reference.model import MelDec, WeightNormConv1d, ZeroVox

DURATION_OUT = "_phoneme_encoder._variance_adaptor.duration_predictor.linear_layer"


def _plan(module: nn.Module):
    """[(key, shape, kind, scale)]: kind "normal" (times scale), "const" (scale)."""
    plan = []
    for prefix, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            key = f"{prefix}.{name}" if prefix else name
            if isinstance(mod, nn.Embedding):
                plan.append((key, p.shape, "normal", p.shape[1] ** -0.5))
            elif isinstance(mod, WeightNormConv1d) and name == "weight_g":
                plan.append((key, p.shape, "const", 1.0))
            elif p.dim() < 2:
                plan.append((key, p.shape, "const", 1.0 if name == "weight" else 0.0))
            else:
                fan_in = p.shape[0] * p.shape[2] if isinstance(mod, nn.ConvTranspose1d) \
                    else p[0].numel()
                plan.append((key, p.shape, "normal", fan_in ** -0.5))
        for name, b in mod.named_buffers(recurse=False):
            key = f"{prefix}.{name}" if prefix else name
            const = 1.0 if name in ("running_var", "scale") else 0.0
            plan.append((key, b.shape, "const" if b.is_floating_point() else "long", const))
    return plan


def _fill(module: nn.Module, gen: torch.Generator, device, overrides=None) -> dict:
    plan = _plan(module)
    overrides = overrides or {}
    normal = [(k, s, sc) for k, s, kind, sc in plan if kind == "normal"]
    total = sum(math.prod(s) for _, s, _ in normal)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for k, s, sc in normal:
        n = math.prod(s)
        out[k] = flat[off:off + n].view(s).mul_(overrides.get(k, sc))
        off += n
    for k, s, kind, c in plan:
        if kind == "const":
            out[k] = torch.full(s, overrides.get(k, c), device=device, dtype=torch.float32)
        elif kind == "long":
            out[k] = torch.zeros(s, device=device, dtype=torch.long)
    return out


@torch.no_grad()
def duration_calibration(cfg: dict, sd: dict, device, texts=None, voices=None,
                         who=None) -> tuple[float, float]:
    """(scale of the duration predictor's output weights, its bias) that
    give its predictions over `texts` (the traffic's own, by default a
    fixed set of 15-400 characters), each with the speaker of the wav
    voices[who[i]] (none by default), the configuration's spread of log
    durations, and make the texts' frames, each text's rounded durations
    summed and capped at max_mel_len as the engine caps them, average the
    configuration's frames a phone. Long texts whose durations the seed
    makes longer lose frames to the cap; counting the cap keeps the audio
    the same for every seed."""
    from reference.model import log_mel, round_durations, trim_silence
    from reference.text import Symbols, ZeroVoxNormalizer, text_ids
    from textgen import lognormal_sizes, sentence

    m = cfg["model"]
    sym, norm = Symbols(m["phones"], m["puncts"]), ZeroVoxNormalizer(cfg["lang"][0])
    if texts is None:
        rng = np.random.default_rng(0)
        texts = [sentence(rng, int(n)) for n in lognormal_sizes(32, 110, 0.6, 15, 400)]
    who = list(who) if voices is not None else [None] * len(texts)
    rows = sorted(((text_ids(t.strip(), sym, norm), v, k) for k, (t, v) in
                   enumerate(zip(texts, who))), key=lambda r: len(r[0][0]))
    with torch.device("meta"):
        model = ZeroVox(cfg).eval()
    model.load_state_dict(sd, assign=True)
    spk = [model._spkemb(log_mel(trim_silence(np.asarray(w, np.float32)), cfg["audio"],
                                 device)[None]) for w in voices or ()]
    enc = model._phoneme_encoder
    w = sd[f"{DURATION_OUT}.weight"][0]
    z, owner = [], []
    for b in range(0, len(rows), 64):  # rows of similar length together
        part = rows[b:b + 64]
        L = max(len(p) for (p, _), _, _ in part)
        ph = torch.zeros((len(part), L), dtype=torch.long)
        pu = torch.zeros_like(ph)
        pad = torch.ones((len(part), L), dtype=torch.bool)
        for i, ((p, q), _, _) in enumerate(part):
            ph[i, :len(p)], pu[i, :len(p)], pad[i, :len(p)] = torch.tensor(p), torch.tensor(q), False
        ph, pu, pad = ph.to(device), pu.to(device), pad.to(device)
        x = enc._encoder(ph, pu, pad)
        if spk:
            x = x + torch.cat([spk[v] for _, v, _ in part])
        h = enc._variance_adaptor.duration_predictor.conv_layer(x)
        z.append((h @ w)[~pad].double())
        owner.append(torch.tensor([k for (p, _), _, k in part], device=device)
                     .repeat_interleave(torch.tensor([len(p) for (p, _), _, _ in part],
                                                     device=device)))
    z, owner = torch.cat(z), torch.cat(owner)
    dur = cfg["assumed"]["duration"]
    scale = dur["log_std"] / float(z.std())
    z = z * scale
    no_pad = torch.zeros_like(z, dtype=torch.bool)

    def frames(bias):  # the texts' frames as the engine renders them: capped
        d = round_durations(z + bias, no_pad).double()
        per_text = torch.zeros(len(texts), dtype=d.dtype, device=d.device).index_add_(0, owner, d)
        return float(per_text.clamp(max=m["max_mel_len"]).sum())

    want = dur["frames_per_phone"] * len(z)
    lo, hi = -8.0, 8.0  # frames rise with the bias
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if frames(mid) < want else (lo, mid)
    return scale, hi


def make_weights(cfg: dict, seed: int, device, texts=None, calibration=None, voices=None,
                 who=None):
    """(acoustic model state_dict, vocoder state_dict, duration calibration)
    on `device`, float32, from `seed` (any non-negative integer); the
    calibration is worked out over `texts` with their voices unless given."""
    with torch.device("meta"):
        model, vocoder = ZeroVox(cfg), MelDec(cfg["vocoder"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    sd = _fill(model, gen, device)
    vsd = _fill(vocoder, gen, device)
    calibration = calibration or duration_calibration(cfg, sd, device, texts, voices, who)
    sd[f"{DURATION_OUT}.weight"].mul_(calibration[0])
    sd[f"{DURATION_OUT}.bias"].fill_(calibration[1])
    return sd, vsd, calibration
