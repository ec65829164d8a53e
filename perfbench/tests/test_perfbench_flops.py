"""The operation counts against hand counts and against torch's own count of
the reference model's products."""

import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH / "tests")]

from flops import zerovox as fl  # noqa: E402


def config(name="tts_medium"):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_vocoder_stage_hand_counts():
    h = config()["vocoder"]
    st = dict(fl.vocoder_stages(h, 689))  # bucket 689: 44096 rows after two 8x stages
    # K1: 252 C^2 FLOP a row at C = 128 over [1, 44096, 128]
    assert st["mrf1"] == pytest.approx(182.06e9, rel=1e-4)
    assert st["mrf1"] == 252 * 44096 * 128 ** 2
    # K2's stage: upsampler (128 -> 64, k 4) + the MRF at C = 64 over 88192 rows
    assert st["up2"] + st["mrf2"] == pytest.approx(93.92e9, rel=1e-4)
    assert st["up3"] + st["mrf3"] + st["conv_post"] == pytest.approx(47.04e9, rel=1e-3)
    # ~54 GFLOP an audio second at 22050 Hz (256 samples a frame)
    per_s = fl.vocoder(h, 1000) / (1000 * 256 / 22050)
    assert 50e9 < per_s < 60e9


def test_vocoder_params_count():
    from reference.model import MelDec

    h = config()["vocoder"]
    with torch.device("meta"):
        n = sum(p.numel() for p in MelDec(h).generator.parameters())
    assert fl.vocoder_params(h) == n


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ("tts_medium", "tts_medium_styledec"))
def test_model_counts_match_torch_count(name):
    """At tiny widths: the analytic encoder, decoder, vocoder and speaker
    encoder against FlopCounterMode on the reference model (products only;
    the speaker-conditional norms' per-utterance projections are left out
    of the analytic count, a fraction of a per cent)."""
    from tiny import TINY_DECODER, TINY_MODEL

    from reference.model import MelDec, ZeroVox

    cfg = config(name)
    m = cfg["model"]
    m.update({k: v for k, v in TINY_MODEL.items() if k not in ("encoder", "resnet")})
    m["encoder"], m["resnet"] = TINY_MODEL["encoder"], TINY_MODEL["resnet"]
    m["decoder"].update(TINY_DECODER)
    cfg["vocoder"]["upsample_initial_channel"] = 64
    torch.manual_seed(0)
    model, voc = ZeroVox(cfg).eval(), MelDec(cfg["vocoder"]).eval()
    d = m["emb_dim"] + m["punct_emb_dim"]
    n, T, W = 37, 211, 120
    ph = torch.randint(1, 27, (1, n))
    pad = torch.zeros(1, n, dtype=torch.bool)
    spk = torch.randn(1, 1, d)
    with torch.no_grad():
        enc = _counted(lambda: model.encode(ph, ph % 9, spk, pad))
        x = torch.randn(1, n, d)
        dur = torch.full((1, n), T // n)
        dur[0, -1] += T - int(dur.sum())
        dec = _counted(lambda: model.decode(x, dur, spk, T))
        voc_f = _counted(lambda: voc(torch.randn(1, T, 80)))
        spk_f = _counted(lambda: model._spkemb(torch.randn(1, W, 80)))
    assert fl.encoder(cfg, n) == pytest.approx(enc, rel=1e-9)
    assert fl.decoder(cfg, T) == pytest.approx(dec, rel=5e-3)
    assert fl.vocoder(cfg["vocoder"], T) == pytest.approx(voc_f, rel=1e-9)
    assert fl.speaker_encoder(cfg, W) == pytest.approx(spk_f, rel=1e-6)


def test_train_step_is_three_forwards():
    cfg = config()
    one = fl.speaker_encoder(cfg, 500) + fl.encoder(cfg, 80) + fl.decoder(cfg, 500)
    assert fl.train_step(cfg, [80, 80], [500, 500], 500) == pytest.approx(6 * one)
