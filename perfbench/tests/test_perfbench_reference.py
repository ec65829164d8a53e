"""The plain reference against the port, at tiny widths on the CPU: the
same weights give the same ids, speaker embedding, durations, mel,
waveform and train step."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH / "tests"), str(BENCH / "traffic"), str(BENCH.parent)]

from tiny import tiny_root  # noqa: E402


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def cfg_of(root, name):
    return json.loads((root / "perfbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ("tts_medium", "tts_medium_styledec"))
def test_synthesis_matches_port(root, name):
    from reference.model import round_durations
    from reference.synth import ReferenceTTS
    from synth import load_voices, program_configs
    from textgen import sentence
    from weights import make_weights
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS

    cfg = cfg_of(root, name)
    sd, vsd, _ = make_weights(cfg, 2**33 + 1, "cpu")
    pc, vc = program_configs(cfg)
    engine = ZeroVoxTTS(pc, sd, vc, vsd, language="en", device="cpu")
    ref = ReferenceTTS(cfg, sd, vsd, "cpu")
    wav = load_voices(["en_linda.wav"])[0]
    spk_p = engine.speaker_embed(wav)
    spk_r = ref.speaker(wav)
    torch.testing.assert_close(spk_r, spk_p, rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(3)
    texts = [sentence(rng, n) for n in (25, 60, 41)]
    outs = engine.tts_batch(texts, spk_p.expand(3, -1, -1))
    ids = [ref.ids(t) for t in texts]
    assert [engine.text2phonemeids(t)[0] for t in texts] == [i[0] for i in ids]
    x, log_d, pad, _, _ = ref.encode(ids, spk_r.expand(3, -1, -1))
    dur = round_durations(log_d, pad)
    T = ref.window_bucket(ids, dur)
    for r, (w, n) in enumerate(outs):
        assert n == int(dur[r].sum())
        mine = ref.render(x[r:r + 1], dur[r:r + 1], spk_r, T)
        np.testing.assert_allclose(mine, w, atol=1e-5)
    # durations near 6 frames a phone, as the weight maker intends
    assert 4.0 < float(dur[~pad].float().mean()) < 9.0


def test_train_step_matches_port(root):
    import train_steps
    from reference.train import ReferenceTrainer, batch_plan, collate
    from synth import program_configs
    from weights import make_weights
    from zerovox_tpu_torch.training.data import SpeechDataModule
    from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig, device_batch

    w = json.loads((root / "perfbench" / "workloads" / "tts_medium.train.json").read_text())
    p, cfg = w["params"], cfg_of(root, "tts_medium")
    seed = 2**32 + 5
    corpus = train_steps.make_corpus(p, seed)
    train_steps.write_corpus(corpus, root / "corpus_base")
    pc, _ = program_configs(cfg, p["program_options"])
    dm = SpeechDataModule([{"path": {"preprocessed_path": "corpus"}}], pc.symbols(), p["stats"],
                          batch_size=p["batch"], num_workers=1, seed=seed,
                          base_path=str(root / "corpus_base"), device_cache=True, device="cpu")
    dm.prepare_data()
    tr = Trainer(pc, TrainerConfig(seed=seed, **p["trainer"]), dm.steps_per_epoch(), device="cpu")
    sd, _, _ = make_weights(cfg, seed, "cpu")
    state = tr.init_state(sd)
    ref = ReferenceTrainer(cfg, sd, "cpu", seed, {"steps_per_epoch": dm.steps_per_epoch(),
                                                  "warmup_epochs": 2, "max_epochs": 40})
    plan = batch_plan([len(x) for x in corpus["phoneme"]], [m.shape[0] for m in corpus["mel"]],
                      p["batch"], seed, 0)
    for k, b in enumerate(dm.train_dataloader(0)):
        if k == 3:
            break
        got = float(tr.train_step(state, device_batch(b, "cpu"))["loss"])
        want, g = ref.step(collate(corpus, *plan[k], "cpu"))
        assert got == pytest.approx(want, rel=1e-5)
        grads = g if k == 0 else grads
    # leaves whose gradient is nought to rounding (a key's bias under the
    # softmax) move by Adam's normalized round-off alone: left out, by rule
    med = float(np.median(list(grads.values())))
    mine = dict(ref.model.named_parameters())
    moved = [n for n, _ in state.model.named_parameters() if grads[n] >= 1e-3 * med]
    assert len(moved) > 0.9 * len(grads)
    for n, q in state.model.named_parameters():
        if n in moved:
            torch.testing.assert_close(q.detach(), mine[n].detach(), rtol=1e-4, atol=1e-6,
                                       msg=n)


@pytest.mark.parametrize("seed", (7, 2**31 + 11))
def test_duration_calibration_holds_the_rate(root, seed):
    """Every seed's weights speak the cell's texts, in their voices, at the
    configuration's frames a phone, each text's frames capped at
    max_mel_len as the engine caps them."""
    from reference.model import round_durations
    from reference.synth import ReferenceTTS
    from synth import load_voices
    from textgen import lognormal_sizes, sentence
    from weights import make_weights

    cfg = cfg_of(root, "tts_medium")
    rng = np.random.default_rng(seed)
    texts = [sentence(rng, int(n)) for n in lognormal_sizes(24, 60, 0.5, 15, 200)]
    voices = load_voices(["en_linda.wav", "de_thorsten.wav"])
    who = rng.integers(0, 2, size=len(texts)).tolist()
    sd, vsd, _ = make_weights(cfg, seed, "cpu", texts, voices=voices, who=who)
    ref = ReferenceTTS(cfg, sd, vsd, "cpu")
    spk = [ref.speaker(w) for w in voices]
    frames = phones = 0
    for t, v in zip(texts, who):
        x, log_d, pad, _, _ = ref.encode([ref.ids(t)], spk[v])
        frames += min(int(round_durations(log_d, pad).sum()), cfg["model"]["max_mel_len"])
        phones += int((~pad).sum())
    target = cfg["assumed"]["duration"]["frames_per_phone"]
    assert frames / phones == pytest.approx(target, abs=0.05)
