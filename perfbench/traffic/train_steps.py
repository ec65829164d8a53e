"""Acoustic-model training: `Trainer.train_step` back to back on a synthetic
corpus fed through the port's `SpeechDataModule` (its buckets and its
device cache), in the seeded order of its batches.

Parameters (the cell's `params`):
  batch           utterances a step
  corpus_items    utterances in the corpus
  mel_frames      [min, max]: an utterance's mel frames, spread evenly
  frames_per_phone  the corpus's mean duration of a phone
  stats           pitch and energy minima and maxima the corpus is normalized by
  trainer         TrainerConfig fields (precision, warmup and total epochs)
  program_options model options of the run (the fused speaker stage)

Set-up builds one Trainer and its state, runs every step of epoch 0 (the
first three are the ones the check follows; the rest warm every bucket of
the corpus), and hands that state to the window, which runs steps from
epoch 1 on until `--seconds` have passed; train_step_ms is the window's
time over its steps, synchronized at both ends.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from reference.model import plain_f32
from reference.train import ReferenceTrainer, batch_plan, collate
from synth import program_configs


def make_corpus(p: dict, seed: int) -> dict:
    """Items with mel lengths spread evenly over p["mel_frames"] (the same
    for every seed, in the seed's order); the seed draws their contents."""
    rng = np.random.default_rng([seed, 4])
    lo, hi = p["mel_frames"]
    n = p["corpus_items"]
    mels = rng.permutation(np.round(lo + (hi - lo) * (np.arange(n) + 0.5) / n).astype(int))
    st = p["stats"]
    c = {k: [] for k in ("phoneme", "puncts", "pitch_raw", "energy_raw", "duration", "mel")}
    for t in mels:
        k = max(2, int(round(t / p["frames_per_phone"])))
        d = 1 + rng.multinomial(t - k, rng.dirichlet(np.full(k, 2.0)))
        c["duration"].append(d.astype(np.int32))
        c["phoneme"].append(rng.integers(1, 28, size=k).astype(np.int32))
        c["puncts"].append(np.where(rng.random(k) < 0.2, rng.integers(1, 10, size=k), 0)
                           .astype(np.int32))
        for name, mn, mx in (("pitch_raw", st["pitch_min"], st["pitch_max"]),
                             ("energy_raw", st["energy_min"], st["energy_max"])):
            u = rng.random(k)
            c[name].append((np.exp(u * np.log(mx - mn + 1.0)) + mn - 1.0).astype(np.float32))
        c["mel"].append(rng.normal(-4.0, 2.0, size=(t, 80)).astype(np.float32))
    # as the data module reads them back: log-min-max normalized, in float32
    c["pitch"] = [np.log(x - np.float32(st["pitch_min"] - 1.0))
                  / np.log(np.float32(st["pitch_max"] - st["pitch_min"] + 1.0)) for x in c["pitch_raw"]]
    c["energy"] = [np.log(x - np.float32(st["energy_min"] - 1.0))
                   / np.log(np.float32(st["energy_max"] - st["energy_min"] + 1.0))
                   for x in c["energy_raw"]]
    return c


def write_corpus(c: dict, base: Path) -> None:
    """The corpus in the preprocessed layout the data module reads."""
    pp = base / "corpus"
    for d in ("mel", "pitch", "energy", "duration"):
        (pp / d).mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(len(c["mel"])):
        b = f"utt{i:05d}"
        np.save(pp / "mel" / f"mel-{b}.npy", c["mel"][i])
        (pp / "mel" / f"startstop-{b}.json").write_text(
            json.dumps({"start_hop": 0, "end_hop": int(c["mel"][i].shape[0])}))
        np.save(pp / "pitch" / f"pitch-{b}.npy", c["pitch_raw"][i])
        np.save(pp / "energy" / f"energy-{b}.npy", c["energy_raw"][i])
        np.save(pp / "duration" / f"duration-{b}.npy", c["duration"][i])
        lines.append(f"{b}.wav|{','.join(map(str, c['phoneme'][i]))}|"
                     f"{','.join(map(str, c['puncts'][i]))}|synthetic")
    (pp / "train.txt").write_text("\n".join(lines) + "\n")


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def run(run) -> None:
    from zerovox_tpu_torch.training.data import SpeechDataModule
    from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig, device_batch

    p = run.params()
    cfg, _ = program_configs(run.cfg, p.get("program_options"))
    run.mark("start")
    corpus = make_corpus(p, run.seed)
    base = Path(os.environ.get("TMPDIR", "/tmp")) / "perfbench-train-corpus"
    shutil.rmtree(base, ignore_errors=True)
    write_corpus(corpus, base)
    st = p["stats"]
    dm = SpeechDataModule([{"path": {"preprocessed_path": "corpus"}}], cfg.symbols(), st,
                          batch_size=p["batch"], num_workers=1, seed=run.seed, base_path=str(base),
                          device_cache=True, device=run.device)
    dm.prepare_data()
    run.mark("corpus")
    tcfg = TrainerConfig(seed=run.seed, **p["trainer"])
    trainer = Trainer(cfg, tcfg, dm.steps_per_epoch(), device=run.device)
    sd, _ = run.weights()
    state = trainer.init_state(sd)
    del sd
    run.mark("trainer")
    names = [n for n, q in state.model.named_parameters() if q.requires_grad]
    p0 = {n: q.detach().clone() for n, q in state.model.named_parameters() if q.requires_grad}

    def epoch_batches(epoch):
        for b in dm.train_dataloader(epoch):
            yield device_batch(b, run.device)

    # epoch 0: steps 1-3 are the checked ones, the rest warm the corpus's buckets
    losses, grad_norms, change_norms = [], None, None
    for i, batch in enumerate(epoch_batches(0)):
        out = trainer.train_step(state, batch)
        if i < 3:
            losses.append(float(out["loss"]))
        if i == 0:
            nu = state.optimizer.nu
            b2 = state.optimizer.b2
            grad_norms = {n: float(torch.sqrt(v.float().sum() / (1.0 - b2))) for n, v in zip(names, nu)}
        if i == 2:
            cur = dict(state.model.named_parameters())
            change_norms = leaf_norms({n: cur[n].detach() - p0[n] for n in names})
            del p0
    shutil.rmtree(base, ignore_errors=True)  # the corpus lives in the device cache now

    steps, epoch = 0, 1
    with run.window():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < run.seconds:
            for batch in epoch_batches(epoch):
                trainer.train_step(state, batch)
                steps += 1
                if time.perf_counter() - t0 >= run.seconds:
                    break
            epoch += 1
    run.read_memory_peak()
    spe = dm.steps_per_epoch()
    run.attempted = steps
    run.e2e["train_step_ms"] = run.window_s * 1e3 / steps
    phones = [len(x) for x in corpus["phoneme"]]
    frames = [m.shape[0] for m in corpus["mel"]]
    window = [items for e in range(1, 2 + steps // spe)
              for items, _ in batch_plan(phones, frames, p["batch"], run.seed, e)][:steps]
    run.values.update(steps=steps, batches=[([phones[i] for i in b], [frames[i] for i in b])
                                            for b in window])
    run.log(steps=steps, window_s=run.window_s, train_step_ms=run.e2e["train_step_ms"],
            steps_per_epoch=spe, losses_first3=losses)
    del state, trainer, dm
    run.free()
    check(run, corpus, losses, grad_norms, change_norms, spe)


def check(run, corpus, losses, grad_norms, change_norms, steps_per_epoch, tf32=False):
    """The reference follows the first three steps from the same weights
    and batches. Compared, each against the reference: the three losses
    (relative gap), each leaf's first clipped gradient norm and each
    leaf's change after three steps (gap over the larger of the leaf's
    reference norm and the median leaf's). Leaves whose reference gradient
    is under a thousandth of the median leaf's move by rounding alone and
    are left out of both."""
    p = run.params()
    plain_f32(tf32)
    sd, _ = run.weights()
    t = p["trainer"]
    ref = ReferenceTrainer(run.cfg, sd, run.device, run.seed,
                           {"steps_per_epoch": steps_per_epoch,
                            "warmup_epochs": t.get("warmup_epochs", 2),
                            "max_epochs": t.get("max_epochs", 40)})
    p0 = {n: q.detach().clone() for n, q in ref.model.named_parameters()}
    del sd
    mel_lens = [m.shape[0] for m in corpus["mel"]]
    plan = batch_plan([len(x) for x in corpus["phoneme"]], mel_lens, p["batch"], run.seed, 0)
    ref_losses, ref_grads = [], None
    for k in range(3):
        items, offs = plan[k]
        loss, g = ref.step(collate(corpus, items, offs, run.device))
        ref_losses.append(loss)
        ref_grads = g if k == 0 else ref_grads
    cur = dict(ref.model.named_parameters())
    ref_change = leaf_norms({n: cur[n].detach() - p0[n] for n in p0})
    med_g = float(np.median(list(ref_grads.values())))
    keep = [n for n in ref_grads if ref_grads[n] >= 1e-3 * med_g and n in grad_norms]
    med_c = float(np.median([ref_change[n] for n in keep]))

    def worst(mine, theirs, med):
        gaps = {n: abs(mine[n] - theirs[n]) / max(theirs[n], med) for n in keep}
        n = max(gaps, key=gaps.get)
        return gaps[n], n

    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    grad_gap, grad_leaf = worst(grad_norms, ref_grads, med_g)
    change_gap, change_leaf = worst(change_norms, ref_change, med_c)
    run.log(losses=losses, ref_losses=ref_losses, leaves=len(grad_norms), compared_leaves=len(keep),
            left_out=sorted(set(grad_norms) - set(keep)), grad_gap_leaf=grad_leaf,
            change_gap_leaf=change_leaf)
    run.check("loss_gap", loss_gap, run.limit("loss_gap"))
    run.check("grad_gap", grad_gap, run.limit("grad_gap"))
    run.check("change_gap", change_gap, run.limit("change_gap"))
