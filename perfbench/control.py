"""The control of the check: the plain reference computed in TF32 (the
precision below the configurations' float32 with TF32 off) put in the
program's place, held to the float32 reference by the cell's own check.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 [--seconds 5]

For each seed it makes the cell's traffic, produces every answer of a
short window with the TF32 reference (serving: whole requests grouped in
arrival order into windows of the batcher's size, streams one by one;
offline: the job's calls; training: the first three steps), runs the
cell's check on them and prints one JSON line of the numbers compared
and whether the control came out correct (it should not). Its numbers set
the upper end of each limit (PERF.md). Runs on the CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import harness  # noqa: E402
from reference.model import plain_f32, round_durations  # noqa: E402
from reference.synth import (MEL_BUCKETS, SPEC_FRAMES_PER_PHONE, ReferenceTTS,  # noqa: E402
                             pick_bucket, stream_pieces)
from synth import load_voices  # noqa: E402


class Producer:
    """The reference in TF32, rendering as the program renders."""

    def __init__(self, run, voices, texts, who):
        plain_f32(True)
        sd, vsd = run.weights(texts, voices, who)
        self.ref = ReferenceTTS(run.cfg, sd, vsd, run.device)
        self.spk = [self.ref.speaker(w) for w in voices]

    def batch(self, texts, voices):
        ids = [self.ref.ids(t) for t in texts]
        spk = torch.cat([self.spk[v] for v in voices])
        x, log_d, pad, _, _ = self.ref.encode(ids, spk)
        dur = round_durations(log_d, pad)
        T = self.ref.window_bucket(ids, dur)
        return [self.ref.render(x[r:r + 1], dur[r:r + 1], spk[r:r + 1], T)
                for r in range(len(texts))]

    def stream(self, text, voice, chunk):
        out = []
        for piece in stream_pieces(text, self.ref.max_txt):
            ids = [self.ref.ids(piece)]
            if not ids[0][0]:
                continue
            x, log_d, pad, _, _ = self.ref.encode(ids, self.spk[voice])
            dur = round_durations(log_d, pad)
            n = len(ids[0][0])
            mel_len = self.ref.mel_len(dur, True)
            T = pick_bucket(min(SPEC_FRAMES_PER_PHONE * n + 16, self.ref.max_mel), MEL_BUCKETS)
            T = T if mel_len <= T else pick_bucket(mel_len, MEL_BUCKETS)
            out.append(self.ref.render(x, dur, self.spk[voice], T, chunk))
        return out


def serve(run, seconds):
    import open_loop_serve as kind

    p = run.params()
    reqs = kind.make_requests(p, np.random.default_rng([run.seed, 1]), seconds)
    voices = load_voices(p["voices"])
    prod = Producer(run, voices, [r.text for r in reqs], [r.voice for r in reqs])
    whole = [r for r in reqs if not r.stream]
    calls = [whole[i:i + p["max_batch"]] for i in range(0, len(whole), p["max_batch"])]
    for call in calls:
        for r, w in zip(call, prod.batch([r.text for r in call], [r.voice for r in call])):
            r.wav, r.done = w, 0.0
    for r in reqs:
        if r.stream:
            r.pieces = [[w] for w in prod.stream(r.text, r.voice, p["chunk_frames"])]
            r.done = 0.0
    del prod
    kind.check(run, reqs, [[id(r.text) for r in c] for c in calls], voices)


def batch(run, seconds):
    import offline_batch as kind

    p = run.params()
    texts, who = kind.make_job(p, np.random.default_rng([run.seed, 1]))
    voices = load_voices(p["voices"])
    prod = Producer(run, voices, texts, who)
    B, done = p["batch"], []
    for i in range(max(1, int(seconds))):
        rows = list(range(i * B, (i + 1) * B))
        wavs = prod.batch([texts[r] for r in rows], [who[r] for r in rows])
        done.append((rows, [(w, len(w) // run.cfg["audio"]["hop_size"]) for w in wavs]))
    del prod
    kind.check(run, texts, who, done, voices)


def train(run, seconds, fault="tf32"):
    """fault "tf32": the reference in TF32; "half": the reference in
    float32 on the first half of each batch's rows (the mean over the rest)."""
    import train_steps as kind
    from reference.train import ReferenceTrainer, batch_plan, collate

    p = run.params()
    corpus = kind.make_corpus(p, run.seed)
    spe = p["corpus_items"] // p["batch"]
    t = p["trainer"]
    plain_f32(fault == "tf32")
    sd, _ = run.weights()
    ref = ReferenceTrainer(run.cfg, sd, run.device, run.seed,
                           {"steps_per_epoch": spe, "warmup_epochs": t["warmup_epochs"],
                            "max_epochs": t["max_epochs"]})
    p0 = {n: q.detach().clone() for n, q in ref.model.named_parameters()}
    plan = batch_plan([len(x) for x in corpus["phoneme"]], [m.shape[0] for m in corpus["mel"]],
                      p["batch"], run.seed, 0)
    losses, grads = [], None
    for k in range(3):
        batch = collate(corpus, *plan[k], run.device)
        if fault == "half":
            batch = {key: v[: p["batch"] // 2] for key, v in batch.items()}
        loss, g = ref.step(batch)
        losses.append(loss)
        grads = g if k == 0 else grads
    cur = dict(ref.model.named_parameters())
    change = kind.leaf_norms({n: cur[n].detach() - p0[n] for n in p0})
    del ref, p0, cur
    kind.check(run, corpus, losses, grads, change, spe)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", choices=("tf32", "half"), default="tf32",
                    help="half: the training cell's half-batch fault instead of the control")
    args = ap.parse_args(argv)
    harness.set_cache_env()
    sys.path.insert(0, str(harness.BENCH_DIR / "traffic"))
    for seed in args.seeds:
        run = harness.Run(args.workload, seed, args.seconds, False)
        kind = run.workload["traffic"]
        if kind == "train_steps":
            train(run, args.seconds, args.fault)
        else:
            {"open_loop_serve": serve, "offline_batch": batch}[kind](run, args.seconds)
        ok = all(v <= lim for _, v, lim in run.checks)
        print(json.dumps({"control": args.workload, "fault": args.fault, "seed": seed,
                          "correct": ok,
                          "checks": {n: v for n, v, _ in run.checks}},
                         default=lambda x: None if isinstance(x, float) and math.isnan(x) else x),
              flush=True)
        harness.Run.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
