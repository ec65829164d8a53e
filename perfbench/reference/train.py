"""The reference's training: the batches a seeded epoch gives, collated
from the corpus arrays, and the plain train step (teacher-forced forward,
the masked loss, backward, global-norm clip, Adam without a first moment
when b1 = 0, the epoch warmup-cosine rate).

The batch plan is the port's documented data order (`training/data.py`):
an rng seeded by (seed, epoch) shuffles the items, sorts each chunk of 32
batches by phone count, cuts full batches (the rest dropped), shuffles the
batches, then draws one child seed a batch for the reference-mel crops.
Dropout draws from a generator on the device seeded by (seed + 1, step),
as the trainer seeds its own, so both sides draw the same masks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .model import Dropout, ZeroVox, train_forward, zerovox_loss

PHONEME_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512)
MEL_BUCKETS = (128, 256, 384, 512, 768, 1024, 1280, 1536, 1792)
REF_LEN = 500


def bucket(n: int, buckets) -> int:
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def batch_plan(phone_lens, mel_lens, batch: int, seed: int, epoch: int):
    """[(item indices, crop offsets)] of one epoch, in step order."""
    rng = np.random.default_rng((seed, epoch))
    idx = rng.permutation(len(phone_lens))
    chunk = batch * 32
    batches = []
    for c0 in range(0, len(idx), chunk):
        part = idx[c0:c0 + chunk]
        part = part[np.argsort(np.asarray([phone_lens[i] for i in part]), kind="stable")]
        for b0 in range(0, (len(part) // batch) * batch, batch):
            batches.append(part[b0:b0 + batch])
    rng.shuffle(batches)
    seeds = rng.integers(np.iinfo(np.int64).max, size=len(batches))
    out = []
    for pos, b in enumerate(batches):
        crng = np.random.default_rng(seeds[pos])
        offs = [int(crng.integers(0, int(mel_lens[i]) - REF_LEN + 1))
                if mel_lens[i] >= REF_LEN else 0 for i in b]
        out.append((np.asarray(b), offs))
    return out


def collate(corpus: dict, items, offs, device) -> dict:
    """One batch as the train step takes it (masks True at padding)."""
    pl = [len(corpus["phoneme"][i]) for i in items]
    ml = [corpus["mel"][i].shape[0] for i in items]
    L, T = bucket(max(pl), PHONEME_BUCKETS), bucket(max(ml), MEL_BUCKETS)
    B, M = len(items), corpus["mel"][items[0]].shape[1]
    out = {k: np.zeros((B, L), np.float32 if k in ("pitch", "energy") else np.int64)
           for k in ("phoneme", "puncts", "pitch", "energy", "duration")}
    out["mel"] = np.zeros((B, T, M), np.float32)
    out["ref_mel"] = np.zeros((B, REF_LEN, M), np.float32)
    for r, (i, off) in enumerate(zip(items, offs)):
        for k in ("phoneme", "puncts", "pitch", "energy", "duration"):
            out[k][r, :pl[r]] = corpus[k][i]
        mel = corpus["mel"][i]
        out["mel"][r, :ml[r]] = mel
        rows = off + np.arange(REF_LEN) if ml[r] >= REF_LEN else np.arange(REF_LEN) % ml[r]
        out["ref_mel"][r] = mel[rows]
    t = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    t["phoneme_mask"] = torch.arange(L, device=device)[None] >= torch.tensor(pl, device=device)[:, None]
    t["mel_mask"] = torch.arange(T, device=device)[None] >= torch.tensor(ml, device=device)[:, None]
    return t


def learning_rate(t: dict, step: int) -> float:
    """The epoch warmup-cosine rate, floored at a tenth of the base."""
    epoch = step // max(t["steps_per_epoch"], 1)
    if epoch < t["warmup_epochs"]:
        f = (epoch + 1.0) / max(t["warmup_epochs"], 1)
    else:
        prog = (epoch - t["warmup_epochs"]) / max(1, t["max_epochs"] - t["warmup_epochs"])
        f = max(0.1, 0.5 * (1.0 + math.cos(math.pi * prog)))
    return t["learning_rate"] * f


class ReferenceTrainer:
    """The plain model in train mode and its optimizer state."""

    def __init__(self, cfg: dict, state_dict: dict, device, seed: int, schedule: dict):
        self.model = ZeroVox(cfg).to(device).train()
        self.model.load_state_dict(state_dict)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.nu = [torch.zeros_like(p) for p in self.params]
        tr = cfg["training"]
        self.b2, self.eps, self.clip = tr["betas"][1], tr["eps"], tr["grad_clip"]
        if tr["betas"][0] != 0.0 or tr["weight_decay"] != 0.0:
            raise ValueError("the reference step takes betas[0] == 0 and no weight decay")
        self.schedule = dict(schedule, learning_rate=tr["learning_rate"])
        self.gen = torch.Generator(device=device)
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self.gen
        self.seed = seed
        self.step_no = 0

    def step(self, batch: dict):
        """-> (loss, {leaf: norm of its clipped gradient})."""
        seq = np.random.SeedSequence([self.seed + 1, self.step_no]).generate_state(1)[0]
        self.gen.manual_seed(int(seq))
        for p in self.params:
            p.grad = None
        loss = zerovox_loss(train_forward(self.model, batch), batch)
        loss.backward()
        with torch.no_grad():
            g = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(x) for x in g]))
            scale = 1.0 if norm < self.clip else self.clip / norm
            g = [x * scale for x in g]
            count = self.step_no + 1
            bc2 = (1.0 - torch.tensor(self.b2, dtype=torch.float32) ** count).item()
            lr = learning_rate(self.schedule, self.step_no)
            for p, n, x in zip(self.params, self.nu, g):
                n.mul_(self.b2).addcmul_(x, x, value=1.0 - self.b2)
                p.sub_(lr * x / (torch.sqrt(n / bc2) + self.eps))
        self.step_no += 1
        return float(loss.detach()), {k: float(torch.linalg.vector_norm(x)) for k, x in zip(self.names, g)}
