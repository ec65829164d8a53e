"""Training data: the preprocessed corpus on disk -> bucketed host batches.

The PyTorch package's own copy of the host path of the JAX package's
`training/data.py`, with the same on-disk contract and the same batches for
the same seed:

  * per-corpus `train.txt` metadata (`wav|phones|puncts|text`), per-utterance
    `mel-/pitch-/energy-/duration-*.npy` and `startstop-*.json` files;
    items without a duration file are skipped. Pitch and energy are
    log-min-max normalized to [0, 1] with the corpus stats;
  * `collate` pads phoneme and mel lengths up to static buckets and crops a
    fixed-length zero-shot reference mel from each item's own mel (tiled
    when the item is shorter than the crop);
  * `SpeechDataModule.train_dataloader(epoch)` shuffles with an rng seeded
    by (seed, epoch), groups similar lengths, and loads and collates in a
    thread pool while yielding batches strictly in order;
  * with `device_cache`, the whole bucket-padded corpus is uploaded to the
    device once (`_DeviceCorpusCache`, the JAX package's counterpart) and
    each batch is gathered there from its index and crop-offset vectors,
    drawn from the same rng streams as the host path, so the batches are
    the host path's bit for bit. A corpus over DEVICE_CACHE_BYTE_LIMIT
    (checked on the host arrays' sizes, before anything is allocated)
    falls back to host loading.

Host batches are numpy; `training.trainer.device_batch` moves them to the
card. Cached batches are tensors on the device already.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from zerovox_tpu_torch.symbols import Symbols

MAX_REF_LEN = 500

PHONEME_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512)
MEL_BUCKETS = (128, 256, 384, 512, 768, 1024, 1280, 1536, 1792)


def preprocessed_data_path() -> str:
    p = os.environ.get("ZEROVOX_PREPROCESSED_DATA_PATH", "")
    if not p:
        raise RuntimeError("ZEROVOX_PREPROCESSED_DATA_PATH env var is not set")
    return p


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


@dataclass
class Sample:
    preprocessed_path: str
    filename: str
    phonemes: list
    puncts: list
    transcript: str


class SpeechDataset:
    """Metadata index + per-item feature loading."""

    def __init__(self, filename: str, corpora, symbols: Symbols, stats: dict,
                 base_path: str | None = None):
        self._symbols = symbols
        self._stats = stats
        self.samples: list[Sample] = []

        base = base_path if base_path is not None else preprocessed_data_path()
        for corpus in corpora:
            pp = os.path.join(base, corpus["path"]["preprocessed_path"])
            meta = os.path.join(pp, filename)
            if not os.path.exists(meta):
                continue
            with open(meta, encoding="utf-8") as f:
                for line in f:
                    wav, phones, puncts, transcript = line.strip("\n").split("|")
                    basename = os.path.splitext(wav)[0]
                    dur_path = os.path.join(pp, "duration", f"duration-{basename}.npy")
                    if not os.path.exists(dur_path):
                        print(f"{dur_path} missing -> skipping sample")
                        continue
                    self.samples.append(Sample(
                        preprocessed_path=pp, filename=wav,
                        phonemes=[int(p) for p in phones.split(",")],
                        puncts=[int(p) for p in puncts.split(",")],
                        transcript=transcript))

    def __len__(self) -> int:
        return len(self.samples)

    def load_item(self, idx: int) -> dict:
        s = self.samples[idx]
        basename = os.path.splitext(s.filename)[0]
        pp = s.preprocessed_path

        mel = np.load(os.path.join(pp, "mel", f"mel-{basename}.npy")).astype(np.float32)
        with open(os.path.join(pp, "mel", f"startstop-{basename}.json")) as f:
            d = json.load(f)
        pitch = np.load(os.path.join(pp, "pitch", f"pitch-{basename}.npy")).astype(np.float32)
        energy = np.load(os.path.join(pp, "energy", f"energy-{basename}.npy")).astype(np.float32)
        duration = np.load(os.path.join(pp, "duration", f"duration-{basename}.npy")).astype(np.int32)

        st = self._stats
        pitch = np.log(pitch - (st["pitch_min"] - 1.0))
        pitch = pitch / np.log(st["pitch_max"] - st["pitch_min"] + 1.0)
        energy = np.log(energy - (st["energy_min"] - 1.0))
        energy = energy / np.log(st["energy_max"] - st["energy_min"] + 1.0)

        return {
            "phoneme": np.asarray(s.phonemes, np.int32),
            "puncts": np.asarray(s.puncts, np.int32),
            "text": s.transcript,
            "pitch": pitch.astype(np.float32),
            "energy": energy.astype(np.float32),
            "duration": duration,
            "mel": mel,
            "basename": basename,
            "preprocessed_path": pp,
            "start_hop": d["start_hop"],
            "end_hop": d["end_hop"],
        }


def collate(items: list[dict], rng: np.random.Generator, ref_mel_len: int = MAX_REF_LEN,
            phoneme_buckets=PHONEME_BUCKETS, mel_buckets=MEL_BUCKETS) -> tuple[dict, dict]:
    """Pad a list of items into one statically bucketed batch (x, y)."""
    B = len(items)
    phoneme_lens = np.asarray([len(it["phoneme"]) for it in items], np.int32)
    mel_lens = np.asarray([it["mel"].shape[0] for it in items], np.int32)

    L = _bucket(int(phoneme_lens.max()), phoneme_buckets)
    T = _bucket(int(mel_lens.max()), mel_buckets)
    n_mels = items[0]["mel"].shape[1]

    phonemes = np.zeros((B, L), np.int32)
    puncts = np.zeros((B, L), np.int32)
    pitch = np.zeros((B, L), np.float32)
    energy = np.zeros((B, L), np.float32)
    duration = np.zeros((B, L), np.int32)
    mels = np.zeros((B, T, n_mels), np.float32)
    ref_mels = np.zeros((B, ref_mel_len, n_mels), np.float32)

    for i, it in enumerate(items):
        n, t = phoneme_lens[i], mel_lens[i]
        phonemes[i, :n] = it["phoneme"]
        puncts[i, :n] = it["puncts"]
        pitch[i, :n] = it["pitch"][:n]
        energy[i, :n] = it["energy"][:n]
        duration[i, :n] = it["duration"][:n]
        mels[i, :t] = it["mel"]
        # fixed-length zero-shot reference crop of the item's own mel
        if t >= ref_mel_len:
            off = rng.integers(0, t - ref_mel_len + 1)
            ref_mels[i] = it["mel"][off:off + ref_mel_len]
        else:
            reps = int(np.ceil(ref_mel_len / t))
            ref_mels[i] = np.tile(it["mel"], (reps, 1))[:ref_mel_len]

    x = {
        "phoneme": phonemes,
        "puncts": puncts,
        "phoneme_len": phoneme_lens,
        "phoneme_mask": np.arange(L)[None, :] >= phoneme_lens[:, None],
        "text": [it["text"] for it in items],
        "mel_len": mel_lens,
        "mel_mask": np.arange(T)[None, :] >= mel_lens[:, None],
        "pitch": pitch,
        "energy": energy,
        "duration": duration,
        "ref_mel": ref_mels,
        "basenames": [it["basename"] for it in items],
        "preprocessed_paths": [it["preprocessed_path"] for it in items],
        "starts": [it["start_hop"] for it in items],
        "ends": [it["end_hop"] for it in items],
    }
    return x, {"mel": mels}


# A device-resident corpus pays only while the whole padded feature store fits
# comfortably beside the parameters and activations (the JAX package's budget).
DEVICE_CACHE_BYTE_LIMIT = 2 << 30


class _DeviceCorpusCache:
    """Every item's features, bucket-padded, resident on `device`; a batch
    is an on-device gather by its index and reference-crop-offset vectors,
    so a step moves tens of bytes from the host instead of megabytes."""

    FIELDS = ("phoneme", "puncts", "pitch", "energy", "duration")

    def __init__(self, items: list[dict]):
        self.items = items
        self.n = len(items)
        self.lmax = _bucket(max(len(it["phoneme"]) for it in items), PHONEME_BUCKETS)
        self.tmax = _bucket(max(it["mel"].shape[0] for it in items), MEL_BUCKETS)
        self.n_mels = items[0]["mel"].shape[1]
        # the padded host arrays' bytes, known before any of them exists
        self.nbytes = 4 * self.n * (5 * self.lmax + self.tmax * self.n_mels + 2)
        self.phoneme_len = np.asarray([len(it["phoneme"]) for it in items], np.int32)
        self.mel_len = np.asarray([it["mel"].shape[0] for it in items], np.int32)

    def upload(self, device) -> None:
        n, lmax = self.n, self.lmax
        host = {k: np.zeros((n, lmax), np.float32 if k in ("pitch", "energy") else np.int32)
                for k in self.FIELDS}
        host["mel"] = np.zeros((n, self.tmax, self.n_mels), np.float32)
        for i, it in enumerate(self.items):
            ln, t = self.phoneme_len[i], self.mel_len[i]
            for k in self.FIELDS:
                host[k][i, :ln] = it[k][:ln]
            host["mel"][i, :t] = it["mel"]
        host["phoneme_len"], host["mel_len"] = self.phoneme_len, self.mel_len
        self.data = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        self.items = None

    def gather(self, bidx: np.ndarray, ref_off: np.ndarray, L: int, T: int,
               ref_len: int) -> tuple[dict, dict]:
        d = self.data
        dev = d["mel"].device
        idx = torch.as_tensor(np.asarray(bidx, np.int64), device=dev)
        off = torch.as_tensor(np.asarray(ref_off, np.int64), device=dev)
        plen, mlen = d["phoneme_len"][idx], d["mel_len"][idx]
        mel_full = d["mel"][idx]  # [B, Tmax, M]
        # as the host collate: a crop at the offset when the item is long
        # enough, the item tiled from its start otherwise
        r = torch.arange(ref_len, device=dev)[None, :]
        rows = torch.where(mlen[:, None] >= ref_len, off[:, None] + r,
                           r % torch.clamp(mlen, min=1)[:, None].long())
        ref = torch.gather(mel_full, 1, rows[..., None].expand(-1, -1, mel_full.shape[2]))
        x = {k: d[k][idx, :L] for k in self.FIELDS}
        x.update(phoneme_len=plen, mel_len=mlen, ref_mel=ref,
                 phoneme_mask=torch.arange(L, device=dev)[None, :] >= plen[:, None],
                 mel_mask=torch.arange(T, device=dev)[None, :] >= mlen[:, None])
        return x, {"mel": mel_full[:, :T]}


class SpeechDataModule:
    """Shuffled, length-bucketed, prefetching batch iterator. With
    `device_cache`, batches are gathered on `device` (None: the card)."""

    def __init__(self, corpora, symbols: Symbols, stats: dict, batch_size: int = 64,
                 num_workers: int = 4, seed: int = 0, ref_mel_len: int = MAX_REF_LEN,
                 base_path: str | None = None, drop_last: bool = True,
                 device_cache: bool = False, device=None):
        self.corpora = corpora
        self._symbols = symbols
        self._stats = stats
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._ref_mel_len = ref_mel_len
        self._base_path = base_path
        # drop_last=False pads the tail batch with wrap-around duplicates
        # (x["pad_items"] counts them, at the end of the batch)
        self.drop_last = drop_last
        self.device_cache = device_cache
        self._device = device
        self._cache: _DeviceCorpusCache | None = None
        self.train_dataset: SpeechDataset | None = None

    def prepare_data(self):
        self.train_dataset = SpeechDataset("train.txt", self.corpora, self._symbols, self._stats,
                                           base_path=self._base_path)

    def steps_per_epoch(self) -> int:
        assert self.train_dataset is not None
        return max(1, len(self.train_dataset) // self.batch_size)

    def _batch_indices(self, rng):
        """Shuffle, then group length-adjacent items so bucket padding is
        tight. Returns (index_array, n_pad) pairs; n_pad > 0 only on the tail
        batch when drop_last is False."""
        ds = self.train_dataset
        idx = rng.permutation(len(ds))
        chunk = self.batch_size * 32
        batches, leftovers = [], []
        for c0 in range(0, len(idx), chunk):
            part = idx[c0:c0 + chunk]
            lens = np.asarray([len(ds.samples[i].phonemes) for i in part])
            part = part[np.argsort(lens, kind="stable")]
            n_full = (len(part) // self.batch_size) * self.batch_size
            for b0 in range(0, n_full, self.batch_size):
                batches.append((part[b0:b0 + self.batch_size], 0))
            leftovers.extend(part[n_full:])
        if not self.drop_last:
            for b0 in range(0, len(leftovers), self.batch_size):
                b = np.asarray(leftovers[b0:b0 + self.batch_size])
                n_pad = self.batch_size - len(b)
                if n_pad:
                    b = np.concatenate([b, idx[:n_pad]])
                batches.append((b, n_pad))
        rng.shuffle(batches)
        return batches

    def train_dataloader(self, epoch: int | None = None):
        """Generator of (x, y) host batches. With `epoch` given, batch order
        and reference crops come from an rng seeded by (seed, epoch), so the
        data of an epoch does not depend on what ran before it. Per-batch
        child seeds are drawn up front and batches are yielded in position
        order, so the worker count changes nothing."""
        assert self.train_dataset is not None, "call prepare_data() first"
        if self.device_cache and self._cache is None:
            self._build_cache()
        if self.device_cache:
            yield from self._device_dataloader(epoch)
            return
        ds = self.train_dataset
        rng = np.random.default_rng((self._seed, epoch)) if epoch is not None else self._rng
        batches = self._batch_indices(rng)
        seeds = rng.integers(np.iinfo(np.int64).max, size=len(batches))
        q: queue.Queue = queue.Queue(maxsize=self.num_workers * 2)

        def worker(batch_list):
            for pos, (bidx, n_pad) in batch_list:
                items = [ds.load_item(int(i)) for i in bidx]
                x, y = collate(items, np.random.default_rng(seeds[pos]),
                               ref_mel_len=self._ref_mel_len)
                x["pad_items"] = n_pad
                q.put((pos, (x, y)))

        n_workers = min(self.num_workers, max(1, len(batches)))
        indexed = list(enumerate(batches))
        for i in range(n_workers):
            threading.Thread(target=worker, args=(indexed[i::n_workers],), daemon=True).start()

        pending: dict[int, tuple] = {}
        for next_pos in range(len(batches)):
            while next_pos not in pending:
                pos, item = q.get()
                pending[pos] = item
            yield pending.pop(next_pos)

    def _build_cache(self) -> None:
        from zerovox_tpu_torch.device import resolve_device

        ds = self.train_dataset
        cache = _DeviceCorpusCache([ds.load_item(i) for i in range(len(ds))])
        if cache.nbytes > DEVICE_CACHE_BYTE_LIMIT:
            print(f"device corpus cache disabled: corpus {cache.nbytes / 1e6:.0f} MB exceeds the "
                  f"{DEVICE_CACHE_BYTE_LIMIT / 1e6:.0f} MB HBM budget")
            self.device_cache = False
            return
        cache.upload(resolve_device(self._device))
        self._cache = cache
        print(f"device corpus cache: {len(ds)} items, {cache.nbytes / 1e6:.1f} MB resident on device")

    def _device_dataloader(self, epoch: int | None = None):
        """The host path's batches (same rng streams: batch order and crop
        offsets), gathered on the device."""
        rng = np.random.default_rng((self._seed, epoch)) if epoch is not None else self._rng
        batches = self._batch_indices(rng)
        seeds = rng.integers(np.iinfo(np.int64).max, size=len(batches))
        cache, ref_len = self._cache, self._ref_mel_len
        for pos, (bidx, n_pad) in enumerate(batches):
            crng = np.random.default_rng(seeds[pos])
            bidx = np.asarray(bidx)
            mlen = cache.mel_len[bidx]
            L = _bucket(int(cache.phoneme_len[bidx].max()), PHONEME_BUCKETS)
            T = _bucket(int(mlen.max()), MEL_BUCKETS)
            # collate's draws: one per item long enough for a crop, in item order
            offs = np.zeros(len(bidx), np.int64)
            for i, t in enumerate(mlen):
                if t >= ref_len:
                    offs[i] = crng.integers(0, int(t) - ref_len + 1)
            x, y = cache.gather(bidx, offs, L, T, ref_len)
            x["pad_items"] = n_pad
            yield x, y
