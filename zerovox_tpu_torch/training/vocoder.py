"""HiFi-GAN adversarial vocoder training on a CUDA card, or data parallel on several.

The PyTorch counterpart of the JAX package's `training/vocoder.py`:

  * `VocoderDataset` samples fixed-length (mel, wav) segments from
    preprocess output dirs (`train.txt`, `wavs/`, `mel/`,
    `mel/startstop-*.json`) or `.h5` export dirs (`feats` + `wave`), every
    item preloaded, items shorter than a segment padded; one epoch's plan of
    (item, offset) draws comes from a numpy `default_rng(seed)`, so a seed
    gives the JAX package's batches bit for bit. `device_batches` keeps the
    corpus on the card and cuts each step's segments there from the plan:
    bitwise `batches`;
  * `make_batched_logmel` is the mel loss's frontend: reflect pad, frames,
    `torch.fft.rfft`, the Slaney filterbank, log(clip(., 1e-5));
  * `make_vocoder_step` is one GAN round in upstream HiFi-GAN's order: the
    discriminators' update on the detached fake, then the generator's
    (LSGAN adversarial + feature matching (x2) + 45 x mel L1) against the
    updated discriminators. The generator's forward runs once: its output,
    detached, is the discriminators' fake (the JAX step recomputes it from
    the same weights, so the values are the same). `precision="bf16-mixed"`
    runs both nets on bf16 copies of their float32 weights and inputs, as
    the JAX step's `_half`, and reduces every loss in float32; `split=True`
    runs the round as two calls (`.parts = (d_step, g_step)`, the JAX
    step's two programs) with the same math;
  * the optimizers are `optax.adamw` as the JAX trainer configures them (b1
    0.8, b2 0.99, eps 1e-8, weight decay 0.01 on every parameter, no
    clipping) on optax's staircase exponential decay per epoch;
  * `VocoderTrainer.fit` logs each epoch's last losses (fetched from the
    card only then) to `losses.json`, and every `checkpoint_every_n_epochs`
    (and at the end) writes `checkpoints/vocoder-NNNN.pt` (both nets, both
    optimizers, step, epoch; `restore_state` continues from it, and from
    the JAX trainer's `vocoder-NNNN.msgpack`, which `save_jax_state`
    writes) and the inference contract `config.json` + `generator.msgpack`,
    which both packages' engines load as a meldec dir;
  * with a `mesh` over a process group the trainer is data parallel (see
    `VocoderTrainer`); a data x model mesh replicates the nets over
    `model`, as the JAX vocoder trainer does.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, dataclass
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from zerovox_tpu_torch.device import resolve_device, use_full_f32
from zerovox_tpu_torch.models.hifigan import (Generator, HifiGanConfig, MultiPeriodDiscriminator,
                                              MultiScaleDiscriminator, discriminator_loss,
                                              feature_loss, generator_loss)
from zerovox_tpu_torch.parallel.mesh import (Mesh, all_reduce_grads, all_reduce_values,
                                             process_device, replicate, shard_batch)
from zerovox_tpu_torch.training.optim import AdamW, exponential_decay_schedule

# ----------------------------------------------------------------- data


@dataclass
class VocoderDataConfig:
    sampling_rate: int = 22050
    fft_size: int = 1024
    hop_size: int = 256
    win_length: int = 1024
    num_mels: int = 80
    fmin: float = 0.0
    fmax: float | None = 8000.0
    segment_frames: int = 32  # 32 * 256 = 8192 samples, upstream default


class VocoderDataset:
    """Random fixed-length (mel, wav) segments over preprocessed corpora.

    Mel frame t of `mel-{base}.npy` covers wav[(start_hop + t) * hop : +hop]
    of `wavs/{base}.wav` (preprocess dirs), or the `.h5` files' `feats` and
    `wave` pair up directly. Everything is preloaded; items shorter than a
    segment are edge-padded (mel) and zero-padded (wav)."""

    def __init__(self, dirs: list[str], cfg: VocoderDataConfig, seed: int = 0):
        self.cfg = cfg
        self.items: list[tuple[np.ndarray, np.ndarray]] = []  # (mel [T, M], wav [T * hop])
        for d in dirs:
            if os.path.exists(os.path.join(d, "train.txt")):
                self._load_pp_dir(d)
            else:
                self._load_h5_dir(d)
        if not self.items:
            raise ValueError(f"no usable (mel, wav) items under {dirs}")
        self._rng = np.random.default_rng(seed)
        self._dev = None  # the corpus on a device (device_batches)

    def _add(self, mel: np.ndarray, wav: np.ndarray) -> None:
        hop, F_ = self.cfg.hop_size, self.cfg.segment_frames
        T = min(mel.shape[0], len(wav) // hop)
        if T < 2:
            return
        mel, wav = mel[:T], wav[: T * hop]
        if T < F_:  # pad short items up to one segment
            mel = np.pad(mel, ((0, F_ - T), (0, 0)), mode="edge")
            wav = np.pad(wav, (0, (F_ - T) * hop))
        self.items.append((mel.astype(np.float32), wav.astype(np.float32)))

    def _load_pp_dir(self, d: str) -> None:
        from zerovox_tpu_torch.dsp.audio import load_wav

        hop = self.cfg.hop_size
        with open(os.path.join(d, "train.txt")) as f:
            for line in f:
                wavname = line.strip().split("|")[0]
                base = os.path.splitext(wavname)[0]
                mel_p = os.path.join(d, "mel", f"mel-{base}.npy")
                ss_p = os.path.join(d, "mel", f"startstop-{base}.json")
                wav_p = os.path.join(d, "wavs", wavname)
                if not (os.path.exists(mel_p) and os.path.exists(wav_p)):
                    continue
                start_hop = 0
                if os.path.exists(ss_p):
                    with open(ss_p) as sf:
                        start_hop = int(json.load(sf)["start_hop"])
                wav, _ = load_wav(wav_p, target_sr=self.cfg.sampling_rate)
                self._add(np.load(mel_p), wav[start_hop * hop:])

    def _load_h5_dir(self, d: str) -> None:
        import glob

        import h5py

        for p in sorted(glob.glob(os.path.join(d, "**", "*.h5"), recursive=True)):
            with h5py.File(p, "r") as h:
                self._add(np.asarray(h["feats"]), np.asarray(h["wave"]))

    def __len__(self) -> int:
        return len(self.items)

    def _epoch_plan(self, batch_size: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """One epoch's (item indices, segment offsets) per batch: a
        permutation of the items, the tail batch wrapped from its start, one
        offset drawn per row (the JAX package's draws, in its order)."""
        F_ = self.cfg.segment_frames
        order = self._rng.permutation(len(self.items))
        for b0 in range(0, len(order), batch_size):
            idx = order[b0: b0 + batch_size]
            if len(idx) < batch_size:  # wrap
                idx = np.concatenate([idx, order[: batch_size - len(idx)]])
            t0s = np.asarray([int(self._rng.integers(0, self.items[int(i)][0].shape[0] - F_ + 1))
                              for i in idx], np.int32)
            yield np.asarray(idx, np.int32), t0s

    def skip_epochs(self, n: int, batch_size: int) -> None:
        """Draw n epochs' plans and drop them: a run resumed after epoch n - 1
        then samples what the uninterrupted run samples."""
        for _ in range(n):
            for _ in self._epoch_plan(batch_size):
                pass

    def batches(self, batch_size: int) -> Iterator[dict]:
        """One epoch of {"mel": [B, F, M], "wav": [B, F * hop]} numpy batches."""
        F_, hop = self.cfg.segment_frames, self.cfg.hop_size
        for idx, t0s in self._epoch_plan(batch_size):
            mels = np.empty((batch_size, F_, self.cfg.num_mels), np.float32)
            wavs = np.empty((batch_size, F_ * hop), np.float32)
            for j, (i, t0) in enumerate(zip(idx, t0s)):
                mel, wav = self.items[int(i)]
                t0 = int(t0)
                mels[j] = mel[t0: t0 + F_]
                wavs[j] = wav[t0 * hop: (t0 + F_) * hop]
            yield {"mel": mels, "wav": wavs}

    def cache_nbytes(self) -> int:
        """Bytes of the corpus as `device_batches` keeps it (items padded to
        the longest)."""
        tmax = max(mel.shape[0] for mel, _ in self.items)
        return len(self.items) * tmax * 4 * (self.cfg.num_mels + self.cfg.hop_size)

    def device_batches(self, batch_size: int, device) -> Iterator[dict]:
        """`batches` with the corpus on `device`: uploaded once (items padded
        to the longest), each step's segments cut there by a gather from the
        plan's (index, offset) pairs. Bitwise `batches` (the same plan)."""
        device = torch.device(device)
        hop, F_ = self.cfg.hop_size, self.cfg.segment_frames
        if self._dev is None or self._dev[0].device != device:
            n = len(self.items)
            tmax = max(mel.shape[0] for mel, _ in self.items)
            mels = np.zeros((n, tmax, self.cfg.num_mels), np.float32)
            wavs = np.zeros((n, tmax * hop), np.float32)
            for i, (mel, wav) in enumerate(self.items):
                mels[i, : mel.shape[0]] = mel
                wavs[i, : len(wav)] = wav
            self._dev = (torch.from_numpy(mels).to(device), torch.from_numpy(wavs).to(device))
            print(f"vocoder device cache: {n} items, "
                  f"{(mels.nbytes + wavs.nbytes) / 1e6:.1f} MB on {device}")
        mels, wavs = self._dev
        frames = torch.arange(F_, device=device)
        samples = torch.arange(F_ * hop, device=device)
        for idx, t0s in self._epoch_plan(batch_size):
            plan = torch.from_numpy(np.stack([idx, t0s]).astype(np.int64))
            if device.type == "cuda":
                plan = plan.pin_memory()
            i, t0 = plan.to(device, non_blocking=True)
            yield {"mel": mels[i[:, None], t0[:, None] + frames],
                   "wav": wavs[i[:, None], t0[:, None] * hop + samples]}


# ------------------------------------------------------------ mel loss


def make_batched_logmel(cfg: VocoderDataConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """wav [B, T] -> log-mel [B, T / hop, n_mels], the training features'
    transform (dsp/mels.py's padding, window and filterbank), on the wav's
    device."""
    from zerovox_tpu_torch.dsp.mels import hann_window, mel_filterbank

    fft, hop, win = cfg.fft_size, cfg.hop_size, cfg.win_length
    basis = torch.tensor(mel_filterbank(cfg.sampling_rate, fft, cfg.num_mels, cfg.fmin,
                                        cfg.fmax))  # [M, fft // 2 + 1]
    w = hann_window(win)
    if win < fft:
        lp = (fft - win) // 2
        w = np.pad(w, (lp, fft - win - lp))
    window = torch.tensor(w)
    pad = (fft - hop) // 2
    on: dict = {}  # (basis, window) by device

    def logmel(y: torch.Tensor) -> torch.Tensor:
        if y.device not in on:
            on[y.device] = (basis.to(y.device), window.to(y.device))
        b, wnd = on[y.device]
        yp = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
        frames = yp.unfold(1, fft, hop) * wnd  # [B, frames, fft]
        mags = torch.abs(torch.fft.rfft(frames, n=fft, dim=-1))
        return torch.log(torch.clamp(mags @ b.T, min=1e-5))

    return logmel


# ------------------------------------------------------------ train step


@dataclass
class VocoderTrainState:
    gen: Generator
    mpd: MultiPeriodDiscriminator
    msd: MultiScaleDiscriminator
    g_opt: AdamW
    d_opt: AdamW
    step: int = 0


def vocoder_adamw(params, b1: float = 0.8, b2: float = 0.99) -> AdamW:
    """optax.adamw(lr, b1, b2, weight_decay=0.01), as the JAX trainer makes
    it: eps 1e-8, every parameter decayed, no clipping."""
    return AdamW(params, betas=(b1, b2), eps=1e-8, weight_decay=0.01, grad_clip=None)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


def make_vocoder_step(logmel: Callable, schedule: Callable[[int], float],
                      mel_weight: float = 45.0, precision: str = "32",
                      split: bool = False, grad_reduce: Callable | None = None) -> Callable:
    """step(state, batch) -> losses (detached, on the device): one GAN round
    on batch {"mel": [B, F, M], "wav": [B, F * hop]} (tensors on the nets'
    device), updating `state` in place. `schedule(count)` gives each
    optimizer's learning rate from its update count before the update.
    `grad_reduce(params)`, when given, runs on each optimizer's parameters
    between the backward and the update (the data-parallel mean)."""
    if precision not in ("32", "bf16-mixed"):
        raise ValueError(f"precision {precision!r}: '32' or 'bf16-mixed'")
    mixed = precision == "bf16-mixed"

    def run(net, *args, grad: bool):
        """net(*args) on its own weights, or under bf16-mixed on bf16 copies
        (through which gradients reach the float32 weights when `grad`)."""
        if not mixed:
            return net(*args)
        half = {n: _bf16(p if grad else p.detach()) for n, p in net.named_parameters()}
        return torch.func.functional_call(net, half, tuple(_bf16(a) for a in args))

    def d_update(state: VocoderTrainState, y, y_hat) -> dict:
        """The discriminators' update against the constant fake y_hat."""
        state.d_opt.zero_grad()
        rf, gf, _, _ = run(state.mpd, y, y_hat, grad=True)
        lf, _, _ = discriminator_loss([r.float() for r in rf], [g.float() for g in gf])
        rs, gs, _, _ = run(state.msd, y, y_hat, grad=True)
        ls, _, _ = discriminator_loss([r.float() for r in rs], [g.float() for g in gs])
        (lf + ls).backward()
        if grad_reduce is not None:
            grad_reduce(state.d_opt.params)
        state.d_opt.step(schedule(state.d_opt.count))
        return {"d_mpd": lf.detach(), "d_msd": ls.detach(), "d_total": (lf + ls).detach()}

    def g_update(state: VocoderTrainState, mel, y, y_g) -> dict:
        """The generator's update from its output y_g (with its graph)
        against the discriminators as they are now."""
        l_mel = torch.mean(torch.abs(logmel(y_g.float()) - mel)) * mel_weight
        d_params = [p for net in (state.mpd, state.msd) for p in net.parameters()]
        for p in d_params:  # gradients through the discriminators, not for them
            p.requires_grad_(False)
        try:
            rf, gf, fr, fg = run(state.mpd, y, y_g, grad=False)
            rs, gs, sr, sg = run(state.msd, y, y_g, grad=False)
        finally:
            for p in d_params:
                p.requires_grad_(True)
        l_fm = feature_loss(fr, fg).float() + feature_loss(sr, sg).float()
        l_adv_f, _ = generator_loss([g.float() for g in gf])
        l_adv_s, _ = generator_loss([g.float() for g in gs])
        loss = l_adv_f + l_adv_s + l_fm + l_mel
        loss.backward()
        if grad_reduce is not None:
            grad_reduce(state.g_opt.params)
        state.g_opt.step(schedule(state.g_opt.count))
        state.step += 1
        return {"g_total": loss.detach(), "g_mel": l_mel.detach(), "g_fm": l_fm.detach(),
                "g_adv": (l_adv_f + l_adv_s).detach()}

    def generate(state: VocoderTrainState, mel, grad: bool):
        state.g_opt.zero_grad()
        with torch.set_grad_enabled(grad):
            y_g = run(state.gen, mel, grad=grad)
        return y_g

    if split:
        def d_step(state: VocoderTrainState, batch: dict) -> dict:
            y_hat = generate(state, batch["mel"], grad=False)
            return d_update(state, batch["wav"], y_hat)

        def g_step(state: VocoderTrainState, batch: dict) -> dict:
            y_g = generate(state, batch["mel"], grad=True)
            return g_update(state, batch["mel"], batch["wav"], y_g)

        def step2(state: VocoderTrainState, batch: dict) -> dict:
            d_aux = d_step(state, batch)
            return {**d_aux, **g_step(state, batch)}

        step2.parts = (d_step, g_step)
        return step2

    def step(state: VocoderTrainState, batch: dict) -> dict:
        # D on the detached fake, then G against the updated D
        y_g = generate(state, batch["mel"], grad=True)
        d_aux = d_update(state, batch["wav"], y_g.detach())
        return {**d_aux, **g_update(state, batch["mel"], batch["wav"], y_g)}

    return step


# --------------------------------------------------------------- trainer


@dataclass
class VocoderTrainerConfig:
    max_epochs: int = 100
    batch_size: int = 16
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999  # per epoch, upstream HiFi-GAN ExponentialLR
    out_folder: str = "myvocoder1"
    precision: str = "32"
    log_every_n_epochs: int = 1
    checkpoint_every_n_epochs: int = 25
    mel_weight: float = 45.0
    seed: int = 42
    # test-size discriminator variants (full reference sizes by default)
    mpd_periods: tuple[int, ...] = (2, 3, 5, 7, 11)
    msd_scales: int = 3
    # the (mel, wav) corpus on the device (VocoderDataset.device_batches)
    device_cache: bool = True
    device_cache_limit: int = 2 << 30
    # the GAN round as two calls (make_vocoder_step split=True)
    split_step: bool = False


def to_device_batch(batch: dict, device) -> dict[str, torch.Tensor]:
    """A host batch of numpy arrays (or tensors already on `device`) on `device`."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device)  # itself when it is there
            continue
        t = torch.from_numpy(np.asarray(v))
        if torch.device(device).type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def _sorted_tree(tree: dict) -> dict:
    """`tree` with every map below the top level in sorted key order."""
    def walk(t):
        return {k: walk(t[k]) for k in sorted(t)} if isinstance(t, dict) else t

    return {k: walk(v) for k, v in tree.items()}


class VocoderTrainer:
    """Epoch-driven GAN trainer on one device (the card unless
    device="cpu"), or data parallel over a `mesh`'s process group, one
    device a process: each rank runs its shard of every batch (the JAX
    trainer's `P("data")` rows) and the gradients are averaged over the
    ranks before each update (the losses are means over equal shards and
    the discriminators have no BatchNorm, so that is the global batch's
    gradient). On a data x model mesh the nets are replicated over
    `model`: the ranks of a model group take the rows of their data index,
    and the averages over the whole world (each shard's gradient counted
    once a model rank) equal the `data` axis's, while keeping the model
    group's replicas bitwise equal. Its generator drops into the engines
    as a meldec dir."""

    def __init__(self, gcfg: HifiGanConfig, dcfg: VocoderDataConfig, tcfg: VocoderTrainerConfig,
                 steps_per_epoch: int, device=None, mesh: Mesh | None = None):
        self.gcfg, self.dcfg, self.tcfg = gcfg, dcfg, tcfg
        device = process_device(mesh, device)
        self.mesh = mesh
        self.group = mesh.group if mesh is not None else None
        self.rank = mesh.rank if mesh is not None else 0
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_full_f32()
        self.schedule = exponential_decay_schedule(tcfg.learning_rate, steps_per_epoch,
                                                   tcfg.lr_decay)
        self.logmel = make_batched_logmel(dcfg)
        reduce = (None if self.group is None else
                  lambda params: all_reduce_grads(params, self.group, average=True))
        self.step_fn = make_vocoder_step(self.logmel, self.schedule, mel_weight=tcfg.mel_weight,
                                         precision=tcfg.precision, split=tcfg.split_step,
                                         grad_reduce=reduce)

    def init_state(self, gen: torch.Generator | None = None) -> VocoderTrainState:
        """Random nets (LeCun-normal kernels, zero biases) drawn from `gen`
        (default: seeded with tcfg.seed) in the order generator, MPD, MSD,
        on the device, with fresh optimizers."""
        from zerovox_tpu_torch.synthesize import random_init_

        gen = gen if gen is not None else torch.Generator().manual_seed(self.tcfg.seed)
        g = Generator(self.gcfg)
        mpd = MultiPeriodDiscriminator(self.tcfg.mpd_periods)
        msd = MultiScaleDiscriminator(self.tcfg.msd_scales)
        for net in (g, mpd, msd):
            random_init_(net, gen)
            net.to(self.device).train()
            if self.group is not None:
                replicate(net, self.mesh)
        t = self.tcfg
        return VocoderTrainState(
            gen=g, mpd=mpd, msd=msd, g_opt=vocoder_adamw(g.parameters(), t.adam_b1, t.adam_b2),
            d_opt=vocoder_adamw([*mpd.parameters(), *msd.parameters()], t.adam_b1, t.adam_b2))

    def train_step(self, state: VocoderTrainState, batch: dict) -> dict[str, torch.Tensor]:
        """One round on `batch` (this rank's rows of it under a process
        group); returns the global batch's losses."""
        losses = self.step_fn(state, to_device_batch(shard_batch(batch, self.mesh), self.device))
        if self.group is not None:
            losses = all_reduce_values(losses, self.group, scale=1.0 / self.mesh.world)
        return losses

    # ----------------------------------------------------------- persist

    def save_generator(self, state: VocoderTrainState, out_dir: str) -> str:
        """The inference contract: config.json + generator.msgpack (the JAX
        package's native meldec dir)."""
        from zerovox_tpu_torch.training.checkpointing import save_native_checkpoint
        from zerovox_tpu_torch.weights import generator_to_jax_params

        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(asdict(self.gcfg), f, indent=1)
        path = os.path.join(out_dir, "generator.msgpack")
        save_native_checkpoint(path, {"params": generator_to_jax_params(state.gen.state_dict(),
                                                                        self.gcfg)},
                               meta={"step": state.step})
        return path

    def save_state(self, state: VocoderTrainState, out_dir: str, epoch: int) -> str:
        """The whole GAN state after `epoch` (both nets, both optimizers'
        moments and counts, the step) as checkpoints/vocoder-NNNN.pt."""
        ckpt_dir = os.path.join(out_dir, "checkpoints")
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, f"vocoder-{epoch:04d}.pt")
        opts = {name: {"count": o.count, "mu": o.mu, "nu": o.nu}
                for name, o in (("g_opt", state.g_opt), ("d_opt", state.d_opt))}
        blob = {"gen": state.gen.state_dict(), "mpd": state.mpd.state_dict(),
                "msd": state.msd.state_dict(), **opts, "step": state.step, "epoch": epoch}
        tmp = path + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)
        with open(path + ".json", "w") as f:
            json.dump({"epoch": epoch}, f)
        return path

    def restore_state(self, state: VocoderTrainState, path) -> int:
        """Load a resume file into `state` (from `init_state`): the port's
        `save_state` file (`.pt`), or the JAX trainer's `vocoder-NNNN.msgpack`
        (flax's bytes of its `VocoderTrainState`, the epoch in the `.json`
        beside it). Returns the epoch `fit` continues at, the one after the
        file's."""
        if str(path).endswith(".msgpack"):
            from zerovox_tpu_torch.utils.msgpack_codec import unpackb

            with open(path, "rb") as f:
                self._load_jax_state(state, unpackb(f.read()), path)
            with open(str(path) + ".json") as f:
                return json.load(f)["epoch"] + 1
        blob = torch.load(path, map_location="cpu", weights_only=True)
        for name in ("gen", "mpd", "msd"):
            getattr(state, name).load_state_dict(blob[name])
        for name in ("g_opt", "d_opt"):
            opt, saved = getattr(state, name), blob[name]
            if len(saved["nu"]) != len(opt.nu):
                raise ValueError(f"{path}: {name} holds another parameter set")
            with torch.no_grad():
                for mine, theirs in zip(opt.nu + opt.mu, saved["nu"] + saved["mu"]):
                    mine.copy_(theirs)
            opt.count = saved["count"]
        state.step = blob["step"]
        return blob["epoch"] + 1

    # The JAX trainer's state in flax's layout: {"g_params", "d_params": {"mpd",
    # "msd"}, "g_opt", "d_opt", "step"}; each optimizer's state is optax.adamw's
    # chain, {"0": {"count", "mu", "nu"}, "1": {}, "2": {"count"}} (Adam, the
    # weight decay, the schedule), mu and nu shaped as the parameters, so the
    # parameters' layout maps carry them over element for element.

    def _layouts(self, state: VocoderTrainState):
        """(generator tree <-> tensors, discriminators' tree <-> tensors), the
        tensors in the order of g_opt's and d_opt's parameter lists."""
        from zerovox_tpu_torch import weights as w

        periods, scales = self.tcfg.mpd_periods, self.tcfg.msd_scales
        g_names = [n for n, _ in state.gen.named_parameters()]
        mpd_names = [n for n, _ in state.mpd.named_parameters()]
        msd_names = [n for n, _ in state.msd.named_parameters()]

        def g_from(tree):
            sd = w.generator_from_jax_params(tree, self.gcfg)
            return [sd[n] for n in g_names]

        def d_from(tree):
            a = w.mpd_from_jax_variables(tree["mpd"], periods)
            b = w.msd_from_jax_variables(tree["msd"], scales)
            return [a[n] for n in mpd_names] + [b[n] for n in msd_names]

        def g_to(tensors):
            return w.generator_to_jax_params(dict(zip(g_names, tensors)), self.gcfg)

        def d_to(tensors):
            k = len(mpd_names)
            return {"mpd": w.mpd_to_jax_variables(dict(zip(mpd_names, tensors[:k])), periods),
                    "msd": w.msd_to_jax_variables(dict(zip(msd_names, tensors[k:])), scales)}

        return (g_from, g_to), (d_from, d_to)

    def _load_jax_state(self, state: VocoderTrainState, tree: dict, path) -> None:
        (g_from, _), (d_from, _) = self._layouts(state)
        for opt, key, from_tree in ((state.g_opt, "g", g_from), (state.d_opt, "d", d_from)):
            adam, sched = tree[f"{key}_opt"]["0"], tree[f"{key}_opt"]["2"]
            if int(adam["count"]) != int(sched["count"]):
                raise ValueError(f"{path}: {key}_opt's Adam count {int(adam['count'])} is not "
                                 f"its schedule's {int(sched['count'])}")
            params = (list(state.gen.parameters()) if key == "g"
                      else [*state.mpd.parameters(), *state.msd.parameters()])
            with torch.no_grad():
                for dst, src in zip(params + opt.mu + opt.nu,
                                    from_tree(tree[f"{key}_params"]) + from_tree(adam["mu"])
                                    + from_tree(adam["nu"])):
                    dst.copy_(src)
            opt.count = int(adam["count"])
        state.step = int(tree["step"])

    def save_jax_state(self, state: VocoderTrainState, out_dir: str, epoch: int) -> str:
        """The JAX trainer's resume file for `state` after `epoch`:
        checkpoints/vocoder-NNNN.msgpack, flax's `to_bytes` of its
        VocoderTrainState (nested maps in sorted key order as flax's trees
        hold them, the state's fields in field order), and its `.json`."""
        from zerovox_tpu_torch.utils.msgpack_codec import packb

        (_, g_to), (_, d_to) = self._layouts(state)

        def opt_state(opt, to_tree):
            count = np.asarray(opt.count, np.int32)
            return {"0": {"count": count, "mu": to_tree(opt.mu), "nu": to_tree(opt.nu)},
                    "1": {}, "2": {"count": count}}

        tree = {"g_params": g_to(list(state.gen.parameters())),
                "d_params": d_to([*state.mpd.parameters(), *state.msd.parameters()]),
                "g_opt": opt_state(state.g_opt, g_to), "d_opt": opt_state(state.d_opt, d_to),
                "step": np.asarray(state.step, np.int32)}
        ckpt_dir = os.path.join(out_dir, "checkpoints")
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, f"vocoder-{epoch:04d}.msgpack")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(packb(_sorted_tree(tree), sort_keys=False))
        os.replace(tmp, path)
        with open(path + ".json", "w") as f:
            json.dump({"epoch": epoch}, f)
        return path

    # --------------------------------------------------------------- fit

    def loader(self, dataset: VocoderDataset) -> Callable[[int], Iterator[dict]]:
        """One epoch's batches: from the device cache unless it is off or
        over its budget."""
        tcfg = self.tcfg
        if tcfg.device_cache and dataset.cache_nbytes() <= tcfg.device_cache_limit:
            return lambda bs: dataset.device_batches(bs, self.device)
        return dataset.batches

    def fit(self, dataset: VocoderDataset, state: VocoderTrainState,
            start_epoch: int = 0) -> VocoderTrainState:
        """Epochs start_epoch .. max_epochs - 1 (a resumed run first skips the
        data plans of the epochs it has done). Each logged epoch's last
        losses go to `losses.json` (appended to the file a resumed run
        finds)."""
        tcfg = self.tcfg
        loader = self.loader(dataset)
        dataset.skip_epochs(start_epoch, tcfg.batch_size)
        os.makedirs(tcfg.out_folder, exist_ok=True)
        hist_path = os.path.join(tcfg.out_folder, "losses.json")
        history: list[dict] = []
        if start_epoch > 0 and os.path.exists(hist_path):
            with open(hist_path) as f:
                history = [r for r in json.load(f) if r["epoch"] < start_epoch]
        t0 = time.time()
        for epoch in range(start_epoch, tcfg.max_epochs):
            losses = None
            for batch in loader(tcfg.batch_size):
                losses = self.train_step(state, batch)
            if self.rank == 0:  # every rank holds the same losses and weights
                self._end_epoch(state, epoch, losses, history, t0)
            if self.group is not None:  # no rank runs ahead of rank 0's checkpoint
                dist.barrier(group=self.group)
        if self.rank == 0:
            with open(hist_path, "w") as f:
                json.dump(history, f, indent=1)
        return state

    def _end_epoch(self, state: VocoderTrainState, epoch: int, losses: dict | None,
                   history: list[dict], t0: float) -> None:
        """Log the epoch's last losses (on log epochs) and write its
        checkpoint (on checkpoint epochs and the last)."""
        tcfg = self.tcfg
        if losses is not None and (epoch % tcfg.log_every_n_epochs == 0
                                   or epoch == tcfg.max_epochs - 1):
            keys = list(losses)
            host = dict(zip(keys, map(float, torch.stack([losses[k] for k in keys]).cpu())))
            bad = [k for k, v in host.items() if not np.isfinite(v)]
            if bad:
                print(f"*** error: invalid loss at epoch {epoch}: "
                      + ", ".join(f"{k}={host[k]}" for k in bad))
            history.append({"epoch": epoch, **host})
            print(f"epoch {epoch}: g_total={host['g_total']:.3f} g_mel={host['g_mel']:.3f} "
                  f"g_adv={host['g_adv']:.3f} g_fm={host['g_fm']:.3f} "
                  f"d_total={host['d_total']:.3f} ({time.time() - t0:.0f}s)", flush=True)
        if (epoch + 1) % tcfg.checkpoint_every_n_epochs == 0 or epoch == tcfg.max_epochs - 1:
            self.save_state(state, tcfg.out_folder, epoch)
            self.save_generator(state, tcfg.out_folder)


# ------------------------------------------------- the round's gradients


class GradRecorder:
    """Stands in for an optimizer where a round's gradients are compared:
    keeps a host copy of the step's gradients, leaves the weights as they
    are."""

    def __init__(self, params):
        self.params, self.count, self.grads = list(params), 0, None

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self, lr):
        self.grads = [p.grad.detach().to("cpu", copy=True) for p in self.params]
        self.count += 1


def card_round_gap(gcfg: HifiGanConfig, dcfg: VocoderDataConfig, tcfg: VocoderTrainerConfig,
                   batch: dict, seed: int, device=None) -> tuple[float, float]:
    """One GAN round from the same weights (drawn from `seed`) and batch on
    `device` (the card) in float32 and on the CPU in float64, the reference
    because torch's float32 CPU convolutions can be the less accurate side.
    Returns the largest gap of a loss relative to the reference's and the
    largest gap of a gradient over that tensor's max."""
    losses, grads = [], []
    for where, dtype in ((device, torch.float32), ("cpu", torch.float64)):
        tr = VocoderTrainer(gcfg, dcfg, tcfg, 1, device=where)
        st = tr.init_state(torch.Generator().manual_seed(seed))
        for net in (st.gen, st.mpd, st.msd):
            net.to(dtype)
        st.g_opt = GradRecorder(st.gen.parameters())
        st.d_opt = GradRecorder([*st.mpd.parameters(), *st.msd.parameters()])
        b = {k: torch.as_tensor(np.asarray(v)).to(tr.device, dtype) for k, v in batch.items()}
        losses.append({k: float(v) for k, v in tr.train_step(st, b).items()})
        grads.append(st.g_opt.grads + st.d_opt.grads)
    loss_rel = max(abs(losses[0][k] - v) / max(abs(v), 1e-300) for k, v in losses[1].items())
    grad_rel = max(((a.double() - b).abs().max() / b.abs().max().clamp(min=1e-300)).item()
                   for a, b in zip(*grads))
    return loss_rel, grad_rel
