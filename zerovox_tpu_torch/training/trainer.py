"""Acoustic-model training loop on one CUDA card.

The PyTorch counterpart of the JAX package's `training/trainer.py`:

  * one train step is forward (train mode: dropout, teacher targets,
    BatchNorm batch statistics) + `zerovox_loss` + backward + the AdamW
    update of `training/optim.py` at the epoch warmup-cosine rate; the
    speaker encoder's running statistics update inside the forward;
  * dropout draws from a `torch.Generator` re-seeded each step from
    (seed + 1, step), as the JAX trainer folds the step into its key;
  * `train_decoder_only` steps only the mel decoder and keeps the speaker
    encoder's BatchNorms on their running statistics;
  * `fit` keeps the per-step losses on the card and fetches them every
    `log_every_n_steps` steps (and at epoch end) for the NaN check and the
    epoch average;
  * at the end of every `checkpoint_every_n_epochs`-th epoch (and of the
    last) `fit` writes `checkpoints/NNNN.msgpack`, the JAX package's native
    format, with `{"epoch", "loss", "step"}` in its `.json`, and keeps the
    newest `keep_checkpoints` of them;
  * `save_train_state` / `restore_train_state` write and read the whole
    train state (weights, optimizer moments, step, epoch, the dropout
    generator) with torch.save, to resume a run.

Float32 only. TensorBoard logging, the profiler and bf16-mixed are not
ported yet.
"""

from __future__ import annotations

import gc
import inspect
import os
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from zerovox_tpu_torch.config import ZeroVoxConfig
from zerovox_tpu_torch.device import resolve_device, use_full_f32
from zerovox_tpu_torch.models.layers import set_dropout_generator
from zerovox_tpu_torch.models.zerovox import ZeroVox, zerovox_loss
from zerovox_tpu_torch.training.checkpointing import save_native_checkpoint
from zerovox_tpu_torch.training.optim import AdamW, warmup_cosine_epoch_schedule
from zerovox_tpu_torch.weights import to_jax_variables

_DEVICE_KEYS = ("phoneme", "puncts", "phoneme_mask", "pitch", "energy",
                "duration", "mel_mask", "ref_mel", "mel")


def device_batch(batch, device) -> dict[str, torch.Tensor]:
    """A data-module batch ((x, y) tuple or dict) -> the flat dict of tensors
    the train step consumes, on `device`."""
    if isinstance(batch, tuple):
        x, y = batch
        batch = {**x, **y}
    device = torch.device(device)
    out = {}
    for k in _DEVICE_KEYS:
        if k in batch:
            t = torch.as_tensor(np.asarray(batch[k]))
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
    return out


@dataclass
class TrainerConfig:
    max_epochs: int = 40
    warmup_epochs: int = 2
    # losses stay on the card and are fetched every N steps for the NaN check
    log_every_n_steps: int = 50
    out_folder: str = "mymodel1"
    keep_checkpoints: int = 0  # 0 keeps all
    checkpoint_every_n_epochs: int = 1  # the last epoch is always saved
    train_decoder_only: bool = False
    precision: str = "32"  # only float32 is ported
    seed: int = 42


@dataclass
class TrainState:
    model: ZeroVox
    optimizer: AdamW
    step: int = 0


class Trainer:
    """Epoch-driven trainer over an iterable of host batches."""

    def __init__(self, cfg: ZeroVoxConfig, tcfg: TrainerConfig, steps_per_epoch: int,
                 device=None):
        if tcfg.precision != "32":
            raise NotImplementedError(f"precision {tcfg.precision!r} is not ported yet ('32' only)")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_full_f32()
        self.schedule = warmup_cosine_epoch_schedule(
            base_lr=cfg.training.learning_rate, warmup_epochs=tcfg.warmup_epochs,
            total_epochs=tcfg.max_epochs, steps_per_epoch=steps_per_epoch)
        self._gen = torch.Generator(device=self.device)

    # ------------------------------------------------------------- lifecycle

    def init_state(self, state_dict: dict | None = None) -> TrainState:
        """A model with `state_dict`'s weights (random ones from the seed when
        none is given) on the device, in train mode, and a fresh optimizer."""
        from zerovox_tpu_torch.synthesize import random_init_

        model = ZeroVox(self.cfg)
        if state_dict is None:
            random_init_(model, torch.Generator().manual_seed(self.tcfg.seed))
        else:
            model.load_state_dict(state_dict)
        model.to(self.device).train()
        set_dropout_generator(model, self._gen)
        if self.tcfg.train_decoder_only:
            for name, p in model.named_parameters():
                p.requires_grad_(name.startswith("_mel_decoder."))
        t = self.cfg.training
        opt = AdamW(model.parameters(), betas=tuple(t.betas), eps=t.eps,
                    weight_decay=t.weight_decay, grad_clip=t.grad_clip)
        return TrainState(model=model, optimizer=opt)

    def restore_into(self, state: TrainState, state_dict: dict,
                     reinit_decoder: bool = False) -> TrainState:
        """Imported weights replace the model's; with `reinit_decoder` the mel
        decoder keeps its current weights."""
        if reinit_decoder:
            state_dict = {**state_dict, **{k: v for k, v in state.model.state_dict().items()
                                           if k.startswith("_mel_decoder.")}}
        state.model.load_state_dict(state_dict)
        return state

    # ------------------------------------------------------------------ step

    def forward_backward(self, state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        """Forward + loss + backward at `state.step`; gradients land in the
        parameters' `.grad`. Returns the detached losses (on the device)."""
        model = state.model
        seed = np.random.SeedSequence([self.tcfg.seed + 1, state.step]).generate_state(1)[0]
        self._gen.manual_seed(int(seed))
        state.optimizer.zero_grad()
        pred = model(batch, train=True, spkemb_train=not self.tcfg.train_decoder_only)
        losses = zerovox_loss(pred, batch)
        losses["loss"].backward()
        return {k: v.detach() for k, v in losses.items()}

    def train_step(self, state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        losses = self.forward_backward(state, batch)
        state.optimizer.step(self.schedule(state.step))
        state.step += 1
        return losses

    # ----------------------------------------------------------- checkpoints

    def checkpoint_root(self) -> str:
        return os.path.join(self.tcfg.out_folder, "checkpoints")

    def save_train_state(self, state: TrainState, path, epoch: int) -> None:
        """The whole train state after `epoch`: weights (BatchNorm running
        statistics included), the optimizer's moments and count, the step
        and the dropout generator's state."""
        opt = state.optimizer
        blob = {"model": state.model.state_dict(), "step": state.step, "epoch": epoch,
                "optimizer": {"count": opt.count, "nu": opt.nu, "mu": opt.mu},
                "dropout_generator": self._gen.get_state()}
        tmp = str(path) + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)

    def restore_train_state(self, state: TrainState, path) -> int:
        """Load `save_train_state`'s file into `state` (from `init_state`);
        returns the epoch `fit` continues at."""
        blob = torch.load(path, map_location="cpu", weights_only=True)
        state.model.load_state_dict(blob["model"])
        opt, saved = state.optimizer, blob["optimizer"]
        if len(saved["nu"]) != len(opt.nu) or (saved["mu"] is None) != (opt.mu is None):
            raise ValueError(f"{path}: optimizer state of another parameter set")
        with torch.no_grad():
            for mine, theirs in zip(opt.nu + (opt.mu or []), saved["nu"] + (saved["mu"] or [])):
                mine.copy_(theirs)
        opt.count = saved["count"]
        state.step = blob["step"]
        self._gen.set_state(blob["dropout_generator"])
        return blob["epoch"] + 1

    # ---------------------------------------------------------------- epochs

    def fit(self, batches_per_epoch: Callable[..., Any], state: TrainState,
            start_epoch: int = 0) -> TrainState:
        """`batches_per_epoch(epoch)` (or `batches_per_epoch()`) yields host
        batches for one epoch."""
        try:
            takes_epoch = bool(inspect.signature(batches_per_epoch).parameters)
        except (TypeError, ValueError):
            takes_epoch = False
        ckpt_root = self.checkpoint_root()
        os.makedirs(ckpt_root, exist_ok=True)
        for epoch in range(start_epoch, self.tcfg.max_epochs):
            t0 = time.time()
            pending: list[dict] = []
            checked = 0
            for batch in batches_per_epoch(epoch) if takes_epoch else batches_per_epoch():
                pending.append(self.train_step(state, device_batch(batch, self.device)))
                if state.step % self.tcfg.log_every_n_steps == 0:
                    self._check_finite(self._fetch(pending[checked:]), state.step)
                    checked = len(pending)
            epoch_losses = self._fetch(pending)
            self._check_finite(epoch_losses[checked:], state.step)
            self._on_epoch_end(epoch, epoch_losses, state, ckpt_root, t0)
        return state

    @staticmethod
    def _fetch(window: list[dict]) -> list[dict[str, float]]:
        """One device-to-host copy of a window of per-step losses."""
        if not window:
            return []
        keys = list(window[0])
        host = torch.stack([torch.stack([d[k] for k in keys]) for d in window]).cpu().numpy()
        return [dict(zip(keys, map(float, row))) for row in host]

    @staticmethod
    def _check_finite(host_losses: list[dict], host_step: int) -> None:
        for i, d in enumerate(host_losses):
            bad = [k for k, v in d.items() if not np.isfinite(v)]
            if bad:
                step = host_step - len(host_losses) + 1 + i
                print(f"*** error: invalid loss detected at step {step}: "
                      + ", ".join(f"{k}={d[k]}" for k in bad))

    def _on_epoch_end(self, epoch: int, epoch_losses: list[dict], state: TrainState,
                      ckpt_root: str, t0: float) -> None:
        gc.collect()
        try:
            import psutil

            rss = psutil.Process(os.getpid()).memory_info().rss / (1024 * 1024)
            print(f"on_train_epoch_end: resident size = {rss} MB")
        except Exception:
            pass
        if epoch_losses:
            avg = {k: float(np.mean([d[k] for d in epoch_losses])) for k in epoch_losses[0]}
            print(f"epoch {epoch}: loss={avg['loss']:.4f} mel={avg['mel_loss']:.4f} "
                  f"({time.time() - t0:.1f}s)")
            every = max(1, self.tcfg.checkpoint_every_n_epochs)
            if epoch % every != every - 1 and epoch != self.tcfg.max_epochs - 1:
                return
            path = os.path.join(ckpt_root, f"{epoch:04d}.msgpack")
            save_native_checkpoint(path, to_jax_variables(state.model.state_dict(), self.cfg),
                                   meta={"epoch": epoch, "loss": avg["loss"], "step": state.step})
            if self.tcfg.keep_checkpoints > 0:
                ckpts = sorted(f for f in os.listdir(ckpt_root) if f.endswith(".msgpack"))
                for old in ckpts[: -self.tcfg.keep_checkpoints]:
                    for stale in (old, old + ".json"):
                        if os.path.exists(os.path.join(ckpt_root, stale)):
                            os.remove(os.path.join(ckpt_root, stale))
