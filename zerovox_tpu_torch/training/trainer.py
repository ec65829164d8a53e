"""Acoustic-model training loop on a CUDA card, or data parallel on several.

The PyTorch counterpart of the JAX package's `training/trainer.py`:

  * one train step is forward (train mode: dropout, teacher targets,
    BatchNorm batch statistics) + `zerovox_loss` + backward + the AdamW
    update of `training/optim.py` at the epoch warmup-cosine rate; the
    speaker encoder's running statistics update inside the forward;
  * `precision="bf16-mixed"` is the JAX `make_train_step`'s mixed branch:
    float32 master weights, the forward and backward on bf16 copies of the
    parameters and of the batch's float32 inputs (gradients flow back
    through the casts into the float32 `.grad`), the model's outputs cast
    back to float32 before the loss, the BatchNorm running statistics kept
    in float32. Not torch.autocast: that keeps ops in float32 that the JAX
    package computes in bf16. `optim_dtype="bf16"` stores Adam's second
    moments in bf16;
  * dropout draws from a `torch.Generator` re-seeded each step from
    (seed + 1, step), as the JAX trainer folds the step into its key;
  * `train_decoder_only` steps only the mel decoder and keeps the speaker
    encoder's BatchNorms on their running statistics;
  * `fit` keeps the per-step losses on the card and fetches them every
    `log_every_n_steps` steps (and at epoch end) for the NaN check, the
    TensorBoard scalars (through an optional `tensorboardX`, under
    `out_folder/lightning_logs[/name]`; off without the package) and the
    epoch average; with `profile_dir` it traces `profile_steps` steps with
    torch.profiler, starting after the run's first step;
  * at the end of every `checkpoint_every_n_epochs`-th epoch (and of the
    last) `fit` writes `checkpoints[/name]/NNNN.msgpack`, the JAX package's
    native format, with `{"epoch", "loss", "step"}` in its `.json`; with
    `checkpoint_format="state"` also `state/NNNN.pt`, the whole train state
    (the port's counterpart of the JAX package's orbax checkpoints), from
    which `resume_from` continues; `keep_checkpoints` keeps the newest N of
    each;
  * `save_train_state` / `restore_train_state` write and read the whole
    train state (weights, optimizer moments, step, epoch, the dropout
    generator) with torch.save;
  * with a `mesh` over a process group (`parallel/mesh.py`) the step is
    data parallel, one process a device: every rank starts from rank 0's
    weights, takes its shard of each batch (`shard_batch`), computes the
    speaker encoder's BatchNorm statistics and the loss's masked means over
    the global batch, and all-reduces the gradients in one flat buffer
    before the clip and the optimizer (the JAX step's order), so every rank
    takes the same update; the losses are the global batch's. Dropout draws
    from a stream of its own on each rank (rank 0's is the single-process
    run's). Rank 0 alone logs and writes checkpoints, and the other ranks
    wait for it at a barrier;
  * on a data x model mesh (`MeshConfig(data=D, model=M)`, M > 1) the
    step is also tensor parallel: `init_state` installs the model axis's
    split layers (`parallel/tensor.py`, the JAX `param_sharding_rules`'
    leaves), so each rank holds its block of those weights and Adam's
    moments take the blocks' shapes. The batch, the BatchNorm sums, the
    loss's denominators and the losses go over the `data` axis only
    (`mesh.data_group`: over the whole world the loss's denominators would
    count every row M times), and dropout seeds from the data index, so a
    model group draws one mask. A split parameter's gradient is summed
    over `data_group`; a replicated one's over the whole world and divided
    by M, which keeps the model group's replicas bitwise equal where the
    backward is not run-to-run exact (cuDNN's, index_put_'s atomics). The
    clip takes the whole gradient's norm (`AdamW(model_group=...)`).
    Checkpoints hold whole weights and moments, gathered over the model
    axis (every rank of global rank 0's model group takes part; rank 0
    writes): the keys and shapes of a data-parallel run, so either mesh
    resumes the other's files.
"""

from __future__ import annotations

import contextlib
import gc
import inspect
import os
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from zerovox_tpu_torch.config import ZeroVoxConfig
from zerovox_tpu_torch.device import resolve_device, use_full_f32
from zerovox_tpu_torch.models.layers import set_dropout_generator
from zerovox_tpu_torch.models.zerovox import ZeroVox, zerovox_loss
from zerovox_tpu_torch.parallel.mesh import (Mesh, all_reduce_grads, all_reduce_values,
                                             process_device, replicate, shard_batch)
from zerovox_tpu_torch.parallel.tensor import (full_state_dict, gather_shards,
                                               load_full_state_dict, local_shards, shard_model,
                                               sharded_axes)
from zerovox_tpu_torch.training.checkpointing import save_native_checkpoint
from zerovox_tpu_torch.training.optim import AdamW, warmup_cosine_epoch_schedule
from zerovox_tpu_torch.utils.profiling import device_trace
from zerovox_tpu_torch.weights import to_jax_variables

_DEVICE_KEYS = ("phoneme", "puncts", "phoneme_mask", "pitch", "energy",
                "duration", "mel_mask", "ref_mel", "mel")


def device_batch(batch, device) -> dict[str, torch.Tensor]:
    """A data-module batch ((x, y) tuple or dict) -> the flat dict of tensors
    the train step consumes, on `device` (tensors already there, as the
    device cache gives them, are kept)."""
    if isinstance(batch, tuple):
        x, y = batch
        batch = {**x, **y}
    device = torch.device(device)
    out = {}
    for k in _DEVICE_KEYS:
        if k in batch:
            v = batch[k]
            if isinstance(v, torch.Tensor) and v.device.type == device.type:
                out[k] = v
                continue
            t = torch.as_tensor(np.asarray(v))
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
    return out


@dataclass
class TrainerConfig:
    max_epochs: int = 40
    warmup_epochs: int = 2
    out_folder: str = "mymodel1"
    name: str | None = None  # run name: checkpoints/<name>, lightning_logs/<name>
    # losses stay on the card and are fetched every N steps for the NaN check
    log_every_n_steps: int = 50
    keep_checkpoints: int = 0  # 0 keeps all
    checkpoint_every_n_epochs: int = 1  # the last epoch is always saved
    train_decoder_only: bool = False
    precision: str = "32"  # "32" | "bf16-mixed"
    checkpoint_format: str = "msgpack"  # "msgpack" | "state" (msgpack + state/NNNN.pt)
    seed: int = 42
    # torch.profiler trace of `profile_steps` steps, starting after the
    # run's first step, written to profile_dir
    profile_dir: str | None = None
    profile_steps: int = 10
    optim_dtype: str = "f32"  # Adam's second moments: "f32" | "bf16"


@dataclass
class TrainState:
    model: ZeroVox
    optimizer: AdamW
    step: int = 0


class _LossBackward(nn.Module):
    """Forward + loss + backward as one module call, so that the bf16
    parameters `torch.func.functional_call` puts in place stay in place
    through the backward (where `remat` recomputes blocks)."""

    def __init__(self, model: ZeroVox):
        super().__init__()
        self.model = model

    def forward(self, inputs: dict, batch: dict, spkemb_train: bool, group=None) -> dict:
        pred = self.model(inputs, train=True, spkemb_train=spkemb_train, group=group)
        pred = {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in pred.items()}
        losses = zerovox_loss(pred, batch, group)
        losses["loss"].backward()
        return {k: v.detach() for k, v in losses.items()}


def _to_bf16(tensors: dict) -> dict:
    return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
            for k, v in tensors.items()}


class Trainer:
    """Epoch-driven trainer over an iterable of host batches."""

    def __init__(self, cfg: ZeroVoxConfig, tcfg: TrainerConfig, steps_per_epoch: int,
                 device=None, mesh: Mesh | None = None):
        """`mesh`: a data (x model) mesh over a process group, this
        process's one device on it (the device then comes from the mesh)."""
        if tcfg.precision not in ("32", "bf16-mixed"):
            raise ValueError(f"precision {tcfg.precision!r}: '32' or 'bf16-mixed'")
        if tcfg.checkpoint_format not in ("msgpack", "state"):
            raise ValueError(f"checkpoint_format {tcfg.checkpoint_format!r}: 'msgpack' or 'state'")
        self.cfg = cfg
        self.tcfg = tcfg
        self.mixed = tcfg.precision == "bf16-mixed"
        device = process_device(mesh, device)
        self.mesh = mesh
        self.group = mesh.group if mesh is not None else None
        self.rank = mesh.rank if mesh is not None else 0
        # the reductions over the batch: the data axis (the whole group without a model axis)
        self.data_group = mesh.data_group if mesh is not None else None
        self.data_index = mesh.data_index if mesh is not None else 0
        self.tensor_parallel = mesh is not None and mesh.shape["model"] > 1
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_full_f32()
        self.schedule = warmup_cosine_epoch_schedule(
            base_lr=cfg.training.learning_rate, warmup_epochs=tcfg.warmup_epochs,
            total_epochs=tcfg.max_epochs, steps_per_epoch=steps_per_epoch)
        self._gen = torch.Generator(device=self.device)
        self._writer = None

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
        if self.group is not None:
            replicate(model, self.mesh)
        if self.tensor_parallel:
            shard_model(model, self.mesh)
        split = sharded_axes(model)
        set_dropout_generator(model, self._gen)
        if self.tcfg.train_decoder_only:
            for name, p in model.named_parameters():
                p.requires_grad_(name.startswith("_mel_decoder."))
        t = self.cfg.training
        named = dict(model.named_parameters())
        opt = AdamW(model.parameters(), betas=tuple(t.betas), eps=t.eps,
                    weight_decay=t.weight_decay, grad_clip=t.grad_clip,
                    state_dtype=self.tcfg.optim_dtype,
                    model_group=self.mesh.model_group if split else None,
                    sharded=[named[n] for n in split])
        return TrainState(model=model, optimizer=opt)

    def restore_into(self, state: TrainState, state_dict: dict,
                     reinit_decoder: bool = False) -> TrainState:
        """Imported (whole) weights replace the model's; with
        `reinit_decoder` the mel decoder keeps its current weights."""
        if reinit_decoder:
            state_dict = {**state_dict, **{k: v for k, v in
                                           full_state_dict(state.model, self.mesh).items()
                                           if k.startswith("_mel_decoder.")}}
        load_full_state_dict(state.model, state_dict, self.mesh)
        return state

    # ------------------------------------------------------------------ step

    def forward_backward(self, state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        """Forward + loss + backward at `state.step`; gradients land in the
        parameters' `.grad`. Returns the detached losses (on the device)."""
        model = state.model
        # data index d > 0 draws its own masks: the d-th child of index 0's
        # stream (the ranks of a model group draw the same)
        spawn_key = (self.data_index,) if self.data_index else ()
        seed = np.random.SeedSequence([self.tcfg.seed + 1, state.step],
                                      spawn_key=spawn_key).generate_state(1)[0]
        self._gen.manual_seed(int(seed))
        state.optimizer.zero_grad()
        step = _LossBackward(model)
        spk = not self.tcfg.train_decoder_only
        if not self.mixed:
            return step(batch, batch, spk, self.data_group)
        half = {f"model.{n}": p.to(torch.bfloat16) for n, p in model.named_parameters()}
        return torch.func.functional_call(step, half,
                                          (_to_bf16(batch), batch, spk, self.data_group))

    def train_step(self, state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        """One step on `batch` (this rank's shard under a process group);
        returns the global batch's losses."""
        losses = self.forward_backward(state, batch)
        if self.group is not None:
            # each rank's loss is its share of the global mean: the sums are the mean's
            self._reduce_grads(state.optimizer)
            losses = all_reduce_values(losses, self.data_group)
        state.optimizer.step(self.schedule(state.step))
        state.step += 1
        return losses

    def _reduce_grads(self, opt: AdamW) -> None:
        """The data axis's sum of the gradients: over the group without a
        model axis; with one, each split block over `data_group` and every
        replicated gradient over the whole world, divided by the model
        axis's size."""
        if not self.tensor_parallel:
            all_reduce_grads(opt.params, self.group)
            return
        split = [p for p, s in zip(opt.params, opt.sharded) if s]
        all_reduce_grads([p for p, s in zip(opt.params, opt.sharded) if not s], self.group,
                         scale=1.0 / self.mesh.shape["model"])
        if self.mesh.shape["data"] > 1:
            all_reduce_grads(split, self.data_group)

    def _moment_axes(self, state: TrainState) -> list:
        """The split axis of each optimizer parameter (None: replicated)."""
        axes = sharded_axes(state.model)
        names = {id(p): n for n, p in state.model.named_parameters()}
        return [axes.get(names[id(p)]) for p in state.optimizer.params]

    # ----------------------------------------------------------- checkpoints

    def checkpoint_root(self) -> str:
        root = os.path.join(self.tcfg.out_folder, "checkpoints")
        return os.path.join(root, self.tcfg.name) if self.tcfg.name else root

    def save_train_state(self, state: TrainState, path, epoch: int) -> None:
        """The whole train state after `epoch`: weights (BatchNorm running
        statistics included), the optimizer's moments (in their dtype) and
        count, the step and the dropout generator's state. Under tensor
        parallelism the weights and moments are gathered whole (every rank
        of global rank 0's model group calls this) and rank 0 writes."""
        opt = state.optimizer
        axes = self._moment_axes(state)
        moments = {k: None if v is None else gather_shards(v, axes, self.mesh)
                   for k, v in (("nu", opt.nu), ("mu", opt.mu))}
        blob = {"model": full_state_dict(state.model, self.mesh), "step": state.step,
                "epoch": epoch,
                "optimizer": {"count": opt.count, **moments},
                "dropout_generator": self._gen.get_state()}
        if self.rank != 0:
            return
        tmp = str(path) + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)

    def restore_train_state(self, state: TrainState, path) -> int:
        """Load `save_train_state`'s file into `state` (from `init_state`);
        returns the epoch `fit` continues at."""
        blob = torch.load(path, map_location="cpu", weights_only=True)
        load_full_state_dict(state.model, blob["model"], self.mesh)
        opt, saved = state.optimizer, blob["optimizer"]
        if len(saved["nu"]) != len(opt.nu) or (saved["mu"] is None) != (opt.mu is None):
            raise ValueError(f"{path}: optimizer state of another parameter set")
        axes = self._moment_axes(state)
        theirs = local_shards(saved["nu"] + (saved["mu"] or []), axes + axes, self.mesh)
        with torch.no_grad():
            for mine, t in zip(opt.nu + (opt.mu or []), theirs):
                mine.copy_(t)
        opt.count = saved["count"]
        state.step = blob["step"]
        self._gen.set_state(blob["dropout_generator"])
        return blob["epoch"] + 1

    def resume_from(self, state: TrainState, ckpt_root: str | None = None
                    ) -> tuple[TrainState, int]:
        """Restore the whole train state from the newest `state/NNNN.pt`
        under `ckpt_root` (default `checkpoint_root()`); returns (state,
        start_epoch) for `fit`."""
        state_dir = os.path.join(ckpt_root or self.checkpoint_root(), "state")
        files = sorted(f for f in os.listdir(state_dir) if f.endswith(".pt")) \
            if os.path.isdir(state_dir) else []
        if not files:
            raise FileNotFoundError(f"no train-state checkpoints under {state_dir}")
        path = os.path.join(state_dir, files[-1])
        start = self.restore_train_state(state, path)
        print(f"resumed from {path} at epoch {start - 1} (step {state.step}); "
              f"continuing at epoch {start}")
        return state, start

    # --------------------------------------------------------------- logging

    def _get_writer(self):
        if self._writer is None and self.rank != 0:  # one writer a job
            self._writer = False
        if self._writer is None:
            try:
                from tensorboardX import SummaryWriter

                logdir = os.path.join(self.tcfg.out_folder, "lightning_logs")
                if self.tcfg.name:
                    logdir = os.path.join(logdir, self.tcfg.name)
                self._writer = SummaryWriter(logdir)
            except Exception:
                self._writer = False
        return self._writer

    def _log_scalars(self, scalars: dict, step: int) -> None:
        w = self._get_writer()
        if w:
            for k, v in scalars.items():
                w.add_scalar(k, float(v), step)

    # ---------------------------------------------------------------- epochs

    def fit(self, batches_per_epoch: Callable[..., Any], state: TrainState,
            start_epoch: int = 0) -> TrainState:
        """`batches_per_epoch(epoch)` (or `batches_per_epoch()`) yields
        batches for one epoch."""
        try:
            takes_epoch = bool(inspect.signature(batches_per_epoch).parameters)
        except (TypeError, ValueError):
            takes_epoch = False
        ckpt_root = self.checkpoint_root()
        os.makedirs(ckpt_root, exist_ok=True)
        profile_after = state.step + 1 if self.tcfg.profile_dir else None
        with contextlib.ExitStack() as tracing:
            for epoch in range(start_epoch, self.tcfg.max_epochs):
                t0 = time.time()
                pending: list[dict] = []
                checked = 0
                for batch in batches_per_epoch(epoch) if takes_epoch else batches_per_epoch():
                    if profile_after is not None and state.step == profile_after:
                        tracing.enter_context(device_trace(self.tcfg.profile_dir))
                    batch = device_batch(shard_batch(batch, self.mesh), self.device)
                    pending.append(self.train_step(state, batch))
                    if (profile_after is not None
                            and state.step >= profile_after + self.tcfg.profile_steps):
                        tracing.close()
                        profile_after = None
                        print(f"profiler trace ({self.tcfg.profile_steps} steps) "
                              f"written to {self.tcfg.profile_dir}")
                    if state.step % self.tcfg.log_every_n_steps == 0:
                        window = self._fetch(pending[checked:])
                        checked = len(pending)
                        self._check_finite(window, state.step)
                        last = window[-1]
                        self._log_scalars({"loss": last["loss"], "mel": last["mel_loss"],
                                           "pitch": last["pitch_loss"],
                                           "energy": last["energy_loss"],
                                           "dur": last["duration_loss"]}, state.step)
                epoch_losses = self._fetch(pending)
                self._check_finite(epoch_losses[checked:], state.step)
                if self.data_index == 0:  # rank 0's model group gathers its checkpoint
                    self._on_epoch_end(epoch, epoch_losses, state, ckpt_root, t0)
                if self.group is not None:  # no rank runs ahead of rank 0's checkpoint
                    dist.barrier(group=self.group)
        if self._writer:  # close drains tensorboardX's queue of pending events
            self._writer.close()
            self._writer = None
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
        """Rank 0 logs the epoch and writes its checkpoints; under tensor
        parallelism the other ranks of its model group take part in the
        gathers of the whole weights."""
        lead = self.rank == 0
        if lead:
            gc.collect()
            try:
                import psutil

                rss = psutil.Process(os.getpid()).memory_info().rss / (1024 * 1024)
                print(f"on_train_epoch_end: resident size = {rss} MB")
            except Exception:
                pass
        if not epoch_losses:
            return
        avg = {k: float(np.mean([d[k] for d in epoch_losses])) for k in epoch_losses[0]}
        if lead:
            self._log_scalars({"aloss": avg["loss"], "amel": avg["mel_loss"],
                               "apitch": avg["pitch_loss"], "aenergy": avg["energy_loss"],
                               "adur": avg["duration_loss"], "lr": self.schedule(state.step)},
                              state.step)
            if self._writer:
                self._writer.flush()
            print(f"epoch {epoch}: loss={avg['loss']:.4f} mel={avg['mel_loss']:.4f} "
                  f"({time.time() - t0:.1f}s)")
        every = max(1, self.tcfg.checkpoint_every_n_epochs)
        if epoch % every != every - 1 and epoch != self.tcfg.max_epochs - 1:
            return
        weights = full_state_dict(state.model, self.mesh)
        path = os.path.join(ckpt_root, f"{epoch:04d}.msgpack")
        if lead:
            save_native_checkpoint(path, to_jax_variables(weights, self.cfg),
                                   meta={"epoch": epoch, "loss": avg["loss"], "step": state.step})
        del weights
        state_dir = os.path.join(ckpt_root, "state")
        if self.tcfg.checkpoint_format == "state":
            if lead:
                os.makedirs(state_dir, exist_ok=True)
            self.save_train_state(state, os.path.join(state_dir, f"{epoch:04d}.pt"), epoch)
        if lead and self.tcfg.keep_checkpoints > 0:
            keep = self.tcfg.keep_checkpoints
            for folder, ext, extra in ((ckpt_root, ".msgpack", (".json",)), (state_dir, ".pt", ())):
                if not os.path.isdir(folder):
                    continue
                for old in sorted(f for f in os.listdir(folder) if f.endswith(ext))[:-keep]:
                    for stale in (old,) + tuple(old + e for e in extra):
                        if os.path.exists(os.path.join(folder, stale)):
                            os.remove(os.path.join(folder, stale))
