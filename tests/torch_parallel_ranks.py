"""Rank bodies of tests/test_torch_parallel.py's two-process runs.

Each runs in a process `parallel.mesh.spawn` starts (gloo on the CPU), so
this module imports torch and the port only: the spawned processes import
it by name and should not pay for JAX. Results go to `out_dir/<what>{r}.pt`.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch

from zerovox_tpu_torch.config import ZeroVoxConfig
from zerovox_tpu_torch.models.zerovox import ZeroVox
from zerovox_tpu_torch.parallel import mesh as pmesh
from zerovox_tpu_torch.training import trainer as ptrainer
from zerovox_tpu_torch.training import vocoder as pv


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def _per_rank_means():
    """DDP's semantics: each rank's loss is the mean over its own shard and
    the gradients (and the reported losses) are averaged over the ranks."""
    loss = ptrainer.zerovox_loss
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(ptrainer, "zerovox_loss",
                                     lambda pred, batch, group=None: loss(pred, batch)))
        stack.enter_context(_patched(ptrainer, "all_reduce_grads",
                                     functools.partial(pmesh.all_reduce_grads, average=True)))
        stack.enter_context(_patched(ptrainer, "all_reduce_values",
                                     functools.partial(pmesh.all_reduce_values, scale=0.5)))
        yield


@contextlib.contextmanager
def _per_rank_bn():
    """The speaker encoder's BatchNorm statistics over each rank's shard
    alone; the loss and the gradients global as in the real step."""
    forward = ZeroVox.forward

    def local_forward(self, batch, train=True, force_duration=False, spkemb_train=None,
                      group=None):
        return forward(self, batch, train, force_duration, spkemb_train, None)

    with _patched(ZeroVox, "forward", local_forward):
        yield


VARIANTS = {"global": contextlib.nullcontext, "per_rank_means": _per_rank_means,
            "per_rank_bn": _per_rank_bn}


def acoustic_step(rank: int, cfg: dict, state_dict: dict, batch: dict, jobs: tuple,
                  out_dir: str) -> None:
    """One data-parallel train step on this rank's half of `batch` for each
    (variant, precision) of `jobs`: the step's global losses, the reduced
    gradients (before the clip), the running statistics and the weights."""
    torch.set_num_threads(1)
    mesh = pmesh.make_mesh(pmesh.MeshConfig(data=2), devices=["cpu"])
    out = {}
    for variant, precision in jobs:
        trainer = ptrainer.Trainer(
            ZeroVoxConfig.from_dict(cfg),
            ptrainer.TrainerConfig(max_epochs=1, warmup_epochs=1, seed=0, precision=precision),
            steps_per_epoch=1, mesh=mesh)
        state = trainer.init_state(state_dict)
        shard = ptrainer.device_batch(pmesh.shard_batch(batch, mesh), "cpu")
        with VARIANTS[variant]():
            losses = trainer.train_step(state, shard)
        model = state.model
        out[(variant, precision)] = {
            "losses": {k: float(v) for k, v in losses.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers() if "running" in n},
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "rows": int(shard["mel"].shape[0]),
        }
    torch.save(out, os.path.join(out_dir, f"acoustic{rank}.pt"))


def vocoder_step(rank: int, gcfg, dcfg, tcfg, nets: dict, batch: dict, out_dir: str) -> None:
    """One data-parallel GAN round on this rank's half of `batch` (`gan_round`)."""
    torch.set_num_threads(1)
    mesh = pmesh.make_mesh(pmesh.MeshConfig(data=2), devices=["cpu"])
    torch.save(gan_round(mesh, gcfg, dcfg, tcfg, nets, batch),
               os.path.join(out_dir, f"vocoder{rank}.pt"))


def gan_round(mesh, gcfg, dcfg, tcfg, nets: dict, batch: dict) -> dict:
    """One GAN round over `mesh` with recording optimizers: the round's
    losses and the reduced gradients. The nets take `nets`' tensors as they
    are (built on the meta device: no random init to pay for)."""
    from zerovox_tpu_torch.models import hifigan

    trainer = pv.VocoderTrainer(gcfg, dcfg, tcfg, 1, mesh=mesh)
    with torch.device("meta"):
        built = {"gen": hifigan.Generator(gcfg),
                 "mpd": hifigan.MultiPeriodDiscriminator(tcfg.mpd_periods),
                 "msd": hifigan.MultiScaleDiscriminator(tcfg.msd_scales)}
    for name, net in built.items():
        net.load_state_dict(nets[name], assign=True)
        net.train()
    state = pv.VocoderTrainState(
        **built, g_opt=pv.GradRecorder(built["gen"].parameters()),
        d_opt=pv.GradRecorder([*built["mpd"].parameters(), *built["msd"].parameters()]))
    losses = trainer.train_step(state, batch)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "g_grads": state.g_opt.grads, "d_grads": state.d_opt.grads}


def steps(rank: int, acoustic: tuple, vocoder: tuple, out_dir: str) -> None:
    """Both of the above in one spawned pair of ranks (a spawn costs seconds
    of imports): `acoustic_step(rank, *acoustic)`, `vocoder_step(rank, *vocoder)`."""
    acoustic_step(rank, *acoustic, out_dir)
    vocoder_step(rank, *vocoder, out_dir)


def distributed_cli(rank: int, argv: list, cfg: dict, corpora: list, out_dir: str) -> None:
    """`cli.train.run` with `--distributed --process-id rank`: this process
    joins the group itself. Records the rows of every batch the trainer
    stepped on (their mel lengths), the process's place in the group and
    its weights after the run."""
    import torch.distributed as dist

    from zerovox_tpu_torch.cli import train as cli

    torch.set_num_threads(1)
    seen = []
    step = ptrainer.Trainer.train_step

    def recording(self, state, batch):
        seen.append((~batch["mel_mask"]).sum(1).tolist())
        return step(self, state, batch)

    try:
        with _patched(ptrainer.Trainer, "train_step", recording):
            got = cli.run(cli.get_args(argv + ["--process-id", str(rank)]), cfg, corpora)
        trainer, mesh = got["trainer"], got["trainer"].mesh
        torch.save({"rank": mesh.rank, "world": mesh.world, "device": str(trainer.device),
                    "backend": dist.get_backend(), "process_local": mesh.process_local,
                    "seen": seen,
                    "params": {n: p.detach().clone()
                               for n, p in got["state"].model.named_parameters()}},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
