"""Rank bodies of tests/test_torch_tensor_parallel.py's four-process run.

The processes `parallel.mesh.spawn` starts (gloo on the CPU, a 2 x 2 data x
model mesh) import this module by name, so it imports torch and the port
only. Rank r sits at (data r // 2, model r % 2); the two ranks of one model
index also form a data-parallel job of their own over their `data_group`,
the reference for the runs that the JAX package has no counterpart of.
Results go to `out_dir/tp{r}.pt`.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist
from torch_parallel_ranks import _patched, gan_round

from zerovox_tpu_torch.config import ZeroVoxConfig
from zerovox_tpu_torch.parallel import mesh as pmesh
from zerovox_tpu_torch.parallel import tensor as ptensor
from zerovox_tpu_torch.training import optim as poptim
from zerovox_tpu_torch.training import trainer as ptrainer


@contextlib.contextmanager
def _row_all_reduce_sum():
    """The row-parallel sum through `all_reduce_sum`, whose backward also
    all-reduces the cotangent: every upstream gradient counted M times."""
    with _patched(ptensor, "reduce_from_model", pmesh.all_reduce_sum):
        yield


def _local_norm(self, grads):
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


@contextlib.contextmanager
def _local_clip_norm():
    """The clip's norm over this rank's blocks and the replicated
    gradients, without the model axis's sum."""
    with _patched(poptim.AdamW, "_global_norm", _local_norm):
        yield


CONTROLS = {"row_all_reduce_sum": _row_all_reduce_sum, "local_clip_norm": _local_clip_norm,
            "world_sums": contextlib.nullcontext}


def _whole(trainer, state) -> dict:
    """The step's losses aside: gradients, weights, second moments (whole,
    by name) and running statistics, gathered over the model axis."""
    model, opt = state.model, state.optimizer
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    axes = ptensor.sharded_axes(model) if trainer.tensor_parallel else {}
    ax = [axes.get(n) for n in names]
    gather = (lambda ts: ptensor.gather_shards(ts, ax, trainer.mesh)) if axes else list
    nu = {id(p): v for p, v in zip(opt.params, opt.nu)}
    return {"grads": dict(zip(names, [g.clone() for g in gather([p.grad for p in params])])),
            "params": dict(zip(names, [p.detach().clone() for p in gather(params)])),
            "nu": dict(zip(names, [v.float().clone() for v in gather([nu[id(p)] for p in params])])),
            "buffers": {n: b.clone() for n, b in model.named_buffers() if "running" in n}}


def _run(cfg: dict, sd: dict, batch: dict, mesh, precision: str = "32", steps: int = 1,
         control: str | None = None, save: str | None = None, resume: str | None = None) -> dict:
    """`steps` train steps from `sd` (or from `resume`'s train state) on
    `mesh`: each step's losses and `_whole` record, with `save` the train
    state after the first step, and this rank's own tensors after the
    last."""
    trainer = ptrainer.Trainer(
        ZeroVoxConfig.from_dict(cfg),
        ptrainer.TrainerConfig(max_epochs=1, warmup_epochs=1, seed=0, precision=precision),
        steps_per_epoch=1, mesh=mesh)
    if control == "world_sums":  # BatchNorm and loss sums over all four ranks
        trainer.data_group = mesh.group
    state = trainer.init_state(sd)
    if resume is not None:
        trainer.restore_train_state(state, resume)
    shard = ptrainer.device_batch(pmesh.shard_batch(batch, mesh), "cpu")
    out = {"steps": []}
    for i in range(steps):
        with CONTROLS[control]() if control else contextlib.nullcontext():
            losses = trainer.train_step(state, shard)
        out["steps"].append({"losses": {k: float(v) for k, v in losses.items()},
                             **_whole(trainer, state)})
        if save is not None and i == 0:
            trainer.save_train_state(state, save, 0)
            dist.barrier()  # the file is written before any rank reads it
    opt = state.optimizer
    out["local"] = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    out["moment_shapes"] = [(tuple(p.shape), tuple(v.shape)) for p, v in zip(opt.params, opt.nu)]
    out["split"] = ptensor.sharded_axes(state.model)
    out["rows"] = int(shard["mel"].shape[0])
    return out


def tp_steps(rank: int, cfgs: dict, sds: dict, batch: dict, vocoder: tuple, out_dir: str,
             mesh) -> None:
    """Every run of the test on this rank of the 2 x 2 mesh `mesh`, with
    the data-parallel runs over its data group; `vocoder`: (gcfg, dcfg,
    tcfg, nets, batch) of one GAN round on either mesh."""
    torch.set_num_threads(1)
    dp = pmesh.make_mesh(pmesh.MeshConfig(data=2), devices=["cpu"], group=mesh.data_group)
    tp_file = os.path.join(out_dir, "tp_state.pt")
    dp_file = os.path.join(out_dir, f"dp{mesh.model_index}_state.pt")
    base, sd = cfgs["base"], sds["base"]
    out = {"coords": (mesh.data_index, mesh.model_index), "shape": mesh.shape,
           "tp32": _run(base, sd, batch, mesh, steps=2, save=tp_file),
           "tp16": _run(base, sd, batch, mesh, "bf16-mixed", steps=2),
           "dp32": _run(base, sd, batch, dp, steps=2, save=dp_file)}
    dist.barrier()  # both data-parallel jobs have written their files
    out["tp_from_dp"] = _run(base, sd, batch, mesh, resume=os.path.join(out_dir, "dp0_state.pt"))
    out["dp_from_tp"] = _run(base, sd, batch, dp, resume=tp_file)
    for control in CONTROLS:
        out[control] = _run(base, sd, batch, mesh, control=control)
    for name in ("one_head", "dropout"):
        out[name] = {"tp": _run(cfgs[name], sds[name], batch, mesh),
                     "dp": _run(cfgs[name], sds[name], batch, dp)}
    for key, m in (("tp", mesh), ("dp", dp)):  # one epoch of `fit`: its checkpoints
        folder = os.path.join(out_dir, f"fit_{key}{mesh.model_index if key == 'dp' else ''}")
        trainer = ptrainer.Trainer(
            ZeroVoxConfig.from_dict(base),
            ptrainer.TrainerConfig(max_epochs=1, warmup_epochs=1, seed=0, out_folder=folder,
                                   checkpoint_format="state"),
            steps_per_epoch=1, mesh=m)
        trainer.fit(lambda: iter([batch]), trainer.init_state(sd))
    out["gan"] = {"tp": gan_round(mesh, *vocoder), "dp": gan_round(dp, *vocoder)}
    torch.save(out, os.path.join(out_dir, f"tp{rank}.pt"))
