"""Data parallelism: the port's counterpart of the JAX package's `parallel/mesh.py`.

The JAX package trains and serves over a `jax.sharding.Mesh` and lets XLA
insert the collectives. In PyTorch the two uses part:

  * **Training runs one process per device** over a `torch.distributed`
    process group (NCCL on the card, gloo on the CPU). Every rank holds the
    whole model (`replicate` broadcasts rank 0's values) and a shard of the
    global batch (`shard_batch`: its contiguous block of rows, the JAX
    `P("data")` layout; or, in a multi-host run, the batch its process
    loaded). The trainers make the rank's reductions global: BatchNorm
    sums and the loss's masked-mean denominators are all-reduced inside the
    step (`all_reduce_sum`, differentiable), and the gradients once after
    the backward (`all_reduce_grads`), before the clip and the optimizer,
    as the JAX step orders them.
  * **Serving keeps the JAX meaning of a mesh: one process, several
    devices.** `make_mesh(MeshConfig(data=n), devices=[...])` lists the
    devices of the `data` axis; `ZeroVoxTTS(mesh=)` keeps one replica of
    the weights on each and shards `tts_batch`'s rows over them.

A `Mesh` is this process's view: its devices on the `data` axis and, in a
multi-process run, the process group. The `model` axis (tensor parallelism)
is not ported: `MeshConfig(model > 1)` raises (ROADMAP P14b).

The JAX `batch_spec` and `process_local_batch_to_global` have no
counterpart: a torch tensor is never a global array, so each rank keeps its
own rows and the reductions above make them one batch.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from zerovox_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: every device of the mesh
    model: int = 1

    def __post_init__(self):
        if self.model > 1:
            raise NotImplementedError(
                f"MeshConfig(model={self.model}): the tensor-parallel model axis is not "
                "ported yet (ROADMAP P14b); use data parallelism")


@dataclass(frozen=True)
class Mesh:
    """This process's devices on the `data` axis and, in a multi-process
    run, the process group whose ranks make up the rest of it.
    `process_local`: each process's batches are already its own rows (a
    multi-host run); otherwise every rank sees the global batch and
    `shard_batch` takes its block."""

    devices: tuple[torch.device, ...]
    group: object | None = None
    process_local: bool = False

    axis_names = ("data", "model")

    @property
    def world(self) -> int:
        return dist.get_world_size(self.group) if self.group is not None else 1

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.group is not None else 0

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices) * self.world, "model": 1}


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def indexed_device(device) -> torch.device:
    """`device` with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def initialize_distributed(strict: bool = True, coordinator_address: str | None = None,
                           num_processes: int | None = None, process_id: int | None = None,
                           device=None) -> object:
    """Join (or form) the job's default process group; returns it.

    `coordinator_address` is "host:port" (a TCP store on that host) or an
    init URL ("tcp://...", "file://..."); without one the group reads
    torchrun's variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
    `device` is this process's device (default `cuda:LOCAL_RANK`, which
    raises without a card: the CPU only when the caller passes it); the
    backend is NCCL on a card, gloo on the CPU. strict=False accepts a
    group that is already formed; every real failure raises: a run that
    went on as several single-process runs would train as many separate
    models."""
    if dist.is_initialized():
        if strict:
            raise RuntimeError("torch.distributed is already initialized")
        return dist.group.WORLD
    device = indexed_device(resolve_device(
        f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}" if device is None else device))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    url = coordinator_address
    if url is not None and "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(default_backend(device), init_method=url or "env://",
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id)
    return dist.group.WORLD


def make_mesh(cfg: MeshConfig | None = None, devices=None, group=None,
              process_local: bool = False) -> Mesh:
    """The mesh over `devices` (default: every visible card, or under a
    process group this process's current card; without a card the default
    raises) and, when a process group is formed (`group`, default the
    job's), over its ranks: one device a rank. Raises when `cfg` does not
    cover them."""
    cfg = cfg or MeshConfig()
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    if devices is None:
        resolve_device()  # the default is the card: raise without one
        devices = ([torch.device("cuda", torch.cuda.current_device())] if group is not None
                   else [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    devices = tuple(indexed_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if group is not None and len(devices) != 1:
        raise ValueError(f"a multi-process mesh takes one device a process, got {len(devices)}")
    mesh = Mesh(devices, group, process_local)
    n = mesh.shape["data"]
    data = cfg.data if cfg.data > 0 else n
    if data * max(1, cfg.model) != n:
        raise ValueError(f"mesh {data}x{max(1, cfg.model)} does not cover {n} devices")
    return mesh


def process_device(mesh: Mesh | None, device=None):
    """The device of one training process: `device`, or on a `mesh` the
    process's one device there (training runs one process a device).
    Raises for a mesh of several devices or a `device` that is not it."""
    if mesh is None:
        return device
    if len(mesh.devices) != 1:
        raise ValueError("training runs one process a device: give each process a mesh over a "
                         "process group (the training CLIs' --devices N spawn them)")
    if device is not None and indexed_device(device) != mesh.devices[0]:
        raise ValueError(f"device {device} is not the mesh's {mesh.devices[0]}")
    return mesh.devices[0]


def shard_batch(batch, mesh: Mesh | None):
    """This rank's rows of a host or device batch (a dict, or an (x, y)
    tuple of dicts): its contiguous block of every array or tensor's
    leading axis, the JAX `P("data")` layout. Other entries (names, texts)
    stay whole. Without a process group, or when the batch is already this
    process's own (`mesh.process_local`), the batch is returned as it is."""
    if mesh is None or mesh.group is None or mesh.process_local:
        return batch
    if isinstance(batch, tuple):
        return tuple(shard_batch(b, mesh) for b in batch)
    world, rank = mesh.world, mesh.rank
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) >= 1:
            if v.shape[0] % world:
                raise ValueError(f"batch of {v.shape[0]} rows ({k}) does not split over {world} ranks")
            b = v.shape[0] // world
            v = v[rank * b:(rank + 1) * b]
        out[k] = v
    return out


def replicate(module: torch.nn.Module, mesh: Mesh) -> list[torch.nn.Module]:
    """One replica of `module` a device of this process's part of the mesh:
    the module itself (moved to the first device) and deep copies on the
    others. Across processes every parameter and buffer takes rank 0's
    values (a broadcast), so all ranks start from one model."""
    import copy

    module.to(mesh.devices[0])
    if mesh.group is not None:
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t.data, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return [module] + [copy.deepcopy(module).to(d) for d in mesh.devices[1:]]


# ------------------------------------------------------------- collectives


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the group's ranks, differentiable: the backward
    all-reduces the cotangent, so each rank's gradient is that of the sum of
    every rank's objective."""
    return _AllReduceSum.apply(t, group)


def all_reduce_values(values: dict[str, torch.Tensor], group,
                      scale: float | None = None) -> dict[str, torch.Tensor]:
    """Detached scalars (a step's losses) summed over the group in one
    all-reduce, then multiplied by `scale` when given."""
    keys = list(values)
    flat = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(flat, group=group)
    if scale is not None:
        flat = flat * scale
    return dict(zip(keys, flat.unbind()))


def all_reduce_grads(params, group, average: bool = False) -> None:
    """Sum (or, with `average`, mean) the parameters' `.grad` over the
    group: one all-reduce of one flat buffer, the gradients written back.
    A parameter without a gradient contributes zeros and gets them."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if average:
        flat /= dist.get_world_size(group)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g)
        offset += n


# ----------------------------------------------------------------- launch


def device_count(requested: int, accelerator: str) -> int:
    """The processes a CLI's `--devices` asks for: -1 is every visible card
    (one process on the CPU, or where no card is visible, whose entry point
    then raises); N > 1 processes on `cuda:0..N-1`, or N gloo ranks with
    `--accelerator cpu`. Raises when fewer cards are visible than asked."""
    if accelerator == "cpu":
        return max(1, requested)
    visible = torch.cuda.device_count()
    if requested > max(visible, 1):
        raise RuntimeError(f"--devices {requested}: only {visible} CUDA device(s) are visible")
    return requested if requested > 0 else max(visible, 1)


def spawn_data_parallel(fn: Callable, nprocs: int, accelerator: str, *args) -> None:
    """fn(*args, mesh) in `nprocs` spawned ranks, rank r on `cuda:r` (a CPU
    rank with accelerator "cpu"), each with its mesh over the group."""
    devices = ["cpu"] * nprocs if accelerator == "cpu" else [f"cuda:{i}" for i in range(nprocs)]
    print(f"data parallel: {nprocs} processes on {', '.join(devices)}")
    spawn(_data_parallel_rank, nprocs, fn, devices, args, devices=devices)


def _data_parallel_rank(rank: int, fn: Callable, devices: list, args) -> None:
    fn(*args, make_mesh(MeshConfig(data=len(devices)), devices=[devices[rank]]))


def spawn(fn: Callable, nprocs: int, *args, devices=None) -> None:
    """Run fn(rank, *args) in `nprocs` fresh processes that form one process
    group through a file store in a temporary directory: rank r on
    devices[r] (default the CPU, over gloo; CUDA devices over NCCL). Returns
    when every rank has; raises if any rank raised."""
    import torch.multiprocessing as mp

    devices = [torch.device(d) for d in (devices or ["cpu"] * nprocs)]
    if len(devices) != nprocs:
        raise ValueError(f"{nprocs} processes but {len(devices)} devices")
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(fn, nprocs, f"file://{tmp}/store", devices, args),
                           nprocs=nprocs, start_method="spawn")


def _rank_main(rank: int, fn: Callable, world: int, url: str, devices, args) -> None:
    initialize_distributed(coordinator_address=url, num_processes=world, process_id=rank,
                           device=devices[rank])
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()
