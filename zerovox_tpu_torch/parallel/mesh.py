"""Data and tensor parallelism: the port's counterpart of the JAX package's `parallel/mesh.py`.

The JAX package trains and serves over a `jax.sharding.Mesh` of axes
("data", "model") and lets XLA insert the collectives. In PyTorch the two
uses part:

  * **Training runs one process per device** over a `torch.distributed`
    process group (NCCL on the card, gloo on the CPU). Rank r sits at
    (data r // M, model r % M) of a D x M mesh, the order of the JAX
    `np.asarray(devices).reshape(data, model)`. Every rank starts from
    global rank 0's weights (`replicate`) and takes the block of each
    global batch that belongs to its data index (`shard_batch`: the JAX
    `P("data")` layout; or, in a multi-host run, the batch its process
    loaded). The trainers make the rank's reductions global over the
    `data` axis: BatchNorm sums and the loss's masked-mean denominators
    are all-reduced inside the step over `data_group` (`all_reduce_sum`,
    differentiable), and the gradients once after the backward
    (`all_reduce_grads`), before the clip and the optimizer, as the JAX
    step orders them.
  * **The `model` axis is Megatron-style 1D tensor parallelism** over the
    leaves that `param_sharding_rules` names (the JAX rule's leaves):
    `parallel/tensor.py` installs column- and row-parallel layers whose
    collectives (`copy_to_model`, `reduce_from_model`, `gather_from_model`)
    run over `model_group`; every other parameter is replicated on the
    ranks of a model group.
  * **Serving keeps the JAX meaning of a mesh: one process, several
    devices.** `make_mesh(MeshConfig(data=n, model=m), devices=[...])`
    lists the devices in the JAX order; `ZeroVoxTTS(mesh=)` keeps one
    replica of the weights on each device of the `data` axis (the first of
    each model row) and shards `tts_batch`'s rows over them, as the JAX
    engine replicates its weights over `model` and splits rows over
    `data`.

A `Mesh` is this process's view: its devices and, in a multi-process run,
the process group with its data and model subgroups.

The JAX `batch_spec` and `process_local_batch_to_global` have no
counterpart: a torch tensor is never a global array, so each rank keeps its
own rows and the reductions above make them one batch.
"""

from __future__ import annotations

import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Callable

import torch
import torch.distributed as dist

from zerovox_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: every device of the mesh not on the model axis
    model: int = 1


@dataclass(frozen=True)
class Mesh:
    """This process's devices and, in a multi-process run, the process
    group whose ranks make up the rest of the mesh, with its subgroups:
    `data_group` (the ranks of this rank's model index: the `data` axis)
    and `model_group` (the ranks of its data index: the `model` axis).
    `process_local`: each process's batches are already its own rows (a
    multi-host run); otherwise every rank sees the global batch and
    `shard_batch` takes its block."""

    devices: tuple[torch.device, ...]
    group: object | None = None
    process_local: bool = False
    model: int = 1
    data_group: object | None = field(default=None, compare=False)
    model_group: object | None = field(default=None, compare=False)

    axis_names = ("data", "model")

    @property
    def world(self) -> int:
        return dist.get_world_size(self.group) if self.group is not None else 1

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.group is not None else 0

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices) * self.world // self.model, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def data_devices(self) -> tuple[torch.device, ...]:
        """The devices that run rows: one a data index (the first of its
        model row on a serving mesh; this process's device under a group)."""
        return self.devices if self.group is not None else self.devices[::self.model]


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
                           device=None, backend: str | None = None) -> object:
    """Join (or form) the job's default process group; returns it.

    `coordinator_address` is "host:port" (a TCP store on that host) or an
    init URL ("tcp://...", "file://..."); without one the group reads
    torchrun's variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
    `device` is this process's device (default `cuda:LOCAL_RANK`, which
    raises without a card: the CPU only when the caller passes it); the
    backend is `backend`, by default NCCL on a card and gloo on the CPU
    (gloo also takes CUDA tensors, through the host: the way to put
    several ranks on one card, which NCCL refuses). strict=False accepts a
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
    dist.init_process_group(backend or default_backend(device), init_method=url or "env://",
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id)
    return dist.group.WORLD


def _axis_groups(group, data: int, model: int) -> tuple[object, object]:
    """(data_group, model_group) of this rank in a data x model mesh over
    `group`, which must be the job's whole group: `dist.new_group` is
    called by every process of the job for every subgroup, in one order
    (a rank that formed only its own would wait forever)."""
    if dist.get_world_size(group) != dist.get_world_size():
        raise ValueError("a mesh with a model axis spans the job's whole process group")
    me = dist.get_rank(group)
    mine = {}
    for m in range(model):  # the data axis: ranks of one model index
        g = dist.new_group([d * model + m for d in range(data)])
        if me % model == m:
            mine["data"] = g
    for d in range(data):  # the model axis: ranks of one data index
        g = dist.new_group([d * model + m for m in range(model)])
        if me // model == d:
            mine["model"] = g
    return mine["data"], mine["model"]


def make_mesh(cfg: MeshConfig | None = None, devices=None, group=None,
              process_local: bool = False) -> Mesh:
    """The data x model mesh over `devices` (default: every visible card,
    or under a process group this process's current card; without a card
    the default raises) and, when a process group is formed (`group`,
    default the job's), over its ranks: one device a rank. Raises when
    `cfg` does not cover them. With `cfg.model > 1` under a process group
    every process of the job must call it (it forms the axis subgroups)."""
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
    n = len(devices) * (dist.get_world_size(group) if group is not None else 1)
    model = max(1, cfg.model)
    data = cfg.data if cfg.data > 0 else n // model
    if data * model != n or data < 1:
        raise ValueError(f"mesh {data}x{model} does not cover {n} devices")
    data_group, model_group = group, None
    if group is not None and model > 1:
        data_group, model_group = _axis_groups(group, data, model)
    return Mesh(devices, group, process_local, model, data_group, model_group)


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
    tuple of dicts): the contiguous block of every array or tensor's
    leading axis that belongs to its data index, the JAX `P("data")`
    layout (the ranks of a model group take the same rows). Other entries
    (names, texts) stay whole. Without a process group, or when the batch
    is already this process's own (`mesh.process_local`), the batch is
    returned as it is."""
    if mesh is None or mesh.group is None or mesh.process_local:
        return batch
    if isinstance(batch, tuple):
        return tuple(shard_batch(b, mesh) for b in batch)
    data, index = mesh.shape["data"], mesh.data_index
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) >= 1:
            if v.shape[0] % data:
                raise ValueError(f"batch of {v.shape[0]} rows ({k}) does not split over {data} "
                                 "data ranks")
            b = v.shape[0] // data
            v = v[index * b:(index + 1) * b]
        out[k] = v
    return out


def replicate(module: torch.nn.Module, mesh: Mesh) -> list[torch.nn.Module]:
    """One replica of `module` a device of this process's part of the
    mesh's data axis: the module itself (moved to the first device) and
    deep copies on the others. Across processes every parameter and buffer
    takes global rank 0's values (a broadcast over the whole group), so all
    ranks start from one model."""
    import copy

    devices = mesh.data_devices
    module.to(devices[0])
    if mesh.group is not None:
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t.data, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return [module] + [copy.deepcopy(module).to(d) for d in devices[1:]]


# ------------------------------------------------------------- collectives


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of t summed over the group; 16-bit tensors sum in
    float32 and round once."""
    low = t.dtype in (torch.bfloat16, torch.float16)
    out = t.to(torch.float32 if low else t.dtype, memory_format=torch.contiguous_format,
               copy=True)
    dist.all_reduce(out, group=group)
    return out.to(t.dtype) if low else out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the group's ranks, differentiable: the backward
    all-reduces the cotangent, so each rank's gradient is that of the sum of
    every rank's objective. Right over the `data` axis, where each rank has
    its own loss; over the `model` axis, where every rank computes the same
    loss, it would multiply the upstream gradients by the axis's size
    (`reduce_from_model` is the model axis's sum)."""
    return _AllReduceSum.apply(t, group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        n, me = dist.get_world_size(group), dist.get_rank(group)
        shape = list(t.shape)
        ctx.dim, ctx.size, ctx.me = dim, shape[dim], me
        shape[dim] *= n
        full = t.new_zeros(shape)
        full.narrow(dim, me * t.shape[dim], t.shape[dim]).copy_(t)
        return _all_reduce(full, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.me * ctx.size, ctx.size), None, None


def copy_to_model(t: torch.Tensor, group) -> torch.Tensor:
    """The entry into a model-parallel region: the identity forward; the
    backward all-reduces the cotangent over the model ranks, whose
    partial gradients of t (one from each rank's shard) sum to its whole
    gradient."""
    return _CopyToModel.apply(t, group)


def reduce_from_model(t: torch.Tensor, group) -> torch.Tensor:
    """The exit of a row-parallel product: the sum of the ranks' partial
    products forward; the identity backward (every model rank computes the
    same loss, so the cotangent is already whole)."""
    return _ReduceFromModel.apply(t, group)


def gather_from_model(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of a split tensor concatenated along `dim` in rank
    order (an all-reduce of the zero-filled whole); the backward takes this
    rank's block of the cotangent."""
    return _GatherFromModel.apply(t, dim % t.dim(), group)


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


def all_reduce_grads(params, group, average: bool = False, scale: float | None = None) -> None:
    """Sum the parameters' `.grad` over the group, then divide by the
    group's size (`average`) or multiply by `scale`: one all-reduce of one
    flat buffer, the gradients written back. A parameter without a
    gradient contributes zeros and gets them."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if average:
        flat /= dist.get_world_size(group)
    if scale is not None:
        flat *= scale
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g)
        offset += n


# ------------------------------------------------------------ the model axis

# The JAX rule shards a kernel (ndim >= 2) whose path holds one of these
# names: w_1 / w_qs / w_ks / w_vs on their output features (the JAX last
# axis, axis 0 of a torch Linear (out, in) or Conv1d (out, in, k) weight),
# w_2 / fc on their input features (the JAX axis -2, torch axis 1), each
# where that width divides by the model axis. In the port's upstream names:
_COLUMN = re.compile(r"(^|\.)(slf_attn\.w_[qkv]s|pos_ffn\.w_1)\.weight$")
_ROW = re.compile(r"(^|\.)(slf_attn\.fc|pos_ffn\.w_2|se\.fc\.[02]|norm[12]\.fc)\.weight$"
                  r"|^_spkemb\.fc\.weight$")


def param_sharding_rules(model: torch.nn.Module, mesh: Mesh | int) -> dict[str, int | None]:
    """The model axis's split of each parameter of `model` (whole, as
    built): {name: torch axis split over `model`, or None (replicated)},
    the JAX `param_sharding_rules` on the same leaves. `mesh`: a Mesh or
    the model axis's size."""
    m = mesh.shape["model"] if isinstance(mesh, Mesh) else int(mesh)
    out = {}
    for name, p in model.named_parameters():
        axis = 0 if _COLUMN.search(name) else 1 if _ROW.search(name) else None
        if m <= 1 or p.dim() < 2 or axis is None or p.shape[axis] % m:
            axis = None
        out[name] = axis
    return out


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
    rank with accelerator "cpu"), each with its data-parallel mesh over the
    group."""
    devices = ["cpu"] * nprocs if accelerator == "cpu" else [f"cuda:{i}" for i in range(nprocs)]
    print(f"data parallel: {nprocs} processes on {', '.join(devices)}")
    spawn(_mesh_rank, nprocs, fn, args, devices=devices, mesh=MeshConfig(data=nprocs))


def _mesh_rank(rank: int, fn: Callable, args, mesh: Mesh) -> None:
    fn(*args, mesh)


def spawn(fn: Callable, nprocs: int, *args, devices=None, mesh: MeshConfig | None = None,
          backend: str | None = None) -> None:
    """Run fn(rank, *args) in `nprocs` fresh processes that form one process
    group through a file store in a temporary directory: rank r on
    devices[r] (default `cuda:r`; raises before starting any process when
    fewer cards are visible, and CPU ranks are asked for by name). With
    `mesh`, a MeshConfig, each rank
    also forms that data x model mesh over the group and gets it as fn's
    last argument: fn(rank, *args, mesh). `backend` is the group's (default
    NCCL on CUDA devices, gloo on the CPU; gloo puts several ranks on one
    card). Returns when every rank has; raises if any rank raised."""
    import torch.multiprocessing as mp

    if devices is None:
        visible = torch.cuda.device_count()
        if nprocs > visible:
            raise RuntimeError(f"spawn: {nprocs} processes but only {visible} CUDA device(s) "
                               "are visible; pass devices=['cpu'] * n for CPU ranks")
        devices = [f"cuda:{i}" for i in range(nprocs)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != nprocs:
        raise ValueError(f"{nprocs} processes but {len(devices)} devices")
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(fn, nprocs, f"file://{tmp}/store", devices, args,
                                             mesh, backend),
                           nprocs=nprocs, start_method="spawn")


def _rank_main(rank: int, fn: Callable, world: int, url: str, devices, args,
               mesh: MeshConfig | None, backend: str | None) -> None:
    initialize_distributed(coordinator_address=url, num_processes=world, process_id=rank,
                           device=devices[rank], backend=backend)
    try:
        if mesh is not None:
            args = (*args, make_mesh(mesh, devices=[devices[rank]]))
        fn(rank, *args)
    finally:
        dist.destroy_process_group()
