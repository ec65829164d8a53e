"""Megatron-style 1D tensor parallelism over a mesh's `model` axis.

`shard_model` walks a whole model against `param_sharding_rules` (the JAX
package's rule, `parallel/mesh.py`) and replaces each `nn.Linear` or
`NLCConv1d` whose weight the rule splits by a `ShardedLayer` holding this
rank's block. Modules are not edited: the layer keeps the name, so
`named_parameters()` gives the upstream names with local shapes.

  * **Column-parallel** (w_1, w_qs / w_ks / w_vs: the rule splits the
    output features): the input enters through `copy_to_model` and the
    layer computes its own output channels. Its bias splits with them
    (Megatron's layout; the JAX package replicates it): the split bias
    then has a local gradient like its weight, and every parameter that
    stays replicated gets its whole gradient on every model rank. Where
    the consumer takes whole features (a row-parallel partner that the
    rule leaves whole, or attention whose heads do not divide by the
    axis) the output is gathered.
  * **Row-parallel** (w_2, fc: the rule splits the input features): fed
    by its column-parallel partner, the input is already local; on a
    replicated input (the SE and speaker-embedding fc's, StyleTTS's AdaIN
    fc) it enters through `copy_to_model` and the layer takes its slice of
    the input features. The partial product is summed by
    `reduce_from_model`, then the replicated bias is added once.

Attention runs the heads of its local q, k, v (models/fs2.py reads the
head count off their width), so when n_head divides by the axis each rank
runs n_head / M heads and `fc` takes the split input; otherwise q, k and v
are gathered, every rank runs every head and `fc` takes its slice.

`full_state_dict` / `load_full_state_dict` gather and split the weights
(the checkpoints hold whole tensors, as a data-parallel run writes them);
`gather_shards` / `local_shards` do the same for lists aligned with a
parameter list (the optimizer's moments).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from zerovox_tpu_torch.models.layers import NLCConv1d
from zerovox_tpu_torch.parallel.mesh import (Mesh, copy_to_model, gather_from_model,
                                             param_sharding_rules, reduce_from_model)


class ShardedLayer(nn.Module):
    """This rank's block of a Linear (`weight` [out, in]) or NLCConv1d
    (`weight` [out, in, k]) split over the model axis on `axis` (0:
    column-parallel, 1: row-parallel). Computes in its input's dtype (the
    JAX package's Dense promotes a bf16 kernel to a float32 input's type).
    `gather_output`: a column-parallel layer returns whole features;
    `split_input`: a row-parallel layer's input holds only its features."""

    def __init__(self, layer: nn.Module, axis: int, mesh: Mesh, gather_output: bool = False,
                 split_input: bool = False):
        super().__init__()
        m, i = mesh.shape["model"], mesh.model_index
        self.axis, self.group, self.model_size, self.model_index = axis, mesh.model_group, m, i
        self.gather_output, self.split_input = gather_output, split_input
        self.full_shape = tuple(layer.weight.shape)
        self.conv = ({"padding": layer.padding, "dilation": layer.dilation,
                      "stride": layer.stride} if isinstance(layer, nn.Conv1d) else None)
        if self.conv is not None and not isinstance(layer, NLCConv1d):
            raise TypeError(f"{type(layer).__name__}: only Linear and NLCConv1d are split")
        with torch.no_grad():
            self.weight = nn.Parameter(layer.weight.chunk(m, axis)[i].clone())
            bias = layer.bias
            if bias is not None and axis == 0:
                bias = bias.chunk(m)[i]
            self.bias = None if bias is None else nn.Parameter(bias.clone())

    def _product(self, x, bias):
        w = self.weight.to(x.dtype)
        b = None if bias is None else bias.to(x.dtype)
        if self.conv is None:
            return F.linear(x, w, b)
        return F.conv1d(x.transpose(1, 2), w, b, **self.conv).transpose(1, 2)

    def forward(self, x):
        if self.axis == 0:
            y = self._product(copy_to_model(x, self.group), self.bias)
            return gather_from_model(y, -1, self.group) if self.gather_output else y
        if not self.split_input:
            n = x.shape[-1] // self.model_size
            x = copy_to_model(x, self.group).narrow(-1, self.model_index * n, n)
        y = reduce_from_model(self._product(x, None), self.group)
        return y if self.bias is None else y + self.bias.to(y.dtype)

    def extra_repr(self) -> str:
        kind = "column" if self.axis == 0 else "row"
        return (f"{kind}-parallel block {tuple(self.weight.shape)} of {self.full_shape}, "
                f"gather_output={self.gather_output}, split_input={self.split_input}")


def _kept_split(rules: dict, parent: str, mod: nn.Module, child: str, m: int) -> bool:
    """Whether the column-parallel `child` of `parent` can hand its local
    features straight to a split consumer (attention's fc over whole heads,
    or the FFN's w_2)."""
    if child in ("w_qs", "w_ks", "w_vs"):
        return rules.get(f"{parent}fc.weight") == 1 and mod.n_head % m == 0
    if child == "w_1":
        return rules.get(f"{parent}w_2.weight") == 1
    return False


def shard_model(model: nn.Module, mesh: Mesh) -> None:
    """Install the sharded layers of `param_sharding_rules(model, mesh)`
    into `model` (whole, the same weights on every rank)."""
    m = mesh.shape["model"]
    rules = param_sharding_rules(model, mesh)
    modules = dict(model.named_modules())
    for name, axis in rules.items():
        if axis is None:
            continue
        path = name[:-len(".weight")]
        parent_name, _, child = path.rpartition(".")
        parent = modules[parent_name] if parent_name else model
        prefix = f"{parent_name}." if parent_name else ""
        layer = modules[path]
        if axis == 0:
            new = ShardedLayer(layer, 0, mesh,
                               gather_output=not _kept_split(rules, prefix, parent, child, m))
        else:
            partner = {"fc": "w_vs", "w_2": "w_1"}.get(child)
            fed = (partner is not None and rules.get(f"{prefix}{partner}.weight") == 0
                   and _kept_split(rules, prefix, parent, partner, m))
            new = ShardedLayer(layer, 1, mesh, split_input=fed)
        parent._modules[child] = new


def sharded_axes(model: nn.Module) -> dict[str, int]:
    """{parameter name: split axis} of the parameters `shard_model` split,
    the column-parallel biases included."""
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, ShardedLayer):
            prefix = f"{name}." if name else ""
            out[prefix + "weight"] = mod.axis
            if mod.bias is not None and mod.axis == 0:
                out[prefix + "bias"] = 0
    return out


def gather_shards(tensors: list, axes: list, mesh: Mesh | None) -> list:
    """Whole tensors from this rank's blocks (axis None: kept as is),
    gathered over the model axis; every rank of the model group calls it."""
    return [t if a is None else gather_from_model(t.detach(), a, mesh.model_group)
            for t, a in zip(tensors, axes)]


def local_shards(tensors: list, axes: list, mesh: Mesh | None) -> list:
    """This rank's blocks of whole tensors (axis None: kept as is)."""
    return [t if a is None else t.chunk(mesh.shape["model"], a)[mesh.model_index]
            for t, a in zip(tensors, axes)]


def full_state_dict(model: nn.Module, mesh: Mesh | None) -> dict[str, torch.Tensor]:
    """`model.state_dict()` with every split parameter whole: the keys and
    shapes a data-parallel run's model has. A collective over the model
    axis when the model is split (every rank of the model group calls it)."""
    sd = model.state_dict()
    axes = sharded_axes(model)
    return dict(zip(sd, gather_shards(list(sd.values()), [axes.get(k) for k in sd], mesh)))


def load_full_state_dict(model: nn.Module, state_dict: dict, mesh: Mesh | None) -> None:
    """Load whole weights (`full_state_dict`'s layout) into a model whose
    layers may be split: each split parameter takes its block."""
    axes = sharded_axes(model)
    model.load_state_dict(dict(zip(state_dict, local_shards(
        list(state_dict.values()), [axes.get(k) for k in state_dict], mesh))))
