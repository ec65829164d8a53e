"""Shared neural-net primitives with the numerics of the JAX package's layers.

Activations at these functions' boundaries are NLC ([batch, length,
channels]), the layout the JAX package uses, so tests compare like with
like. Parameters use PyTorch's own layouts and the upstream gooofy/zerovox
module names: Conv1d weight (out, in, k), Linear weight (out, in),
ConvTranspose1d weight (in, out, k).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias=None, padding: int = 0,
           dilation: int = 1, stride: int = 1) -> torch.Tensor:
    """Conv over NLC x [B, T, Cin] with a torch weight (out, in, k)."""
    y = F.conv1d(x.transpose(1, 2), weight, bias, stride=stride,
                 padding=padding, dilation=dilation)
    return y.transpose(1, 2)


def conv_transpose1d(x: torch.Tensor, weight: torch.Tensor, bias, stride: int,
                     padding: int) -> torch.Tensor:
    """Transposed conv over NLC x [B, T, Cin] with a torch weight (in, out, k)."""
    y = F.conv_transpose1d(x.transpose(1, 2), weight, bias, stride=stride,
                           padding=padding)
    return y.transpose(1, 2)


def torch_std(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unbiased std with 1e-12 inside the sqrt, as the JAX package's
    `torch_std` (its epsilon keeps gradients finite on constant rows)."""
    n = x.shape[dim]
    mu = x.mean(dim=dim, keepdim=True)
    var = ((x - mu) ** 2).sum(dim=dim, keepdim=True) / max(n - 1, 1)
    return torch.sqrt(var + 1e-12)


class Conv(nn.Module):
    """`Conv1d` wrapped as `.conv`, the upstream variance predictor's key
    layout (`conv_layer.conv1d_1.conv.weight`)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, padding: int):
        super().__init__()
        self.conv = nn.Conv1d(in_ch, out_ch, kernel_size, padding=padding)

    def forward(self, x):  # NLC
        return self.conv(x.transpose(1, 2)).transpose(1, 2)


class NLCConv1d(nn.Conv1d):
    """nn.Conv1d applied to NLC activations."""

    def forward(self, x):
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class LinearNorm(nn.Module):
    """Linear projection stored as `.linear` (upstream fs2 LinearNorm)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = False):
        super().__init__()
        self.linear = nn.Linear(in_features, out_features, bias=bias)

    def forward(self, x):
        return self.linear(x)


class SCLN(nn.Module):
    """Speaker-conditional LayerNorm: g(s) * (x - mu) / (sigma + eps) + b(s)
    with the unbiased std and eps added to sigma."""

    def __init__(self, hidden_size: int, eps: float = 1e-8):
        super().__init__()
        self.hidden_size = hidden_size
        self.eps = eps
        self.affine_layer = LinearNorm(hidden_size, 2 * hidden_size, bias=False)

    def forward(self, x, s):
        mu = x.mean(dim=-1, keepdim=True)
        y = (x - mu) / (torch_std(x, dim=-1) + self.eps)
        b, g = torch.split(self.affine_layer(s), self.hidden_size, dim=-1)
        return g * y + b


class Dropout(nn.Module):
    """Dropout with flax's rule (keep with probability 1 - rate, scale the
    kept values by 1 / (1 - rate)), drawing from `generator` when one is
    set (see `set_dropout_generator`). The identity in eval mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_dropout_generator(module: nn.Module, generator: torch.Generator | None) -> None:
    """Point every Dropout under `module` at `generator`."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def remat(module: nn.Module, *args):
    """module(*args) under torch.utils.checkpoint (non-reentrant): the
    backward recomputes the module's activations instead of keeping them,
    as the JAX package's `nn.remat`. checkpoint restores only the default
    generators, so the recomputation here also puts the Dropouts' own
    generators back to their state at the forward (the same masks) and
    leaves the module's buffers (BatchNorm running statistics) as the
    forward left them (one update a step)."""
    from torch.utils.checkpoint import checkpoint

    gens = list({id(m.generator): m.generator for m in module.modules()
                 if isinstance(m, Dropout) and m.generator is not None}.values())
    at_forward = []

    @contextlib.contextmanager
    def forward_ctx():
        at_forward[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute_ctx():
        now = [g.get_state() for g in gens]
        buffers = [b.clone() for b in module.buffers()]
        for g, state in zip(gens, at_forward):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)
            with torch.no_grad():
                for b, saved in zip(module.buffers(), buffers):
                    b.copy_(saved)

    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=lambda: (forward_ctx(), recompute_ctx()))


def instance_norm_time(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalize each channel of NLC x over the length axis (biased var)."""
    mu = x.mean(dim=1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


class InstanceNorm(nn.Module):
    """InstanceNorm1d over the length axis of NLC x [B, L, C]: each channel
    of each sample normalized over L (biased variance, no running
    statistics), then `weight` and `bias` per channel when `affine`."""

    def __init__(self, features: int, affine: bool = False, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x):
        y = instance_norm_time(x, self.eps)
        return y if self.weight is None else y * self.weight + self.bias


class WeightNormConv1d(nn.Module):
    """Conv1d with weight norm over NLC activations: weight = g * v / ||v||,
    one g per output channel and the norm over (in, k), with 1e-12 inside
    the sqrt as in the JAX package. `weight_g` (out, 1, 1) and `weight_v`
    (out, in, k) stay separate parameters, the upstream
    torch.nn.utils.weight_norm keys."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, padding: int = 0,
                 bias: bool = True):
        super().__init__()
        self.padding = padding
        self.weight_g = nn.Parameter(torch.ones(out_ch, 1, 1))
        self.weight_v = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size))
        nn.init.kaiming_uniform_(self.weight_v, a=5 ** 0.5)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def weight(self) -> torch.Tensor:
        v = self.weight_v
        norm = torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True) + 1e-12)
        return v * (self.weight_g / norm)

    def forward(self, x):
        return conv1d(x, self.weight(), self.bias, padding=self.padding)


def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """Sinusoid position table, computed in float64 then cast to float32."""
    positions = np.arange(n_position)[:, None]
    hid_idx = np.arange(d_hid)[None, :]
    angle = positions / np.power(10000, 2 * (hid_idx // 2) / d_hid)
    table = np.zeros((n_position, d_hid))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


@functools.lru_cache(maxsize=32)
def position_table(seq_len: int, d_model: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """[seq_len, d_model] positions, cached per bucket and device (callers
    must not write to it). Row p of the table does not depend on the
    table's length, so a bucket past the trained length needs no special
    case."""
    return torch.tensor(sinusoid_table(seq_len, d_model), device=device, dtype=dtype)
