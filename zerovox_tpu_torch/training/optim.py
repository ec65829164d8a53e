"""Optimizers and learning-rate schedules of the trainers.

The PyTorch counterpart of the JAX package's `training/optim.py` (and of
the vocoder trainer's `optax.adamw`), in optax's order: global-norm
gradient clipping (optional), then Adam's scaling, then decoupled weight
decay, then the learning rate:

    g   <- g * min(1, clip / ||g||)
    nu  <- b2 nu + (1 - b2) g^2                      (mu likewise when b1 != 0)
    u   <- mu_hat / (sqrt(nu / (1 - b2^t)) + eps)    (mu_hat = g when b1 == 0)
    p   <- p - lr(t - 1) * (u + weight_decay * p)

With b1 == 0 (the production configs' betas (0.0, 0.99)) the first moment is
the gradient itself and is not stored. `state_dtype="bf16"` then stores nu
in bf16, as the JAX package's `_scale_by_adam_no_mu(state_dtype=...)`: the
moment update runs in float32 from the stored value, the step uses the
unrounded float32 moment, and only the stored nu is rounded. The acoustic
model's schedule is the epoch warmup + cosine decay with its floor at 0.1
of the base rate; the vocoder's is optax's staircase `exponential_decay`.
Updates run on whole parameter lists with torch's multi-tensor (`_foreach`)
ops.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist


def exponential_decay_schedule(base_lr: float, steps_per_epoch: int,
                               decay: float) -> Callable[[int], float]:
    """optax.exponential_decay(base_lr, transition_steps=steps_per_epoch,
    decay_rate=decay, staircase=True): lr(count) = base_lr *
    decay^floor(count / steps_per_epoch), count taken before the update."""
    every = max(steps_per_epoch, 1)

    def schedule(count: int) -> float:
        return base_lr * decay ** (count // every)

    return schedule


def warmup_cosine_epoch_schedule(base_lr: float, warmup_epochs: int, total_epochs: int,
                                 steps_per_epoch: int,
                                 min_lr_factor: float = 0.1) -> Callable[[int], float]:
    """lr(step) = base_lr * f(epoch): (epoch + 1) / warmup during warmup,
    then max(min_lr_factor, (1 + cos(pi * progress)) / 2)."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        if epoch < warmup_epochs:
            f = (epoch + 1.0) / float(max(warmup_epochs, 1))
        else:
            progress = (epoch - warmup_epochs) / float(max(1, total_epochs - warmup_epochs))
            f = max(min_lr_factor, 0.5 * (1.0 + math.cos(math.pi * progress)))
        return base_lr * f

    return schedule


class AdamW:
    """Clip + Adam (mu-free when b1 == 0) + decoupled weight decay + lr over
    a fixed list of float32 parameters. `step(lr)` reads their `.grad`.
    `grad_clip=None` takes no clipping step (optax.adamw alone).
    `state_dtype`: "f32", or "bf16" second moments (b1 == 0 only; with
    b1 != 0 it warns and keeps float32, as the JAX `make_optimizer`).
    Under tensor parallelism `model_group` is the model axis's group and
    `sharded` the parameters (of `params`) that hold only this rank's block:
    the clip's global norm is then that of the whole gradient,
    sqrt(sum of the replicated g^2 + the model axis's sum of the blocks'
    g^2); the moments take each local parameter's shape."""

    def __init__(self, params, betas=(0.0, 0.99), eps: float = 1e-9,
                 weight_decay: float = 0.0, grad_clip: float | None = 1.0,
                 state_dtype: str = "f32", model_group=None, sharded=()):
        if state_dtype not in ("f32", "bf16"):
            raise ValueError(f"state_dtype must be 'f32' or 'bf16', got {state_dtype!r}")
        self.params = [p for p in params if p.requires_grad]
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps, self.weight_decay, self.grad_clip = eps, weight_decay, grad_clip
        if state_dtype == "bf16" and self.b1 != 0.0:
            print("*** warning: --optim-dtype bf16 requires betas[0] == 0 "
                  "(mu-free path); using full-precision adamw")
            state_dtype = "f32"
        self.state_dtype = state_dtype
        self.count = 0
        nu_dtype = torch.bfloat16 if state_dtype == "bf16" else None
        self.nu = [torch.zeros_like(p, dtype=nu_dtype) for p in self.params]
        self.mu = [torch.zeros_like(p) for p in self.params] if self.b1 != 0.0 else None
        self.model_group = model_group
        ids = {id(p) for p in sharded}
        self.sharded = [id(p) in ids for p in self.params]

    @torch.no_grad()
    def step(self, lr: float) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.grad_clip is not None:
            # global-norm clip: g * clip / ||g|| when ||g|| >= clip
            norm = self._global_norm(grads)
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            grads = torch._foreach_mul(grads, scale)

        self.count += 1
        if self.state_dtype == "bf16":
            # nu32 = b2 nu + (1 - b2) g^2 in float32; the step reads nu32,
            # the stored nu is its bf16 rounding
            nu = [n.float() for n in self.nu]
            torch._foreach_mul_(nu, self.b2)
            gg = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(gg, 1.0 - self.b2)
            torch._foreach_add_(nu, gg)
            torch._foreach_copy_(self.nu, nu)
        else:
            nu = self.nu
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        # bias corrections in float32, as optax computes them
        bc2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32) ** self.count
        denom = torch._foreach_div(nu, bc2.item())
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        if self.mu is None:
            updates = torch._foreach_div(grads, denom)
        else:
            torch._foreach_mul_(self.mu, self.b1)
            torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
            bc1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** self.count
            updates = torch._foreach_div(self.mu, bc1.item())
            torch._foreach_div_(updates, denom)
        if self.weight_decay:
            torch._foreach_add_(updates, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, updates, alpha=-lr)

    def _global_norm(self, grads: list) -> torch.Tensor:
        norms = torch.stack(torch._foreach_norm(grads))
        if self.model_group is None:
            return torch.linalg.vector_norm(norms)
        sq = norms * norms
        split = torch.tensor(self.sharded, device=sq.device)
        blocks = torch.where(split, sq, torch.zeros_like(sq)).sum()
        dist.all_reduce(blocks, group=self.model_group)
        return torch.sqrt(torch.where(split, torch.zeros_like(sq), sq).sum() + blocks)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
