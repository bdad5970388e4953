"""Learning-rate schedule and optimizer (the port of
``isubgvqa_tpu/train/schedule.py``).

Adam (b1 0.9, b2 0.999, eps 1e-8, no weight decay) under a 10-epoch
linear warmup from 1e-6 to the base rate, then a per-epoch decay by
0.98; gradients clipped to global norm 2.0 with optax's formula
(``g`` below the limit, else ``g / norm * limit``: no 1e-6 as in
``clip_grad_norm_``); a step whose gradients hold a non-finite value is
skipped whole — no update, Adam's moments and its own count untouched.
As in optax (``optax.adam(schedule)``) the schedule is driven by Adam's
own count, which a skipped step does not advance, while the train
state's step does.  ``torch.optim.Adam`` does the update: the JAX
package leaves Adam to optax and XLA, not to a kernel.
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch


def warmup_exponential_schedule(base_lr: float, steps_per_epoch: int,
                                warmup_epochs: int = 10,
                                warmup_start_lr: float = 1e-6,
                                gamma: float = 0.98) -> Callable[[int], float]:
    """Linear warmup over ``warmup_epochs`` epochs, then
    ``base_lr * gamma ** (epochs since warmup)``, stepped at epoch
    boundaries (``schedule.py:27-44``)."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        if epoch < warmup_epochs:
            frac = min(epoch / max(warmup_epochs, 1), 1.0)
            return warmup_start_lr + (base_lr - warmup_start_lr) * frac
        return base_lr * gamma ** max(epoch - warmup_epochs, 0)

    return schedule


class Optimizer:
    """Clip, non-finite skip and Adam under the schedule, over
    ``params``' ``.grad``."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float],
                 grad_clip_norm: float = 2.0):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.adam = torch.optim.Adam(self.params, lr=schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8)
        self.count = 0                # updates applied: the schedule's step
        self.notfinite_count = 0      # consecutive skipped steps

    def lr(self) -> float:
        return self.schedule(self.count)

    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' gradients; returns the
        global norm of the raw gradients (f32, on their device)."""
        grads = []
        for p in self.params:
            if p.grad is None:        # an unused parameter: a zero gradient
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        finite = bool(torch.stack([torch.isfinite(g).all()
                                   for g in grads]).all())
        if not finite:
            self.notfinite_count += 1
            return norm
        self.notfinite_count = 0
        if not bool(norm < self.grad_clip_norm):
            torch._foreach_div_(grads, norm)
            torch._foreach_mul_(grads, self.grad_clip_norm)
        for group in self.adam.param_groups:
            group["lr"] = self.lr()
        self.adam.step()
        self.count += 1
        return norm


def make_optimizer(params, base_lr: float, steps_per_epoch: int,
                   warmup_epochs: int = 10, warmup_start_lr: float = 1e-6,
                   gamma: float = 0.98,
                   grad_clip_norm: float = 2.0) -> Optimizer:
    """Adam + warmup/decay + clip 2.0 + skip on non-finite
    (``schedule.py:92-116``; the port has no flat/tensor-parallel
    variants)."""
    sched = warmup_exponential_schedule(base_lr, steps_per_epoch,
                                        warmup_epochs, warmup_start_lr, gamma)
    return Optimizer(params, sched, grad_clip_norm)
