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

Under tensor parallelism (the JAX package's per-leaf optimizer,
``flat=False``, with ``optax.global_norm``) a sharded parameter holds its
model rank's slice, and so do its gradient and Adam's moments: the
squared norms of the sharded leaves are summed over the model group
(each element counted once, replicated leaves once), the non-finite flag
is summed over every rank, so every rank skips or updates together, and
the clip factor is the same on every rank.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch

from ..parallel.mesh import all_reduce_, model_size, shard_dim


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
        self._shard_mask: Optional[torch.Tensor] = None

    def lr(self) -> float:
        return self.schedule(self.count)

    def gradients(self) -> List[torch.Tensor]:
        """Every parameter's ``.grad``; an unused parameter gets a zero
        gradient."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def _sharded(self, device) -> Optional[torch.Tensor]:
        """1.0 for each sharded parameter, 0.0 for the others (kept on
        the device: building it each step would be a host copy), or
        ``None`` without tensor parallelism."""
        if model_size() == 1 or all(shard_dim(p) is None
                                    for p in self.params):
            return None
        if self._shard_mask is None or self._shard_mask.device != device:
            self._shard_mask = torch.tensor(
                [float(shard_dim(p) is not None) for p in self.params],
                device=device)
        return self._shard_mask

    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' gradients; returns the
        global norm of the raw gradients (f32, on their device)."""
        grads = self.gradients()
        norms = torch.stack([torch.linalg.vector_norm(g.float())
                             for g in grads])
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        mask = self._sharded(norms.device)
        if mask is not None:
            sq = norms.square()
            split = torch.stack([(sq * mask).sum(), (sq * (1 - mask)).sum()])
            norm = torch.sqrt(all_reduce_(split[:1], "model")
                              + split[1:]).reshape(())
            bad = all_reduce_((~finite).float().reshape(1), "world")
            finite = bad[0] == 0
        else:
            norm = torch.linalg.vector_norm(norms)
        finite = bool(finite)
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
    (``schedule.py:92-116``).  One optimizer serves one process, a
    data-parallel and a tensor-parallel run: the flat and per-leaf
    layouts of the JAX package are one and the same here."""
    sched = warmup_exponential_schedule(base_lr, steps_per_epoch,
                                        warmup_epochs, warmup_start_lr, gamma)
    return Optimizer(params, sched, grad_clip_norm)
