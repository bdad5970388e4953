"""Learning-rate schedule and optimizer (the port of
``isubgvqa_tpu/train/schedule.py``).

Adam (b1 0.9, b2 0.999, eps 1e-8, no weight decay) under a 10-epoch
linear warmup from 1e-6 to the base rate, then a per-epoch decay by
0.98; gradients clipped to global norm 2.0 with optax's formula
(``g`` below the limit, else ``g / norm * limit``: no 1e-6 as in
``clip_grad_norm_``); a step whose gradients hold a non-finite value is
skipped whole: no update, Adam's moments and its own count untouched.
As in optax (``optax.adam(schedule)``) the schedule is driven by Adam's
own count, which a skipped step does not advance, while the train
state's step does.

The step makes no host read, so a CUDA graph can hold it
(:func:`~.steps.make_multistep_train_step`): Adam's count, the count of
consecutive skipped steps and the learning rate are device tensors, the
clip is a select on the device, and the skip is the JAX package's
``skip_nonfinite``: the inner update (clip, then Adam) always runs, on
the gradients zeroed where the step is skipped, and the parameters, both
moments and the count are then selected against their old values on one
finiteness flag (``old * (1 - f) + new * f`` with ``f`` 0 or 1, exact
either way since both sides are finite).  The update is plain torch
``_foreach`` ops over Adam's state, in ``torch.optim.Adam``'s layout
(``step``, ``exp_avg``, ``exp_avg_sq`` a parameter; every ``step`` is
the one count tensor), so checkpoints keep their format; the JAX
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

from typing import Callable, Iterable, List, Optional, Union

import torch

from ..parallel.mesh import all_reduce_, model_size, shard_dim

BETAS = (0.9, 0.999)
EPS = 1e-8


def warmup_exponential_schedule(base_lr: float, steps_per_epoch: int,
                                warmup_epochs: int = 10,
                                warmup_start_lr: float = 1e-6,
                                gamma: float = 0.98
                                ) -> Callable[[Union[int, torch.Tensor]],
                                              torch.Tensor]:
    """Linear warmup over ``warmup_epochs`` epochs, then
    ``base_lr * gamma ** (epochs since warmup)``, stepped at epoch
    boundaries (``schedule.py:27-44``).  The schedule takes a step (an
    int or a tensor, on any device) and returns an f32 tensor beside it,
    computed as the JAX package's is, in f32 with ``where``."""

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step)
        epoch = torch.div(step, max(steps_per_epoch, 1),
                          rounding_mode="floor").to(torch.float32)
        frac = torch.clamp(epoch / max(warmup_epochs, 1), max=1.0)
        warm = warmup_start_lr + (base_lr - warmup_start_lr) * frac
        decayed = base_lr * torch.pow(
            gamma, torch.clamp(epoch - warmup_epochs, min=0.0))
        return torch.where(epoch < warmup_epochs, warm, decayed)

    return schedule


class Optimizer:
    """Clip, non-finite skip and Adam under the schedule, over
    ``params``' ``.grad``.  ``count`` (f32, Adam's count) and
    ``notfinite_count`` (int32) are 0-d tensors on the parameters'
    device, updated in place."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable, grad_clip_norm: float = 2.0):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        # the state's container and its checkpoint format; its own step()
        # is never called
        self.adam = torch.optim.Adam(self.params, lr=float(schedule(0)),
                                     betas=BETAS, eps=EPS)
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.float32, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self._shard_mask: Optional[torch.Tensor] = None

    def lr(self) -> float:
        """The next update's learning rate (a host read)."""
        return float(self.schedule(self.count))

    def gradients(self) -> List[torch.Tensor]:
        """Every parameter's ``.grad``; an unused parameter gets a zero
        gradient."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def init_state(self) -> None:
        """Adam's moments of every parameter that has none yet (zeros,
        at the parameter's current shape: a tensor-parallel table is cut
        before the first step), each ``step`` the count."""
        for p in self.params:
            st = self.adam.state[p]
            if "exp_avg" not in st:
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            st["step"] = self.count

    def load(self, adam_state: dict, count: int, notfinite_count: int):
        """Adam's ``state_dict`` and the two counts from a checkpoint,
        copied into the existing tensors where they have the same shape
        (a captured graph keeps reading them)."""
        old = {p: dict(self.adam.state[p]) for p in self.params
               if p in self.adam.state}
        self.adam.load_state_dict(adam_state)
        for p, st in old.items():
            new = self.adam.state[p]
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st and k in new and st[k].shape == new[k].shape:
                    st[k].copy_(new[k])
                    new[k] = st[k]
        self.count.fill_(int(count))
        self.notfinite_count.fill_(int(notfinite_count))
        for st in self.adam.state.values():
            if "exp_avg" in st:
                st["step"] = self.count

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

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' gradients, or skip it
        where they hold a non-finite value; returns the global norm of
        the raw gradients (f32, on their device).  No host read."""
        self.init_state()
        grads = self.gradients()
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        finite = torch.isfinite(flat).all()
        # the leaves' norms, then theirs: one f32 sum over all the
        # elements at once rounds worse
        norms = torch.stack(torch._foreach_norm(grads)).float()
        mask = self._sharded(flat.device)
        if mask is not None:
            sq = norms.square()
            split = torch.stack([(sq * mask).sum(), (sq * (1 - mask)).sum()])
            norm = torch.sqrt(all_reduce_(split[:1], "model")
                              + split[1:]).reshape(())
            bad = all_reduce_((~finite).float().reshape(1), "world")
            finite = bad[0] == 0
        else:
            norm = torch.linalg.vector_norm(norms)
        # optax's clip: g below the limit, else g / norm * limit; then
        # zeros where the step is skipped, so the update stays finite
        under = norm < self.grad_clip_norm
        one = torch.ones((), device=norm.device)
        flat = (flat / torch.where(under, one, norm)
                * torch.where(under, one, one * self.grad_clip_norm))
        flat = torch.where(finite, flat, torch.zeros((), device=flat.device))
        g = [t.view_as(p) for t, p in
             zip(flat.split([p.numel() for p in self.params]), self.params)]
        f = finite.float()
        keep = 1.0 - f
        lr = self.schedule(self.count)
        count = self.count + f
        t = torch.clamp(count, min=1.0)          # a skipped first step
        b1, b2 = BETAS
        st = [self.adam.state[p] for p in self.params]
        m = [s["exp_avg"] for s in st]
        v = [s["exp_avg_sq"] for s in st]
        # optax's scale_by_adam: mu = (1 - b1) g + b1 mu, nu likewise on
        # g^2, each selected against the old moment
        m_new = torch._foreach_mul(g, 1.0 - b1)
        torch._foreach_add_(m_new, m, alpha=b1)
        v_new = torch._foreach_mul(g, g)
        torch._foreach_mul_(v_new, 1.0 - b2)
        torch._foreach_add_(v_new, v, alpha=b2)
        for old, new in ((m, m_new), (v, v_new)):
            torch._foreach_mul_(old, keep)
            torch._foreach_mul_(new, f)
            torch._foreach_add_(old, new)
        # the bias-corrected update times -lr, zero on a skipped step
        upd = torch._foreach_div(m, 1.0 - torch.pow(b1, t))
        den = torch._foreach_div(v, 1.0 - torch.pow(b2, t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -lr * f)
        torch._foreach_add_(self.params, upd)
        self.count.copy_(count)
        self.notfinite_count.copy_(torch.where(
            finite, torch.zeros_like(self.notfinite_count),
            self.notfinite_count + 1))
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
