"""Train and eval steps (the port of ``isubgvqa_tpu/train/steps.py``).

One training step: forward with ``train=True`` (dropout, the sampler's
train branch, BatchNorm on batch statistics), cross-entropy over the
real samples, backward (which with the aimle sampler also updates the
state's AIMLE states in place: the JAX package reads them from the state
input's cotangent, ``steps.py:84-101``), then the optimizer's clip /
skip / Adam.  Padding samples carry ``sample_mask == 0`` and add neither loss
nor metrics.  Every random draw of a step comes from one
``torch.Generator`` seeded from ``cfg.seed`` and the step (the JAX
package folds the step into its key, ``steps.py:82``).

In a data-parallel run (:mod:`~isubgvqa_tpu_torch.parallel`) a step is
the JAX package's step on the global batch, the data ranks' batches in
rank order: each rank draws the data group's global batch of noise and
keeps its rows (the same rows on every rank of a model group); the loss
divides the rank's summed NLL by the count of real samples over the data
group; the gradients and the step's metrics are summed over the data
group in one flat buffer before the optimizer's clip and non-finite
check, so every rank takes the same update.  Under tensor parallelism a
sharded parameter's gradient is its shard's, which the data group's
ranks hold alike, so it is summed as a shard.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import Config
from ..data.batching import GraphBatch
from ..models.isubgvqa import ISubGVQA
from ..parallel.mesh import all_reduce_, data_rank, data_shard, data_size
from .schedule import Optimizer
from .state import TrainState


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       sample_mask: torch.Tensor,
                       count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over real samples, from an f32 log-softmax; ``count``
    (the real samples of the global batch) replaces the batch's own."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    mask = sample_mask.float()
    total = mask.sum() if count is None else count
    return (nll * mask).sum() / torch.clamp(total, min=1.0)


def _metrics(logits, labels, sample_mask, loss, count=None) -> dict:
    mask = sample_mask.float()
    correct = (logits.argmax(-1) == labels.long()).float() * mask
    local = mask.sum()
    total = local if count is None else count
    return {"loss_sum": loss.detach() * total, "correct": correct.sum(),
            "count": local}


def _all_reduce_step(optimizer: Optimizer, metrics: dict) -> None:
    """Sum every gradient and the metrics' three sums over the data
    group, in one flat buffer, in place."""
    grads = optimizer.gradients()
    keys = ("loss_sum", "correct", "count")
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack([metrics[k].float() for k in keys])])
    all_reduce_(flat)
    sizes = [g.numel() for g in grads] + [len(keys)]
    for g, part in zip(grads, flat.split(sizes)):
        g.copy_(part.view_as(g))
    for k, v in zip(keys, flat[-len(keys):]):
        metrics[k] = v


def step_generator(cfg: Config, step: int, device) -> torch.Generator:
    """The step's generator: ``cfg.seed`` and the step mixed into one
    64-bit seed."""
    gen = torch.Generator(device=device)
    return gen.manual_seed((cfg.seed * 1_000_003 + step) % (2 ** 63))


def make_train_step(model: ISubGVQA, optimizer: Optimizer, cfg: Config):
    """Returns ``train_step(state, batch, generator=None) -> (state,
    metrics)``; ``metrics`` holds ``loss_sum``, ``correct``, ``count`` and
    ``grad_norm`` (of the raw gradients) as tensors, over the global batch
    in a data-parallel run.  The state is updated in place."""
    def train_step(state: TrainState, batch: GraphBatch,
                   generator: Optional[torch.Generator] = None):
        gen = generator or step_generator(cfg, state.step,
                                          batch.node_mask.device)
        model.zero_grad(set_to_none=True)
        ddp = data_size() > 1
        with data_shard(data_rank(), data_size()):
            out = model(batch, generator=gen, train=True,
                        aimle_states=state.aimle_states)
        count = (all_reduce_(batch.sample_mask.float().sum()) if ddp
                 else None)
        loss = cross_entropy_loss(out.logits, batch.labels,
                                  batch.sample_mask, count)
        loss.backward()
        metrics = _metrics(out.logits.detach(), batch.labels,
                           batch.sample_mask, loss, count)
        if ddp:
            _all_reduce_step(optimizer, metrics)
        metrics["grad_norm"] = optimizer.step()
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(model: ISubGVQA, cfg: Config, return_output: bool = False):
    """Returns ``eval_step(state, batch, generator=None) -> metrics`` (or
    ``(metrics, ModelOutput)`` with ``return_output``): the no-grad eval
    forward on the training model (running statistics, the sampler's eval
    branch)."""

    def eval_step(state: TrainState, batch: GraphBatch,
                  generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            out = model(batch, generator=generator, train=False,
                        aimle_states=state.aimle_states)
            loss = cross_entropy_loss(out.logits, batch.labels,
                                      batch.sample_mask)
            metrics = _metrics(out.logits, batch.labels, batch.sample_mask,
                               loss)
        if return_output:
            return metrics, out
        return metrics

    return eval_step
