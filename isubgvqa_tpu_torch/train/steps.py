"""Train and eval steps (the port of ``isubgvqa_tpu/train/steps.py``).

One training step: forward with ``train=True`` (dropout, the gumbel
sampler's train branch, BatchNorm on batch statistics), cross-entropy
over the real samples, backward, then the optimizer's clip / skip /
Adam.  Padding samples carry ``sample_mask == 0`` and add neither loss
nor metrics.  Every random draw of a step comes from one
``torch.Generator`` seeded from ``cfg.seed`` and the step (the JAX
package folds the step into its key, ``steps.py:82``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import Config
from ..data.batching import GraphBatch
from ..models.isubgvqa import ISubGVQA
from .schedule import Optimizer
from .state import TrainState


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       sample_mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over real samples, from an f32 log-softmax."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    mask = sample_mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _metrics(logits, labels, sample_mask, loss) -> dict:
    mask = sample_mask.float()
    correct = (logits.argmax(-1) == labels.long()).float() * mask
    count = mask.sum()
    return {"loss_sum": loss.detach() * count, "correct": correct.sum(),
            "count": count}


def step_generator(cfg: Config, step: int, device) -> torch.Generator:
    """The step's generator: ``cfg.seed`` and the step mixed into one
    64-bit seed."""
    gen = torch.Generator(device=device)
    return gen.manual_seed((cfg.seed * 1_000_003 + step) % (2 ** 63))


def make_train_step(model: ISubGVQA, optimizer: Optimizer, cfg: Config):
    """Returns ``train_step(state, batch, generator=None) -> (state,
    metrics)``; ``metrics`` holds ``loss_sum``, ``correct``, ``count`` and
    ``grad_norm`` (of the raw gradients) as tensors.  The state is
    updated in place."""
    def train_step(state: TrainState, batch: GraphBatch,
                   generator: Optional[torch.Generator] = None):
        gen = generator or step_generator(cfg, state.step,
                                          batch.node_mask.device)
        model.zero_grad(set_to_none=True)
        out = model(batch, generator=gen, train=True)
        loss = cross_entropy_loss(out.logits, batch.labels, batch.sample_mask)
        loss.backward()
        grad_norm = optimizer.step()
        state.step += 1
        metrics = _metrics(out.logits.detach(), batch.labels,
                           batch.sample_mask, loss)
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step


def make_eval_step(model: ISubGVQA, cfg: Config):
    """Returns ``eval_step(state, batch, generator=None) -> metrics``: the
    no-grad eval forward on the training model (running statistics, the
    sampler's eval branch)."""

    def eval_step(state: TrainState, batch: GraphBatch,
                  generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            out = model(batch, generator=generator, train=False)
            loss = cross_entropy_loss(out.logits, batch.labels,
                                      batch.sample_mask)
            metrics = _metrics(out.logits, batch.labels, batch.sample_mask,
                               loss)
        return metrics

    return eval_step
