"""Train state (the port of ``isubgvqa_tpu/train/state.py``): the step,
the model with its f32 master parameters and BatchNorm buffers, and the
optimizer.  Unlike the JAX pytree it is mutable: a step updates the
model and optimizer in place and returns the same state."""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from ..config import Config
from ..models.build import build_model
from ..models.isubgvqa import ISubGVQA
from .schedule import Optimizer, make_optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: ISubGVQA
    optimizer: Optimizer


def create_train_state(cfg: Config, vocab, steps_per_epoch: int,
                       device=None,
                       state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                       seed: Optional[int] = None) -> TrainState:
    """A training model (f32 masters with gradients, on ``device``: the
    card unless the caller asks for another) and its optimizer at the
    configured schedule (``cfg.lr``, warmup, decay, clip)."""
    model = build_model(cfg, vocab, device, state_dict=state_dict, seed=seed,
                        train=True)
    opt = make_optimizer(model.parameters(), cfg.lr, steps_per_epoch,
                         cfg.warmup_epochs, cfg.warmup_start_lr, cfg.lr_gamma,
                         cfg.grad_clip_norm)
    return TrainState(step=0, model=model, optimizer=opt)
