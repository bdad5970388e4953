"""Train state (the port of ``isubgvqa_tpu/train/state.py``): the step,
the model with its f32 master parameters and BatchNorm buffers, the
optimizer, and with the aimle sampler one adaptive state per masked
layer.  Unlike the JAX pytree it is mutable: a step updates the model,
the optimizer and the AIMLE states in place and returns the same
state."""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch

from ..config import Config
from ..convert import load_clip_text_tables
from ..models.build import (apply_clip_text_tables, build_model,
                            make_aimle_states)
from ..models.isubgvqa import ISubGVQA
from ..sampling import AIMLEState
from .schedule import Optimizer, make_optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: ISubGVQA
    optimizer: Optimizer
    aimle_states: Optional[Dict[int, AIMLEState]] = None


def create_train_state(cfg: Config, vocab, steps_per_epoch: int,
                       device=None,
                       state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                       seed: Optional[int] = None) -> TrainState:
    """A training model (f32 masters with gradients, on ``device``: the
    card unless the caller asks for another) and its optimizer at the
    configured schedule (``cfg.lr``, warmup, decay, clip).  A fresh
    model (no ``state_dict``) starts its question encoder's token and
    position tables from the pretrained CLIP tables at
    ``cfg.clip_weights`` when that is set, as the JAX package's
    ``create_train_state`` does.  With the aimle sampler the state holds
    one fresh AIMLE state per masked layer on the model's device."""
    model = build_model(cfg, vocab, device, state_dict=state_dict, seed=seed,
                        train=True)
    if cfg.clip_weights and state_dict is None:
        apply_clip_text_tables(model, load_clip_text_tables(cfg.clip_weights))
    opt = make_optimizer(model.parameters(), cfg.lr, steps_per_epoch,
                         cfg.warmup_epochs, cfg.warmup_start_lr, cfg.lr_gamma,
                         cfg.grad_clip_norm)
    return TrainState(step=0, model=model, optimizer=opt,
                      aimle_states=make_aimle_states(
                          cfg, next(model.parameters()).device))
