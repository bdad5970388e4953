"""Training of the port: the learning-rate schedule and optimizer, the
train state and the train / eval steps (the port of
``isubgvqa_tpu/train/{schedule,state,steps}.py``).  The ``Trainer`` loop,
checkpoints, multistep and DDP are still to port (ROADMAP.md, Queue 1)."""

from .schedule import Optimizer, make_optimizer, warmup_exponential_schedule
from .state import TrainState, create_train_state
from .steps import cross_entropy_loss, make_eval_step, make_train_step

__all__ = ["Optimizer", "make_optimizer", "warmup_exponential_schedule",
           "TrainState", "create_train_state", "cross_entropy_loss",
           "make_eval_step", "make_train_step"]
