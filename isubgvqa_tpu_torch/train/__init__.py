"""Training of the port (the port of ``isubgvqa_tpu/train/``): the
learning-rate schedule and optimizer, the train state, the train / eval
steps (one at a time, or K as one CUDA graph), the meters, the
three-checkpoint policy and the epoch loop (:class:`Trainer`), in one
process or one rank of a data- and tensor-parallel run."""

from .checkpoint import CheckpointManager
from .loop import Trainer
from .metrics import AverageMeter, ProgressMeter, accuracy_topk
from .schedule import Optimizer, make_optimizer, warmup_exponential_schedule
from .state import TrainState, create_train_state
from .steps import (cross_entropy_loss, make_eval_step,
                    make_multistep_train_step, make_train_step)

__all__ = ["Optimizer", "make_optimizer", "warmup_exponential_schedule",
           "TrainState", "create_train_state", "cross_entropy_loss",
           "make_eval_step", "make_train_step", "make_multistep_train_step",
           "AverageMeter",
           "ProgressMeter", "accuracy_topk", "CheckpointManager", "Trainer"]
