"""Training of the port (the port of ``isubgvqa_tpu/train/``): the
learning-rate schedule and optimizer, the train state, the train / eval
steps, the meters, the three-checkpoint policy and the epoch loop
(:class:`Trainer`), in one process.  DDP is still to port (ROADMAP.md,
Queue 1 item 13)."""

from .checkpoint import CheckpointManager
from .loop import Trainer
from .metrics import AverageMeter, ProgressMeter, accuracy_topk
from .schedule import Optimizer, make_optimizer, warmup_exponential_schedule
from .state import TrainState, create_train_state
from .steps import cross_entropy_loss, make_eval_step, make_train_step

__all__ = ["Optimizer", "make_optimizer", "warmup_exponential_schedule",
           "TrainState", "create_train_state", "cross_entropy_loss",
           "make_eval_step", "make_train_step", "AverageMeter",
           "ProgressMeter", "accuracy_topk", "CheckpointManager", "Trainer"]
