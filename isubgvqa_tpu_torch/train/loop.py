"""Epoch-level training loop (the port of ``isubgvqa_tpu/train/loop.py``;
the reference's ``training/train_loop.py:14-132`` with ``train_epoch``
and ``validate_epoch``): pre-eval or evaluate-only, then per epoch
train, validate and the three-checkpoint policy, printing the JAX
package's lines.

One process on one device, or one rank of a data- and tensor-parallel
run (:mod:`~isubgvqa_tpu_torch.parallel`, launched by ``torchrun``): the
trainer splits the ranks into ``D`` data ranks of ``M =
cfg.model_parallel`` model ranks each (the JAX package's ``(data,
model)`` mesh) and cuts the two tensor-parallel tables to its model
rank's shard; each data rank takes its chunk of every round of the
sharded bucketed iterator (the ranks of a model group the same chunk),
so the global batch is ``D x cfg.batch_size`` (the JAX package's
``put_batch``), the step's sums cross the data group
(:func:`~.steps.make_train_step`), validation reduces its sums across
it, and only rank 0 prints and writes checkpoints.  Every random draw
is seeded from the config: a train step's from ``cfg.seed`` and the
state's step (:func:`~.steps.step_generator`), a validation batch's noise
from ``(cfg.seed, epoch + 1, global batch index)``, the data order from
``cfg.seed + epoch``.  So a run resumed from a checkpoint continues on
the trajectory of one that was never stopped.

With ``cfg.multistep = K > 1`` an epoch's batches go in groups of K of
one shape (:func:`~..data.batching.group_multistep`) through
:func:`~.steps.make_multistep_train_step`, one CUDA graph replay a group
on the card, and a group's metrics cross to the host in one read; what
is left of each shape at the end of the epoch takes the single step.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..data.batching import (group_multistep, iterate_batches,
                             iterate_batches_bucketed, prefetch)
from ..data.build import DataBundle
from ..models.build import resolve_device
from ..parallel.mesh import (data_rank, data_size, init_mesh,
                             is_main_process, shard_model_)
from ..serve import batch_seed
from ..utils.profiling import StepProfiler, trace
from .checkpoint import CheckpointManager
from .distributed_metrics import reduce_dict
from .metrics import AverageMeter, ProgressMeter, StepTimer
from .state import TrainState, create_train_state
from .steps import (METRIC_KEYS, make_eval_step, make_multistep_train_step,
                    make_train_step)

logger = logging.getLogger(__name__)


def refuse_uncapturable(device: torch.device, multistep: int) -> None:
    """Raise ``ValueError`` where ``multistep > 1`` cannot capture a
    step: on CUDA under a Gloo group of more than one rank, whose
    collectives run on the host, outside any CUDA graph."""
    if (multistep > 1 and torch.device(device).type == "cuda"
            and dist.is_initialized() and dist.get_world_size() > 1
            and dist.get_backend() == "gloo"):
        raise ValueError(
            f"multistep {multistep} on CUDA captures {multistep} steps in "
            f"one CUDA graph, and Gloo's collectives run on the host, "
            f"where no graph can hold them: use NCCL or multistep 1")


class Trainer:
    def __init__(self, cfg: Config, data: DataBundle,
                 state: Optional[TrainState] = None, device=None,
                 shard_index: Optional[int] = None,
                 num_shards: Optional[int] = None):
        """``state`` defaults to a fresh :func:`create_train_state` on
        ``device`` (the card unless the caller asks for another); its
        tensor-parallel tables are cut to this rank's shard (a no-op at
        ``cfg.model_parallel = 1``).  ``shard_index`` / ``num_shards``
        pick this trainer's share of every split, by default this
        process's data rank and the data group's size (0 and 1 without
        a process group)."""
        self.cfg = cfg
        self.data = data
        init_mesh(cfg.model_parallel)
        self.shard_index = data_rank() if shard_index is None else shard_index
        self.num_shards = data_size() if num_shards is None else num_shards
        self.main = is_main_process()
        # the schedule's epoch length (loop.py:50-51)
        steps_per_epoch = max(
            len(data.datasets["train"]) // max(cfg.batch_size, 1), 1)
        if state is None:
            state = create_train_state(cfg, data.vocab, steps_per_epoch,
                                       device=resolve_device(device))
        shard_model_(state.model)
        self.state = state
        self.device = next(state.model.parameters()).device
        self.train_step = make_train_step(state.model, state.optimizer, cfg)
        self.eval_step = make_eval_step(state.model, cfg)
        self.multistep = max(int(cfg.multistep or 1), 1)
        self.multi_step = None
        if self.multistep > 1:
            refuse_uncapturable(self.device, self.multistep)
            self.multi_step = make_multistep_train_step(
                state.model, state.optimizer, cfg)
        self.ckpt = CheckpointManager(cfg.output_dir)
        self.val_totals: dict = {}

    # ------------------------------------------------------------ epochs

    def _iter_split(self, split: str, shuffle: bool, seed: int,
                    drop_last: bool, pad_shards: bool = True):
        """``(batch, meta)`` pairs of a split on the trainer's device:
        size-bucketed when the bundle has more than one bucket for it,
        else fixed-shape; this trainer's shard; collated on a thread two
        batches ahead (:func:`prefetch`)."""
        ds = self.data.datasets[split]
        buckets = self.data.bucket_collators.get(split)
        if buckets and len(buckets) > 1:
            it = iterate_batches_bucketed(
                ds, buckets, shuffle=shuffle, seed=seed,
                drop_last=drop_last, shard_index=self.shard_index,
                num_shards=self.num_shards, pad_shards=pad_shards)
        else:
            it = iterate_batches(
                ds, self.data.collators[split], shuffle=shuffle, seed=seed,
                drop_last=drop_last, shard_index=self.shard_index,
                num_shards=self.num_shards, pad_shards=pad_shards)
        return prefetch(it, depth=2, device=self.device)

    def train_epoch(self, epoch: int) -> float:
        cfg = self.cfg
        ds = self.data.datasets["train"]
        batches = group_multistep(
            self._iter_split("train", shuffle=True, seed=cfg.seed + epoch,
                             drop_last=True), self.multistep)
        # an estimate where the bucketed iterator drops each bucket's
        # tail: the meter shows "~N", the last display the exact count
        n_batches = len(ds) // self.num_shards // cfg.batch_size

        batch_time = AverageMeter("Time", ":4.2f")
        data_time = AverageMeter("Data", ":4.2f")
        losses = AverageMeter("Loss", ":.2e")
        grad_norm = AverageMeter("GradNorm", ":4.2f")
        ans_short = AverageMeter("Acc@Short-MGat", ":4.2f")
        buckets = self.data.bucket_collators.get("train")
        bucketed = bool(buckets and len(buckets) > 1)
        progress = ProgressMeter(
            n_batches, [batch_time, data_time, losses, grad_norm, ans_short],
            prefix=f"Epoch: [{epoch}]", estimate=bucketed)
        timer = StepTimer()
        profiler = StepProfiler(enabled=bool(cfg.profile_dir),
                                device=self.device)

        steps = 0
        shown = -1                       # display on the first step
        for tag, batch, meta in batches:
            data_time.update(timer.lap())
            if tag == "multi":
                self.state, m = self.multi_step(self.state, batch)
            else:
                self.state, m = self.train_step(self.state, batch)
                m = {k: v[None] for k, v in m.items()}
            # the steps' four metrics cross to the host in one read
            per_step = torch.stack([m[k].float() for k in METRIC_KEYS],
                                   1).tolist()
            t = timer.lap()
            for loss_sum, correct, count, norm in per_step:
                count = max(count, 1.0)
                loss = loss_sum / count
                acc = correct / count * 100.0
                if np.isfinite(loss):                 # train_epoch.py:123-126
                    losses.update(loss, count)
                else:
                    logger.info("loss is %s", loss)
                grad_norm.update(norm)
                ans_short.update(acc, count)
            batch_time.update(t / len(per_step), len(per_step))
            profiler.step()
            steps += len(per_step)
            if self.main and steps // cfg.print_freq > shown:
                progress.display(steps - 1)
                shown = steps // cfg.print_freq
        if self.main:
            progress.display(steps)
        if profiler.enabled and self.main:
            logger.info("step profile epoch %d: %s", epoch,
                        profiler.summary())
        return losses.avg

    def validate_epoch(self, epoch: int, split: str = "dev"):
        """The eval forward over the split (this trainer's shard; shards
        partition it exactly), under ``torch.no_grad()``: caches built under
        ``torch.inference_mode()`` would break the next backward.  Each
        batch's noise comes from a generator seeded from ``(cfg.seed,
        epoch + 1, global batch index)``, the index over every rank's
        batches.  The sums stay on the device and cross to the host once,
        reduced across the ranks; they are kept in ``val_totals``.
        Returns ``(accuracy in %, mean loss)``."""
        cfg = self.cfg
        sums = torch.zeros(3, dtype=torch.float64, device=self.device)
        batches = self._iter_split(split, shuffle=False, seed=cfg.seed,
                                   drop_last=False, pad_shards=False)
        for b_idx, (batch, meta) in enumerate(batches):
            gen = torch.Generator(device=self.device).manual_seed(
                batch_seed(cfg.seed, epoch + 1,
                           b_idx * self.num_shards + self.shard_index))
            m = self.eval_step(self.state, batch, gen)
            sums += torch.stack([m["loss_sum"], m["correct"],
                                 m["count"]]).double()
        loss_sum, correct, count = sums.tolist()
        totals = reduce_dict({"loss_sum": loss_sum, "correct": correct,
                              "count": count}, average=False)
        self.val_totals = totals
        count = max(totals["count"], 1.0)
        acc = totals["correct"] / count * 100.0
        loss = totals["loss_sum"] / count
        if self.main:
            msg = (f"Val epoch [{epoch}] {split}: Acc@Short {acc:4.2f} "
                   f"Loss {loss:.2e}")
            print(msg, flush=True)
            logger.info(msg)
        return acc, loss

    # ------------------------------------------------------------ run

    def fit(self) -> float:
        """``train_loop.py:40-132``.  With ``cfg.profile_dir`` set, the
        run is traced by ``torch.profiler`` there and each epoch logs a
        summary of its step times and peak device memory."""
        cfg = self.cfg
        if cfg.evaluate or cfg.pre_eval:
            self.validate_epoch(-1)
            if cfg.evaluate:
                return 0.0
        top_accuracy = 0.0
        loss_lowest = float(sys.maxsize)
        with trace(cfg.profile_dir or None):
            for epoch in range(cfg.start_epoch, cfg.epochs):
                self.train_epoch(epoch)
                val_acc, val_loss = self.validate_epoch(epoch)
                loss_lowest, top_accuracy = self.ckpt.save_policy(
                    self.state, epoch, cfg, val_loss, val_acc,
                    loss_lowest, top_accuracy)
                if self.main:
                    print(f"Top validation accuracy so far was "
                          f"{top_accuracy}", flush=True)
        return top_accuracy

    def resume(self, path: str, model_only: bool = False):
        """``main.py:124-139``: load a checkpoint into the state in place
        (model-only when evaluating, ``main.py:131``), each
        tensor-parallel table's shard cut from the full one in the file;
        returns ``(next start epoch, checkpointed config)``."""
        return self.ckpt.restore(path, self.state, model_only=model_only)
