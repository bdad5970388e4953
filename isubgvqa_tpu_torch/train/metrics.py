"""Host-side meters and accuracy (the port's own copy of
``isubgvqa_tpu/train/metrics.py``, which mirrors the reference's
``utils/avg_meter.py``, ``utils/progress_meter.py`` and
``utils/accuracies.py``).  The lines they print are the JAX package's,
character for character."""

from __future__ import annotations

import logging
import time
from typing import Sequence

import numpy as np

logger = logging.getLogger(__name__)


def accuracy_topk(logits: np.ndarray, labels: np.ndarray,
                  topk: Sequence[int] = (1,),
                  sample_mask: np.ndarray | None = None) -> list[float]:
    """Top-k accuracy in percent (``utils/accuracies.py:4-18``)."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    maxk = max(topk)
    idx = np.argsort(-logits, axis=-1)[:, :maxk]
    correct = idx == labels[:, None]
    if sample_mask is not None:
        correct = correct & (np.asarray(sample_mask)[:, None] > 0)
        denom = max(float(np.sum(sample_mask)), 1.0)
    else:
        denom = float(len(labels))
    return [float(correct[:, :k].any(axis=1).sum()) * 100.0 / denom
            for k in topk]


class AverageMeter:
    """``utils/avg_meter.py:1-23``."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val: float, n: float = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1e-12)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    """``utils/progress_meter.py:6-26``."""

    def __init__(self, num_batches: int, meters: Sequence[AverageMeter],
                 prefix: str = "", estimate: bool = False):
        """``estimate`` marks ``num_batches`` as approximate (the
        bucketed iterator drops each bucket's tail and multi-host
        rounds are wrap-padded, so the exact count is only known after
        the epoch): the total renders as ``~N``."""
        num_digits = len(str(num_batches // 1))
        total = ("~" if estimate else "") + str(num_batches)
        self.batch_fmtstr = "[{:" + str(num_digits) + "d}/" + total + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        line = "\t".join(entries)
        print(line, flush=True)
        logger.info(line)


class StepTimer:
    """Wall-clock batch/data timers (``train_epoch.py:26-29``)."""

    def __init__(self):
        self.end = time.time()

    def lap(self) -> float:
        now = time.time()
        dt = now - self.end
        self.end = now
        return dt
