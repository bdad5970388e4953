"""Cross-process metric aggregation and rich logging (the port of
``isubgvqa_tpu/train/distributed_metrics.py``, the reference's
``utils/misc.py`` helpers):

* :class:`SmoothedValue`: a windowed meter (``misc.py:22-82``);
* :func:`reduce_dict`: sum or average a dict of scalars across processes
  (``misc.py:130-154``);
* :func:`all_gather_objects`: gather picklable objects
  (``misc.py:85-127``);
* :class:`MetricLogger`: an iteration logger with ETA and the device's
  peak memory (``misc.py:157-262``).

The collectives run over the data group of a data-parallel run
(:mod:`~isubgvqa_tpu_torch.parallel`), where the JAX package gathers with
``process_allgather``: the ranks of a model group hold the same samples,
so over the world each would count ``M`` times.  Without a group (or
with one data rank) each is the identity, as in the JAX package with one
process.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, List

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import data_size, group_of


def _sum_over_ranks(values) -> np.ndarray:
    """Sum a small f64 vector over the data group (on the card for
    NCCL)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor(np.asarray(values, np.float64), device=dev)
    dist.all_reduce(t, group=group_of("data")[0])
    return t.cpu().numpy()


class SmoothedValue:
    """Track a series of values with windowed smoothing
    (``misc.py:22-82``)."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """Sum count and total across processes (``misc.py:40-51``)."""
        if data_size() == 1:
            return
        count, total = _sum_over_ranks([self.count, self.total])
        self.count = int(count)
        self.total = float(total)

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return float(np.max(self.deque)) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


def reduce_dict(input_dict: Dict[str, float], average: bool = True
                ) -> Dict[str, float]:
    """Average (or sum) scalar metrics across processes
    (``misc.py:130-154``): a copy in one process."""
    if data_size() == 1:
        return dict(input_dict)
    keys = sorted(input_dict)
    summed = _sum_over_ranks([input_dict[k] for k in keys])
    if average:
        summed = summed / data_size()
    return dict(zip(keys, summed.tolist()))


def all_gather_objects(obj) -> List:
    """Gather picklable objects from all processes, in rank order
    (``misc.py:85-127``), over the data group: ``[obj]`` in one
    process."""
    group, size = group_of("data")
    if size == 1:
        return [obj]
    out: List = [None] * size
    dist.all_gather_object(out, obj, group=group)
    return out


def device_memory_stats() -> str:
    """Peak device memory for the logger line (``misc.py:240-241``):
    ``torch.cuda.max_memory_allocated()`` where there is a card, else
    ``n/a``."""
    if not torch.cuda.is_available():
        return "n/a"
    peak = torch.cuda.max_memory_allocated() or torch.cuda.memory_allocated()
    return f"{peak / (1024 ** 2):.0f}MB"


class MetricLogger:
    """``misc.py:157-262``: named SmoothedValues and ``log_every``.  As in
    the reference and the JAX package, the training loop uses
    AverageMeter / ProgressMeter instead."""

    def __init__(self, delimiter: str = "\t"):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = ""):
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                eta = (iter_time.global_avg * (total - i) if total else 0)
                eta_str = str(datetime.timedelta(seconds=int(eta)))
                print(self.delimiter.join([
                    header, f"[{i}{'/' + str(total) if total else ''}]",
                    f"eta: {eta_str}", str(self),
                    f"time: {iter_time}", f"data: {data_time}",
                    f"mem: {device_memory_stats()}",
                ]), flush=True)
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        print(f"{header} Total time: "
              f"{datetime.timedelta(seconds=int(total_time))}", flush=True)
