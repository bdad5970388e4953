"""Data-parallel processes over ``torch.distributed`` (the port of the
``data`` axis of ``isubgvqa_tpu/parallel/mesh.py``).

The JAX package shards each batch over the ``data`` axis of a device mesh
and lets XLA insert the collectives.  Here each process (one rank, one
card) holds its share of the global batch, ``world_size x batch_size``
samples, and the collectives are explicit:

* :func:`init_distributed` joins the process group that ``torchrun``
  describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``):
  NCCL for a CUDA device, Gloo otherwise, with an explicit timeout.
  Without that environment it does nothing and every helper below is
  the identity of one process;
* :func:`all_reduce_sum` is a sum over the ranks that autograd
  differentiates (its backward sums the gradients over the ranks too):
  the masked BatchNorm's statistics and the train step's loss count
  run through it;
* :func:`data_shard` and :func:`shard_draw`: inside a train step every
  rank draws the global batch's noise from the step's generator and
  keeps its own rows, so an ``N``-rank step equals one step of one
  process on the ranks' batches concatenated in rank order.

The mesh's ``model`` axis (``tp_spec``, tensor parallelism) has no
counterpart: ``model_parallel > 1`` is refused by the CLI.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

_shard = (0, 1)              # (rank, world size) of the draws in a step


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0 (``utils/misc.py:380-382``): the one that prints and
    writes checkpoints."""
    return rank() == 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def device_for_rank() -> torch.device:
    """``cuda:LOCAL_RANK``: the card of this process on its host."""
    return torch.device("cuda", local_rank())


def init_distributed(device=None, timeout: datetime.timedelta =
                     DEFAULT_TIMEOUT, init_method: Optional[str] = None
                     ) -> bool:
    """Join the process group that ``RANK`` and ``WORLD_SIZE`` describe
    (``torchrun`` sets them, with ``LOCAL_RANK`` and ``MASTER_ADDR`` /
    ``MASTER_PORT``); returns whether a group is up.  No such
    environment: nothing happens (one process).  ``device`` picks the
    backend (NCCL for CUDA, Gloo otherwise; default: the card when there
    is one; with none, it raises as ``resolve_device`` does rather than
    join Gloo on the CPU unasked) and, for CUDA, becomes this process's
    current card.  ``init_method`` replaces ``env://`` (``file://<path>``
    for a group that needs no port)."""
    if is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if device is None:
        from ..models.build import resolve_device   # (a cycle at import)

        resolve_device()               # raises without a card
        device = device_for_rank()
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        if device.index is None:
            device = device_for_rank()
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=init_method or "env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]), timeout=timeout)
    return True


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (no autograd); returns ``t``."""
    if is_initialized():
        dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, differentiable: each rank's loss reads the
    global sum, so the gradient of a rank's partial sum is the sum over
    the ranks of their losses' gradients of the global sum."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, with the gradient summed over them in
    the backward; ``t`` itself in one process."""
    return _AllReduceSum.apply(t) if is_initialized() else t


@contextlib.contextmanager
def data_shard(shard_rank: int, shards: int):
    """Draws inside the block (:func:`shard_draw`) are the rows of rank
    ``shard_rank`` of a global batch of ``shards`` equal shares."""
    global _shard
    saved, _shard = _shard, (shard_rank, shards)
    try:
        yield
    finally:
        _shard = saved


def shard_draw(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int],
               axis: int = 0) -> torch.Tensor:
    """``draw(shape)`` for this rank's rows on ``axis`` (the batch axis)
    of ``shape``: inside :func:`data_shard` the global shape is drawn
    and this rank's ``shape[axis]`` rows are kept."""
    shard_rank, shards = _shard
    shape = tuple(int(s) for s in shape)
    if shards == 1:
        return draw(shape)
    full = list(shape)
    full[axis] *= shards
    return draw(tuple(full)).narrow(axis, shard_rank * shape[axis],
                                    shape[axis])
