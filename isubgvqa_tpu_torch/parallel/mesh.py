"""Data- and tensor-parallel processes over ``torch.distributed`` (the
port of ``isubgvqa_tpu/parallel/mesh.py``'s ``(data, model)`` mesh).

The JAX package shards each batch over the ``data`` axis of a device mesh,
row-shards two parameter tables over its ``model`` axis
(``TP_PARAM_RULES``) and lets XLA insert the collectives.  Here each
process (one rank) holds its share of the global batch and its shard of
the two tables, and the collectives are explicit:

* :func:`init_distributed` joins the process group that ``torchrun``
  describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``):
  by default NCCL for a CUDA device and Gloo otherwise, or the backend
  named by the caller, with an explicit timeout.  Without that
  environment it does nothing and every helper below is the identity of
  one process;
* :func:`init_mesh` splits the ``D x M`` ranks into data groups and model
  groups: ranks ``r`` with the same ``r // M`` form one model group (the
  JAX mesh's ``(data, model)`` device order), ranks with the same
  ``r % M`` one data group.  Without it the whole group is the data
  group and the model group is each rank alone;
* :func:`all_reduce_sum` is a sum over the data group that autograd
  differentiates (its backward sums the gradients over the group too):
  the masked BatchNorm's statistics and the train step's loss count run
  through it;
* :func:`reduce_from_model_region` and :func:`copy_to_model_region` are
  Megatron's two tensor-parallel regions: a sum over the model group
  whose backward is the identity, and the identity whose backward sums
  over the model group.  The sharded token embedding ends in the first;
  the sharded ``logit_fc`` starts with the second and ends with the
  first;
* :data:`TP_PARAM_RULES`, :func:`tp_dim` and :func:`shard_model_`: the two
  tables, cut along the dimension that the JAX package's rules shard,
  when it divides ``M``; :func:`gather_shard` rebuilds a full table;
* :func:`data_shard` and :func:`shard_draw`: inside a train step every
  rank draws the data group's global batch of noise from the step's
  generator and keeps its own rows, so a ``D x M`` step equals one step
  of one process on the data ranks' batches concatenated in rank order.

The collectives are ``all_reduce`` and ``broadcast`` only, which Gloo
also runs on CUDA tensors: NCCL refuses two ranks on one card, where
Gloo runs a tensor-parallel job all the same.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

_shard = (0, 1)              # (rank, world size) of the draws in a step


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the ``(data, model)`` grid and its two
    groups (``None``: a group of this rank alone, or the world)."""

    data_rank: int
    data_size: int
    model_rank: int
    model_size: int
    data_group: Optional[object]
    model_group: Optional[object]


_mesh: Optional[Mesh] = None


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
    """``cuda:LOCAL_RANK``: the card of this process on its host.  With
    more ranks than cards the ranks share them in turn (a Gloo group:
    NCCL refuses two ranks on one card)."""
    return torch.device("cuda",
                        local_rank() % max(torch.cuda.device_count(), 1))


def init_distributed(device=None, timeout: datetime.timedelta =
                     DEFAULT_TIMEOUT, init_method: Optional[str] = None,
                     backend: Optional[str] = None) -> bool:
    """Join the process group that ``RANK`` and ``WORLD_SIZE`` describe
    (``torchrun`` sets them, with ``LOCAL_RANK`` and ``MASTER_ADDR`` /
    ``MASTER_PORT``); returns whether a group is up.  No such
    environment: nothing happens (one process).  ``device`` (default:
    the card when there is one; with none, it raises as
    ``resolve_device`` does rather than join Gloo on the CPU unasked)
    becomes this process's current card when it is a CUDA device.
    ``backend`` (``nccl`` or ``gloo``) defaults to NCCL for CUDA and Gloo
    otherwise; a backend that fails raises, none is swapped in.
    ``init_method`` replaces ``env://`` (``file://<path>`` for a group
    that needs no port)."""
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
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    dist.init_process_group(
        backend or ("nccl" if cuda else "gloo"),
        init_method=init_method or "env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]), timeout=timeout)
    return True


def init_mesh(model_parallel: int = 1) -> Mesh:
    """Split the process group's ``D x M`` ranks (``M =
    model_parallel``) into data and model groups; every rank calls it,
    with the same ``M``.  A second call with the same ``M`` keeps the
    groups.  Without a process group only ``M = 1`` is possible."""
    global _mesh
    m = int(model_parallel)
    world = world_size()
    if m < 1 or world % m:
        raise ValueError(f"model_parallel={m} does not divide the "
                         f"{world} rank(s) of the process group")
    if m == 1:                 # the process group is the data group
        _mesh = None
        return _current()
    if _mesh is not None and _mesh.model_size == m:
        return _mesh
    r, d = rank(), world // m
    data_group = model_group = None
    # every rank creates every group, in the same order
    for i in range(d):
        g = dist.new_group([i * m + j for j in range(m)])
        if i == r // m:
            model_group = g
    if d > 1:
        for j in range(m):
            g = dist.new_group([i * m + j for i in range(d)])
            if j == r % m:
                data_group = g
    _mesh = Mesh(data_rank=r // m, data_size=d, model_rank=r % m,
                 model_size=m, data_group=data_group,
                 model_group=model_group)
    return _mesh


def _current() -> Mesh:
    return _mesh or Mesh(rank(), world_size(), 0, 1, None, None)


def data_rank() -> int:
    return _current().data_rank


def data_size() -> int:
    return _current().data_size


def model_rank() -> int:
    return _current().model_rank


def model_size() -> int:
    return _current().model_size


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _mesh
    _mesh = None
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def group_of(group: str):
    """``(group object, size)`` of ``"data"``, ``"model"`` or ``"world"``
    (the object ``None`` is the whole process group; a size of 1 needs no
    collective)."""
    mesh = _current()
    if group == "data":
        return (mesh.data_group if mesh.model_size > 1 else None,
                mesh.data_size)
    if group == "model":
        return mesh.model_group, mesh.model_size
    if group == "world":
        return None, world_size()
    raise ValueError(f"group {group!r}: data, model or world")


def all_reduce_(t: torch.Tensor, group: str = "data") -> torch.Tensor:
    """Sum ``t`` over ``group`` (``"data"``, ``"model"`` or ``"world"``)
    in place (no autograd); returns ``t``."""
    group, size = group_of(group)
    if size > 1:
        dist.all_reduce(t, group=group)
    return t


def _model_sum(t: torch.Tensor) -> torch.Tensor:
    out = t.clone()
    dist.all_reduce(out, group=_current().model_group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group, differentiable: each rank's loss reads the
    global sum, so the gradient of a rank's partial sum is the sum over
    the ranks of their losses' gradients of the global sum."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group: str = "data") -> torch.Tensor:
    """``t`` summed over ``group`` (default the data group), with the
    gradient summed over it in the backward; ``t`` itself in one
    process."""
    group, size = group_of(group)
    return t if size == 1 else _AllReduceSum.apply(t, group)


class _ReduceFromModelRegion(torch.autograd.Function):
    """Forward: the sum over the model group.  Backward: the identity,
    since every model rank computes the same loss from the sum (a
    backward that summed too would scale the upstream gradients by
    ``M``)."""

    @staticmethod
    def forward(ctx, t):
        return _model_sum(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _CopyToModelRegion(torch.autograd.Function):
    """Forward: the identity.  Backward: the sum over the model group of
    the ranks' gradients (each reads a part of the input)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _model_sum(g)


def reduce_from_model_region(t: torch.Tensor) -> torch.Tensor:
    return _ReduceFromModelRegion.apply(t) if model_size() > 1 else t


def copy_to_model_region(t: torch.Tensor) -> torch.Tensor:
    return _CopyToModelRegion.apply(t) if model_size() > 1 else t


# ------------------------------------------------------------- tensor
# parallelism: the JAX package's TP_PARAM_RULES on the port's names.  The
# CLIP token table [V, D] is cut into rows, as in JAX; logit_fc's weight
# is [answers, 512] here, the JAX kernel [512, answers] transposed, so
# the JAX package's rows are its columns.  logit_fc's bias stays whole.
TP_PARAM_RULES = (
    ("token_embedding.weight", 0),
    ("logit_fc.weight", 1),
)

SHARD_DIM = "model_shard_dim"      # the attribute a sharded parameter carries


def tp_dim(name: str, shape: Sequence[int]) -> Optional[int]:
    """The dimension along which parameter ``name`` of ``shape`` is cut
    over the model group, or ``None``: no rule matches, the dimension
    does not divide, or there is one model rank (``tp_spec``'s
    divisibility gate)."""
    m = model_size()
    if m <= 1:
        return None
    for suffix, dim in TP_PARAM_RULES:
        if (name == suffix or name.endswith("." + suffix)) \
                and len(shape) == 2 and shape[dim] % m == 0:
            return dim
    return None


def shard_bounds(full: int) -> tuple:
    """``(start, size)`` of this model rank's share of ``full``."""
    size = full // model_size()
    return model_rank() * size, size


def shard_of(full: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's slice of a full table, a copy."""
    start, size = shard_bounds(full.shape[dim])
    return full.narrow(dim, start, size).clone()


def shard_model_(model: torch.nn.Module) -> Dict[str, int]:
    """Cut the parameters that :func:`tp_dim` names to this model rank's
    slice, in place (the ``Parameter`` objects stay, so an optimizer
    built over them keeps them); each carries its dimension as
    ``model_shard_dim``.  Returns ``{name: dim}``; empty with one model
    rank."""
    cut = {}
    for name, p in model.named_parameters():
        if getattr(p, SHARD_DIM, None) is not None:
            continue
        dim = tp_dim(name, p.shape)
        if dim is None:
            continue
        with torch.no_grad():
            p.data = shard_of(p.data, dim)
        setattr(p, SHARD_DIM, dim)
        cut[name] = dim
    return cut


def shard_dim(p: torch.Tensor) -> Optional[int]:
    """The dimension a sharded parameter is cut along, else ``None``."""
    return getattr(p, SHARD_DIM, None)


def gather_shard(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The full table from every model rank's slice ``t`` along ``dim``:
    each rank writes its slice into a zero buffer and the buffers are
    summed over the model group (a collective: every model rank calls
    it)."""
    if model_size() == 1:
        return t
    shape = list(t.shape)
    shape[dim] *= model_size()
    full = t.new_zeros(shape)
    start, size = shard_bounds(shape[dim])
    full.narrow(dim, start, size).copy_(t)
    dist.all_reduce(full, group=_current().model_group)
    return full


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
