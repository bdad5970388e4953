"""Train and eval steps (the port of ``isubgvqa_tpu/train/steps.py``).

One training step: forward with ``train=True`` (dropout, the sampler's
train branch, BatchNorm on batch statistics), cross-entropy over the
real samples, backward (which with the aimle sampler also updates the
state's AIMLE states in place: the JAX package reads them from the state
input's cotangent, ``steps.py:84-101``), then the optimizer's clip /
skip / Adam.  Padding samples carry ``sample_mask == 0`` and add neither loss
nor metrics.  Every random draw of a step comes from one
``torch.Generator`` seeded from ``cfg.seed`` and the step (the JAX
package folds the step into its key, ``steps.py:82``).

In a data-parallel run (:mod:`~isubgvqa_tpu_torch.parallel`) a step is
the JAX package's step on the global batch, the data ranks' batches in
rank order: each rank draws the data group's global batch of noise and
keeps its rows (the same rows on every rank of a model group); the loss
divides the rank's summed NLL by the count of real samples over the data
group; the gradients and the step's metrics are summed over the data
group in one flat buffer before the optimizer's clip and non-finite
check, so every rank takes the same update.  Under tensor parallelism a
sharded parameter's gradient is its shard's, which the data group's
ranks hold alike, so it is summed as a shard.

:func:`make_multistep_train_step` runs K such steps as one CUDA graph
replay on the card (the JAX package's multistep ``lax.scan``), and as a
loop elsewhere.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..config import Config
from ..data.batching import GraphBatch
from .. import ops
from ..models.isubgvqa import ISubGVQA
from ..ops.gemm import forget_cached
from ..parallel.mesh import all_reduce_, data_rank, data_shard, data_size
from ..sampling.aimle import AIMLE_FIELDS
from .schedule import Optimizer
from .state import TrainState


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       sample_mask: torch.Tensor,
                       count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over real samples, from an f32 log-softmax; ``count``
    (the real samples of the global batch) replaces the batch's own."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    mask = sample_mask.float()
    total = mask.sum() if count is None else count
    return (nll * mask).sum() / torch.clamp(total, min=1.0)


def _metrics(logits, labels, sample_mask, loss, count=None) -> dict:
    mask = sample_mask.float()
    correct = (logits.argmax(-1) == labels.long()).float() * mask
    local = mask.sum()
    total = local if count is None else count
    return {"loss_sum": loss.detach() * total, "correct": correct.sum(),
            "count": local}


def _all_reduce_step(optimizer: Optimizer, metrics: dict) -> None:
    """Sum every gradient and the metrics' three sums over the data
    group, in one flat buffer, in place."""
    grads = optimizer.gradients()
    keys = ("loss_sum", "correct", "count")
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack([metrics[k].float() for k in keys])])
    all_reduce_(flat)
    sizes = [g.numel() for g in grads] + [len(keys)]
    for g, part in zip(grads, flat.split(sizes)):
        g.copy_(part.view_as(g))
    for k, v in zip(keys, flat[-len(keys):]):
        metrics[k] = v


def step_seed(cfg: Config, step: int) -> int:
    """``cfg.seed`` and the step mixed into one 64-bit seed."""
    return (cfg.seed * 1_000_003 + step) % (2 ** 63)


def step_generator(cfg: Config, step: int, device) -> torch.Generator:
    """The step's generator, seeded with :func:`step_seed`."""
    return torch.Generator(device=device).manual_seed(step_seed(cfg, step))


def make_train_step(model: ISubGVQA, optimizer: Optimizer, cfg: Config):
    """Returns ``train_step(state, batch, generator=None) -> (state,
    metrics)``; ``metrics`` holds ``loss_sum``, ``correct``, ``count`` and
    ``grad_norm`` (of the raw gradients) as tensors, over the global batch
    in a data-parallel run.  The state is updated in place."""
    def train_step(state: TrainState, batch: GraphBatch,
                   generator: Optional[torch.Generator] = None):
        gen = generator or step_generator(cfg, state.step,
                                          batch.node_mask.device)
        model.zero_grad(set_to_none=True)
        ddp = data_size() > 1
        with data_shard(data_rank(), data_size()):
            out = model(batch, generator=gen, train=True,
                        aimle_states=state.aimle_states)
        count = (all_reduce_(batch.sample_mask.float().sum()) if ddp
                 else None)
        loss = cross_entropy_loss(out.logits, batch.labels,
                                  batch.sample_mask, count)
        loss.backward()
        metrics = _metrics(out.logits.detach(), batch.labels,
                           batch.sample_mask, loss, count)
        if ddp:
            _all_reduce_step(optimizer, metrics)
        metrics["grad_norm"] = optimizer.step()
        state.step += 1
        return state, metrics

    return train_step


METRIC_KEYS = ("loss_sum", "correct", "count", "grad_norm")


def _stacked(rows: torch.Tensor) -> dict:
    """``[K, 4]`` rows of the step metrics -> ``{key: [K]}``."""
    return {k: rows[:, i] for i, k in enumerate(METRIC_KEYS)}


def _metric_row(m: dict) -> torch.Tensor:
    return torch.stack([m[k].float() for k in METRIC_KEYS])


def _shape_key(batch: GraphBatch) -> tuple:
    return tuple(tuple(getattr(batch, f.name).shape)
                 for f in dataclasses.fields(batch))


def _state_tensors(state: TrainState, optimizer: Optimizer) -> list:
    """Every tensor a step updates in place: the weights, the BatchNorm
    buffers, Adam's moments, the two counts and the AIMLE states."""
    ts = list(state.model.parameters()) + list(state.model.buffers())
    for p in optimizer.params:
        st = optimizer.adam.state[p]
        ts += [st["exp_avg"], st["exp_avg_sq"]]
    ts += [optimizer.count, optimizer.notfinite_count]
    for st in (state.aimle_states or {}).values():
        ts += [getattr(st, f) for f in AIMLE_FIELDS]
    return ts


@dataclasses.dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    inputs: list                 # K static GraphBatch
    metrics: torch.Tensor        # [K, 4], written by each replay
    launches: dict               # the kernel launches of one replay


def make_multistep_train_step(model: ISubGVQA, optimizer: Optimizer,
                              cfg: Config):
    """Returns ``multi_step(state, batches, generators=None) -> (state,
    metrics)``: ``K = len(batches)`` full optimizer updates (the port of
    the JAX package's ``make_multistep_train_step``, a ``lax.scan`` of
    the step), with ``metrics`` stacked ``[K]`` per key.  The trajectory
    is that of K :func:`make_train_step` calls: inner step ``j`` draws
    from :func:`step_generator` at ``state.step + j`` (or from
    ``generators[j]``).

    On a CUDA device the K steps (forward, backward, clip, Adam and the
    metrics) are one ``torch.cuda.CUDAGraph`` for each batch shape and K,
    and a group is one replay: the batches are copied into the graph's
    static inputs, K registered CUDA generators are seeded on the host,
    and the graph is launched.  The first group of a shape captures it,
    after one warm-up step on a side stream (it builds the kernels, their
    counters and attributes and Adam's state) whose updates are undone;
    the graphs share one memory pool.  A replay bumps no tensor's
    version, so the weights' memos (:func:`~..ops.gemm.cached`) are
    dropped after it, and the wrappers' launch counts gain what the
    capture recorded (:func:`~..ops.add_launch_counts`).  With
    ``generators`` the replay starts from their states without advancing
    them.  Collectives of a data- or tensor-parallel step are captured
    with it: NCCL's can be, Gloo's run on the host and cannot (the
    Trainer refuses that pairing).

    On any other device the K steps run one after another: the plain
    version, against which the graph is held."""
    single = make_train_step(model, optimizer, cfg)
    graphs: dict = {}
    shared: dict = {"pool": None, "generators": []}

    def loop(state, batches, generators):
        rows = []
        for j, b in enumerate(batches):
            state, m = single(state, b,
                              None if generators is None else generators[j])
            rows.append(_metric_row(m))
        return state, _stacked(torch.stack(rows))

    def capture(state, batches) -> _Captured:
        k, dev = len(batches), batches[0].node_mask.device
        gens = shared["generators"]
        while len(gens) < k:
            gens.append(torch.Generator(device=dev))
        optimizer.init_state()
        current = torch.cuda.current_stream(dev)
        step0 = state.step
        saved = [t.detach().clone() for t in _state_tensors(state, optimizer)]
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            single(state, batches[0], step_generator(cfg, step0, dev))
        current.wait_stream(side)
        with torch.no_grad():
            torch._foreach_copy_(_state_tensors(state, optimizer), saved)
        state.step = step0
        del saved
        inputs = [b._map(torch.clone) for b in batches]
        metrics = torch.zeros(k, len(METRIC_KEYS), device=dev)
        graph = torch.cuda.CUDAGraph()
        for g in gens[:k]:
            graph.register_generator_state(g)
        before = ops.launch_counts()
        try:
            # thread_local: the prefetch thread goes on copying batches
            with torch.cuda.graph(graph, pool=shared["pool"],
                                  capture_error_mode="thread_local"):
                for j in range(k):
                    state, m = single(state, inputs[j], gens[j])
                    metrics[j].copy_(_metric_row(m))
        finally:
            state.step = step0
        shared["pool"] = graph.pool()
        after = ops.launch_counts()
        launches = {n: after[n] - before[n] for n in after}
        ops.add_launch_counts(launches, -1)     # recorded, not launched
        return _Captured(graph, inputs, metrics, launches)

    def multi_step(state: TrainState, batches, generators=None):
        batches = list(batches)
        if batches[0].node_mask.device.type != "cuda":
            return loop(state, batches, generators)
        key = (_shape_key(batches[0]), len(batches))
        if key not in graphs:
            graphs[key] = capture(state, batches)
        group = graphs[key]
        for static, b in zip(group.inputs, batches):
            static.copy_(b)
        for j, g in enumerate(shared["generators"][:len(batches)]):
            if generators is None:
                g.manual_seed(step_seed(cfg, state.step + j))
            else:
                g.set_state(generators[j].get_state())
        group.graph.replay()
        state.step += len(batches)
        forget_cached(model.parameters())
        ops.add_launch_counts(group.launches)
        return state, _stacked(group.metrics.clone())

    multi_step.graphs = graphs
    return multi_step


def make_eval_step(model: ISubGVQA, cfg: Config, return_output: bool = False):
    """Returns ``eval_step(state, batch, generator=None) -> metrics`` (or
    ``(metrics, ModelOutput)`` with ``return_output``): the no-grad eval
    forward on the training model (running statistics, the sampler's eval
    branch)."""

    def eval_step(state: TrainState, batch: GraphBatch,
                  generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            out = model(batch, generator=generator, train=False,
                        aimle_states=state.aimle_states)
            loss = cross_entropy_loss(out.logits, batch.labels,
                                      batch.sample_mask)
            metrics = _metrics(out.logits, batch.labels, batch.sample_mask,
                               loss)
        if return_output:
            return metrics, out
        return metrics

    return eval_step
