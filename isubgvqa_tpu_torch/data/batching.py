"""Dense, fixed-shape graph mini-batches as PyTorch tensors.

The port of ``isubgvqa_tpu/data/batching.py``: the same dense layout
(``[B, N_max, ...]`` nodes, ``[B, E_max, ...]`` edges with per-edge
within-graph node positions), the same truncation counts and the same
bucket routing, the same sharded and bucketed iteration, the same
multistep grouping (:func:`group_multistep`, as lists), and a
background :func:`prefetch` that copies batches to the card on a side
stream.  :class:`GraphBatch` is a dataclass of tensors with the JAX
pytree's field names, dtypes and shapes.  A :class:`Collator` given a
:class:`~isubgvqa_tpu_torch.native.PackedGraphStore` fills its batches in
C++ (``native/csrc/collate.cpp``); the Python fill stays as the oracle
and as what ``ISUBGVQA_NATIVE=0`` selects.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

import numpy as np
import torch

from .scene_graph import GraphArrays


@dataclasses.dataclass
class GraphBatch:
    """One mini-batch; every shape is static for its bucket."""

    node_tokens: torch.Tensor    # int32 [B, N, 4]
    node_bbox: torch.Tensor      # float32 [B, N, 4]
    node_mask: torch.Tensor      # bool  [B, N]
    edge_src: torch.Tensor       # int32 [B, E]
    edge_dst: torch.Tensor       # int32 [B, E]
    edge_token: torch.Tensor     # int32 [B, E]
    edge_sign: torch.Tensor      # float32 [B, E]; -1 on added symmetric edges
    edge_mask: torch.Tensor      # bool  [B, E]
    qst_tokens: torch.Tensor     # int32 [B, L]
    qst_mask: torch.Tensor       # int32 [B, L]
    labels: torch.Tensor         # int32 [B]
    sample_mask: torch.Tensor    # float32 [B]; 0 on padding samples

    @property
    def num_graphs(self) -> int:
        return self.node_tokens.shape[0]

    @property
    def max_nodes_per_graph(self) -> int:
        return self.node_tokens.shape[1]

    def _map(self, fn) -> "GraphBatch":
        return GraphBatch(**{f.name: fn(getattr(self, f.name))
                             for f in dataclasses.fields(self)})

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "GraphBatch":
        return self._map(torch.Tensor.pin_memory)

    def is_pinned(self) -> bool:
        """Whether every tensor lies in pinned host memory."""
        return all(getattr(self, f.name).is_pinned()
                   for f in dataclasses.fields(self))

    def copy_(self, other: "GraphBatch") -> "GraphBatch":
        """Copy ``other``'s tensors (same shapes) into this batch's."""
        for f in dataclasses.fields(self):
            getattr(self, f.name).copy_(getattr(other, f.name))
        return self

    def record_stream(self, stream) -> None:
        """Mark every tensor as used on ``stream`` (CUDA tensors)."""
        for f in dataclasses.fields(self):
            getattr(self, f.name).record_stream(stream)


@dataclasses.dataclass
class BatchMeta:
    """Host-side companion of a GraphBatch (ids, raw text, types)."""

    question_ids: List[str]
    image_ids: List[str]
    questions: List[str]
    qst_types: List[dict]
    num_real: int
    graphs: List[GraphArrays]


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static shape bucket for a batch size."""

    batch_size: int
    max_nodes_per_graph: int = 128
    max_edges_per_graph: int = 384
    question_len: int = 32


class Collator:
    """Samples -> dense :class:`GraphBatch` with static shapes.

    Oversized graphs are truncated to the caps; dropped nodes and edges
    are counted in ``truncated_nodes`` / ``truncated_edges``.

    Given a ``packed_store``
    (:class:`~isubgvqa_tpu_torch.native.PackedGraphStore`, as
    ``build_bucket_collators`` makes one), the per-graph loop runs in the
    native C++ fill, whose outputs lie in pinned memory when the store
    pins; the question arrays then join them there.  ``native`` says
    which fill runs.  The Python loop stays as the oracle and is what
    runs without a store or under ``ISUBGVQA_NATIVE=0``; both give the
    same batches and truncation counts."""

    def __init__(self, tokenizer, spec: BucketSpec, vocab=None,
                 packed_store=None):
        self.tokenizer = tokenizer
        self.spec = spec
        self._vocab = vocab
        self.truncated_nodes = 0
        self.truncated_edges = 0
        self._packed = packed_store
        self._native_lib = None
        if packed_store is not None:
            from ..native.collate import load_collate_lib
            self._native_lib = load_collate_lib()

    @property
    def native(self) -> bool:
        """Whether batches are filled by the native C++ fill."""
        return self._native_lib is not None

    def collate(self, samples: Sequence) -> tuple[GraphBatch, BatchMeta]:
        assert len(samples) <= self.spec.batch_size
        if self.native:
            return self._collate_native(samples)
        return self._collate_python(samples)

    def _questions_into(self, samples: Sequence, q_ids: np.ndarray,
                        q_mask: np.ndarray) -> None:
        """Tokenize the questions into ``q_ids`` / ``q_mask`` ``[B, L]``,
        padding rows past the real samples."""
        qst_tokens, qst_mask = self.tokenizer(
            [s.question for s in samples], max_len=self.spec.question_len)
        num_real = len(samples)
        q_ids[:num_real] = qst_tokens
        q_ids[num_real:] = self.tokenizer.pad_id
        q_mask[:num_real] = qst_mask
        q_mask[num_real:] = 0

    @staticmethod
    def _meta(samples: Sequence, graphs: List[GraphArrays]) -> BatchMeta:
        return BatchMeta(
            question_ids=[s.question_id for s in samples],
            image_ids=[s.image_id for s in samples],
            questions=[s.question for s in samples],
            qst_types=[s.qst_type for s in samples],
            num_real=len(samples),
            graphs=graphs,
        )

    def _collate_native(self, samples: Sequence
                        ) -> tuple[GraphBatch, BatchMeta]:
        spec, store = self.spec, self._packed
        graphs = [s.graph for s in samples]
        rows = store.rows(graphs)
        labels_in = np.asarray([s.label for s in samples], np.int32)
        (node_tokens, node_bbox, node_mask, edge_src, edge_dst, edge_token,
         edge_sign, edge_mask, labels, sample_mask, tn, te) = \
            store.fill_batch(self._native_lib, rows, labels_in,
                             spec.batch_size, spec.max_nodes_per_graph,
                             spec.max_edges_per_graph)
        self.truncated_nodes += tn
        self.truncated_edges += te
        shape = (spec.batch_size, spec.question_len)
        q_ids = store.empty(shape, torch.int32)
        q_mask = store.empty(shape, torch.int32)
        self._questions_into(samples, q_ids.numpy(), q_mask.numpy())
        batch = GraphBatch(
            node_tokens=node_tokens, node_bbox=node_bbox, node_mask=node_mask,
            edge_src=edge_src, edge_dst=edge_dst, edge_token=edge_token,
            edge_sign=edge_sign, edge_mask=edge_mask, qst_tokens=q_ids,
            qst_mask=q_mask, labels=labels, sample_mask=sample_mask)
        return batch, self._meta(samples, graphs)

    def _collate_python(self, samples: Sequence
                        ) -> tuple[GraphBatch, BatchMeta]:
        spec = self.spec
        b, n, e = (spec.batch_size, spec.max_nodes_per_graph,
                   spec.max_edges_per_graph)
        num_real = len(samples)

        node_tokens = np.ones((b, n, 4), np.int32)   # <pad> token id 1
        node_bbox = np.zeros((b, n, 4), np.float32)
        node_mask = np.zeros((b, n), bool)
        edge_src = np.zeros((b, e), np.int32)
        edge_dst = np.zeros((b, e), np.int32)
        edge_token = np.ones((b, e), np.int32)
        edge_sign = np.ones((b, e), np.float32)
        edge_mask = np.zeros((b, e), bool)
        labels = np.zeros((b,), np.int32)
        sample_mask = np.zeros((b,), np.float32)

        graphs: List[GraphArrays] = []
        for gi in range(num_real):
            g: GraphArrays = samples[gi].graph
            gn = g.num_nodes
            if gn > n:
                self.truncated_nodes += gn - n
                gn = n
            keep = (g.edge_src < gn) & (g.edge_dst < gn)
            ge = int(keep.sum())
            if ge > e:
                self.truncated_edges += ge - e
                ge = e
            sel = np.nonzero(keep)[0][:ge]
            graphs.append(g)
            node_tokens[gi, :gn] = g.node_tokens[:gn]
            node_bbox[gi, :gn] = g.node_bbox[:gn]
            node_mask[gi, :gn] = True
            edge_src[gi, :ge] = g.edge_src[sel]
            edge_dst[gi, :ge] = g.edge_dst[sel]
            edge_token[gi, :ge] = g.edge_token[sel]
            edge_sign[gi, :ge] = g.edge_sign[sel]
            edge_mask[gi, :ge] = True
            labels[gi] = samples[gi].label
            sample_mask[gi] = 1.0

        q_ids = np.empty((b, spec.question_len), np.int32)
        q_mask = np.empty((b, spec.question_len), np.int32)
        self._questions_into(samples, q_ids, q_mask)

        t = torch.from_numpy
        batch = GraphBatch(
            node_tokens=t(node_tokens), node_bbox=t(node_bbox),
            node_mask=t(node_mask), edge_src=t(edge_src),
            edge_dst=t(edge_dst), edge_token=t(edge_token),
            edge_sign=t(edge_sign), edge_mask=t(edge_mask),
            qst_tokens=t(q_ids), qst_mask=t(q_mask), labels=t(labels),
            sample_mask=t(sample_mask),
        )
        return batch, self._meta(samples, graphs)


def iterate_batches(dataset, collator: Collator, shuffle: bool = False,
                    seed: int = 0, drop_last: bool = False,
                    shard_index: int = 0, num_shards: int = 1,
                    pad_shards: bool = True
                    ) -> Iterator[tuple[GraphBatch, BatchMeta]]:
    """Fixed-shape batches with ``DistributedSampler``-like sharding (the
    JAX package's ``iterate_batches``): each process takes a strided
    slice of the (optionally shuffled) index list, wrap-padded to a
    multiple of ``num_shards`` so every process steps equally often;
    ``pad_shards=False`` partitions the dataset exactly instead."""
    b = collator.spec.batch_size
    idx = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    if num_shards > 1 and pad_shards:
        pad = (-len(idx)) % num_shards
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
    idx = idx[shard_index::num_shards]
    n_full = len(idx) // b
    for i in range(n_full):
        yield collator.collate([dataset[int(j)]
                                for j in idx[i * b:(i + 1) * b]])
    if len(idx) > n_full * b and not drop_last:
        yield collator.collate([dataset[int(j)] for j in idx[n_full * b:]])


def _norm_bucket_key(k):
    # bare int keys carry no question-length constraint: order them
    # after same-node-cap tuple keys (least specific last)
    return k if isinstance(k, tuple) else (k, float("inf"))


def route_to_buckets(dataset, collators: dict, idx=None) -> dict:
    """Route sample indices to the smallest bucket whose node, edge and
    question-length caps fit; the largest bucket is the truncating
    fallback.  Same rule as the JAX package's ``route_to_buckets``.

    The per-sample sizes (nodes, edges, question tokens) are read once
    and cached on the dataset object, keyed by the tokenizer, so an
    epoch does not re-tokenize the whole set."""
    caps = sorted(collators.keys(), key=_norm_bucket_key)
    any_qlen = any(isinstance(k, tuple) for k in caps)
    if idx is None:
        idx = range(len(dataset))
    tok = collators[caps[0]].tokenizer
    cache = getattr(dataset, "_route_size_cache", None)
    if not (cache and cache[0] is tok and cache[1] == any_qlen
            and len(cache[2]) == len(dataset)):
        sizes = np.empty((len(dataset), 3), dtype=np.int64)
        for j in range(len(dataset)):
            s = dataset[j]
            sizes[j] = (s.graph.num_nodes, s.graph.edge_src.shape[0],
                        tok.count_tokens(s.question) if any_qlen else 0)
        cache = (tok, any_qlen, sizes)
        try:
            dataset._route_size_cache = cache
        except AttributeError:           # a list, or a read-only object
            pass
    sizes = cache[2]
    per_bucket: dict = {c: [] for c in caps}
    for j in idx:
        n, e, q = (int(v) for v in sizes[int(j)])
        for key in caps:
            spec = collators[key].spec
            if (n <= spec.max_nodes_per_graph
                    and e <= spec.max_edges_per_graph
                    and (not any_qlen or q <= spec.question_len)):
                per_bucket[key].append(int(j))
                break
        else:
            per_bucket[caps[-1]].append(int(j))
    return per_bucket


def iterate_batches_bucketed(dataset, collators: dict, shuffle: bool = False,
                             seed: int = 0, drop_last: bool = False,
                             shard_index: int = 0, num_shards: int = 1,
                             pad_shards: bool = True,
                             group_by_bucket: bool = False
                             ) -> Iterator[tuple[GraphBatch, BatchMeta]]:
    """Size-bucketed iteration (the JAX package's
    ``iterate_batches_bucketed``): samples go to the smallest bucket that
    fits them; each bucket's batches form rounds of ``num_shards``
    same-shape chunks (the chunk list wrap-padded to a multiple of
    ``num_shards`` unless ``pad_shards=False``), and process
    ``shard_index`` collates its chunk of every round, so all processes
    see the same shape sequence.  Rounds come grouped by bucket in
    ascending order, shuffled under ``shuffle`` unless
    ``group_by_bucket`` (which then only shuffles batch composition)."""
    caps = sorted(collators.keys(), key=_norm_bucket_key)
    idx = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    per_bucket = route_to_buckets(dataset, collators, idx)
    rounds = []
    for cap in caps:
        b = collators[cap].spec.batch_size
        members = per_bucket[cap]
        n_full = len(members) // b
        chunks = [members[i * b:(i + 1) * b] for i in range(n_full)]
        if len(members) > n_full * b and not drop_last:
            chunks.append(members[n_full * b:])
        if not chunks:
            continue
        if pad_shards:
            pad = (-len(chunks)) % num_shards
            chunks += [chunks[i % len(chunks)] for i in range(pad)]  # wrap
        for i in range(0, len(chunks), num_shards):
            rounds.append((cap, chunks[i:i + num_shards]))
    if shuffle and not group_by_bucket:
        np.random.default_rng(seed + 1).shuffle(rounds)
    for cap, group in rounds:
        if shard_index < len(group):
            yield collators[cap].collate(
                [dataset[t] for t in group[shard_index]])


def group_multistep(iterator: Iterator, k: int) -> Iterator:
    """Group consecutive same-shape ``(batch, meta)`` pairs into groups of
    ``k`` train steps (the JAX package's ``group_multistep``: the same
    shape key, the same rule and the same order).

    Yields ``("multi", [batch, ...], metas)`` once ``k`` batches of one
    shape have accumulated, and at the end of the stream flushes what is
    left of each shape, in first-seen order, as ``("single", batch,
    meta)`` items.  Unlike the JAX package the group is a list, not a
    stacked array, which
    :func:`~isubgvqa_tpu_torch.train.steps.make_multistep_train_step`
    takes as it is.  ``k <= 1`` yields every pair as a single."""
    if k <= 1:
        for batch, meta in iterator:
            yield ("single", batch, meta)
        return

    def shape_key(b: GraphBatch):
        return (tuple(b.node_tokens.shape), tuple(b.edge_src.shape),
                tuple(b.qst_tokens.shape))

    pending: dict = {}
    order: list = []                      # flush in first-seen order
    for batch, meta in iterator:
        key = shape_key(batch)
        if key not in pending:
            pending[key] = []
            order.append(key)
        pending[key].append((batch, meta))
        if len(pending[key]) == k:
            group = pending.pop(key)
            order.remove(key)
            yield ("multi", [b for b, _ in group], tuple(m for _, m in group))
    for key in order:
        for batch, meta in pending[key]:
            yield ("single", batch, meta)


def prefetch(iterator: Iterator, depth: int = 2, device=None) -> Iterator:
    """Run ``iterator`` in a background thread with up to ``depth`` items
    ready in a bounded queue (the JAX package's ``prefetch``): the host
    collates the next batch while the device runs the current one.  The
    producer's exception re-raises at the consumer; when the consumer
    stops early (``break``, an exception, ``close()``), the producer
    stops too.

    ``device``: ``None`` yields the items as they are; a callable places
    each item in the producer thread; a CUDA device copies each item's
    :class:`GraphBatch` (the item itself, or the first of a ``(batch,
    meta)`` pair) from pinned host memory with ``non_blocking`` copies on
    a side stream (a batch the native fill put in pinned memory is copied
    from there; any other is first copied into pinned memory).  Before
    the consumer gets a copied batch, its current stream waits on the
    copy's event, and every tensor of the batch is recorded on that
    stream, so the allocator does not hand the memory to a later copy
    while the consumer's work may still read it.  Any other device takes
    a plain ``.to(device)``.
    """
    import queue
    import threading

    cuda = (device is not None and not callable(device)
            and torch.device(device).type == "cuda")
    if cuda:
        dev = torch.device(device)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        side = torch.cuda.Stream(device=dev)

    def split(item):
        if isinstance(item, tuple) and len(item) == 2:
            return item[0], item[1], True
        return item, None, False

    def place(item):
        if device is None:
            return item, None
        if callable(device):
            return device(item), None
        batch, meta, pair = split(item)
        event = None
        if cuda:
            host = batch if batch.is_pinned() else batch.pin_memory()
            with torch.cuda.device(dev), torch.cuda.stream(side):
                batch = host.to(dev, non_blocking=True)
                event = torch.cuda.Event()
                event.record(side)
        else:
            batch = batch.to(device)
        return ((batch, meta) if pair else batch), event

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def guarded_put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not guarded_put(place(item)):
                    return
            guarded_put(end)
        except BaseException as exc:        # noqa: BLE001 — re-raised
            guarded_put(exc)

    thread = threading.Thread(target=producer, daemon=True, name="prefetch")
    thread.start()
    try:
        while True:
            got = q.get()
            if got is end:
                return
            if isinstance(got, BaseException):
                raise got
            item, event = got
            if event is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(event)
                split(item)[0].record_stream(stream)
            yield item
    finally:
        stop.set()
        try:                               # unblock a parked producer
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
