"""Columnar graph store and the ctypes binding of the native collate fill
(the port of ``isubgvqa_tpu/native/collate.py``).

:class:`PackedGraphStore` keeps every distinct
:class:`~isubgvqa_tpu_torch.data.scene_graph.GraphArrays` (cached per
image by the scene-graph store, so object identity is a stable key) in
capacity-doubling contiguous arrays: node tokens and boxes ``[total_nodes,
4]``, the edge columns ``[total_edges]``, ``int64`` offsets.  The C++ fill
(``csrc/collate.cpp``) then assembles a dense batch with straight
``memcpy``s, and the ctypes call releases the GIL, so a prefetch
thread's collation overlaps the main thread's Python work.

The outputs are CPU tensors whose memory the fill writes through a raw
pointer; ``.numpy()`` views them without a copy.  A store made with
``pin_memory=True`` allocates them in pinned host memory from PyTorch's
caching host allocator, so a ``non_blocking`` copy to the card needs no
staging copy, and the allocator, which owns each buffer, keeps it from
reuse until the copy that reads it has finished.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from .build import build_and_load, native_disabled

_I64 = ctypes.c_int64
_P = ctypes.c_void_p

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load_collate_lib() -> Optional[ctypes.CDLL]:
    """Build and load the collate fill once per process (thread-safe);
    ``None`` under ``ISUBGVQA_NATIVE=0``.  A failed build raises
    (:class:`~.build.NativeBuildError`)."""
    global _lib
    if native_disabled():
        return None
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = build_and_load("collate")
                lib.isubgvqa_collate_fill.restype = None
                lib.isubgvqa_collate_fill.argtypes = (
                    [_P] * 8 + [_P, _P, _I64, _I64, _I64, _I64] + [_P] * 11)
                _lib = lib
    return _lib


def _grow(arr: np.ndarray, need: int) -> np.ndarray:
    cap = arr.shape[0]
    if need <= cap:
        return arr
    out = np.empty((max(need, cap * 2),) + arr.shape[1:], arr.dtype)
    out[:cap] = arr
    return out


class PackedGraphStore:
    """Incrementally packed graphs, keyed by ``GraphArrays`` identity.

    :meth:`rows` maps a batch's graphs to store rows, appending unknown
    graphs first; after the first epoch every graph is a dict hit.  One
    lock guards growth and lookup, so concurrent prefetch threads share
    a store.  ``pin_memory`` puts :meth:`fill_batch`'s outputs in pinned
    host memory (it needs CUDA)."""

    def __init__(self, pin_memory: bool = False):
        self.pin_memory = pin_memory
        self._lock = threading.Lock()
        self._row_of: dict = {}       # id(GraphArrays) -> row
        self._keepalive: list = []    # keeps each id() from being reused
        self.n_graphs = 0
        self.n_nodes = 0
        self.n_edges = 0
        self.node_tokens = np.empty((256, 4), np.int32)
        self.node_bbox = np.empty((256, 4), np.float32)
        self.edge_src = np.empty((1024,), np.int32)
        self.edge_dst = np.empty((1024,), np.int32)
        self.edge_token = np.empty((1024,), np.int32)
        self.edge_sign = np.empty((1024,), np.float32)
        self.node_off = np.zeros((257,), np.int64)
        self.edge_off = np.zeros((257,), np.int64)

    def _add(self, g) -> int:
        n, e = g.num_nodes, g.num_edges
        self.node_tokens = _grow(self.node_tokens, self.n_nodes + n)
        self.node_bbox = _grow(self.node_bbox, self.n_nodes + n)
        self.edge_src = _grow(self.edge_src, self.n_edges + e)
        self.edge_dst = _grow(self.edge_dst, self.n_edges + e)
        self.edge_token = _grow(self.edge_token, self.n_edges + e)
        self.edge_sign = _grow(self.edge_sign, self.n_edges + e)
        self.node_off = _grow(self.node_off, self.n_graphs + 2)
        self.edge_off = _grow(self.edge_off, self.n_graphs + 2)
        self.node_tokens[self.n_nodes:self.n_nodes + n] = g.node_tokens
        self.node_bbox[self.n_nodes:self.n_nodes + n] = g.node_bbox
        self.edge_src[self.n_edges:self.n_edges + e] = g.edge_src
        self.edge_dst[self.n_edges:self.n_edges + e] = g.edge_dst
        self.edge_token[self.n_edges:self.n_edges + e] = g.edge_token
        self.edge_sign[self.n_edges:self.n_edges + e] = g.edge_sign
        self.n_nodes += n
        self.n_edges += e
        self.n_graphs += 1
        self.node_off[self.n_graphs] = self.n_nodes
        self.edge_off[self.n_graphs] = self.n_edges
        row = self.n_graphs - 1
        self._row_of[id(g)] = row
        self._keepalive.append(g)
        return row

    def rows(self, graphs: Sequence) -> np.ndarray:
        out = np.empty(len(graphs), np.int64)
        with self._lock:
            for i, g in enumerate(graphs):
                r = self._row_of.get(id(g))
                out[i] = self._add(g) if r is None else r
        return out

    def empty(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """An uninitialised output tensor, pinned when the store pins."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.pin_memory)

    def fill_batch(self, lib: ctypes.CDLL, rows: np.ndarray,
                   labels: np.ndarray, b: int, n: int, e: int) -> tuple:
        """Run the C++ fill.  Returns the ten dense batch tensors
        (``node_mask`` and ``edge_mask`` bool) and the
        ``(truncated_nodes, truncated_edges)`` increments."""
        outs = (self.empty((b, n, 4), torch.int32),
                self.empty((b, n, 4), torch.float32),
                self.empty((b, n), torch.uint8),
                self.empty((b, e), torch.int32),
                self.empty((b, e), torch.int32),
                self.empty((b, e), torch.int32),
                self.empty((b, e), torch.float32),
                self.empty((b, e), torch.uint8),
                self.empty((b,), torch.int32),
                self.empty((b,), torch.float32))
        trunc = np.zeros((2,), np.int64)
        rows = np.ascontiguousarray(rows, np.int64)
        labels = np.ascontiguousarray(labels, np.int32)
        # the buffers are snapshotted under the lock and read outside it:
        # growth in another thread swaps in new buffers but never moves or
        # changes the data of rows already assigned, and the snapshot
        # keeps the old buffers alive, so concurrent fills overlap
        with self._lock:
            bufs = (self.node_tokens, self.node_bbox, self.edge_src,
                    self.edge_dst, self.edge_token, self.edge_sign,
                    self.node_off, self.edge_off)
        lib.isubgvqa_collate_fill(
            *(a.ctypes.data for a in bufs),
            rows.ctypes.data, labels.ctypes.data, len(rows), b, n, e,
            *(t.data_ptr() for t in outs), trunc.ctypes.data)
        (nt, nb, nm, es, ed, et, esg, em, lab, sm) = outs
        return (nt, nb, nm.view(torch.bool), es, ed, et, esg,
                em.view(torch.bool), lab, sm, int(trunc[0]), int(trunc[1]))
