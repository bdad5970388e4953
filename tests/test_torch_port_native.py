"""The port's native C++ collate fill (``isubgvqa_tpu_torch/native/``)
bit-exact against the port's Python fill and against the JAX package's
``Collator`` (its Python fill) on the same seeded samples, truncation
counts included: nodes over the cap, edges touching cut nodes, edges
over the cap, a partial batch, and two threads filling through one
store.  ``ISUBGVQA_NATIVE=0`` selects the Python fill; a failed build
raises instead of falling back."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from isubgvqa_tpu.data.batching import BucketSpec as JBucketSpec
from isubgvqa_tpu.data.batching import Collator as JCollator
from isubgvqa_tpu.data.gqa import Sample as JSample
from isubgvqa_tpu.data.scene_graph import GraphArrays as JGraphArrays
from isubgvqa_tpu.data.tokenizer import HashWordTokenizer as JTokenizer
from isubgvqa_tpu_torch import native
from isubgvqa_tpu_torch.data import (BucketSpec, Collator, GraphArrays,
                                     HashWordTokenizer, Sample)
from isubgvqa_tpu_torch.data.build import build_bucket_collators
from isubgvqa_tpu_torch.native import build as nbuild
from isubgvqa_tpu_torch.native import collate as ncollate

from test_model import small_cfg

N_CAP, E_CAP, B, L = 8, 12, 6, 16


def _graph(rng, n_nodes, n_edges, src_hi=None):
    """Seeded graph arrays; edge ends drawn below ``src_hi`` (default all
    nodes)."""
    hi = src_hi or n_nodes
    return dict(
        node_tokens=rng.integers(0, 500, (n_nodes, 4)).astype(np.int32),
        node_bbox=rng.uniform(0, 800, (n_nodes, 4)).astype(np.float32),
        edge_src=rng.integers(0, hi, (n_edges,)).astype(np.int32),
        edge_dst=rng.integers(0, hi, (n_edges,)).astype(np.int32),
        edge_token=rng.integers(0, 500, (n_edges,)).astype(np.int32),
        edge_sign=rng.choice([1.0, -1.0], (n_edges,)).astype(np.float32))


# graph sizes per case: (nodes, edges, edge ends drawn below)
CASES = {
    "nodes_over_cap": [(12, 6, N_CAP), (20, 4, 4), (3, 2, None)],
    "edges_touching_cut_nodes": [(14, 10, None), (11, 12, None),
                                 (8, 5, None)],
    "edges_over_cap": [(8, 30, None), (6, 13, None), (5, 2, None)],
    "partial_batch": [(4, 6, None)],
}


def _samples(case, seed=0):
    """The same seeded samples for both packages: (port, JAX)."""
    rng = np.random.default_rng(seed)
    sizes = CASES[case] * (1 if case == "partial_batch" else 2)
    port, jax_ = [], []
    for i, (n, e, hi) in enumerate(sizes):
        g = _graph(rng, n, e, hi)
        q = f"is there a thing number {i} on the table?"
        label = int(rng.integers(0, 100))
        port.append(Sample(f"q{i}", GraphArrays(**g), q, {}, label, f"i{i}"))
        jax_.append(JSample(f"q{i}", JGraphArrays(**g), q, {}, label, f"i{i}"))
    return port, jax_


def _assert_equal(got, want):
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), np.asarray(getattr(want, f.name))
        assert a.numpy().dtype == b.dtype, f.name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)


def _spec():
    return BucketSpec(batch_size=B, max_nodes_per_graph=N_CAP,
                      max_edges_per_graph=E_CAP, question_len=L)


@pytest.mark.parametrize("case", list(CASES))
def test_native_fill_matches_python_fills(case):
    port, jax_ = _samples(case)
    tok = HashWordTokenizer(max_len=L)
    nat = Collator(tok, _spec(), packed_store=native.PackedGraphStore())
    py = Collator(tok, _spec())
    jc = JCollator(JTokenizer(max_len=L), JBucketSpec(
        batch_size=B, max_nodes_per_graph=N_CAP, max_edges_per_graph=E_CAP,
        question_len=L))
    assert nat.native and not py.native
    for lo in range(0, len(port), B):
        got, meta = nat.collate(port[lo:lo + B])
        want, _ = py.collate(port[lo:lo + B])
        jwant, _ = jc.collate(jax_[lo:lo + B])
        _assert_equal(got, want)
        _assert_equal(got, jwant)
        assert meta.num_real == len(port[lo:lo + B])
    counts = (nat.truncated_nodes, nat.truncated_edges)
    assert counts == (py.truncated_nodes, py.truncated_edges) \
        == (jc.truncated_nodes, jc.truncated_edges)
    if case == "nodes_over_cap":
        assert counts[0] > 0
    if case == "edges_touching_cut_nodes":
        # every edge with an end at or past the cap is dropped, uncounted
        assert counts[0] > 0 and not got.edge_src[got.edge_mask].ge(
            N_CAP).any()
    if case == "edges_over_cap":
        assert counts == (0, counts[1]) and counts[1] > 0
    if case == "partial_batch":
        assert got.sample_mask.tolist() == [1.0] + [0.0] * (B - 1)


def test_two_threads_fill_through_one_store():
    port = [s for case in ("nodes_over_cap", "edges_touching_cut_nodes",
                           "edges_over_cap") for s in _samples(case, 7)[0]]
    port = port * 4
    tok = HashWordTokenizer(max_len=L)
    chunks = [port[i:i + B] for i in range(0, len(port), B)]
    oracle = Collator(tok, _spec())
    want = [oracle.collate(c)[0] for c in chunks]
    store = native.PackedGraphStore()
    got, errors = [None] * len(chunks), []

    def work(t):
        try:
            coll = Collator(tok, _spec(), packed_store=store)
            for i in range(t, len(chunks), 2):
                got[i] = coll.collate(chunks[i])[0]
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for g, w in zip(got, want):
        _assert_equal(g, w)
    assert store.n_graphs == len(port) // 4


def test_native_env_zero_selects_the_python_fill(monkeypatch):
    cfg = small_cfg(bucket_node_caps=(16,))
    tok = HashWordTokenizer(max_len=cfg.question_len)
    assert all(c.native for c in build_bucket_collators(
        cfg, tok, None, batch_size=4).values())
    monkeypatch.setenv("ISUBGVQA_NATIVE", "0")
    colls = build_bucket_collators(cfg, tok, None, batch_size=4)
    assert not any(c.native for c in colls.values())
    assert ncollate.load_collate_lib() is None


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(nbuild, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(nbuild, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(ncollate, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="no-such-g"):
        Collator(HashWordTokenizer(max_len=L), _spec(),
                 packed_store=native.PackedGraphStore())
    assert not list((tmp_path / "build").glob("*.so"))


def test_cpu_store_gives_ordinary_memory():
    """A store made for a CPU caller fills ordinary (unpinned) memory."""
    port, _ = _samples("partial_batch")
    batch, _ = Collator(HashWordTokenizer(max_len=L), _spec(),
                        packed_store=native.PackedGraphStore()).collate(port)
    assert not batch.is_pinned()
    assert isinstance(batch.node_mask, torch.Tensor)
