"""The rest of the port's host data layer against the JAX package's:
``iterate_batches`` and ``iterate_batches_bucketed`` with their sharding
and grouping arguments yield equal arrays; ``route_to_buckets`` caches
the sizes it reads; ``prefetch`` keeps order, re-raises the producer's
exception and stops its thread when the consumer stops;
``build_datasets`` (synthetic, and question and scene-graph JSONs in
GQA's layout) and ``build_text_vocab`` give what the JAX package gives;
the profiling hooks write a trace and step statistics.  All on the CPU; the CUDA copy path of ``prefetch`` is
held in ``tests/test_torch_port_cuda.py``."""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from isubgvqa_tpu.config import Config as JConfig
from isubgvqa_tpu.data import (AnswerMap, BucketSpec, Collator,
                               HashWordTokenizer, SceneGraphVocab,
                               SyntheticGQA)
from isubgvqa_tpu.data.batching import (iterate_batches,
                                        iterate_batches_bucketed)
from isubgvqa_tpu.data.build import build_bucket_collators, build_datasets
from isubgvqa_tpu.data.gqa import build_text_vocab
from isubgvqa_tpu_torch import data as tdata
from isubgvqa_tpu_torch.config import Config as TConfig
from isubgvqa_tpu_torch.utils import profiling

from test_torch_port_data import _assert_same_batch
from test_torch_port_model import one_torch_thread  # noqa: F401

SIZE = 40


@pytest.fixture(scope="module")
def fixture():
    vocab, tvocab = (SceneGraphVocab.synthetic(),
                     tdata.SceneGraphVocab.synthetic())
    ans, tans = AnswerMap.synthetic(64), tdata.AnswerMap.synthetic(64)
    ds = SyntheticGQA(vocab, ans, size=SIZE, seed=5, shape_mix="gqa")
    tds = tdata.SyntheticGQA(tvocab, tans, size=SIZE, seed=5, shape_mix="gqa")
    kw = dict(question_len=32, bucket_question_lens=(16,), meta_dir="")
    tok = HashWordTokenizer(vocab_size=4096, max_len=32)
    ttok = tdata.HashWordTokenizer(vocab_size=4096, max_len=32)
    jcolls = build_bucket_collators(JConfig(**kw), tok, vocab, batch_size=3)
    tcolls = tdata.build_bucket_collators(TConfig(**kw), ttok, tvocab,
                                          batch_size=3)
    spec = dict(batch_size=6, max_nodes_per_graph=128,
                max_edges_per_graph=384, question_len=32)
    return dict(ds=ds, tds=tds, jcolls=jcolls, tcolls=tcolls,
                jc=Collator(tok, BucketSpec(**spec), vocab=vocab),
                tc=tdata.Collator(ttok, tdata.BucketSpec(**spec),
                                  vocab=tvocab))


def _assert_same_stream(jit, tit):
    n = 0
    for (jb, jm), (tb, tm) in zip(jit, tit, strict=True):
        assert jm.question_ids == tm.question_ids and jm.num_real == tm.num_real
        _assert_same_batch(jb, tb)
        n += 1
    return n


SHARDING = [(1, True), (3, True), (3, False)]


@pytest.mark.parametrize("shards,pad", SHARDING,
                         ids=["one", "three-padded", "three-exact"])
@pytest.mark.parametrize("shuffle,drop_last",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_iterate_batches_matches_jax(fixture, shuffle, drop_last, shards,
                                     pad):
    f = fixture
    total = 0
    for shard in range(shards):
        kw = dict(shuffle=shuffle, seed=11, drop_last=drop_last,
                  shard_index=shard, num_shards=shards, pad_shards=pad)
        total += _assert_same_stream(
            iterate_batches(f["ds"], f["jc"], **kw),
            tdata.iterate_batches(f["tds"], f["tc"], **kw))
    assert total >= shards * (SIZE // shards // 6)


@pytest.mark.parametrize("shards,pad", SHARDING,
                         ids=["one", "three-padded", "three-exact"])
@pytest.mark.parametrize("shuffle,group,drop_last",
                         [(False, False, False), (True, False, True),
                          (True, True, False)],
                         ids=["ordered", "shuffled", "grouped"])
def test_iterate_batches_bucketed_matches_jax(fixture, shuffle, group,
                                              drop_last, shards, pad):
    f = fixture
    shapes = []
    for shard in range(shards):
        kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last,
                  shard_index=shard, num_shards=shards, pad_shards=pad,
                  group_by_bucket=group)
        _assert_same_stream(
            iterate_batches_bucketed(f["ds"], f["jcolls"], **kw),
            tdata.iterate_batches_bucketed(f["tds"], f["tcolls"], **kw))
        shapes.append([tuple(b.node_tokens.shape) for b, _ in
                       tdata.iterate_batches_bucketed(f["tds"], f["tcolls"],
                                                      **kw)])
    if pad:     # padded rounds: every shard walks the same shape sequence
        assert all(s == shapes[0] for s in shapes)
    if group:   # grouped: one run of batches per bucket, ascending
        seen = [s for i, s in enumerate(shapes[0])
                if i == 0 or s != shapes[0][i - 1]]
        assert len(seen) == len(set(seen))


def test_route_to_buckets_reads_sizes_once(fixture, monkeypatch):
    f = fixture
    ds = tdata.SyntheticGQA(tdata.SceneGraphVocab.synthetic(),
                            tdata.AnswerMap.synthetic(64), size=SIZE, seed=5,
                            shape_mix="gqa")
    tok = next(iter(f["tcolls"].values())).tokenizer
    calls = []
    count = tok.count_tokens
    monkeypatch.setattr(tok, "count_tokens",
                        lambda q: calls.append(q) or count(q))
    first = tdata.route_to_buckets(ds, f["tcolls"])
    assert len(calls) == SIZE
    idx = np.arange(SIZE)[::-1]
    again = tdata.route_to_buckets(ds, f["tcolls"], idx)
    assert len(calls) == SIZE                     # cached on the dataset
    assert {k: sorted(v) for k, v in again.items()} == first
    samples = [ds[i] for i in range(SIZE)]        # a list takes no cache
    assert tdata.route_to_buckets(samples, f["tcolls"]) == first


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch"]


def _wait_no_prefetch_thread(timeout=5.0):
    end = time.monotonic() + timeout
    while _prefetch_threads() and time.monotonic() < end:
        time.sleep(0.01)
    return not _prefetch_threads()


def test_prefetch_keeps_order_and_places(fixture):
    f = fixture
    want = list(tdata.iterate_batches(f["tds"], f["tc"]))
    for device in (None, "cpu"):
        got = list(tdata.prefetch(tdata.iterate_batches(f["tds"], f["tc"]),
                                  depth=2, device=device))
        assert [m.question_ids for _, m in got] == \
            [m.question_ids for _, m in want]
        for (g, _), (w, _) in zip(got, want):
            for field in tdata.GraphBatch.__dataclass_fields__:
                assert torch.equal(getattr(g, field), getattr(w, field))
    placed = list(tdata.prefetch(iter(range(7)), depth=3,
                                 device=lambda x: 10 * x))
    assert placed == [10 * i for i in range(7)]
    assert _wait_no_prefetch_thread()


def test_prefetch_reraises_the_producers_exception():
    def source():
        yield 1
        yield 2
        raise KeyError("producer failed")

    got = []
    with pytest.raises(KeyError, match="producer failed"):
        for item in tdata.prefetch(source(), depth=1):
            got.append(item)
    assert got == [1, 2]
    assert _wait_no_prefetch_thread()


def test_prefetch_producer_stops_after_early_break():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    it = tdata.prefetch(endless(), depth=2)
    for item in it:
        if item == 3:
            break
    it.close()
    assert _wait_no_prefetch_thread(), "producer thread still running"
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n        # nothing produced after the stop
    assert n <= 3 + 1 + 2 + 1        # consumed, in flight, queued, parked


def test_build_datasets_synthetic_matches_jax():
    kw = dict(synthetic=True, synthetic_size=48, batch_size=4,
              synthetic_shape_mix="gqa", meta_dir="", question_len=32,
              text_vocab_size=4096)
    jdata = build_datasets(JConfig(**kw))
    tdata_ = tdata.build_datasets(TConfig(**kw))
    assert set(tdata_.datasets) == set(jdata.datasets) == {"train", "dev",
                                                         "testdev"}
    for split, jds in jdata.datasets.items():
        tds = tdata_.datasets[split]
        assert len(tds) == len(jds)
        for i in (0, len(jds) - 1):
            js, ts = jds[i], tds[i]
            assert (js.question_id, js.question, js.label, js.image_id) == \
                (ts.question_id, ts.question, ts.label, ts.image_id)
            np.testing.assert_array_equal(js.graph.node_tokens,
                                          ts.graph.node_tokens)
        jcolls = jdata.bucket_collators[split]
        tcolls = tdata_.bucket_collators[split]
        assert ({k: dataclasses.asdict(c.spec) for k, c in jcolls.items()}
                == {k: dataclasses.asdict(c.spec) for k, c in tcolls.items()})
        assert (dataclasses.asdict(tdata_.collators[split].spec)
                == dataclasses.asdict(jdata.collators[split].spec))
    assert tdata_.collators["dev"].spec.batch_size == 16
    assert len(tdata_.answers) == len(jdata.answers)
    assert len(tdata_.vocab) == len(jdata.vocab)
    jb, _ = jdata.collators["train"].collate(
        [jdata.datasets["train"][i] for i in range(4)])
    tb, _ = tdata_.collators["train"].collate(
        [tdata_.datasets["train"][i] for i in range(4)])
    _assert_same_batch(jb, tb)


def test_build_datasets_real_gqa_layout_matches_jax(tmp_path):
    """The real-GQA branch (``_has_real_gqa``): question and scene-graph
    JSONs under ``data_dir`` in GQA's layout, one store for the splits,
    testdev filtered to the images with graphs."""
    syn = tdata.SyntheticGQA(tdata.SceneGraphVocab.synthetic(),
                             tdata.AnswerMap.synthetic(16), size=12,
                             num_images=6, seed=2)
    graphs = syn.store.scene_graphs
    images = sorted(graphs)
    (tmp_path / "questions").mkdir()
    (tmp_path / "sceneGraphs").mkdir()
    files = {"train": "train_balanced_questions.json",
             "valid": "val_balanced_questions.json",
             "testdev": "testdev_balanced_questions.json"}
    for split, name in files.items():
        qs = {f"{split}{i}": {"imageId": img, "question": q, "answer": a,
                              "types": {"structural": "query"}}
              for i, (_, img, q, a) in enumerate(syn.samples)}
        qs[f"{split}-nograph"] = {"imageId": "missing", "question": "what?",
                                  "answer": "yes"}
        (tmp_path / "questions" / name).write_text(json.dumps(qs))
    half = len(images) // 2
    for name, keys in (("train_sceneGraphs.json", images[:half]),
                       ("val_sceneGraphs.json", images[half:]),
                       ("scene_graphs_test_dev.json", images[:half])):
        (tmp_path / "sceneGraphs" / name).write_text(
            json.dumps({k: graphs[k] for k in keys}))
    kw = dict(data_dir=str(tmp_path), batch_size=4, meta_dir="",
              question_len=32, text_vocab_size=4096, max_nodes_per_graph=32)
    jdata = build_datasets(JConfig(**kw))
    tdata_ = tdata.build_datasets(TConfig(**kw))
    for split, jds in jdata.datasets.items():
        tds = tdata_.datasets[split]
        assert isinstance(tds, tdata.GQADataset)
        assert len(tds) == len(jds) and tds.ids == jds.ids
        assert _assert_same_stream(
            iterate_batches(jds, jdata.collators[split]),
            tdata.iterate_batches(tds, tdata_.collators[split])) >= 1
    assert len(tdata_.datasets["train"]) == 13      # the graph-less one kept
    assert "testdev-nograph" not in tdata_.datasets["testdev"].ids
    assert tdata_.datasets["train"].store is tdata_.datasets["dev"].store


def test_build_text_vocab_matches_jax(fixture):
    questions = [fixture["ds"][i].question for i in range(SIZE)]
    questions.append("What Is THE color?")
    want = build_text_vocab(questions, HashWordTokenizer())
    got = tdata.build_text_vocab(questions, tdata.HashWordTokenizer())
    assert got == want
    assert list(got)[:5] == ["<unk>", "<pad>", "<sos>", "<eos>", "<self>"]


def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("ISUBGVQA_TRACE_DIR", raising=False)
    with profiling.trace():                     # disabled: writes nothing
        torch.ones(4).sum()
    monkeypatch.setenv("ISUBGVQA_TRACE_DIR", str(tmp_path))
    with profiling.trace():
        torch.ones(8, 8).matmul(torch.ones(8, 8))
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(ev.get("name", "")) for ev in events)


def test_step_profiler_summary():
    prof = profiling.StepProfiler(device="cpu")
    for _ in range(4):
        prof.step()
    stats = prof.summary()
    assert set(stats) == {"mean_s", "p50_s", "p95_s"}   # no CUDA peak
    assert stats["p95_s"] >= stats["p50_s"] >= 0.0
    off = profiling.StepProfiler(enabled=False)
    off.step()
    assert off.summary() == {}


def test_gc_pauses_reports_collections_while_open():
    import gc
    import io
    import json

    buf = io.StringIO()
    with profiling.gc_pauses(min_ms=0.0, file=buf):
        gc.collect()
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert any(ln["generation"] == 2 and ln["gc_pause_ms"] >= 0.0
               for ln in lines)
    gc.collect()                          # closed: nothing more is written
    assert len(buf.getvalue().splitlines()) == len(lines)
