"""The port's serving ``Predictor`` on the CPU, with the behaviours of
``tests/test_serve.py``, plus the same top answer as the JAX Predictor on
the same weights when both draw zero Gumbel noise."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from isubgvqa_tpu.data import AnswerMap, SceneGraphVocab
from isubgvqa_tpu.serve import Predictor as JPredictor
from isubgvqa_tpu_torch.config import Config as TConfig
from isubgvqa_tpu_torch.data import SceneGraphVocab as TVocab
from isubgvqa_tpu_torch.models.build import build_model
from isubgvqa_tpu_torch.serve import Predictor, batch_seed
from isubgvqa_tpu_torch.sampling import gumbel as tgumbel

from test_model import small_cfg
from test_torch_port_model import jax_weights, one_torch_thread  # noqa: F401
from test_torch_port_model import quick_xla  # noqa: F401


def _cfg(**kw):
    return TConfig.from_json(small_cfg(meta_dir="", **kw).to_json())


def _sg(n, rels=True):
    return {"objects": {
        str(i): {"name": f"obj{i % 2}", "attributes": ["attr0"] if i else [],
                 "relations": ([{"object": str((i + 1) % n), "name": "rel0"}]
                               if rels and n > 1 else []),
                 "x1": i, "y1": 0, "x2": 10 + i, "y2": 10}
        for i in range(n)}}


@pytest.fixture(scope="module")
def predictor():
    return Predictor.from_seed(_cfg(), device="cpu")


@pytest.fixture(scope="module")
def predictor_bucketed():
    return Predictor.from_seed(
        _cfg(max_nodes_per_graph=64, max_edges_per_graph=256,
             bucket_node_caps=(8, 64)), device="cpu")


def test_predictor_end_to_end(predictor, tmp_path):
    results = predictor.predict(
        ["what is next to the obj0?", "is there an obj1?"], [_sg(2), _sg(2)],
        batch_size=2)
    assert len(results) == 2
    r = results[0]
    assert isinstance(r.answer, str)
    assert 0.0 <= r.confidence <= 1.0
    assert len(r.top_answers) == 5
    assert r.node_mask.shape == (2,) and r.gate.shape == (2,)
    assert set(r.subgraph_nodes) <= {"obj0", "obj1"}
    assert np.round(r.node_mask).sum() <= 3
    r2 = predictor.predict(["what is next to the obj0?"], [_sg(2)])[0]
    assert r2.answer == r.answer
    # the port's own checkpoint round-trips
    path = str(tmp_path / "model.pt")
    predictor.save(path)
    again = Predictor.from_checkpoint(path, device="cpu")
    r3 = again.predict(["what is next to the obj0?"], [_sg(2)])[0]
    assert r3.answer == r.answer and r3.confidence == pytest.approx(
        r.confidence, abs=1e-6)


def test_entry_points_do_not_fall_back_to_the_cpu(monkeypatch):
    """With no device asked for, the entry points want CUDA and raise
    where there is none, rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_seed(_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(_cfg(), TVocab.synthetic())


def test_predictor_partial_batch(predictor):
    results = predictor.predict(["q?"] * 3, [{"objects": {}}] * 3,
                                batch_size=2)
    assert len(results) == 3 and all(r is not None for r in results)


def test_predict_draws_a_fresh_noise_stream_per_batch(predictor):
    seen = []
    orig = predictor._forward

    def spy(batch, generator):
        seen.append(generator.initial_seed())
        return orig(batch, generator)

    predictor._forward = spy
    try:
        results = predictor.predict(["what is next to the obj0?"] * 3,
                                    [_sg(6)] * 3, batch_size=1)
        assert len(results) == 3
        assert len(set(seen)) == 3
        assert seen == [batch_seed(0, i) for i in range(3)]
        again = predictor.predict(["what is next to the obj0?"] * 3,
                                  [_sg(6)] * 3, batch_size=1)
        assert seen[3:] == seen[:3]
        assert [r.answer for r in again] == [r.answer for r in results]
        assert all(np.array_equal(a.node_mask, b.node_mask)
                   for a, b in zip(again, results))
    finally:
        predictor._forward = orig


def test_predict_routes_small_graphs_to_small_buckets(predictor_bucketed):
    p = predictor_bucketed
    small_cap = min(p.cfg.bucket_node_caps)
    results = p.predict(["is there an obj1?"], [_sg(2, rels=False)],
                        batch_size=2)
    assert len(results) == 1 and results[0] is not None
    (node_shape, _), = p.last_batch_shapes
    assert node_shape[1] == small_cap


def test_predict_preserves_input_order_across_buckets(predictor_bucketed):
    p = predictor_bucketed
    big = p.cfg.max_nodes_per_graph // 2 + 1
    graphs = [_sg(2), _sg(big), _sg(3), _sg(big), _sg(2)]
    results = p.predict([f"is there an obj{i % 2}?" for i in range(5)],
                        graphs, batch_size=2)
    assert all(r is not None for r in results)
    for r, g in zip(results, graphs):
        assert len(r.node_mask) == len(g["objects"])
    assert len({shape for shape, _ in p.last_batch_shapes}) >= 2


def test_same_top_answer_as_jax_with_zero_noise(predictor, monkeypatch):
    jcfg = dataclasses.replace(small_cfg(meta_dir=""), bucket_node_caps=(),
                               bucket_question_lens=())
    tcfg = TConfig.from_json(jcfg.to_json())
    port = Predictor(tcfg, predictor.vocab, predictor.answers, device="cpu",
                     state_dict=predictor.model.state_dict())
    params, stats = jax_weights(jcfg, {k: v.float() for k, v in
                                       port.model.state_dict().items()})
    # the JAX Predictor would point jax's persistent compilation cache at
    # a directory for the rest of the process; this test needs no cache
    monkeypatch.setenv("ISUBGVQA_COMPILE_CACHE", "0")
    jpred = JPredictor(jcfg, params, stats, SceneGraphVocab.synthetic(),
                       AnswerMap.synthetic(jcfg.num_answers))
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(tgumbel, "draw_gumbel",
                        lambda shape, generator, device:
                        torch.zeros(shape, device=device))
    qs = ["what is next to the obj0?", "is there an obj1?",
          "what color is the obj0?", "how many obj1 are there?"]
    sgs = [_sg(2), _sg(5), _sg(9), _sg(3, rels=False)]
    rj = jpred.predict(qs, sgs, batch_size=4)
    rt = port.predict(qs, sgs, batch_size=4)
    for a, b in zip(rt, rj):
        assert a.answer == b.answer
        np.testing.assert_array_equal(np.round(a.node_mask),
                                      np.round(np.asarray(b.node_mask)))
        assert a.confidence == pytest.approx(b.confidence, abs=1e-4)
