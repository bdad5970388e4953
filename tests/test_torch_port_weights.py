"""Weights between the two packages: the port's ``state_dict_from_jax``
is the exact inverse of the JAX package's ``convert_state_dict`` on a
tree of the JAX init's structure, a fresh port ``state_dict`` converts
to that structure, and configs round-trip through JSON in both
directions."""

import json

import numpy as np
import pytest
import torch

import jax

from isubgvqa_tpu.config import Config as JConfig
from isubgvqa_tpu.convert import convert_state_dict
from isubgvqa_tpu.data import (AnswerMap, BucketSpec, Collator,
                               HashWordTokenizer, SceneGraphVocab,
                               SyntheticGQA)
from isubgvqa_tpu.models.build import build_model, init_model
from isubgvqa_tpu_torch import data as tdata
from isubgvqa_tpu_torch.config import Config as TConfig
from isubgvqa_tpu_torch.convert import (load_upstream_state_dict,
                                        state_dict_from_jax)
from isubgvqa_tpu_torch.models.build import build_model as tbuild

from test_model import small_cfg
from test_torch_port_model import one_torch_thread  # noqa: F401
from test_torch_port_model import quick_xla  # noqa: F401


def _cfg():
    # two encoder/decoder/MGAT layers keep the JAX init cheap while
    # covering the masked and unmasked GAT layers
    return small_cfg(encoder_layers=2, decoder_layers=2, mgat_layers=2,
                     mgat_masks=(1.0, 0.15))


def _convert(cfg, sd):
    return convert_state_dict({k: v.numpy() for k, v in sd.items()},
                              encoder_layers=cfg.encoder_layers,
                              decoder_layers=cfg.decoder_layers,
                              mgat_layers=cfg.mgat_layers)


@pytest.fixture(scope="module")
def jax_init():
    cfg = _cfg()
    vocab = SceneGraphVocab.synthetic()
    answers = AnswerMap.synthetic(cfg.num_answers)
    ds = SyntheticGQA(vocab, answers, size=8, seed=0)
    spec = BucketSpec(batch_size=2, max_nodes_per_graph=16,
                      max_edges_per_graph=64, question_len=cfg.question_len)
    tok = HashWordTokenizer(vocab_size=cfg.text_vocab_size,
                            max_len=cfg.question_len)
    batch, _ = Collator(tok, spec, vocab=vocab).collate([ds[0], ds[1]])
    model = build_model(cfg, vocab)
    # the init's tree, shapes and dtypes from a trace alone (compiling the
    # init costs ~6 s of CPU), filled with seeded values: every leaf then
    # differs from its neighbours, which the round trip needs more than
    # the init's own values
    shapes = jax.eval_shape(lambda b: init_model(model, b), batch)
    rng = np.random.default_rng(0)
    params, stats = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)
    return cfg, params, stats


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_state_dict_from_jax_inverts_convert_state_dict(jax_init):
    cfg, params, stats = jax_init
    sd = state_dict_from_jax(params, stats)
    p2, s2 = _convert(cfg, sd)
    for tree, back in ((params, p2), (stats, s2)):
        a, b = _leaves(tree), _leaves(back)
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype, path
            assert np.array_equal(np.asarray(x), np.asarray(y)), path


def test_fresh_port_state_dict_has_the_jax_structure(jax_init):
    cfg, params, stats = jax_init
    tm = tbuild(TConfig.from_json(cfg.to_json()),
                tdata.SceneGraphVocab.synthetic(), device="cpu")
    p2, s2 = _convert(cfg, {k: v.float() for k, v in tm.state_dict().items()})
    for tree, back in ((params, p2), (stats, s2)):
        a, b = _leaves(tree), _leaves(back)
        assert [p for p, _ in a] == [p for p, _ in b]
        assert [np.shape(x) for _, x in a] == [np.shape(y) for _, y in b]


def test_jax_weights_load_strictly_into_the_port(jax_init):
    cfg, params, stats = jax_init
    sd = state_dict_from_jax(params, stats)
    tm = tbuild(TConfig.from_json(cfg.to_json()),
                tdata.SceneGraphVocab.synthetic(), device="cpu",
                state_dict=sd)
    assert set(tm.state_dict()) == set(sd)
    w = tm.state_dict()["gat_seq.convs.1.lin_edge.weight"]
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(params["gat_seq"]["lin_edge_all"]["kernel"])
        [:, w.shape[0]:].T)


def test_load_upstream_state_dict_cleans_an_upstream_payload():
    tm = tbuild(TConfig.from_json(_cfg().to_json()),
                tdata.SceneGraphVocab.synthetic(), device="cpu")
    sd = {f"module.{k}": v for k, v in tm.state_dict().items()}
    sd["module.scene_graph_encoder.bbox_encoding.0.num_batches_tracked"] = \
        torch.tensor(3)
    sd["module.graph_global_attention_pooling.gate_nn.0.weight"] = \
        torch.zeros(2, 2)
    out = load_upstream_state_dict({"model": sd, "epoch": 1})
    assert set(out) == set(tm.state_dict())
    tm.load_state_dict(out, strict=True)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_config_json_round_trips(direction):
    src_cls, dst_cls = ((JConfig, TConfig) if direction == "jax_to_port"
                        else (TConfig, JConfig))
    cfg = src_cls(sampler_type="gumbel", sample_k=3, compute_dtype="float32",
                  bucket_node_caps=(8, 64), meta_dir="")
    back = dst_cls.from_json(cfg.to_json())
    assert json.loads(back.to_json()) == json.loads(cfg.to_json())
    assert back.bucket_node_caps == (8, 64) and back.mgat_masks == cfg.mgat_masks
