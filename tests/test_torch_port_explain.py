"""The port's eval paths against the JAX package on the CPU: the
Trainer's ``validate_epoch`` and ``run_token_coo_exp``, and the
token-co-occurrence functions.

Both packages run ``small_cfg`` cut to one encoder layer, one decoder
layer and two GAT layers (the second masked), with the imle sampler in
f32, whose eval
is a plain top-k (no noise), on the same weights (a seeded port init,
BatchNorm statistics at the data's scale, crossed to flax by the JAX
package's converter) and the same synthetic dev set, whose answers are
the scene graphs' object names, and the classifier's bias lifts the two
commonest answers, so that every metric branch fires.  The
JAX Trainer gets that state directly (no init of its own).  Before
asserting equal predictions, the tests assert that the smallest top-1
logit gap exceeds twice the largest logit difference between the
packages (ROADMAP.md Queue 3, "the margin rule"); then validation's
accuracy is exact and its loss within 1e-5 relative, and explain's
counts exact and its ratios within 1e-9.

The port's own properties: two shards recombine into the whole run
(validation's counts exactly, its f32 loss sum within 1e-6 relative:
summation order; explain's sums exactly), bucketed and not; the
vectorized metric pass equals the per-sample oracle; ``--save_expl``
writes a PNG per question.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from isubgvqa_tpu.data.build import build_datasets as jbuild_datasets
from isubgvqa_tpu.data.gqa import AnswerMap as JAnswerMap
from isubgvqa_tpu.data.synthetic import SyntheticGQA as JSyntheticGQA
from isubgvqa_tpu.explain import token_coo as jcoo
from isubgvqa_tpu.explain import run_token_coo_exp as jrun_token_coo_exp
from isubgvqa_tpu.models.build import build_model as jbuild_model
from isubgvqa_tpu.train.loop import Trainer as JTrainer
from isubgvqa_tpu.train.state import TrainState as JTrainState
from isubgvqa_tpu.train.steps import make_eval_step as jmake_eval_step
from isubgvqa_tpu_torch import data as tdata
from isubgvqa_tpu_torch.config import Config
from isubgvqa_tpu_torch.explain import run_token_coo_exp
from isubgvqa_tpu_torch.explain import token_coo
from isubgvqa_tpu_torch.train import Trainer, create_train_state

from test_model import small_cfg
from test_torch_port_model import (jax_weights, one_torch_thread,  # noqa: F401
                                   set_bn_stats)
from test_torch_port_model import quick_xla  # noqa: F401

DEV = 24                     # dev questions: 3 eval batches of 8


def object_answers(vocab, n):
    """Answers that are the vocab's object names (so predicted and true
    answers occur among the node labels), padded to ``n``."""
    names = [t for t in vocab.itos if t.startswith("obj")]
    return (names + [f"ans{i}" for i in range(n)])[:n]


def bundle(build, answer_map, synthetic, cfg):
    data = build(cfg)
    l2a = object_answers(data.vocab, cfg.num_answers)
    answers = answer_map({a: i for i, a in enumerate(l2a)}, l2a)
    dev = synthetic(data.vocab, answers, size=DEV, seed=1, split="valid")
    return dataclasses.replace(data, answers=answers,
                               datasets={**data.datasets, "dev": dev})


def configs(bucketed: bool):
    kw = {} if bucketed else dict(bucket_node_caps=(),
                                  bucket_question_lens=())
    jcfg = small_cfg(sampler_type="imle", synthetic=True, synthetic_size=32,
                     eval_batch_factor=2, meta_dir="", epochs=0,
                     num_data_shards=1, encoder_layers=1, decoder_layers=1,
                     mgat_layers=2, mgat_masks=(1.0, 0.15), **kw)
    return jcfg, Config.from_json(jcfg.to_json())


def port_side(bucketed: bool):
    _, tcfg = configs(bucketed)
    data = bundle(tdata.build_datasets, tdata.AnswerMap, tdata.SyntheticGQA,
                  tcfg)
    state = create_train_state(tcfg, data.vocab, steps_per_epoch=1,
                               device="cpu")
    set_bn_stats(state.model)
    # at random init every question gets the same answer; lift the two
    # commonest dev answers to one mean logit above the rest, so that the
    # questions split between them and some are answered right
    dev = data.datasets["dev"]
    common = np.argsort(-np.bincount([dev[i].label for i in range(DEV)]))[:2]
    mean = dev_logits(state.model, data).mean(0)
    with torch.no_grad():
        state.model.logit_fc.bias[torch.as_tensor(common)] += torch.as_tensor(
            0.2 + mean.max() - mean[common])
    return tcfg, data, state


def dev_logits(model, data) -> np.ndarray:
    out = []
    for batch, _ in tdata.iterate_batches(data.datasets["dev"],
                                          data.collators["dev"]):
        with torch.no_grad():
            out.append(model(batch, train=False).logits.numpy())
    return np.concatenate(out)[:DEV]


@pytest.fixture(scope="module")
def port():
    return {b: port_side(b) for b in (False, True)}


@pytest.fixture(scope="module")
def parity(port):
    """Both packages over the unbucketed dev set: the JAX Trainer's
    validation (its eval step also returning the logits), the JAX runner,
    and the port's counterparts."""
    tcfg, tdata_, state = port[False]
    jcfg, _ = configs(False)
    jdata = bundle(jbuild_datasets, JAnswerMap, JSyntheticGQA, jcfg)
    assert len(jdata.bucket_collators["dev"]) == 1
    model = jbuild_model(jcfg, jdata.vocab)
    params, stats = jax_weights(
        jcfg, {k: v.float() for k, v in state.model.state_dict().items()})
    jstate = JTrainState(step=0, params=params, opt_state=(),
                         batch_stats=stats, aimle_states=None)
    jtrainer = JTrainer(jcfg, model, jdata, state=jstate)
    eval_step = jax.jit(jmake_eval_step(model, jcfg, return_output=True))
    jlogits = []

    def recording_eval_step(st, batch, rng):
        metrics, out = eval_step(st, batch, rng)
        jlogits.append(np.asarray(out.logits))
        return metrics

    jtrainer.eval_step = recording_eval_step
    jval = jtrainer.validate_epoch(0)
    jres = jrun_token_coo_exp(model=model, state=jtrainer.state, data=jdata,
                              cfg=jcfg, split="dev")

    trainer = Trainer(tcfg, tdata_, state=state)
    tval = trainer.validate_epoch(0)
    tres = run_token_coo_exp(state.model, tdata_, tcfg, split="dev")
    return dict(jval=jval, tval=tval, jres=jres, tres=tres,
                jlogits=np.concatenate(jlogits)[:DEV],
                tlogits=dev_logits(state.model, tdata_))


def test_margin_exceeds_the_packages_logit_difference(parity):
    t, j = parity["tlogits"], parity["jlogits"]
    diff = float(np.abs(t - j).max())
    top2 = -np.sort(-t, axis=1)[:, :2]
    gap = float((top2[:, 0] - top2[:, 1]).min())
    print(f"smallest top-1 gap {gap:.3g}, largest logit difference "
          f"{diff:.3g}")
    assert gap > 2 * diff
    np.testing.assert_array_equal(t.argmax(1), j.argmax(1))


def test_validate_epoch_matches_jax(parity):
    (tacc, tloss), (jacc, jloss) = parity["tval"], parity["jval"]
    assert tacc == jacc
    assert tloss == pytest.approx(jloss, rel=1e-5)


def test_run_token_coo_exp_matches_jax(parity):
    t, j = parity["tres"].sums, parity["jres"].sums
    assert t.keys() == j.keys()
    for k in ("acc_n", "acc_at_n", "ans_n", "qst_n", "n_seen", "acc_sum",
              "acc_at_sum", "ans_sum"):
        assert t[k] == j[k], k
    for k in t:
        assert t[k] == pytest.approx(j[k], abs=1e-9), k
    assert t["acc_at_n"] > 0 and t["qst_n"] > 0, "a metric branch never fired"
    assert parity["tres"].summary().splitlines()[0].startswith("Accuracy: ")


@pytest.mark.parametrize("bucketed", [False, True],
                         ids=["one-bucket", "bucketed"])
def test_sharded_validation_recombines(port, bucketed):
    tcfg, data, state = port[bucketed]
    assert (len(data.bucket_collators["dev"]) > 1) == bucketed
    full = Trainer(tcfg, data, state=state)
    full.validate_epoch(0)
    parts = []
    for i in range(2):
        tr = Trainer(tcfg, data, state=state, shard_index=i, num_shards=2)
        tr.validate_epoch(0)
        parts.append(tr.val_totals)
    assert full.val_totals["count"] == DEV
    for k in ("correct", "count"):
        assert parts[0][k] + parts[1][k] == full.val_totals[k], k
    assert parts[0]["loss_sum"] + parts[1]["loss_sum"] == pytest.approx(
        full.val_totals["loss_sum"], rel=1e-6)


@pytest.mark.parametrize("bucketed", [False, True],
                         ids=["one-bucket", "bucketed"])
def test_sharded_explain_recombines(port, bucketed):
    tcfg, data, state = port[bucketed]
    kw = dict(model=state.model, data=data, cfg=tcfg, split="dev", seed=7)
    full = run_token_coo_exp(**kw)
    shards = [run_token_coo_exp(**kw, shard_index=i, num_shards=2)
              for i in range(2)]
    assert full.num_samples == DEV
    assert shards[0].num_samples + shards[1].num_samples == DEV
    for k, v in full.sums.items():
        assert shards[0].sums[k] + shards[1].sums[k] == pytest.approx(
            v, abs=1e-9), k


@pytest.mark.parametrize("bucketed", [False, True],
                         ids=["one-bucket", "bucketed"])
def test_fast_metrics_match_oracle(port, bucketed):
    tcfg, data, state = port[bucketed]
    kw = dict(model=state.model, data=data, cfg=tcfg, split="dev", seed=5)
    slow = run_token_coo_exp(**kw, fast_metrics=False)
    masks = {}
    collected = run_token_coo_exp(**kw, collect_masks=masks)
    fast = run_token_coo_exp(**kw)
    assert fast.sums.keys() == slow.sums.keys() == collected.sums.keys()
    for k, v in slow.sums.items():
        assert fast.sums[k] == pytest.approx(v, abs=1e-9), k
        assert collected.sums[k] == v, k
    assert slow.sums["acc_at_n"] > 0 and slow.sums["qst_n"] > 0
    assert len(masks) == DEV
    assert all(set(np.unique(m["mask"])) <= {0.0, 1.0}
               for m in masks.values())


def test_save_expl_writes_a_png_per_question(port, tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("networkx")
    tcfg, data, state = port[False]
    masks = {}
    run_token_coo_exp(state.model, data, tcfg, split="dev", save_expl=True,
                      expl_dir=str(tmp_path), run="t", max_batches=1,
                      save_qst_meta_data=True, collect_masks=masks)
    assert len(masks) == 8
    ds = data.datasets["dev"]
    for i in range(8):
        s = ds[i]
        qdir = tmp_path / s.image_id / s.question_id
        assert (qdir / f"{s.question_id}_t.png").stat().st_size > 0
        assert (qdir / f"{s.question_id}_t_qst_meta_data.json").is_file()


OBJECTS = ["cat", "dog", "tree", "cat"]
COO_CASES = [
    ([1.0, 0.0, 1.0, 0.0], "cat", "cat", "where is the cat?"),
    ([0.0, 1.0, 0.0, 0.0], "dog", "dog", "is the dog near the tree?"),
    ([1.0, 1.0, 1.0, 1.0], "cat", "cat", "what color is the cat?"),
    ([0.0, 0.0, 0.0, 0.0], "sky", "sky", "hello there?"),
    ([1.0, 0.0, 0.0, 1.0], "tree", "cat", "Is The Cat On The Tree?"),
    ([0.5, -1.0, 2.0, 0.0], "dog", "dog", "dog cat tree"),
]


def _same(a, b):
    a, b = np.atleast_1d(np.asarray(a, float)), np.atleast_1d(
        np.asarray(b, float))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mask,ans,gt,question", COO_CASES)
def test_token_coo_matches_jax(mask, ans, gt, question):
    for threshold in (0.0, 0.5):
        _same(token_coo.compute_ans_token_cooccurrence(
            mask, ans, gt, OBJECTS, question, threshold),
            jcoo.compute_ans_token_cooccurrence(
            mask, ans, gt, OBJECTS, question, threshold))
        _same(token_coo.compute_qst_token_cooccurrence(
            mask, OBJECTS, question, threshold),
            jcoo.compute_qst_token_cooccurrence(
            mask, OBJECTS, question, threshold))
        words = question.split()
        _same(token_coo.compute_text_expl_token_cooccurrence(
            mask, OBJECTS, words, question, threshold),
            jcoo.compute_text_expl_token_cooccurrence(
            mask, OBJECTS, words, question, threshold))
