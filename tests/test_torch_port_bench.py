"""The port's bench (``isubgvqa_tpu_torch.bench``) and its FLOP count
(``isubgvqa_tpu_torch.ops.flops``) on the CPU.

* The bucket streams against the root ``bench.build_bucket_streams`` of
  the JAX bench (imported here only): the same keys, weights and
  collated arrays from the same seeded draws.
* The timing guards, the cases of ``tests/test_bench_streams.py`` with a
  patched clock or a patched ``_time_stream``.
* The FLOP count: exactly linear in the batch; equal to the matrix
  products that ``FlopCounterMode`` sees over the plain eval forward at
  ``small_cfg``, with the one-hot incidence products (the plain graph
  layers' gathers and scatters) counted as nothing; a train step
  between 2x and 3.5x the forward.
* The three bench functions end to end on ``device="cpu"`` at batch 4,
  one bucket, one timed batch: finite numbers under the documented keys,
  and no MFU, which is a share of the card's peak.
"""

import dataclasses
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode, flop_registry

import bench as jbench
from isubgvqa_tpu.config import Config as JConfig
from isubgvqa_tpu.data import (AnswerMap, HashWordTokenizer, SceneGraphVocab,
                               SyntheticGQA)
from isubgvqa_tpu.data.build import build_bucket_collators
from isubgvqa_tpu_torch import bench
from isubgvqa_tpu_torch import data as tdata
from isubgvqa_tpu_torch.models.build import build_model
from isubgvqa_tpu_torch.ops import flops

from test_model import small_cfg
from test_torch_port_data import _assert_same_batch
from test_torch_port_model import one_torch_thread, port_cfg  # noqa: F401


def test_bucket_streams_match_jax_bench():
    kw = dict(question_len=32, bucket_question_lens=(16,), meta_dir="")
    vocab, tvocab = (SceneGraphVocab.synthetic(),
                     tdata.SceneGraphVocab.synthetic())
    ans, tans = AnswerMap.synthetic(16), tdata.AnswerMap.synthetic(16)
    ds = SyntheticGQA(vocab, ans, size=40, seed=0, shape_mix="gqa")
    tds = tdata.SyntheticGQA(tvocab, tans, size=40, seed=0, shape_mix="gqa")
    jcolls = build_bucket_collators(
        JConfig(**kw), HashWordTokenizer(vocab_size=4096, max_len=32), vocab,
        batch_size=4)
    tcolls = tdata.build_bucket_collators(
        port_cfg(JConfig(**kw)),
        tdata.HashWordTokenizer(vocab_size=4096, max_len=32), tvocab,
        batch_size=4)
    jstreams, jweights = jbench.build_bucket_streams(ds, jcolls, 4)
    tstreams, tweights = bench.build_bucket_streams(tds, tcolls, 4)
    assert list(tstreams) == list(jstreams) and len(tstreams) >= 3
    assert tweights == jweights
    for key, batches in jstreams.items():
        assert len(tstreams[key]) == len(batches) >= 5
        for jb, tb in zip(batches, tstreams[key]):
            _assert_same_batch(jb, tb)


def _one_bucket(size):
    """``size`` samples in one bucket of batch 4 (the JAX test's setup)."""
    vocab = tdata.SceneGraphVocab.synthetic()
    ds = tdata.SyntheticGQA(vocab, tdata.AnswerMap.synthetic(16), size=size,
                            seed=0)
    spec = tdata.BucketSpec(4, max_nodes_per_graph=32, max_edges_per_graph=160,
                            question_len=12)
    colls = {(32, 12): tdata.Collator(tdata.HashWordTokenizer(max_len=12),
                                      spec, vocab=vocab)}
    return bench.build_bucket_streams(ds, colls, batch_size=4, min_timed=4)


@pytest.mark.parametrize("members,distinct", [(4, True), (2, True),
                                              (1, False)],
                         ids=["equal-to-batch", "below-batch", "one-member"])
def test_stream_distinct_inputs(members, distinct):
    """A bucket with a batch of members or fewer still gives distinct
    batches; a bucket of one member cannot, and is flagged."""
    streams, weights = _one_bucket(members)
    (batches,) = streams.values()
    assert len(batches) == 5
    assert bench._stream_is_distinct(batches) is distinct
    assert list(weights.values()) == [1.0]


def test_streams_deterministic_across_calls():
    s1, _ = _one_bucket(10)
    s2, _ = _one_bucket(10)
    for k in s1:
        for b1, b2 in zip(s1[k], s2[k]):
            assert torch.equal(b1.node_tokens, b2.node_tokens)


def test_time_stream_median_of_chunks_with_patched_clock(monkeypatch):
    """Warm-up untimed; chunks of 5; the median of the chunks' ms a
    batch.  The clock advances only inside ``run_one``."""
    now = [0.0]
    cost = {0: 1.0, 1: 0.010, 2: 0.010, 3: 0.010, 4: 0.010, 5: 0.010,
            6: 0.030, 7: 0.030, 8: 0.030, 9: 0.030, 10: 0.030,
            11: 0.020, 12: 0.020}
    monkeypatch.setattr(bench, "_clock", lambda: now[0])

    def run_one(i):
        now[0] += cost[i]

    ms = bench._time_stream(run_one, list(range(13)), torch.device("cpu"))
    assert ms == pytest.approx(20.0)       # chunks of 10, 30 and 20 ms


def test_peak_flops_takes_a_torch_dtype_or_its_name():
    for dtype, name in ((torch.bfloat16, "bfloat16"),
                        (torch.float32, "float32")):
        assert flops.peak_flops(dtype) == flops.peak_flops(name) \
            == flops.PEAK_FLOPS[name]
    with pytest.raises(KeyError):
        flops.peak_flops(torch.float16)


def test_time_stream_checked_retimes_impossible_readings(monkeypatch):
    readings = [1.0, 50.0]    # the first implies 500x the peak
    monkeypatch.setattr(bench, "_time_stream",
                        lambda run_one, batches, device: readings.pop(0))
    peak = flops.PEAK_FLOPS["bfloat16"]
    ms, retimed = bench._time_stream_checked(None, None, peak * 0.5, peak,
                                             None)
    assert retimed and ms == 50.0 and not readings


def test_time_stream_checked_passes_plausible_readings(monkeypatch):
    calls = []
    monkeypatch.setattr(bench, "_time_stream",
                        lambda run_one, batches, device: calls.append(1)
                        or 100.0)
    peak = flops.PEAK_FLOPS["bfloat16"]
    ms, retimed = bench._time_stream_checked(None, None, peak * 0.01, peak,
                                             None)
    assert ms == 100.0 and not retimed and len(calls) == 1


def test_time_stream_checked_zero_flops_disables_guard(monkeypatch):
    monkeypatch.setattr(bench, "_time_stream",
                        lambda run_one, batches, device: 0.001)
    ms, retimed = bench._time_stream_checked(None, None, 0.0, 1.0, None)
    assert ms == 0.001 and not retimed


BUCKET_SHAPES = [(16, 64, 16), (128, 384, 32)]


@pytest.mark.parametrize("n,e,l", BUCKET_SHAPES)
def test_flops_linear_in_batch(n, e, l):
    cfg = port_cfg(small_cfg())
    for fn in (flops.forward_flops, flops.train_step_flops):
        one = fn(cfg, 1, n, e, l)
        assert one > 0
        for b in (7, 256, 2048):
            assert fn(cfg, b, n, e, l) == b * one
    ratio = (flops.train_step_flops(cfg, 1, n, e, l)
             / flops.forward_flops(cfg, 1, n, e, l))
    assert 2.0 <= ratio <= 3.5


def _no_incidence(op):
    """``op``'s FlopCounterMode formula, zero where an operand holds only
    0s and 1s: a one-hot incidence product, which the plain graph layers
    use as a gather or a scatter by index."""
    base = flop_registry[op]

    def formula(*args, out_val=None, **kw):
        if any(isinstance(a, torch.Tensor) and a.is_floating_point()
               and bool(((a == 0) | (a == 1)).all()) for a in args[:3]):
            return 0
        return base(*args, out_val=out_val, **kw)
    formula._get_raw = True
    return formula


def test_forward_flops_equal_flop_counter_over_plain_forward():
    cfg = port_cfg(small_cfg())
    vocab = tdata.SceneGraphVocab.synthetic()
    ds = tdata.SyntheticGQA(vocab, tdata.AnswerMap.synthetic(32), size=8,
                            seed=0)
    spec = tdata.BucketSpec(batch_size=4, max_nodes_per_graph=32,
                            max_edges_per_graph=128, question_len=12)
    coll = tdata.Collator(tdata.HashWordTokenizer(vocab_size=512, max_len=12),
                          spec, vocab=vocab)
    batch, _ = coll.collate([ds[i] for i in range(3)])    # one padded slot
    model = build_model(cfg, vocab, device="cpu")
    aten = torch.ops.aten
    mapping = {op: _no_incidence(op)
               for op in (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)}
    with torch.no_grad(), FlopCounterMode(display=False,
                                          custom_mapping=mapping) as fc:
        model(batch, generator=torch.Generator().manual_seed(0))
    counted = fc.get_total_flops()
    assert counted == flops.forward_flops(cfg, *flops.batch_shape(batch))
    # the incidence products were there, and are what was left out
    with torch.no_grad(), FlopCounterMode(display=False) as everything:
        model(batch, generator=torch.Generator().manual_seed(0))
    assert everything.get_total_flops() > counted


def _finite(d, keys):
    for k in keys:
        assert isinstance(d[k], float) and math.isfinite(d[k]) and d[k] > 0, k


@pytest.fixture(scope="module")
def cpu_setup():
    cfg = port_cfg(small_cfg(bucket_node_caps=(32,)))
    return bench.build_bench_setup(cfg, num_batches=2, min_timed=1,
                                   device="cpu")


def test_bench_inference_on_cpu(cpu_setup):
    out = bench.bench_inference(setup=cpu_setup)
    assert out["device"] == "cpu" and out["batch_size"] == 4
    _finite(out, ("qps_per_chip", "ms_per_batch", "flops_per_question",
                  "tflops_per_sec"))
    assert out["mfu"] is None and out["peak_tflops"] is None   # off the card
    assert list(out["per_bucket"]) == ["(32, 12)"]
    (entry,) = out["per_bucket"].values()
    _finite(entry, ("ms_per_batch", "qps", "weight", "tflops_per_sec"))
    assert entry["mfu"] is None
    assert entry["batches_timed"] == 1 and entry["weight"] == 1.0
    assert out["qps_per_chip"] == pytest.approx(entry["qps"])


def test_bench_e2e_on_cpu(cpu_setup):
    out = bench.bench_e2e(setup=cpu_setup, epochs=1)
    assert out["questions_per_epoch"] == len(cpu_setup.ds) == 8
    _finite(out, ("e2e_qps_per_chip", "e2e_qps_best"))
    assert len(out["epoch_seconds"]) == 1


def test_bench_train_step_on_cpu(cpu_setup):
    setup = dataclasses.replace(
        cpu_setup, model=None,
        state=bench.create_train_state(cpu_setup.cfg, cpu_setup.vocab,
                                       steps_per_epoch=8, device="cpu"))
    out = bench.bench_train_step(setup=setup)
    _finite(out, ("train_qps_per_chip", "ms_per_step", "flops_per_question",
                  "tflops_per_sec"))
    (entry,) = out["per_bucket"].values()
    _finite(entry, ("ms_per_step", "tflops_per_sec"))
    assert out["mfu"] is None and entry["mfu"] is None
    assert setup.state.step == 2                  # warm-up and one timed
    assert out["flops_per_question"] == pytest.approx(
        flops.train_step_flops(setup.cfg, 1, 32, 128, 12))


@pytest.mark.parametrize("sampler", ["imle", "aimle", "simple"])
def test_bench_rows_of_the_other_samplers_on_cpu(cpu_setup, sampler):
    """``--full``'s rows: the inference row and the train-step row of each
    sampler on the gumbel setup's fixture, with the same FLOPs a question
    as the gumbel rows (a sampler adds no matrix product)."""
    setup = bench.for_sampler(cpu_setup, sampler)
    assert setup.bucket_batches is cpu_setup.bucket_batches
    assert (setup.aimle_states is not None) == (sampler == "aimle")
    out = bench.bench_inference(setup=setup)
    assert out["sampler"] == sampler
    _finite(out, ("qps_per_chip", "ms_per_batch", "tflops_per_sec"))
    gumbel = bench.bench_inference(setup=cpu_setup)
    assert out["flops_per_question"] == gumbel["flops_per_question"]
    tsetup = bench.for_sampler(cpu_setup, sampler, train=True)
    train = bench.bench_train_step(setup=tsetup)
    assert train["sampler"] == sampler and tsetup.state.step == 2
    _finite(train, ("train_qps_per_chip", "ms_per_step"))
    assert train["flops_per_question"] == pytest.approx(
        flops.train_step_flops(setup.cfg, 1, 32, 128, 12))


def test_multistep_row_reports_ms_per_step_at_the_single_steps_flops():
    """``bench_train_step(multistep=2)`` (the mirror of the JAX bench's
    ``test_multistep_flops_accounting_is_dispatch_invariant``): three
    groups of two distinct batches (one a warm-up), ms per step, and the
    FLOPs a question of the K = 1 row on the same fixture."""
    cfg = port_cfg(small_cfg(bucket_node_caps=(32,), encoder_layers=1,
                             decoder_layers=1, text_emb_dim=64, num_heads=4,
                             general_hidden_dim=32))
    setup = bench.build_bench_setup(cfg, num_batches=6, min_timed=5,
                                    device="cpu", train=True)
    one = bench.bench_train_step(setup=setup)
    two_setup = bench.for_sampler(setup, "gumbel", train=True)
    two = bench.bench_train_step(setup=two_setup, multistep=2)
    assert (one["multistep"], two["multistep"]) == (1, 2)
    assert two_setup.state.step == 6                 # 3 groups of 2
    _finite(two, ("train_qps_per_chip", "ms_per_step", "flops_per_question"))
    (entry,) = two["per_bucket"].values()
    assert two["ms_per_step"] == pytest.approx(entry["ms_per_step"])
    assert two["flops_per_question"] == pytest.approx(
        one["flops_per_question"], rel=1e-12)
    with pytest.raises(ValueError, match="fewer than 3 groups"):
        bench.bench_train_step(setup=two_setup, multistep=3)


def test_bench_raises_without_cuda(monkeypatch):
    """No fallback: without CUDA and without ``--device cpu`` the bench
    raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--batch-size", "4", "--iters", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.build_bench_setup(port_cfg(small_cfg()), num_batches=1)


def test_cached_weights_survive_inference_mode():
    """The bench runs its forwards under ``torch.inference_mode()``: the
    weight layouts the kernels' wrappers cache on first use
    (``ops/gemm.py:cached``) must stay ordinary tensors, whose version a
    later call can read, and are kept across calls."""
    from isubgvqa_tpu_torch.ops.gemm import cached

    w, bias = torch.randn(6, 4), torch.randn(6)
    make = lambda: torch.cat([w, bias[:, None]], 1)
    with torch.inference_mode():
        first = cached(w, "stacked", (bias,), make)
        assert not first.is_inference()
        assert cached(w, "stacked", (bias,), make) is first
        temp = torch.randn(3)               # made under the mode: not kept
        assert torch.equal(cached(temp, "k", (), lambda: 2 * temp), 2 * temp)
        assert "_isg_memo" not in temp.__dict__
    with torch.no_grad():
        assert cached(w, "stacked", (bias,), make) is first
        bias.add_(1.0)                      # an update makes it anew
    assert not torch.equal(cached(w, "stacked", (bias,), make), first)


def test_bench_explain_on_cpu():
    """The explain bench over a tiny GQA-mix dev set: every question
    counted once a pass, the median of the passes after the first."""
    out = bench.bench_explain(batch_size=4, dev_size=8, node_caps=(32,),
                              passes=1, device="cpu")
    assert out["device"] == "cpu" and out["questions"] == 8
    assert len(out["pass_seconds"]) == 1
    _finite(out, ("explain_qps_per_chip", "explain_qps_best"))
    assert out["explain_qps_best"] == pytest.approx(out["explain_qps_per_chip"])
