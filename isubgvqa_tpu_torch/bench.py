"""Bench of the port: batched GQA inference, the end-to-end eval
pipeline and the training step, in questions per second on one card.

    python -m isubgvqa_tpu_torch.bench [--full] [--e2e] [--explain] [--device cpu]

The port of the JAX package's root ``bench.py``, by the same method:

* the fixture is the GQA-like heavy-tailed size mix
  (``SyntheticGQA(shape_mix="gqa")``), routed into the size buckets
  (node caps 16/32/64/128 x question caps 16/32) by
  :func:`~isubgvqa_tpu_torch.data.route_to_buckets`, the rule the
  iterators use;
* every bucket is timed on its own stream of distinct full batches
  drawn from a generator seeded per bucket (``[0xB37C4, *key]``, the
  JAX bench's draws, so the same sample indices land in each batch);
* time per batch is the wall time of chunks of 5 batches ending in a
  ``torch.cuda.synchronize()``, the median over chunks, after one
  warm-up batch;
* the headline blends the buckets' time per question by their share of
  the sample mix;
* FLOPs are the model's matrix products at the batch's padded shapes
  (:func:`~isubgvqa_tpu_torch.ops.flops.forward_flops`), the same
  number whatever computes them; MFU divides their rate by the card's
  data-sheet peak for the compute dtype
  (:data:`~isubgvqa_tpu_torch.ops.flops.PEAK_FLOPS`), and a reading
  above 95 % of it is timed again and the slower kept.  Off the card
  MFU and the peak are ``null``.

Prints the per-bucket breakdown as JSON lines on stderr and one JSON
line on stdout; each row names the collate fill of its fixture
(``fill``: ``native``, the C++ fill into pinned memory, or ``python``
under ``ISUBGVQA_NATIVE=0``).  ``--e2e`` adds the end-to-end pipeline
(bucketed iterator, collate, :func:`~isubgvqa_tpu_torch.data.prefetch`
to the card, forward); ``--explain`` adds explanation extraction end to end
(:func:`bench_explain`, its rates also in the stdout line); ``--full``
adds those, the inference rows of the imle, aimle and simple samplers,
the training step of all four and a gumbel training row through the
multistep path (``--train-multistep``, K = 8: ``(multistep 8)``), as
the root ``bench.py --full`` does.  On a
CUDA device the fused layers run their CUDA kernels; without CUDA the
bench raises unless ``--device cpu`` asks for the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import sys
import time
from typing import Optional

import numpy as np
import torch

from .config import Config
from .data import (AnswerMap, HashWordTokenizer, SceneGraphVocab,
                   SyntheticGQA, build_bucket_collators,
                   iterate_batches_bucketed, prefetch, route_to_buckets)
from .models.build import build_model, make_aimle_states, resolve_device
from .ops.flops import (batch_shape, forward_flops, peak_flops,
                        train_step_flops)
from .train import (create_train_state, make_multistep_train_step,
                    make_train_step)

NODE_CAPS = (16, 32, 64, 128)
CHUNK = 5                     # batches a timed chunk
IMPOSSIBLE = 0.95             # of the peak: a reading above it is re-timed
_clock = time.perf_counter


def _cfg(sampler: str, batch_size: int, dtype: str,
         node_caps=NODE_CAPS) -> Config:
    return Config(batch_size=batch_size, compute_dtype=dtype,
                  sampler_type=sampler, sample_k=3, question_len=32,
                  max_nodes_per_graph=128, max_edges_per_graph=384,
                  bucket_node_caps=tuple(node_caps))


def build_bucket_streams(ds, collators, batch_size: int, min_timed: int = 4):
    """Per-bucket streams of pairwise-distinct full batches.

    Routing is :func:`route_to_buckets`.  Each batch draws a fresh
    composition from a generator seeded per bucket, without replacement
    where the bucket has a batch of members and with replacement where it
    has fewer, redrawn on a repeated index tuple.  A bucket gets
    ``max(min_timed + 1, ceil(members / batch_size))`` batches, the first
    a warm-up.  Returns ``(bucket_batches: key -> [GraphBatch],
    bucket_weight: key -> share of the sample mix)``."""
    per_bucket = route_to_buckets(ds, collators)
    b = batch_size
    n_total = sum(len(m) for m in per_bucket.values())
    bucket_batches, bucket_weight = {}, {}
    for key, members in per_bucket.items():
        if not members:
            continue
        bucket_weight[key] = len(members) / n_total
        n_need = max(min_timed + 1, math.ceil(len(members) / b))
        gen = np.random.default_rng(
            [0xB37C4] + [int(v) for v in np.atleast_1d(key)])
        batches, seen = [], set()
        for _ in range(n_need):
            for _ in range(16):
                if len(members) >= b:
                    idx = gen.permutation(len(members))[:b]
                else:
                    idx = gen.integers(0, len(members), size=b)
                t = tuple(idx.tolist())
                if t not in seen or len(members) == 1:
                    seen.add(t)
                    break
            batch, _ = collators[key].collate([ds[members[j]] for j in idx])
            batches.append(batch)
        bucket_batches[key] = batches
    return bucket_batches, bucket_weight


@dataclasses.dataclass
class BenchSetup:
    cfg: Config
    vocab: SceneGraphVocab
    ds: SyntheticGQA
    collators: dict
    bucket_batches: dict          # key -> [GraphBatch] on the host
    bucket_weight: dict           # key -> share of the sample mix
    device: torch.device
    model: Optional[torch.nn.Module] = None   # the eval model
    state: Optional[object] = None            # the train state
    aimle_states: Optional[dict] = None       # the eval model's (aimle)


def build_bench_setup(cfg: Config, num_batches: int = 12, min_timed: int = 4,
                      device=None, train: bool = False) -> BenchSetup:
    """The GQA-like fixture of ``cfg.batch_size * num_batches`` samples,
    its bucket collators and streams, and on ``device`` (the card unless
    the caller asks for another) an eval model, or with ``train`` a train
    state, from ``cfg.seed``."""
    dev = resolve_device(device)
    vocab = SceneGraphVocab.build(cfg.meta_dir, glove_path=cfg.glove_path,
                                  seed=cfg.seed)
    answers = AnswerMap.build(cfg.meta_dir, cfg.num_answers)
    ds = SyntheticGQA(vocab, answers, size=cfg.batch_size * num_batches,
                      seed=0, shape_mix="gqa")
    tok = HashWordTokenizer(vocab_size=cfg.text_vocab_size,
                            max_len=cfg.question_len)
    collators = build_bucket_collators(cfg, tok, vocab,
                                       batch_size=cfg.batch_size,
                                       pin_memory=dev.type == "cuda")
    bucket_batches, bucket_weight = build_bucket_streams(
        ds, collators, cfg.batch_size, min_timed)
    cfg = dataclasses.replace(cfg, num_answers=len(answers))
    setup = BenchSetup(cfg, vocab, ds, collators, bucket_batches,
                       bucket_weight, dev)
    return for_sampler(setup, cfg.sampler_type, train)


def for_sampler(setup: BenchSetup, sampler: str,
                train: bool = False) -> BenchSetup:
    """``setup``'s fixture and streams with an eval model (or with
    ``train`` a train state) of ``sampler``, from ``cfg.seed``: the
    samplers add no parameters, so every sampler gets the same
    weights."""
    cfg = dataclasses.replace(setup.cfg, sampler_type=sampler)
    setup = dataclasses.replace(setup, cfg=cfg, model=None, state=None,
                                aimle_states=None)
    if train:
        setup.state = create_train_state(cfg, setup.vocab, steps_per_epoch=8,
                                         device=setup.device)
    else:
        setup.model = build_model(cfg, setup.vocab, setup.device)
        setup.aimle_states = make_aimle_states(cfg, setup.device)
    return setup


def fill_name(collators) -> str:
    """Which collate fill ``collators`` run: ``native`` (the C++ fill)
    or ``python`` (``ISUBGVQA_NATIVE=0``)."""
    return ("native" if all(c.native for c in collators.values())
            else "python")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stream_is_distinct(batches) -> bool:
    """True iff the batches are pairwise-distinct inputs."""
    digests = set()
    for b in batches:
        h = hashlib.sha1()
        for t in (b.node_tokens, b.qst_tokens, b.edge_src):
            h.update(t.cpu().numpy().tobytes())
        digests.add(h.hexdigest())
    return len(digests) == len(batches)


def _time_stream(run_one, batches, device: torch.device) -> float:
    """Median ms a batch over chunks of :data:`CHUNK` batches, each ended
    by a synchronize; the first batch is a warm-up, not timed."""
    run_one(batches[0])
    _sync(device)
    timed = batches[1:]
    chunk_ms = []
    for i in range(0, len(timed), CHUNK):
        chunk = timed[i:i + CHUNK]
        t0 = _clock()
        for b in chunk:
            run_one(b)
        _sync(device)
        chunk_ms.append((_clock() - t0) / len(chunk) * 1e3)
    return float(np.median(chunk_ms))


def _rate_impossible(ms: float, flops_per_batch: float,
                     peak_flops: float) -> bool:
    """True when ``flops_per_batch`` in ``ms`` would run above
    :data:`IMPOSSIBLE` of the card's peak."""
    if not flops_per_batch or ms <= 0:
        return False
    return flops_per_batch / (ms / 1e3) > IMPOSSIBLE * peak_flops


def _time_stream_checked(run_one, batches, flops_per_batch: float,
                         peak_flops: Optional[float],
                         device: torch.device) -> tuple:
    """:func:`_time_stream`, timed once more if the reading implies a rate
    above :data:`IMPOSSIBLE` of the peak (no check without a peak);
    keeps the slower reading.  Returns ``(ms, retimed)``."""
    ms = _time_stream(run_one, batches, device)
    if peak_flops and _rate_impossible(ms, flops_per_batch, peak_flops):
        return max(ms, _time_stream(run_one, batches, device)), True
    return ms, False


def _peak(cfg: Config, device: torch.device) -> Optional[float]:
    """The card's data-sheet peak for the compute dtype; none off the
    card, where a share of the H100's peak means nothing."""
    return peak_flops(cfg.compute_dtype) if device.type == "cuda" else None


def _mfu(rate: float, peak: Optional[float]) -> Optional[float]:
    return rate / peak if peak else None


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def bench_inference(sampler: str = "gumbel", batch_size: int = 2048,
                    iters: int = 12, dtype: str = "bfloat16",
                    node_caps=NODE_CAPS, device=None,
                    setup: Optional[BenchSetup] = None) -> dict:
    """Questions per second per bucket and blended, ms per batch,
    TFLOP/s and MFU of the eval forward (logits and the sampled node
    mask) under ``torch.inference_mode()``, the sampler's noise from one
    explicit generator.  ``setup`` reuses a :func:`build_bench_setup`
    (eval).  The FLOPs are the model's matrix products, which no sampler
    adds to (:mod:`~isubgvqa_tpu_torch.ops.flops`), so every sampler's
    row divides by the same count."""
    if setup is None:
        setup = build_bench_setup(_cfg(sampler, batch_size, dtype, node_caps),
                                  iters, device=device)
    cfg, dev, model = setup.cfg, setup.device, setup.model
    peak = _peak(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def run_one(batch):
        with torch.inference_mode():
            out = model(batch, generator=gen,
                        aimle_states=setup.aimle_states)
        return out.logits, out.node_mask

    per_bucket = {}
    blended_t_q = blended_flops_q = small_frac = 0.0
    for key in sorted(setup.bucket_batches):
        host = setup.bucket_batches[key]
        batches = [b.to(dev) for b in host]
        flops = forward_flops(cfg, *batch_shape(batches[0]))
        ms, retimed = _time_stream_checked(run_one, batches, flops, peak, dev)
        w = setup.bucket_weight[key]
        blended_t_q += w * (ms / 1e3) / cfg.batch_size
        blended_flops_q += w * flops / cfg.batch_size
        if key[0] < cfg.max_nodes_per_graph:
            small_frac += w
        entry = {
            "ms_per_batch": ms,
            "qps": cfg.batch_size / (ms / 1e3),
            "weight": w,
            "batches_timed": len(batches) - 1,
            "tflops_per_sec": flops / (ms / 1e3) / 1e12,
            "mfu": _mfu(flops / (ms / 1e3), peak),
        }
        if retimed:
            entry["retimed"] = True
        if not _stream_is_distinct(host[1:]):
            entry["distinct_inputs"] = False
        per_bucket[str(key)] = entry
        del batches
    return {
        "sampler": cfg.sampler_type,
        "fill": fill_name(setup.collators),
        "device": _device_name(dev),
        "dtype": cfg.compute_dtype,
        "batch_size": cfg.batch_size,
        "qps_per_chip": 1.0 / blended_t_q,
        "ms_per_batch": blended_t_q * cfg.batch_size * 1e3,
        "small_bucket_frac": small_frac,
        "flops_per_question": blended_flops_q,
        "tflops_per_sec": blended_flops_q / blended_t_q / 1e12,
        "mfu": _mfu(blended_flops_q / blended_t_q, peak),
        "peak_tflops": peak and peak / 1e12,
        "per_bucket": per_bucket,
    }


def bench_e2e(sampler: str = "gumbel", batch_size: int = 2048,
              iters: int = 12, dtype: str = "bfloat16", node_caps=NODE_CAPS,
              epochs: int = 3, device=None,
              setup: Optional[BenchSetup] = None) -> dict:
    """End-to-end eval pipeline: the bucketed iterator (shuffled, grouped
    by bucket) collating with the setup's fill, :func:`prefetch` (depth 3)
    copying to the card, and the forward with at most 4 batches in flight,
    over a full epoch of the fixture; questions per second over the
    epoch's real samples, the median of ``epochs`` epochs, after one
    forward per bucket as a warm-up."""
    if setup is None:
        setup = build_bench_setup(_cfg(sampler, batch_size, dtype, node_caps),
                                  iters, device=device)
    cfg, dev, model = setup.cfg, setup.device, setup.model
    gen = torch.Generator(device=dev).manual_seed(0)

    def forward(batch):
        with torch.inference_mode():
            out = model(batch, generator=gen,
                        aimle_states=setup.aimle_states)
        return out.logits, out.node_mask

    for batches in setup.bucket_batches.values():
        forward(batches[0].to(dev))
    _sync(dev)
    epoch_s, n_questions = [], 0
    for ep in range(epochs):
        it = prefetch(iterate_batches_bucketed(
            setup.ds, setup.collators, shuffle=True, seed=100 + ep,
            drop_last=False, group_by_bucket=True), depth=3, device=dev)
        in_flight, n_q = [], 0
        t0 = _clock()
        for batch, meta in it:
            forward(batch)
            n_q += meta.num_real
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record()
                in_flight.append(done)
                if len(in_flight) > 4:        # bounded pipelined dispatch
                    in_flight.pop(0).synchronize()
        _sync(dev)
        epoch_s.append(_clock() - t0)
        n_questions = n_q
    sec = float(np.median(epoch_s))
    return {
        "sampler": cfg.sampler_type,
        "fill": fill_name(setup.collators),
        "device": _device_name(dev),
        "e2e_qps_per_chip": n_questions / sec,
        "e2e_qps_best": n_questions / float(np.min(epoch_s)),
        "questions_per_epoch": n_questions,
        "epoch_seconds": epoch_s,
    }


def bench_train_step(sampler: str = "gumbel", batch_size: int = 256,
                     iters: int = 8, dtype: str = "bfloat16",
                     node_caps=NODE_CAPS, device=None,
                     setup: Optional[BenchSetup] = None,
                     multistep: int = 1) -> dict:
    """The full training step (forward, backward, clip and Adam) of the
    port's ``make_train_step`` on ``create_train_state``, ms per step and
    training questions per second per bucket and blended by the bucket
    mix, TFLOP/s and MFU of the step's products.  ``setup`` reuses a
    :func:`build_bench_setup` with ``train``.  The FLOPs are the step's
    matrix products, which no sampler adds to (a sampler's backward makes
    none), so every sampler's row divides by the same count.

    ``multistep = K > 1`` times the Trainer's multistep path
    (:func:`~.train.make_multistep_train_step`: K same-bucket batches a
    dispatch, one CUDA graph replay on the card): each bucket's stream
    is cut into groups of K distinct batches, at least 3 (the first a
    warm-up, which captures), and a group's time over K is the ms per
    step.  The FLOPs are still the single step's, so FLOPs per question
    do not depend on K."""
    k = max(int(multistep), 1)
    if setup is None:
        setup = build_bench_setup(_cfg(sampler, batch_size, dtype, node_caps),
                                  max(iters, 3 * k),
                                  min_timed=3 * k - 1 if k > 1 else 4,
                                  device=device, train=True)
    cfg, dev, state = setup.cfg, setup.device, setup.state
    peak = _peak(cfg, dev)
    step = (make_multistep_train_step if k > 1 else make_train_step)(
        state.model, state.optimizer, cfg)

    def run_one(unit):
        return step(state, unit)[1]

    blended_t_q = blended_flops_q = 0.0
    per_bucket = {}
    for key in sorted(setup.bucket_batches):
        host = setup.bucket_batches[key]
        batches = [b.to(dev) for b in host]
        flops = train_step_flops(cfg, *batch_shape(batches[0]))
        units = batches
        if k > 1:
            if len(batches) < 3 * k:
                raise ValueError(f"multistep {k}: bucket {key} has "
                                 f"{len(batches)} batches, fewer than 3 "
                                 f"groups")
            units = [batches[i:i + k]
                     for i in range(0, len(batches) - k + 1, k)]
        ms, retimed = _time_stream_checked(run_one, units, flops * k, peak,
                                           dev)
        ms /= k
        w = setup.bucket_weight[key]
        blended_t_q += w * (ms / 1e3) / cfg.batch_size
        blended_flops_q += w * flops / cfg.batch_size
        entry = {"ms_per_step": ms, "weight": w,
                 "tflops_per_sec": flops / (ms / 1e3) / 1e12,
                 "mfu": _mfu(flops / (ms / 1e3), peak)}
        if retimed:
            entry["retimed"] = True
        if not _stream_is_distinct(host[1:]):
            entry["distinct_inputs"] = False
        per_bucket[str(key)] = entry
        del batches
    return {
        "sampler": cfg.sampler_type,
        "fill": fill_name(setup.collators),
        "device": _device_name(dev),
        "dtype": cfg.compute_dtype,
        "batch_size": cfg.batch_size,
        "multistep": k,
        "train_qps_per_chip": 1.0 / blended_t_q,
        "ms_per_step": blended_t_q * cfg.batch_size * 1e3,
        "flops_per_question": blended_flops_q,
        "tflops_per_sec": blended_flops_q / blended_t_q / 1e12,
        "mfu": _mfu(blended_flops_q / blended_t_q, peak),
        "per_bucket": per_bucket,
    }


def bench_explain(sampler: str = "gumbel", batch_size: int = 2048,
                  dtype: str = "bfloat16", node_caps=NODE_CAPS,
                  dev_size: int = 20480, passes: int = 3,
                  device=None) -> dict:
    """Explanation extraction end to end (the root ``bench.py``'s
    ``bench_explain``): the real
    :func:`~isubgvqa_tpu_torch.explain.run_token_coo_exp` (the bucketed
    iterator, the Python collate, :func:`prefetch` to the card, the
    forward with the argmax on the card and the vectorized host metric
    pass) over a GQA-mix synthetic dev set of ``dev_size`` questions at
    batch ``batch_size``; questions per second over a pass, the median of
    ``passes`` passes after a first pass that is discarded.  Each pass
    draws other noise (seed ``1000 + pass``)."""
    import contextlib
    import io

    from .data import build_datasets
    from .explain import run_token_coo_exp

    dev = resolve_device(device)
    cfg = dataclasses.replace(
        _cfg(sampler, batch_size, dtype, node_caps), synthetic=True,
        synthetic_size=dev_size * 4, synthetic_shape_mix="gqa",
        eval_batch_factor=1)          # eval batches at the benched size
    data = build_datasets(cfg, pin_memory=dev.type == "cuda")
    cfg = dataclasses.replace(cfg, num_answers=len(data.answers))
    model = build_model(cfg, data.vocab, dev)
    aimle_states = make_aimle_states(cfg, dev)
    n, times = 0, []
    for p in range(passes + 1):
        t0 = _clock()
        with contextlib.redirect_stdout(io.StringIO()):
            res = run_token_coo_exp(model, data, cfg, split="dev",
                                    seed=1000 + p, aimle_states=aimle_states)
        _sync(dev)
        dt = _clock() - t0
        n = res.num_samples
        if p > 0:                    # pass 0: the caches and a warm-up
            times.append(dt)
    sec = float(np.median(times))
    return {
        "sampler": cfg.sampler_type,
        "fill": fill_name(data.bucket_collators["dev"]),
        "device": _device_name(dev),
        "batch_size": cfg.batch_size,
        "explain_qps_per_chip": n / sec,
        "explain_qps_best": n / float(np.min(times)),
        "questions": n,
        "pass_seconds": times,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="also the end-to-end pipeline, the inference rows "
                         "of imle, aimle and simple, and the training step "
                         "of all four samplers")
    ap.add_argument("--e2e", action="store_true",
                    help="also the end-to-end pipeline")
    ap.add_argument("--explain", action="store_true",
                    help="also explanation extraction end to end")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=22,
                    help="fixture size in batches")
    ap.add_argument("--node-caps", type=int, nargs="+", default=NODE_CAPS)
    ap.add_argument("--train-batch", type=int, default=256)
    ap.add_argument("--train-multistep", type=int, default=8,
                    help="K of --full's extra gumbel train-step row "
                         "through the multistep path (K updates a "
                         "dispatch, one CUDA graph replay); 1 leaves "
                         "the row out")
    args = ap.parse_args(argv)

    cfg = _cfg("gumbel", args.batch_size, "bfloat16", args.node_caps)
    setup = build_bench_setup(cfg, args.iters, device=args.device)
    head = bench_inference(setup=setup)
    print(json.dumps(head), file=sys.stderr)
    if args.e2e or args.full:
        print(json.dumps(bench_e2e(setup=setup)), file=sys.stderr)
    if args.full:
        for sampler in ("imle", "aimle", "simple"):
            print(json.dumps(bench_inference(
                setup=for_sampler(setup, sampler))), file=sys.stderr)
        tsetup = build_bench_setup(
            _cfg("gumbel", args.train_batch, "bfloat16", args.node_caps), 8,
            device=args.device, train=True)
        for sampler in ("gumbel", "imle", "aimle", "simple"):
            print(json.dumps(bench_train_step(
                setup=for_sampler(tsetup, sampler, train=True))),
                file=sys.stderr)
        del tsetup
        if args.train_multistep > 1:
            print(json.dumps(bench_train_step(
                "gumbel", args.train_batch, node_caps=args.node_caps,
                device=args.device, multistep=args.train_multistep)),
                file=sys.stderr)
    explain = {}
    if args.explain or args.full:
        row = bench_explain(batch_size=args.batch_size,
                            node_caps=args.node_caps, device=args.device)
        print(json.dumps(row), file=sys.stderr)
        explain = {k: row[k] for k in ("explain_qps_per_chip",
                                       "explain_qps_best")}
    print(json.dumps({
        "metric": "GQA questions/sec/chip (batched inference, ISubGVQA "
                  "forward + discrete subgraph extraction, GQA-realistic "
                  "heavy-tailed size mix, bucket-blended)",
        "value": head["qps_per_chip"],
        "unit": "questions/sec/chip",
        "device": head["device"],
        "batch_size": args.batch_size,
        **explain,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
