"""Host collation: the native C++ fill against the Python fill (the
port's counterpart of ``scripts/bench_host_collate.py``)::

    python -m isubgvqa_tpu_torch.bench_host_collate [--batch-size 2048]

The samples a second of dense-batch assembly at the bench's batch size, per
bucket (node caps 16, 32, 64 and 128 by question lengths 16 and 32), on
the GQA-like synthetic mix of ``4 x --batch-size`` samples.  Each
bucket's batch repeats its members up to the batch size; each fill
collates it once to warm up, then ``--reps`` times on the clock.  The
native fill is the bucket collators' own (``isubgvqa_tpu_torch/native``,
built on first use); the Python fill is a collator of the same spec
without the packed store, the one ``ISUBGVQA_NATIVE=0`` selects.  Host
only: no card is touched.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time


def run(batch_size: int = 2048, reps: int = 10, cfg=None,
        size: int = 0) -> dict:
    """``{"batch_size", "buckets": {key: {"native": ..., "python": ...,
    "speedup"}}}`` for every bucket with 8 or more members of a fixture
    of ``size`` samples (default ``4 x batch_size``)."""
    from .config import Config
    from .data import (AnswerMap, Collator, HashWordTokenizer,
                       SceneGraphVocab, SyntheticGQA)
    from .data.batching import route_to_buckets
    from .data.build import build_bucket_collators

    cfg = cfg or Config(batch_size=batch_size, question_len=32,
                        bucket_node_caps=(16, 32, 64, 128),
                        bucket_question_lens=(16, 32))
    vocab = SceneGraphVocab.build(cfg.meta_dir, seed=cfg.seed)
    answers = AnswerMap.build(cfg.meta_dir, cfg.num_answers)
    ds = SyntheticGQA(vocab, answers, size=size or batch_size * 4, seed=0,
                      shape_mix="gqa")
    tok = HashWordTokenizer(vocab_size=cfg.text_vocab_size,
                            max_len=cfg.question_len)
    colls = build_bucket_collators(cfg, tok, vocab, batch_size=batch_size)
    if not all(c.native for c in colls.values()):
        raise RuntimeError("the native fill is off (ISUBGVQA_NATIVE=0): "
                           "nothing to compare the Python fill with")
    out = {"batch_size": batch_size, "reps": reps, "buckets": {}}
    for key, members in sorted(route_to_buckets(ds, colls).items()):
        if len(members) < 8:
            continue
        idx = (members * (batch_size // len(members) + 1))[:batch_size]
        samples = [ds[j] for j in idx]
        nat = colls[key]
        py = Collator(nat.tokenizer, nat.spec, vocab=vocab)
        row = {}
        for label, coll in (("native", nat), ("python", py)):
            coll.collate(samples)          # warm the caches and the store
            t0 = time.perf_counter()
            for _ in range(reps):
                coll.collate(samples)
            dt = (time.perf_counter() - t0) / reps
            row[label] = {"ms_per_batch": dt * 1e3,
                          "samples_per_sec": len(samples) / dt}
        row["speedup"] = (row["python"]["ms_per_batch"]
                          / row["native"]["ms_per_batch"])
        out["buckets"][str(key)] = row
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    out = run(args.batch_size, args.reps)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
