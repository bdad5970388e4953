"""Each model component timed alone at the bench's shapes (the port's
counterpart of ``scripts/profile_components.py``)::

    python -m isubgvqa_tpu_torch.profile_components [--bucket 32 32]
    python -m isubgvqa_tpu_torch.profile_components --device cpu \\
        --config tiny.json --bucket 32 12 --batch-size 4 --iters 2

An eval model of the config of record (bf16, gumbel, k = 3; ``--config``
a JSON base) and ``--iters + 1`` distinct batches of one bucket of the
bench's GQA-like fixture at B = 256.  Each component's inputs are the
outputs of the components before it on the same batch, computed
beforehand; the component then runs once on the first batch (a warm-up)
and on the other ``--iters`` between two CUDA events (the host's clock on
the CPU).  Rows: the question encoder with its token and position
tables, the program decoder, the scene-graph encoder, the masked GAT
stack with its sampler, the pooling; ms a call each.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, List

import torch


def time_calls(fn: Callable, inputs: List[tuple],
               device: torch.device) -> float:
    """ms a call of ``fn(*args)`` over ``inputs[1:]`` after a warm-up on
    ``inputs[0]``."""
    with torch.inference_mode():
        fn(*inputs[0])
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for args in inputs[1:]:
                fn(*args)
            end.record()
            end.synchronize()
            total = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for args in inputs[1:]:
                fn(*args)
            total = (time.perf_counter() - t0) * 1e3
    return total / max(len(inputs) - 1, 1)


def run(cfg, bucket, iters: int = 16, device=None, setup=None) -> dict:
    """The five rows for ``iters`` distinct batches of ``bucket``."""
    from . import bench

    if setup is None:
        setup = bench.build_bench_setup(cfg, num_batches=iters + 1,
                                        min_timed=iters, device=device)
    model, dev = setup.model, setup.device
    key = tuple(bucket)
    batches = [b.to(dev) for b in setup.bucket_batches[key][:iters + 1]]
    dt = model.compute_dtype
    gen = torch.Generator(device=dev).manual_seed(0)
    stages = []
    with torch.inference_mode():
        for b in batches:
            x = model.text_vocab_embedding(b.qst_tokens, dt)
            enc = model.question_encoder(x, b.qst_mask)
            feats = model.program_decoder(enc)
            lang = model.qsts_reduction(feats.reshape(feats.shape[0], -1), dt)
            instr = model.instr_reduction(feats, dt)
            x_enc, e_enc = model.scene_graph_encoder(b, dt)
            h, node_mask, _, _ = model.gat_seq(
                x_enc, b, e_enc, instr, lang, gen, None, dt, False,
                setup.aimle_states)
            stages.append(dict(b=b, enc=enc, lang=lang, instr=instr,
                               x_enc=x_enc, e_enc=e_enc, h=h,
                               node_mask=node_mask))
    cfg = setup.cfg
    rows = [
        (f"question_encoder ({cfg.encoder_layers}L, {cfg.text_emb_dim})",
         lambda s: model.question_encoder(
             model.text_vocab_embedding(s["b"].qst_tokens, dt),
             s["b"].qst_mask)),
        (f"program_decoder ({cfg.decoder_layers}L)",
         lambda s: model.program_decoder(s["enc"])),
        ("scene_graph_encoder",
         lambda s: model.scene_graph_encoder(s["b"], dt)),
        (f"MGAT x{cfg.mgat_layers} (incl sampler)",
         lambda s: model.gat_seq(s["x_enc"], s["b"], s["e_enc"], s["instr"],
                                 s["lang"], gen, None, dt, False,
                                 setup.aimle_states)),
        ("global_attention_pooling",
         lambda s: model.graph_global_attention_pooling(
             s["h"], s["lang"], s["b"].node_mask, s["node_mask"], dt)),
    ]
    out = {"bucket": list(key), "batch_size": cfg.batch_size,
           "dtype": cfg.compute_dtype, "device": str(dev),
           "iters": len(batches) - 1, "timer": "CUDA events"
           if dev.type == "cuda" else "host clock", "rows": []}
    for label, fn in rows:
        ms = time_calls(fn, [(s,) for s in stages], dev)
        out["rows"].append({"component": label, "ms": ms})
    return out


def main(argv=None) -> dict:
    from . import bench
    from .config import Config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bucket", type=int, nargs=2, default=[32, 32],
                    metavar=("NODE_CAP", "QLEN"))
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--iters", type=int, default=16,
                    help="distinct batches timed after the warm-up")
    ap.add_argument("--config", default=None,
                    help="a JSON Config as the base (default: the bench's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.config:
        with open(args.config) as f:
            cfg = dataclasses.replace(Config.from_json(f.read()),
                                      batch_size=args.batch_size,
                                      sampler_type="gumbel", sample_k=3)
    else:
        cfg = bench._cfg("gumbel", args.batch_size, "bfloat16")
    out = run(cfg, args.bucket, args.iters, args.device)
    print(f"shapes: B={out['batch_size']} bucket {tuple(out['bucket'])} "
          f"{out['dtype']} on {out['device']} ({out['timer']}, "
          f"{out['iters']} distinct batches)")
    for row in out["rows"]:
        print(f"{row['component']:38s} {row['ms']:8.3f} ms", flush=True)
    print(json.dumps(out), file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
