"""Device time by kernel over a profiled stream of one size bucket (the
port's counterpart of ``scripts/profile_breakdown.py``)::

    python -m isubgvqa_tpu_torch.profile_breakdown --bucket 128 32 \\
        --batch-size 2048 --group
    python -m isubgvqa_tpu_torch.profile_breakdown --train --batch-size 256
    python -m isubgvqa_tpu_torch.profile_breakdown --device cpu \\
        --config tiny.json --bucket 32 12 --batch-size 4 --iters 2

The bench's GQA-like fixture (:func:`~isubgvqa_tpu_torch.bench.
build_bench_setup`) gives the bucket ``--iters + 1`` distinct batches.
The eval forward (``--train``: the train step) runs the first as a
warm-up, then the other ``--iters`` under ``torch.profiler``.  On the card
each CUDA kernel's device time is summed by name (``--group``: by the
port's kernel families, :data:`KERNEL_FAMILIES`, the rest as ``other
(PyTorch)``); with ``--device cpu`` each CPU operator's self time.  The
table gives each row's time a batch, its share of the summed time (the
shares add to 100 %) and its calls a batch, then the busy share: the
summed time over the profiled window's wall time.  ``--trace-dir`` keeps
the Chrome trace.  ``--config`` is a JSON base (the bench's config of
record by default); ``--sampler`` and ``--batch-size`` apply over it.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import sys
import time
from typing import Dict, Optional

import torch

# the port's kernels by name, the most specific first
KERNEL_FAMILIES = ("gemm_any", "gemm_bwd", "gemm_sm90", "gemm_gather",
                   "gemm", "reduce_rows", "colsum",
                   "gat_edge_bwd", "gat_edge", "graph_norm_bwd", "graph_norm",
                   "graph_index",
                   "attention_bwd", "attention_mma", "attention", "ln_bwd",
                   "residual_ln",
                   "relu_bwd", "scatter_mean_bwd", "scatter_mean",
                   "scatter_rows", "instr_gelu")
OTHER = "other (PyTorch)"


def kernel_family(name: str) -> str:
    """The port's kernel family a kernel's name belongs to, else
    :data:`OTHER`."""
    return next((k for k in KERNEL_FAMILIES if k in name), OTHER)


def op_times(prof, cuda: bool) -> Dict[str, list]:
    """``{name: [us, calls]}`` of a finished ``torch.profiler`` run: each
    CUDA kernel's device time, or (``cuda`` false) each CPU operator's
    self time."""
    out: Dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    if cuda:
        for ev in prof.events():
            if str(getattr(ev, "device_type", "")).endswith("CUDA") \
                    and ev.device_time_total > 0:
                out[ev.name][0] += ev.device_time_total
                out[ev.name][1] += 1
    else:
        for ev in prof.key_averages():
            if ev.self_cpu_time_total > 0:
                out[ev.key][0] += ev.self_cpu_time_total
                out[ev.key][1] += ev.count
    return dict(out)


def profile_stream(run_one, batches, device: torch.device,
                   trace_dir: Optional[str] = None):
    """``run_one`` on each batch under ``torch.profiler`` (CUDA activity
    on the card); returns ``(op_times, wall_us)``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for b in batches:
            run_one(b)
        if cuda:
            torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"breakdown-{os.getpid()}-{time.time_ns()}.json"))
    return op_times(prof, cuda), wall_us


def breakdown(times: Dict[str, list], wall_us: float, n: int,
              group: bool = False) -> dict:
    """Rows ``(name, us a batch, share in %, calls a batch)`` by time,
    the summed time a batch and the busy share of the window."""
    if group:
        grouped: Dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
        for name, (us, calls) in times.items():
            grouped[kernel_family(name)][0] += us
            grouped[kernel_family(name)][1] += calls
        times = dict(grouped)
    total = sum(us for us, _ in times.values())
    rows = [(name, us / n, 100.0 * us / total if total else 0.0, calls / n)
            for name, (us, calls) in sorted(times.items(),
                                            key=lambda kv: -kv[1][0])]
    return {"rows": rows, "busy_us_per_batch": total / n,
            "wall_us_per_batch": wall_us / n,
            "busy_share": total / wall_us if wall_us else None,
            "batches": n}


def run(cfg, bucket, train: bool = False, iters: int = 8,
        group: bool = False, device=None, trace_dir: Optional[str] = None,
        setup=None) -> dict:
    """Profile ``iters`` distinct batches of ``bucket`` (a ``(node cap,
    question len)`` key of the bench's buckets) through the eval forward,
    or with ``train`` the train step, of ``cfg``.  ``setup`` reuses a
    :func:`~isubgvqa_tpu_torch.bench.build_bench_setup` (with ``train``
    when ``train``)."""
    from . import bench
    from .train import make_train_step

    if setup is None:
        setup = bench.build_bench_setup(cfg, num_batches=iters + 1,
                                        min_timed=iters, device=device,
                                        train=train)
    key = tuple(bucket)
    if key not in setup.bucket_batches:
        raise SystemExit(f"bucket {key} not in "
                         f"{sorted(setup.bucket_batches)}")
    dev = setup.device
    batches = [b.to(dev) for b in setup.bucket_batches[key][:iters + 1]]
    if train:
        state = setup.state
        step = make_train_step(state.model, state.optimizer, setup.cfg)

        def run_one(b):
            return step(state, b)[1]
    else:
        gen = torch.Generator(device=dev).manual_seed(0)

        def run_one(b):
            with torch.inference_mode():
                return setup.model(b, generator=gen)

    run_one(batches[0])                       # warm-up, before the trace
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    times, wall_us = profile_stream(run_one, batches[1:], dev, trace_dir)
    out = breakdown(times, wall_us, len(batches) - 1, group)
    out.update(bucket=list(key), train=train, device=str(dev),
               batch_size=setup.cfg.batch_size,
               sampler=setup.cfg.sampler_type,
               measures="CUDA kernel device time" if dev.type == "cuda"
               else "CPU operator self time")
    return out


def format_table(out: dict, top: int = 30) -> str:
    n = out["batches"]
    lines = [f"{out['measures']}: {out['busy_us_per_batch'] / 1e3:.3f} "
             f"ms/batch of {out['wall_us_per_batch'] / 1e3:.3f} ms wall "
             f"(busy share {out['busy_share']:.1%}, {n} batches)",
             f"{'us/batch':>10}  {'%':>6}  {'calls':>7}  op"]
    shown = out["rows"][:top]
    for name, us, share, calls in shown:
        lines.append(f"{us:10.1f}  {share:6.2f}  {calls:7.1f}  {name[:90]}")
    rest = out["rows"][top:]
    if rest:
        lines.append(f"{sum(r[1] for r in rest):10.1f}  "
                     f"{sum(r[2] for r in rest):6.2f}  {'':7}  (rest)")
    return "\n".join(lines)


def main(argv=None) -> dict:
    from . import bench
    from .config import Config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bucket", type=int, nargs=2, default=[16, 16],
                    metavar=("NODE_CAP", "QLEN"),
                    help="size bucket to profile (node cap, question len)")
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--train", action="store_true",
                    help="profile the training step instead of inference")
    ap.add_argument("--sampler", default="gumbel")
    ap.add_argument("--iters", type=int, default=8,
                    help="distinct batches to run under the trace")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--group", action="store_true",
                    help="aggregate kernels by the port's kernel family")
    ap.add_argument("--trace-dir", default=None,
                    help="keep the Chrome trace here")
    ap.add_argument("--config", default=None,
                    help="a JSON Config as the base (default: the bench's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' profiles "
                         "the CPU operators of the plain path)")
    args = ap.parse_args(argv)
    if args.config:
        with open(args.config) as f:
            cfg = dataclasses.replace(Config.from_json(f.read()),
                                      batch_size=args.batch_size,
                                      sampler_type=args.sampler,
                                      sample_k=3)
    else:
        cfg = bench._cfg(args.sampler, args.batch_size, "bfloat16")
    print(f"profiling {'train step' if args.train else 'forward'} @ bucket "
          f"{tuple(args.bucket)}, batch {args.batch_size} ...",
          file=sys.stderr)
    out = run(cfg, args.bucket, args.train, args.iters, args.group,
              args.device, args.trace_dir)
    print(format_table(out, args.top))
    return out


if __name__ == "__main__":
    main()
