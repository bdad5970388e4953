"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Sets the cell up (data and weights from the seed, the program's model or
train state, every shape warmed), measures for ``--seconds``, checks the
timed path's outputs against the plain reference, and prints, as the
last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics, or with
``--trace 1`` the per-layer ones), ``device`` and, traced, ``breakdown``;
its last key, ``checks``, holds each number compared beside its limit,
which are also the last lines of standard error.  Exits non-zero with no
result when the cell's CUDA devices are missing or when JAX or the JAX
package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, os.path.join(ROOT, "benchmark", ".cache",
                                             _dir))
os.environ.setdefault("USE_FLAX", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark.harness import forbidden_modules, load_cell, run_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print("loaded JAX or the JAX package: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
