"""Readings that the limits of ``correct`` are set from: the program's
numbers over many seeds, and the control's, in one process.

    python3 benchmark/calibrate.py --workload <name> --seconds 3 \\
        --seeds 11 12 13 ... [--control] [--faults [NAME ...]] [--probes]

For each seed the cell is set up and run for a short window, and the
check's numbers are printed as one JSON line.  ``--control`` adds the
numbers of the plain reference put in the program's place at the
precision below the configuration's (float8: e4m3 operands, e5m2
gradients, each tensor scaled to its largest value), on the same inputs;
``--faults`` adds, for a training cell, the reference with half of each
batch left out of the loss (the mean over the rest) and with one answer a
step altered, or those of them named; ``--probes`` reads the numbers of
one graph layer's gradients doubled, which no compared number catches.
The benchmark's own runs never run this.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse

    import torch

    from benchmark.harness import Tracer, load_cell, load_module

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=None,
                    help="a training cell's faults, all or those named")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--details", action="store_true",
                    help="per-leaf readings behind a training cell's numbers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose BENCHMARK.json and data files "
                         "define the cell")
    args = ap.parse_args(argv)

    cell = load_cell(args.workload, args.root)
    mod = load_module("drivers", cell.mix["kind"], args.root)
    dev = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        driver = mod.Driver(cell, seed, dev, Tracer(False, 0.0, 0.0))
        driver.setup()
        t1 = time.perf_counter()
        counters = driver.window(args.seconds)
        driver.free()
        row = {"seed": seed, "setup_s": t1 - t0,
               "attempted": counters["attempted"],
               "program": {n: v for n, v, _ in driver.check()}}
        if hasattr(driver, "spread"):
            row["program_spread"] = driver.spread
        if args.control:
            row["control"] = mod.control(driver)
        if args.faults is not None and hasattr(mod, "faults"):
            row["faults"] = (mod.faults(driver, args.faults) if args.faults
                             else mod.faults(driver))
        if args.probes and hasattr(mod, "probes"):
            row["probes"] = mod.probes(driver)
        if args.details and hasattr(mod, "details"):
            row["details"] = mod.details(driver)
        row["check_s"] = time.perf_counter() - t1 - counters["window_s"]
        print(json.dumps(row), flush=True)
        del driver
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
