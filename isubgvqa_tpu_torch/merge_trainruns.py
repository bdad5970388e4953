"""Merge per-sampler convergence records into one artifact (the port of
``scripts/merge_trainruns.py``).

    python -m isubgvqa_tpu_torch.merge_trainruns --out \
        TRAINRUN_torch_h100.json gumbel.json simple.json imle.json ...

Each input is a ``train_convergence`` record.  The first that has a
``task`` gives the header; every sampler's run is taken from the inputs
in order.  Where two inputs hold the same sampler, a run that continues
the other (``--resume``: its first epoch is the next after the other's
last) is joined to it: the epoch rows concatenated, the best accuracy
the larger, the lowest loss the smaller, the wall seconds summed, the
mask statistics the later run's.  Otherwise the run with more epochs
recorded is kept.
"""

from __future__ import annotations

import argparse
import json
from typing import List


def join(a: dict, b: dict) -> dict:
    """Run ``b`` continuing run ``a`` of the same sampler, as one run."""
    out = dict(b)
    out["epochs"] = a["epochs"] + b["epochs"]
    out["best_val_acc"] = max(a["best_val_acc"], b["best_val_acc"])
    out["lowest_val_loss"] = min(a["lowest_val_loss"], b["lowest_val_loss"])
    out["wall_s"] = round(a["wall_s"] + b["wall_s"], 1)
    notes = [r["note"] for r in (a, b) if r.get("note")]
    if notes:
        out["note"] = "; ".join(notes)
    return out


def merge(records: List[dict]) -> dict:
    merged = None
    for d in records:
        if merged is None and "task" in d:
            merged = {**d, "runs": {}}
        elif merged is None:
            merged = {"runs": {}}
        for k, v in d.get("runs", {}).items():
            have = merged["runs"].get(k)
            if have is None:
                merged["runs"][k] = v
                continue
            old, new = have.get("epochs", []), v.get("epochs", [])
            if old and new and new[0]["epoch"] == old[-1]["epoch"] + 1:
                merged["runs"][k] = join(have, v)
            elif len(new) > len(old):
                merged["runs"][k] = v
    return merged


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("python -m isubgvqa_tpu_torch.merge_trainruns")
    p.add_argument("--out", default="TRAINRUN_torch.json")
    p.add_argument("paths", nargs="+")
    args = p.parse_args(argv)
    records = []
    for path in args.paths:
        with open(path) as f:
            records.append(json.load(f))
    merged = merge(records)
    with open(args.out, "w") as f:
        json.dump(merged, f, indent=1)
    print(json.dumps({k: {"best_val_acc": v.get("best_val_acc"),
                          "epochs": len(v.get("epochs", []))}
                      for k, v in merged["runs"].items()}, indent=1))
    return merged


if __name__ == "__main__":
    main()
