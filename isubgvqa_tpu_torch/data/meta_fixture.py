"""A GQA-like meta-info directory, made from a seed.

The synthetic task (:mod:`.synthetic`) asks about an object of a scene
graph and takes that object's name as the answer when the name is in the
answer map, else a random answer.  With the GQA meta-info assets (the
eight files ``tools/fetch_meta_assets.py`` copies) most object names are
answers, and the task is learnable; without them the port falls back to
a synthetic vocabulary whose names are never answers, so every answer is
random and no model can do better than chance.  Where the assets are not
at hand, this writes a stand-in with their file names, formats and entry
counts (1,703 object names, 618 attributes, 311 relations, the three
JSON lists, 1,842 answers) in which :data:`ANSWER_SHARE` of the object
names that the synthetic questions draw from are answers, drawn from
:data:`SEED`.  The tokens are made-up letter words; no GQA content is
reproduced.

    python -m isubgvqa_tpu_torch.data.meta_fixture DST
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

COUNTS = {"names": 1703, "attrs": 618, "rels": 311, "objects": 600,
          "predicates": 121, "attributes": 369, "answers": 1842}
# the share of the asked object names that are answers: the JAX package's
# convergence record states 0.81 for its run on the GQA assets
ANSWER_SHARE = 0.81
SEED = 0


def _words(prefix: str, n: int) -> list:
    """``n`` distinct letter-only words: ``prefix`` and a base-26 index."""
    out = []
    for i in range(n):
        s, i = "", i + 26
        while i:
            i, r = divmod(i, 26)
            s = chr(97 + r) + s
        out.append(prefix + s)
    return out


def write_gqa_like_meta(dst: str) -> str:
    """Write the eight meta-info files into ``dst``; returns ``dst``."""
    rng = np.random.default_rng(SEED)
    names = _words("nm", COUNTS["names"])
    attrs = _words("at", COUNTS["attrs"])
    rels = _words("rl", COUNTS["rels"])
    # the synthetic questions draw names from the first third of the
    # vocabulary's body (data/synthetic.py), which the names fill
    pool = names[:(len(names) + len(attrs) + len(rels) + 1) // 3]
    n_pool = int(round(ANSWER_SHARE * len(pool)))
    picked = [pool[i] for i in sorted(rng.choice(len(pool), n_pool,
                                                 replace=False))]
    answers = ["yes", "no", "left", "right"] + picked
    rest = names[len(pool):] + attrs + rels
    answers += [rest[i] for i in rng.permutation(len(rest))[
        :COUNTS["answers"] - len(answers)]]
    answers = [answers[i] for i in rng.permutation(len(answers))]
    os.makedirs(dst, exist_ok=True)
    for fname, rows in (("name_gqa.txt", names), ("attr_gqa.txt", attrs),
                        ("rel_gqa.txt", rels)):
        with open(os.path.join(dst, fname), "w") as f:
            f.write("\n".join(rows) + "\n")
    for fname, rows in (
            ("objects.json", names[:COUNTS["objects"]]),
            ("predicates.json", rels[:COUNTS["predicates"]]),
            ("attributes.json", attrs[:COUNTS["attributes"]]),
            ("trainval_label2ans.json", answers),
            ("trainval_ans2label.json",
             {a: i for i, a in enumerate(answers)})):
        with open(os.path.join(dst, fname), "w") as f:
            json.dump(rows, f)
    return dst


def main(argv=None) -> str:
    p = argparse.ArgumentParser(
        "python -m isubgvqa_tpu_torch.data.meta_fixture")
    p.add_argument("dst")
    return write_gqa_like_meta(p.parse_args(argv).dst)


if __name__ == "__main__":
    main()
