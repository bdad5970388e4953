"""The GQA-like question generator, frozen for the benchmark.

A copy of the port's ``data/synthetic.py`` ``"gqa"`` shape mix (its
vocabulary split, question templates, node counts ~ lognormal(2.6, 0.75)
clipped to [2, 120], one or two relations a node, up to three attributes,
bounding boxes), made bucket by bucket: each size bucket of a mix gets a
pool of images whose node counts are the mix's lognormal conditioned on
the bucket's node range, and questions whose template length fits the
bucket's question cap.  So a rare bucket needs no epoch of samples to be
filled.

The output is raw GQA data, as the dataset's JSON files hold it: scene
graphs ``{"objects": {id: {...}}}``, question strings and answer strings,
with the scene-graph vocabulary and the answer list beside them.  The
program and the plain reference each turn it into batches themselves.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_WORD = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\w]+|[^\s\w]+",
    re.IGNORECASE)

SPECIALS = ["<unk>", "<pad>", "<sos>", "<eos>", "<self>"]

QUESTION_TEMPLATES = [
    "what is the {attr} object called",
    "is there a {name} in the image",
    "what color is the {name}",
    "what is next to the {name}",
    "how many {name} are there",
    "does the {name} look {attr}",
]

LONG_QUESTION_TEMPLATES = [
    "looking very carefully at the whole scene shown in this image can "
    "you tell me whether the {name} that appears there seems {attr}",
    "considering everything that is visible in this particular picture "
    "what would you say is positioned directly next to the {name}",
    "out of all of the different objects that can be seen in the image "
    "how many of them would you describe as being a {name}",
]


def vocab_tokens(num_objects: int = 30, num_attrs: int = 20,
                 num_rels: int = 10) -> List[str]:
    """The synthetic scene-graph vocabulary: the five specials, then
    object, attribute and relation tokens and the ``pokemon`` sentinel."""
    body = ([f"obj{i}" for i in range(num_objects)]
            + [f"attr{i}" for i in range(num_attrs)]
            + [f"rel{i}" for i in range(num_rels)] + ["pokemon"])
    return SPECIALS + body


def answer_list(n: int = 1842) -> List[str]:
    """The synthetic answer list (label -> answer)."""
    names = [f"ans{i}" for i in range(n)]
    names[:4] = ["yes", "no", "bottle", "left"]
    return names


@dataclasses.dataclass
class BucketPool:
    """One size bucket's raw questions over its own images."""

    key: Tuple[int, int]               # (node cap, question-length cap)
    graphs: Dict[str, dict]            # image id -> scene graph
    questions: List[Tuple[str, str, str, str]]   # (qid, image, text, answer)
    sizes: np.ndarray                  # [Q, 3] nodes, edges, tokens


def edge_count(sg: dict) -> int:
    """Edges of a scene graph as the dataset's conversion makes them: a
    self loop a node, each relation, and each missing reverse edge."""
    present = set()
    for oid, obj in sg["objects"].items():
        for rel in obj["relations"]:
            present.add((oid, rel["object"]))
    n = len(sg["objects"])
    rels = sum(len(o["relations"]) for o in sg["objects"].values())
    missing = sum(1 for (a, b) in present if (b, a) not in present)
    return n + rels + missing


def _node_counts(rng: np.random.Generator, lo: int, hi: int, size: int,
                 mean: float, sigma: float, clip: Sequence[int]) -> np.ndarray:
    """``size`` node counts of the clipped lognormal, kept in ``(lo, hi]``."""
    out = []
    while len(out) < size:
        n = np.clip(rng.lognormal(mean, sigma, 4096), clip[0], clip[1])
        n = n.astype(np.int64)
        out.extend(n[(n > lo) & (n <= hi)].tolist())
    return np.asarray(out[:size])


def _scene_graph(rng: np.random.Generator, n: int, names, attrs, rels,
                 max_rel: int) -> dict:
    """One scene graph of ``n`` objects: each a uniform name, up to three
    uniform attributes, one to ``max_rel`` relations to distinct other
    objects with uniform names, and a box."""
    name_i = rng.integers(0, len(names), n).tolist()
    n_attr = rng.integers(0, 4, n).tolist()
    n_rel = (rng.integers(1, min(max_rel + 1, n), n) if n > 2
             else np.ones(n, np.int64)).tolist()
    attr_i = rng.integers(0, len(attrs), (n, 3)).tolist()
    # distinct targets: offsets 1 .. n - 1 from the object, the second
    # offset drawn among those the first left
    first = rng.integers(0, n - 1, n)
    second = (first + 1 + rng.integers(0, max(n - 2, 1), n)) % (n - 1)
    tgt = ((np.arange(n)[:, None] + 1 + np.stack([first, second], 1)) % n
           ).tolist()
    rel_i = rng.integers(0, len(rels), (n, 2)).tolist()
    xy = (rng.uniform(0.0, 1.0, (n, 4)) * [400, 300, 400, 300]
          + [0, 0, 400, 300]).tolist()
    objects = {}
    for i in range(n):
        objects[str(i)] = {
            "name": names[name_i[i]],
            "attributes": [attrs[a] for a in attr_i[i][:n_attr[i]]],
            "relations": [{"object": str(t), "name": rels[r]} for t, r in
                          zip(tgt[i][:n_rel[i]], rel_i[i])],
            "x1": xy[i][0], "y1": xy[i][1], "x2": xy[i][2], "y2": xy[i][3],
        }
    return {"objects": objects}


def node_range(key: Tuple[int, int], node_caps: Sequence[int]):
    """The node counts ``(lo, hi]`` that land in bucket ``key``."""
    caps = sorted(node_caps)
    i = caps.index(key[0])
    return (0 if i == 0 else caps[i - 1]), key[0]


def make_pool(rng: np.random.Generator, key: Tuple[int, int], mix: dict,
              itos: Sequence[str], answers: Sequence[str],
              n_questions: int, tag: str,
              e_cap: Optional[int] = None) -> BucketPool:
    """``n_questions`` questions of bucket ``key`` over
    ``ceil(n_questions / questions_per_image)`` images.  A graph with more
    edges than ``e_cap`` (the bucket's edge cap; None for the bucket that
    takes every graph too large for the others) is drawn again, so it
    lands in the bucket."""
    gen = mix["generator"]
    body = [t for t in itos[5:] if not t.startswith("<")]
    third = max(len(body) // 3, 1)
    names, attrs, rels = body[:third], body[third:2 * third], body[2 * third:]
    caps = mix["node_caps"]
    lo, hi = node_range(key, caps)
    n_imgs = -(-n_questions // gen["questions_per_image"])
    graphs = {}
    counts = _node_counts(rng, lo, hi, 4 * n_imgs, *gen["node_lognormal"],
                          gen["node_clip"])
    ci = 0
    img_size = {}
    while len(graphs) < n_imgs:
        sg = _scene_graph(rng, int(counts[ci % len(counts)]), names, attrs,
                          rels, gen["max_rel"])
        ci += 1
        e = edge_count(sg)
        if e_cap is None or e <= e_cap:
            img = f"{tag}{len(graphs)}"
            graphs[img] = sg
            img_size[img] = (len(sg["objects"]), e)
    long_q = key[1] > gen["short_question_cap"]
    pool = LONG_QUESTION_TEMPLATES if long_q else QUESTION_TEMPLATES
    a2l = {a: i for i, a in enumerate(answers)}
    img_ids = list(graphs)
    questions, sizes = [], []
    for q in range(n_questions):
        img = img_ids[q % n_imgs]
        objs = list(graphs[img]["objects"].values())
        obj = objs[int(rng.integers(0, len(objs)))]
        template = pool[int(rng.integers(0, len(pool)))]
        text = template.format(
            name=obj["name"],
            attr=obj["attributes"][0] if obj["attributes"] else "plain") + "?"
        answer = (obj["name"] if obj["name"] in a2l
                  else answers[int(rng.integers(0, len(answers)))])
        questions.append((f"{tag}q{q}", img, text, answer))
        sizes.append(img_size[img] + (len(_WORD.findall(text.lower())) + 2,))
    return BucketPool(tuple(key), graphs, questions, np.asarray(sizes))


def draw_batches(rng: np.random.Generator, pool_size: int, batch_size: int,
                 count: int) -> List[np.ndarray]:
    """``count`` pairwise-distinct compositions of ``batch_size`` pool
    indices each (without replacement inside a batch where the pool
    holds enough, else with it)."""
    seen, out = set(), []
    while len(out) < count:
        idx = (rng.permutation(pool_size)[:batch_size]
               if pool_size >= batch_size
               else rng.integers(0, pool_size, batch_size))
        t = tuple(idx.tolist())
        if t not in seen:
            seen.add(t)
            out.append(idx)
    return out


def schedule(shares: Sequence[float], length: int) -> List[int]:
    """Bucket indices of a smooth weighted round-robin by ``shares``
    (given to one decimal of a percent), the same for every seed: at
    each step every bucket gains its weight, the richest is taken (the
    first on a tie) and pays the total.  Every prefix holds each bucket's
    share to within one unit."""
    w = [int(round(10 * s)) for s in shares]
    total = sum(w)
    current = [0] * len(w)
    out = []
    for _ in range(length):
        for i, wi in enumerate(w):
            current[i] += wi
        pick = max(range(len(w)), key=lambda i: (current[i], -i))
        current[pick] -= total
        out.append(pick)
    return out
