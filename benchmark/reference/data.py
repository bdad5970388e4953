"""Raw GQA data to dense batches, in plain Python and NumPy.

The reference's own reading of the dataset's semantics (the upstream
``datasets/scene_graph.py`` and ``datasets/gqa.py``): node features are
one name token and up to three distinct attribute tokens, padded with
``<pad>`` (unknown tokens read as ``<pad>`` too, index 1); objects in
the sorted order of their ids; a self loop a node before its relation
edges; a missing reverse edge appended with sign -1; the CLIP-style
question ids of a hash word tokenizer (``<|startoftext|>`` ... ``<|endoftext|>``,
padded with the end id, the last kept id forced to the end id when a
question is cut).  A batch pads every graph to the bucket's node and edge
caps, keeping the first edges whose ends both survive the node cap.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, Sequence

import numpy as np

_WORD = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\w]+|[^\s\w]+",
    re.IGNORECASE)


def graph_arrays(sg: dict, stoi: Dict[str, int]) -> dict:
    """One scene graph as arrays: ``tokens [N, 4]``, ``bbox [N, 4]``,
    ``src``, ``dst``, ``etok``, ``sign`` ``[E]``."""
    pad, oov, self_tok = stoi["<pad>"], 1, stoi["<self>"]
    ids = sorted(sg["objects"])
    pos = {o: i for i, o in enumerate(ids)}
    present = {(pos[o], pos[r["object"]]) for o in ids
               for r in sg["objects"][o]["relations"] if r["object"] in pos}
    tokens, bbox, src, dst, etok, sign = [], [], [], [], [], []
    for o in ids:
        i, obj = pos[o], sg["objects"][o]
        row = [stoi.get(obj["name"], oov)]
        row += [stoi.get(a, oov) for a in dict.fromkeys(obj["attributes"])][:3]
        tokens.append(row + [pad] * (4 - len(row)))
        bbox.append([obj.get(k, -1) for k in ("x1", "y1", "x2", "y2")])
        src.append(i); dst.append(i); etok.append(self_tok); sign.append(1.0)
        for r in obj["relations"]:
            j = pos.get(r["object"])
            if j is None:
                continue
            t = stoi.get(r["name"], oov)
            src.append(i); dst.append(j); etok.append(t); sign.append(1.0)
            if (j, i) not in present:
                src.append(j); dst.append(i); etok.append(t); sign.append(-1.0)
    return {"tokens": np.asarray(tokens, np.int64),
            "bbox": np.asarray(bbox, np.float32),
            "src": np.asarray(src, np.int64), "dst": np.asarray(dst, np.int64),
            "etok": np.asarray(etok, np.int64),
            "sign": np.asarray(sign, np.float32)}


def question_ids(text: str, length: int, vocab_size: int = 49408):
    """``(ids [length], mask [length])`` of the hash word tokenizer."""
    bos, eos = vocab_size - 2, vocab_size - 1
    words = _WORD.findall(text.lower().strip())
    ids = [bos] + [int.from_bytes(hashlib.md5(w.encode()).digest()[:8],
                                  "little") % (vocab_size - 2)
                   for w in words] + [eos]
    ids = ids[:length]
    if len(ids) == length:
        ids[-1] = eos
    out = np.full(length, eos, np.int64)
    mask = np.zeros(length, np.int64)
    out[:len(ids)] = ids
    mask[:len(ids)] = 1
    return out, mask


def dense_batch(items: Sequence[tuple], graphs: Dict[str, dict],
                stoi: Dict[str, int], answers: Sequence[str],
                n_cap: int, e_cap: int, l_cap: int,
                vocab_size: int = 49408, cache=None) -> dict:
    """``items``: ``(qid, image, question, answer)`` rows -> numpy arrays
    of one padded batch, keyed as the model reads them."""
    b = len(items)
    a2l = {a: i for i, a in enumerate(answers)}
    out = {"node_tokens": np.ones((b, n_cap, 4), np.int64),
           "node_bbox": np.zeros((b, n_cap, 4), np.float32),
           "node_mask": np.zeros((b, n_cap), bool),
           "edge_src": np.zeros((b, e_cap), np.int64),
           "edge_dst": np.zeros((b, e_cap), np.int64),
           "edge_token": np.ones((b, e_cap), np.int64),
           "edge_sign": np.ones((b, e_cap), np.float32),
           "edge_mask": np.zeros((b, e_cap), bool),
           "qst_tokens": np.zeros((b, l_cap), np.int64),
           "qst_mask": np.zeros((b, l_cap), np.int64),
           "labels": np.zeros(b, np.int64)}
    cache = {} if cache is None else cache
    for r, (_, img, text, answer) in enumerate(items):
        g = cache.get(img)
        if g is None:
            g = cache[img] = graph_arrays(graphs[img], stoi)
        n = min(len(g["tokens"]), n_cap)
        keep = np.nonzero((g["src"] < n) & (g["dst"] < n))[0][:e_cap]
        e = len(keep)
        out["node_tokens"][r, :n] = g["tokens"][:n]
        out["node_bbox"][r, :n] = g["bbox"][:n]
        out["node_mask"][r, :n] = True
        for k, s in (("edge_src", "src"), ("edge_dst", "dst"),
                     ("edge_token", "etok"), ("edge_sign", "sign")):
            out[k][r, :e] = g[s][keep]
        out["edge_mask"][r, :e] = True
        out["qst_tokens"][r], out["qst_mask"][r] = question_ids(
            text, l_cap, vocab_size)
        label_of = "bottle" if answer == "bottle cap" else answer
        out["labels"][r] = a2l.get(label_of, 0)
    return out


def real_sizes(batch: dict) -> np.ndarray:
    """``[B, 3]``: each question's own node, edge and token counts."""
    return np.stack([batch["node_mask"].sum(1), batch["edge_mask"].sum(1),
                     batch["qst_mask"].sum(1)], 1)
