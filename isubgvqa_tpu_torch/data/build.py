"""Datasets and collators of the three GQA splits (the port of
``isubgvqa_tpu/data/build.py``).

:func:`build_datasets` gives train / dev / testdev sharing one
scene-graph store, collators per split and size bucket, and the
reference's evaluation batch of ``eval_batch_factor`` times the training
batch (``datasets/build.py:55-67``).  It falls back to the synthetic
mini-GQA fixture when ``cfg.synthetic`` is set or the real JSONs are
absent.  Every collator of the three splits fills its batches in C++
over one shared :class:`~isubgvqa_tpu_torch.native.PackedGraphStore`
(graphs pack once), in pinned memory for a caller that feeds the card;
``ISUBGVQA_NATIVE=0`` selects the Python fill.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

from ..config import Config
from ..native.collate import PackedGraphStore, load_collate_lib
from .batching import BucketSpec, Collator
from .gqa import AnswerMap, GQADataset
from .scene_graph import SceneGraphStore
from .synthetic import SyntheticGQA
from .tokenizer import build_tokenizer
from .vocab import SceneGraphVocab


@dataclasses.dataclass
class DataBundle:
    datasets: Dict[str, object]          # train / dev / testdev
    collators: Dict[str, Collator]       # per split, at the largest caps
    vocab: SceneGraphVocab
    answers: AnswerMap
    tokenizer: object
    # per split: bucket key -> Collator, ascending
    bucket_collators: Dict[str, Dict[tuple, Collator]] = dataclasses.field(
        default_factory=dict)


def _has_real_gqa(cfg: Config) -> bool:
    return os.path.isfile(os.path.join(
        cfg.data_dir, "questions", "train_balanced_questions.json"))


def build_datasets(cfg: Config, pin_memory: bool = False) -> DataBundle:
    """``pin_memory``: the native fill's batches in pinned host memory
    (for a caller that copies them to the card; it needs CUDA)."""
    vocab = SceneGraphVocab.build(cfg.meta_dir, glove_path=cfg.glove_path,
                                  seed=cfg.seed)
    answers = AnswerMap.build(cfg.meta_dir, cfg.num_answers)
    tokenizer = build_tokenizer(cfg.clip_tokenizer_dir,
                                max_len=cfg.question_len,
                                vocab_size=cfg.text_vocab_size)
    if cfg.synthetic or not _has_real_gqa(cfg):
        eval_size = max(cfg.synthetic_size // 4, 1)
        datasets = {
            split: SyntheticGQA(vocab, answers, size=size, seed=cfg.seed,
                                split=name, shape_mix=cfg.synthetic_shape_mix)
            for split, name, size in (
                ("train", "train", cfg.synthetic_size),
                ("dev", "valid", eval_size),
                ("testdev", "testdev", eval_size))}
    else:
        store = SceneGraphStore(vocab, data_dir=cfg.data_dir,
                                max_nodes=cfg.max_nodes_per_graph)
        datasets = {split: GQADataset(name, store, answers, cfg.data_dir)
                    for split, name in (("train", "train"), ("dev", "valid"),
                                        ("testdev", "testdev"))}
    eval_bs = cfg.batch_size * cfg.eval_batch_factor
    split_bs = {"train": cfg.batch_size, "dev": eval_bs, "testdev": eval_bs}
    packed = _make_packed_store(pin_memory)
    bucket_collators = {
        split: build_bucket_collators(cfg, tokenizer, vocab, batch_size=bs,
                                      packed_store=packed)
        for split, bs in split_bs.items()}
    top = (cfg.max_nodes_per_graph, cfg.question_len)
    collators = {split: colls[top]
                 for split, colls in bucket_collators.items()}
    return DataBundle(datasets=datasets, collators=collators, vocab=vocab,
                      answers=answers, tokenizer=tokenizer,
                      bucket_collators=bucket_collators)


def _make_packed_store(pin_memory: bool = False):
    """A :class:`PackedGraphStore` for the native fill, or None under
    ``ISUBGVQA_NATIVE=0`` (the collators then fill in Python).  A failed
    build of the fill raises."""
    if load_collate_lib() is None:
        return None
    return PackedGraphStore(pin_memory=pin_memory)


def build_bucket_collators(cfg: Config, tokenizer, vocab, batch_size: int,
                           packed_store=None, pin_memory: bool = False
                           ) -> Dict[tuple, Collator]:
    """Collators keyed by ``(node_cap, question_len_cap)`` over the cross
    product of the configured node and question-length buckets.  Node
    caps clamp to ``max_nodes_per_graph``; each small bucket gets a
    4x-nodes edge budget; the largest keeps ``max_edges_per_graph``.
    They share ``packed_store``, or a new store (pinned under
    ``pin_memory``) when none is given."""
    n_max, e_max = cfg.max_nodes_per_graph, cfg.max_edges_per_graph
    q_max = cfg.question_len
    n_caps = sorted({min(c, n_max) for c in (cfg.bucket_node_caps or ())}
                    | {n_max})
    q_caps = sorted({min(q, q_max) for q in (cfg.bucket_question_lens or ())}
                    | {q_max})

    def e_cap_for(n_cap: int) -> int:
        return e_max if n_cap == n_max else min(max(4 * n_cap, 1), e_max)

    if packed_store is None:
        packed_store = _make_packed_store(pin_memory)
    return {
        (n_cap, q_cap): Collator(
            tokenizer,
            BucketSpec(batch_size=batch_size, max_nodes_per_graph=n_cap,
                       max_edges_per_graph=e_cap_for(n_cap),
                       question_len=q_cap),
            vocab=vocab, packed_store=packed_store)
        for n_cap in n_caps for q_cap in q_caps
    }
