"""A cell's data: raw GQA-like questions by size bucket (from
:mod:`.gqa_gen`), the batch compositions drawn from them, each
question's own sizes, the batches the program's data layer builds
from the raw data, and the reference's batches of the same questions."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from . import gqa_gen
from .harness import subseed
from .reference import data as ref_data


class Fixture:
    def __init__(self, cell, seed: int, batch_size: int, n_batches: int,
                 n_questions: int):
        mix, conf = cell.mix, cell.config
        self.mix, self.conf, self.batch_size = mix, conf, batch_size
        self.itos = gqa_gen.vocab_tokens()
        self.answers = gqa_gen.answer_list(conf["num_answers"])
        self.keys: List[Tuple[int, int]] = [tuple(k) for k in mix["buckets"]]
        rng = np.random.default_rng(subseed(seed, "data"))
        self.caps = {k: self._caps(k) for k in self.keys}
        last = max(self.keys)
        self.pools = {k: gqa_gen.make_pool(
            rng, k, mix, self.itos, self.answers, n_questions,
            f"n{k[0]}q{k[1]}_", None if k == last else int(self.caps[k][1]))
            for k in self.keys}
        self.comps = {k: gqa_gen.draw_batches(rng, n_questions, batch_size,
                                              n_batches) for k in self.keys}
        # each question's sizes as the bucket processes them
        self.sizes = {k: [np.minimum(self.pools[k].sizes[c], self.caps[k])
                          for c in self.comps[k]] for k in self.keys}
        self._graph_cache: Dict[str, dict] = {}

    def _caps(self, key):
        caps = self.mix["node_caps"]
        e_max = self.conf["max_edges_per_graph"]
        e = e_max if key[0] == max(caps) else min(4 * key[0], e_max)
        return np.array([key[0], e, key[1]])

    def program_batches(self, cfg, pin: bool) -> Dict[tuple, list]:
        """Every composition as the program's data layer collates it from
        the raw data (scene-graph conversion, tokenizer, the native fill),
        after checking that the program routes each pool to its bucket."""
        from isubgvqa_tpu_torch.data import (AnswerMap, HashWordTokenizer,
                                             SceneGraphVocab,
                                             build_bucket_collators,
                                             route_to_buckets)
        from isubgvqa_tpu_torch.data.gqa import Sample
        from isubgvqa_tpu_torch.data.scene_graph import SceneGraphStore

        vocab = SceneGraphVocab(self.itos, dim=cfg.general_hidden_dim,
                                seed=cfg.seed)
        amap = AnswerMap({a: i for i, a in enumerate(self.answers)},
                         list(self.answers))
        graphs = {}
        for p in self.pools.values():
            graphs.update(p.graphs)
        store = SceneGraphStore(vocab, graphs=graphs)
        tok = HashWordTokenizer(vocab_size=cfg.text_vocab_size,
                                max_len=cfg.question_len)
        collators = build_bucket_collators(cfg, tok, vocab,
                                           batch_size=self.batch_size,
                                           pin_memory=pin)
        out = {}
        for k in self.keys:
            samples = [Sample(qid, store.query(img), text,
                              {"structural": "query", "semantic": "attr",
                               "detailed": "synthetic"},
                              amap.label_of(ans), img)
                       for qid, img, text, ans in self.pools[k].questions]
            routed = route_to_buckets(samples, collators)
            if len(routed[k]) != len(samples):
                raise RuntimeError(f"the program routes {len(samples) - len(routed[k])} "
                                   f"questions of pool {k} to another bucket")
            out[k] = []
            for comp in self.comps[k]:
                batch, _ = collators[k].collate([samples[i] for i in comp])
                if pin and not batch.is_pinned():
                    batch = batch.pin_memory()
                out[k].append(batch)
        self.vocab = vocab
        return out

    def reference_batch(self, key, j: int, device) -> dict:
        """Composition ``j`` of bucket ``key`` as the reference builds it,
        as tensors on ``device``."""
        pool = self.pools[key]
        items = [pool.questions[i] for i in self.comps[key][j]]
        n, e, l = (int(v) for v in self.caps[key])
        b = ref_data.dense_batch(items, pool.graphs,
                                 {t: i for i, t in enumerate(self.itos)},
                                 self.answers, n, e, l,
                                 self.conf["text_vocab_size"],
                                 self._graph_cache)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}
