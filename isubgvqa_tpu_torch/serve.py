"""Serving API of the port: weights -> answers + explanation subgraphs.

The port of ``isubgvqa_tpu/serve.py:Predictor``::

    predictor = Predictor.from_checkpoint("model.pt")     # on cuda
    results = predictor.predict(["what is on the table?"], [scene_graph])
    results[0].answer, results[0].subgraph_nodes

Tokenization, graph conversion and the collate fill (C++ unless
``ISUBGVQA_NATIVE=0``) run on the host; each size bucket's batch runs one
eval forward on the device.  Requests are bucketed per
call, results come back in input order, and every batch draws its
Gumbel noise from a fresh generator seeded from ``(seed, batch_index)``
(the JAX Predictor folds its key per batch the same way).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .config import Config
from .convert import load_upstream_state_dict
from .data.batching import iterate_batches_bucketed
from .data.build import build_bucket_collators
from .data.gqa import AnswerMap, Sample
from .data.scene_graph import convert_scene_graph
from .data.tokenizer import build_tokenizer
from .data.vocab import SceneGraphVocab
from .models.build import build_model, make_aimle_states, resolve_device


@dataclasses.dataclass
class Prediction:
    answer: str
    confidence: float
    top_answers: List[tuple]          # [(answer, prob), ...]
    subgraph_nodes: List[str]         # object labels the model kept
    node_mask: np.ndarray             # per-real-node 0/1 mask
    gate: np.ndarray                  # pooling attention per node


def batch_seed(seed: int, *keys: int) -> int:
    """Seed of a batch's noise generator, from the run's ``seed`` and the
    batch's non-negative ``keys`` (its index; the Trainer adds the
    epoch)."""
    return int(np.random.SeedSequence([seed, *keys]).generate_state(1)[0])


class Predictor:
    def __init__(self, cfg: Config, vocab: SceneGraphVocab,
                 answers: AnswerMap, state_dict=None, device=None,
                 topk: int = 5, aimle_states=None):
        """``aimle_states`` (aimle only; a fresh state per masked layer by
        default) is handed to every eval forward, which never changes it,
        as the JAX Predictor's is (``serve.py:63,76``)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.vocab = vocab
        self.answers = answers
        self.topk = topk
        self.model = build_model(cfg, vocab, self.device,
                                 state_dict=state_dict)
        self.aimle_states = (
            {i: st.to(self.device) for i, st in aimle_states.items()}
            if aimle_states else make_aimle_states(cfg, self.device))
        self.tokenizer = build_tokenizer(cfg.clip_tokenizer_dir,
                                         max_len=cfg.question_len,
                                         vocab_size=cfg.text_vocab_size)
        self.last_batch_shapes: List[tuple] = []

    @classmethod
    def from_seed(cls, cfg: Config, device=None, **kw) -> "Predictor":
        """A randomly initialised model (``cfg.seed``) over the vocabulary
        and answer map that ``cfg.meta_dir`` gives (synthetic without
        meta assets)."""
        vocab = SceneGraphVocab.build(cfg.meta_dir, glove_path=cfg.glove_path,
                                      seed=cfg.seed)
        answers = AnswerMap.build(cfg.meta_dir, cfg.num_answers)
        cfg = dataclasses.replace(cfg, num_answers=len(answers))
        return cls(cfg, vocab, answers, device=device, **kw)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[Config] = None,
                        device=None, **kw) -> "Predictor":
        """Load the port's own ``torch.save`` file
        (``{"config": json, "state_dict": ...}``, see :meth:`save`), one
        of the Trainer's checkpoints (``checkpoint``,
        ``checkpoint_lowest_val_loss``, ``checkpoint_top_res``,
        ``checkpoint{epoch:04d}``; :mod:`.train.checkpoint`), whose payload
        holds the same two keys, or an upstream ``.pth`` together with
        ``cfg``.  A ``cfg`` given with the port's file replaces its
        config (another compute dtype, say)."""
        blob = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(blob, dict) and "state_dict" in blob:
            cfg = cfg or Config.from_json(blob["config"])
            sd = blob["state_dict"]
        else:
            if cfg is None:
                raise ValueError("an upstream checkpoint needs a Config")
            sd = load_upstream_state_dict(blob, cfg.node_classification)
        vocab = SceneGraphVocab.build(cfg.meta_dir, glove_path=cfg.glove_path,
                                      seed=cfg.seed)
        answers = AnswerMap.build(cfg.meta_dir, cfg.num_answers)
        cfg = dataclasses.replace(cfg, num_answers=len(answers))
        return cls(cfg, vocab, answers, state_dict=sd, device=device, **kw)

    def save(self, path: str) -> None:
        sd = {k: v.float().cpu() for k, v in self.model.state_dict().items()}
        torch.save({"config": self.cfg.to_json(), "state_dict": sd}, path)

    def _forward(self, batch, generator: torch.Generator):
        with torch.no_grad():
            out = self.model(batch.to(self.device), generator=generator,
                             aimle_states=self.aimle_states)
        return out.logits, out.node_mask, out.gate

    def predict(self, questions: Sequence[str], scene_graphs: Sequence[dict],
                batch_size: int = 64, seed: int = 0) -> List[Prediction]:
        """Answer ``questions[i]`` against ``scene_graphs[i]`` (GQA
        scene-graph dicts)."""
        assert len(questions) == len(scene_graphs)
        samples = [
            Sample(f"q{i}", convert_scene_graph(sg, self.vocab,
                                                self.cfg.max_nodes_per_graph),
                   q, {}, 0, f"img{i}")
            for i, (q, sg) in enumerate(zip(questions, scene_graphs))
        ]
        # a store of its own for each request: a server's requests bring
        # new graphs, which a shared store would keep forever
        collators = build_bucket_collators(
            self.cfg, self.tokenizer, self.vocab, batch_size=batch_size,
            pin_memory=self.device.type == "cuda")
        results: List[Optional[Prediction]] = [None] * len(samples)
        self.last_batch_shapes = []
        for b_idx, (batch, meta) in enumerate(
                iterate_batches_bucketed(samples, collators)):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(batch_seed(seed, b_idx))
            self.last_batch_shapes.append(
                (tuple(batch.node_tokens.shape), tuple(batch.qst_tokens.shape)))
            logits, node_mask, gate = self._forward(batch, gen)
            probs = torch.softmax(logits.float(), -1).cpu().numpy()
            nm = (node_mask[..., 0].float().cpu().numpy()
                  if node_mask is not None
                  else np.ones(batch.node_tokens.shape[:2], np.float32))
            gate = gate[..., 0].float().cpu().numpy()
            valid_all = batch.node_mask.numpy()
            tokens = batch.node_tokens.numpy()
            for s in range(meta.num_real):
                valid = valid_all[s]
                labels = [self.vocab.itos[t] for t in tokens[s][valid, 0]]
                mask_s = nm[s][valid]
                order = np.argsort(-probs[s])[: self.topk]
                results[int(meta.question_ids[s][1:])] = Prediction(
                    answer=self.answers.label2ans[int(order[0])],
                    confidence=float(probs[s][order[0]]),
                    top_answers=[(self.answers.label2ans[int(j)],
                                  float(probs[s][j])) for j in order],
                    subgraph_nodes=[l for l, m in zip(labels, mask_s)
                                    if m > 0],
                    node_mask=mask_s,
                    gate=gate[s][valid],
                )
        return results


__all__ = ["Predictor", "Prediction", "batch_seed"]
