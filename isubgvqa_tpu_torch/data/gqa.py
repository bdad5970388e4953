"""GQA question dataset (host side).

Equivalent of ``GQADataset`` (``datasets/gqa.py:55-234``): per-split
question JSON loading, the 1842-answer label maps with bijection check
(``gqa.py:95-116``), the testdev filter to images with scene graphs
(``gqa.py:142-153``), and the ``"bottle cap" -> "bottle"`` answer remap
(``gqa.py:179-181``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

from .scene_graph import GraphArrays, SceneGraphStore

_SPLIT_FILES = {
    "train": "train_balanced_questions.json",
    "valid": "val_balanced_questions.json",
    "testdev": "testdev_balanced_questions.json",
}


class AnswerMap:
    """ans2label / label2ans with the reference's bijection assertion."""

    def __init__(self, ans2label: Dict[str, int], label2ans: List[str]):
        assert len(ans2label) == len(label2ans)
        for ans, label in ans2label.items():
            assert label2ans[label] == ans
        self.ans2label = ans2label
        self.label2ans = label2ans

    def __len__(self) -> int:
        return len(self.ans2label)

    def label_of(self, answer: str) -> int:
        if answer == "bottle cap":   # gqa.py:179-181
            answer = "bottle"
        return self.ans2label.get(answer, 0)

    @classmethod
    def from_meta_dir(cls, meta_dir: str) -> "AnswerMap":
        with open(os.path.join(meta_dir, "trainval_ans2label.json")) as f:
            a2l = json.load(f)
        with open(os.path.join(meta_dir, "trainval_label2ans.json")) as f:
            l2a = json.load(f)
        return cls(a2l, l2a)

    @classmethod
    def synthetic(cls, n: int = 1842) -> "AnswerMap":
        l2a = [f"ans{i}" for i in range(n)]
        l2a[:4] = ["yes", "no", "bottle", "left"]
        return cls({a: i for i, a in enumerate(l2a)}, l2a)

    @classmethod
    def build(cls, meta_dir: Optional[str], n: int = 1842) -> "AnswerMap":
        if meta_dir and os.path.isfile(
            os.path.join(meta_dir, "trainval_ans2label.json")
        ):
            return cls.from_meta_dir(meta_dir)
        return cls.synthetic(n)


def build_text_vocab(questions, tokenizer) -> dict:
    """A word vocabulary from question texts (the JAX package's
    ``build_text_vocab``; the reference builds it but answers through the
    CLIP tokenizer).  Returns stoi with the five specials first."""
    tokens = []
    for q in questions:
        tokens.extend(tokenizer.tokenize(q.lower()))
    specials = ["<unk>", "<pad>", "<sos>", "<eos>", "<self>"]
    return {t: i for i, t in enumerate(specials + sorted(set(tokens)))}


@dataclasses.dataclass
class Sample:
    question_id: str
    graph: GraphArrays
    question: str
    qst_type: dict
    label: int
    image_id: str


class GQADataset:
    """One split of GQA questions backed by a shared scene-graph store."""

    def __init__(self, split: str, store: SceneGraphStore, answers: AnswerMap,
                 data_dir: str):
        self.split = split
        self.store = store
        self.answers = answers
        path = os.path.join(data_dir, "questions", _SPLIT_FILES[split])
        with open(path) as f:
            self.data: Dict[str, dict] = json.load(f)
        if split == "testdev":   # gqa.py:142-153
            td = store.scene_graphs_testdev
            self.data = {
                k: v for k, v in self.data.items()
                if v["imageId"] in td and td[v["imageId"]] is not None
            }
        self.ids = list(self.data.keys())

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def num_answers(self) -> int:
        return len(self.answers)

    def __getitem__(self, idx: int) -> Sample:
        qid = self.ids[idx]
        datum = self.data[qid]
        return Sample(
            question_id=qid,
            graph=self.store.query(datum["imageId"]),
            question=datum["question"],
            qst_type=datum.get("types", {}),
            label=self.answers.label_of(datum["answer"]),
            image_id=datum["imageId"],
        )
