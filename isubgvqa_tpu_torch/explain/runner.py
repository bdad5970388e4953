"""Batched explanation extraction over a split (the port of
``isubgvqa_tpu/explain/runner.py``; the reference's
``run_token_coo_exp``, ``run_token_coo.py:49-185``): accuracy,
accuracy-AT (the answer among the scene graph's node labels), the
three token co-occurrence metrics and optional subgraph rendering.

Full padded batches go through the eval forward on the device, which
takes the argmax there: per batch only the predictions ``[B]`` and the
node mask ``[B, N]`` come back to the host, in one copy.  The metric
pass reads the labels, node tokens and node mask from the collated host
arrays, which travel beside the device batch through :func:`prefetch`,
never copied back from the card.  The vectorized metric pass
(:func:`_accumulate_fast`) is the default; the per-sample loop stays as
its oracle and runs when a rendering or mask collection asks for the
samples one by one.  Under ``text_sampling`` the text mask ``[B, L]``
comes back in the same copy, and the question tokens it keeps, decoded by
the data's tokenizer, give the text-explanation co-occurrence
(``run_token_coo.py:108-116,262-268``); without it that metric is NaN.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.batching import (iterate_batches, iterate_batches_bucketed,
                             prefetch)
from ..data.build import DataBundle
from ..serve import batch_seed
from ..train.distributed_metrics import reduce_dict
from .token_coo import (compute_ans_token_cooccurrence,
                        compute_qst_token_cooccurrence,
                        compute_text_expl_token_cooccurrence)

logger = logging.getLogger(__name__)

SUM_KEYS = ("acc_sum", "acc_n", "acc_at_sum", "acc_at_n", "ans_sum",
            "ans_n", "qst_sum", "qst_n", "text_sum", "text_n")


def _answer_vocab_ids(label2ans, vocab) -> np.ndarray:
    """Per-answer scene-graph vocab id, or -1 where the answer string is
    no scene-graph token.  ``answer in node_labels``
    (``run_token_coo.py:146``) is id membership, since node labels are
    vocab strings."""
    stoi = vocab.stoi
    return np.asarray([stoi.get(label2ans[i], -1)
                       for i in range(len(label2ans))], dtype=np.int64)


def _question_word_ids(question: str, stoi, cache: dict) -> np.ndarray:
    """``question.split("?")[0].lower().split(" ")`` as vocab ids (-1 for
    a word outside the vocab), cached per question."""
    got = cache.get(question)
    if got is None:
        words = question.split("?")[0].lower().split(" ")
        got = np.asarray([stoi.get(w, -1) for w in words], dtype=np.int64)
        cache[question] = got
    return got


def _text_expl(s, mask_text, qst_ids, qst_valid, tokenizer) -> list:
    """Sample ``s``'s text explanation: the decoded question tokens that
    the text mask keeps (``run_token_coo.py:108-116``)."""
    return [tokenizer.decode_token(int(qst_ids[s, i]))
            for i in range(qst_ids.shape[1])
            if qst_valid[s, i] and mask_text[s, i] == 1.0]


def _accumulate_fast(acc: dict, *, preds, labels, ids0, valid, sel,
                     num_real, questions, ans_vid, stoi,
                     word_cache, mask_text=None, qst_ids=None,
                     qst_valid=None, tokenizer=None) -> None:
    """One batch's metric sums by numpy id comparisons: equal to the
    per-sample oracle loop's; only correct samples pay a per-sample cost
    for the question and text co-occurrences
    (``run_token_coo.py:145-185``)."""
    preds = preds[:num_real]
    labels = labels[:num_real]
    ids0 = ids0[:num_real]
    valid = valid[:num_real]
    sel = sel[:num_real]

    pred_vid = ans_vid[preds]                       # [R]
    gt_vid = ans_vid[labels]
    # padded node slots carry token id 1, never -1
    pred_present = ((ids0 == pred_vid[:, None]) & valid).any(1)
    gt_present = ((ids0 == gt_vid[:, None]) & valid).any(1)
    gt_masked = ((ids0 == gt_vid[:, None]) & sel).any(1)
    correct = preds == labels

    acc["acc_sum"] += float(correct.sum())
    acc["acc_n"] += float(num_real)
    # accuracy-AT: the predicted answer among the node labels (:146-147)
    acc["acc_at_sum"] += float((pred_present & correct).sum())
    acc["acc_at_n"] += float(pred_present.sum())

    for s in np.nonzero(correct)[0]:                # :148-173
        question = questions[s]
        # answer-token co-occurrence (token_coo_fns.py:4-10)
        if gt_present[s] and "color" not in question:
            acc["ans_sum"] += float(gt_masked[s])
            acc["ans_n"] += 1.0
        # question-token co-occurrence (:13-24)
        wids = _question_word_ids(question, stoi, word_cache)
        node_ids = ids0[s][valid[s]]
        matches = np.isin(wids, node_ids)
        n_match = int(matches.sum())
        if n_match:
            kept = np.isin(wids, ids0[s][sel[s]])
            acc["qst_sum"] += float(kept.sum()) / n_match
            acc["qst_n"] += 1.0
        # text-explanation co-occurrence (:27-36)
        if mask_text is not None:
            expl_ids = np.asarray(
                [stoi.get(w, -1) for w in _text_expl(
                    s, mask_text, qst_ids, qst_valid, tokenizer)],
                dtype=np.int64)
            cand = np.isin(expl_ids, node_ids)
            n_cand = int(cand.sum())
            if n_cand:
                kept = np.isin(expl_ids, ids0[s][sel[s]])
                acc["text_sum"] += float(kept.sum()) / n_cand
                acc["text_n"] += 1.0


@dataclasses.dataclass
class ExplainResults:
    accuracy: float
    accuracy_at: float
    ans_token_coo: float
    qst_token_coo: float
    text_token_coo: float
    num_samples: int
    # the metric sums and counts, reduced across shards: shard results
    # recombine exactly from them
    sums: Optional[dict] = None

    def summary(self) -> str:
        return (f"Accuracy: {self.accuracy}\n"
                f"Accuracy AT: {self.accuracy_at}\n"
                f"Ans. Tok. Coo: {self.ans_token_coo}\n"
                f"Qst. Tok. Coo: {self.qst_token_coo}\n"
                f"Qst. Text Tok. Coo: {self.text_token_coo}")


def _with_host_half(batches):
    """``(batch, (meta, host batch))``: the collated host tensors ride
    beside the batch through :func:`prefetch`, which moves only the
    first half to the device."""
    for batch, meta in batches:
        yield batch, (meta, batch)


def run_token_coo_exp(
    model,
    data: DataBundle,
    cfg: Config,
    split: str = "dev",
    save_expl: bool = False,
    expl_dir: Optional[str] = None,
    run: Optional[str] = None,
    save_qst_meta_data: bool = False,
    max_batches: Optional[int] = None,
    seed: int = 0,
    shard_index: int = 0,
    num_shards: int = 1,
    collect_masks: Optional[dict] = None,
    expl_format: str = "png",
    fast_metrics: bool = True,
    aimle_states: Optional[dict] = None,
) -> ExplainResults:
    """Explain ``split`` with ``model`` (an eval model, or a training
    model run in eval mode) on the model's device.  ``shard_index`` /
    ``num_shards`` take one share of an exact partition of the split, and
    the shards' sums add up to the whole run's.  Batch ``b``'s noise
    comes from a generator seeded from ``(seed, b)``."""
    device = next(model.parameters()).device
    vocab = data.vocab
    label2ans = data.answers.label2ans
    tokenizer = data.tokenizer

    def forward(batch, b_idx):
        gen = torch.Generator(device=device).manual_seed(
            batch_seed(seed, b_idx))
        with torch.no_grad():
            out = model(batch, generator=gen, train=False,
                        aimle_states=aimle_states)
            preds = out.logits.argmax(-1).float()[:, None]
            mask = (out.node_mask[..., 0].float() if out.node_mask is not None
                    else torch.ones(batch.node_mask.shape, device=device))
            parts = [preds, mask]
            if out.mask_text is not None:
                parts.append(out.mask_text.float())
            # one copy to the host: the predictions beside the masks
            got = torch.cat(parts, dim=1).cpu().numpy()
        n = mask.shape[1]
        return (got[:, 0].astype(np.int64), got[:, 1:1 + n],
                got[:, 1 + n:] if out.mask_text is not None else None)

    accuracy, accuracy_at, ans_coo, qst_coo, text_coo = [], [], [], [], []
    n_seen = 0
    # the vectorized metric pass, unless a per-sample artifact (rendering,
    # mask collection) needs the sample loop, which stays the oracle
    use_fast = fast_metrics and not save_expl and collect_masks is None
    fast_acc = dict.fromkeys(SUM_KEYS, 0.0)
    ans_vid = _answer_vocab_ids(label2ans, vocab) if use_fast else None
    word_cache: dict = {}

    ds = data.datasets[split]
    buckets = data.bucket_collators.get(split)
    if buckets and len(buckets) > 1:
        # size-bucketed; a truncated run (max_batches) shuffles the bucket
        # schedule with a fixed seed so it does not see only the first
        # bucket.  pad_shards=False: shards partition the split exactly,
        # so no wrap-padded duplicate skews the reduced sums
        batches = iterate_batches_bucketed(
            ds, buckets, shuffle=max_batches is not None, seed=seed,
            shard_index=shard_index, num_shards=num_shards,
            pad_shards=False)
    else:
        batches = iterate_batches(ds, data.collators[split],
                                  shard_index=shard_index,
                                  num_shards=num_shards, pad_shards=False)
    stream = prefetch(_with_host_half(batches), depth=2, device=device)
    try:
        for b_idx, (batch, (meta, host)) in enumerate(stream):
            if max_batches is not None and b_idx >= max_batches:
                break
            preds, node_mask, mask_text = forward(batch, b_idx)
            labels = host.labels.numpy()
            node_valid = host.node_mask.numpy()
            tokens0 = host.node_tokens.numpy()[:, :, 0]
            qst_ids, qst_valid = host.qst_tokens.numpy(), host.qst_mask.numpy()
            if use_fast:
                _accumulate_fast(
                    fast_acc, preds=preds, labels=labels, ids0=tokens0,
                    valid=node_valid, sel=(node_mask > 0.0) & node_valid,
                    num_real=meta.num_real, questions=meta.questions,
                    ans_vid=ans_vid, stoi=vocab.stoi, word_cache=word_cache,
                    mask_text=mask_text, qst_ids=qst_ids,
                    qst_valid=qst_valid, tokenizer=tokenizer)
                n_seen += meta.num_real
                continue
            for s in range(meta.num_real):
                n_seen += 1
                label_gt = label2ans[int(labels[s])]
                answer_str = label2ans[int(preds[s])]
                question_raw = meta.questions[s]
                sel = node_valid[s]
                mask_s = node_mask[s][sel]
                node_labels = [vocab.itos[t] for t in tokens0[s][sel]]
                if collect_masks is not None:
                    collect_masks[str(meta.question_ids[s])] = {
                        "mask": np.asarray(mask_s, np.float32),
                        "pred": answer_str,
                        "gt": label_gt,
                    }
                accuracy.append(float(answer_str == label_gt))    # :145
                if answer_str in node_labels:                      # :146-147
                    accuracy_at.append(float(answer_str == label_gt))
                if answer_str == label_gt:                         # :148-173
                    ans_coo.append(compute_ans_token_cooccurrence(
                        mask_s, answer_str, label_gt, node_labels,
                        question_raw, threshold=0.0))
                    qst_coo.append(compute_qst_token_cooccurrence(
                        mask_s, node_labels, question_raw, threshold=0.0))
                    if mask_text is not None:
                        text_coo.append(compute_text_expl_token_cooccurrence(
                            mask_s, node_labels, _text_expl(
                                s, mask_text, qst_ids, qst_valid, tokenizer),
                            question_raw, threshold=0.0))
                if save_expl and expl_dir is not None:
                    _save_explanation(meta, s, node_labels, mask_s,
                                      question_raw, answer_str, label_gt,
                                      expl_dir, run, expl_format,
                                      save_qst_meta_data)
    finally:
        stream.close()

    def nan_sums(xs):
        vals = np.asarray([x[0] if isinstance(x, tuple) else x for x in xs],
                          dtype=np.float64)
        return float(np.nansum(vals)), float(np.sum(~np.isnan(vals)))

    if use_fast:
        sums = dict(fast_acc)
    else:
        sums = {"acc_sum": float(np.sum(accuracy)),
                "acc_n": float(len(accuracy)),
                "acc_at_sum": float(np.sum(accuracy_at)),
                "acc_at_n": float(len(accuracy_at))}
        sums["ans_sum"], sums["ans_n"] = nan_sums(ans_coo)
        sums["qst_sum"], sums["qst_n"] = nan_sums(qst_coo)
        sums["text_sum"], sums["text_n"] = nan_sums(text_coo)
    sums["n_seen"] = float(n_seen)
    totals = reduce_dict(sums, average=False)

    def ratio(s, n):
        return float(totals[s] / totals[n]) if totals[n] else float("nan")

    res = ExplainResults(
        accuracy=ratio("acc_sum", "acc_n"),
        accuracy_at=ratio("acc_at_sum", "acc_at_n"),
        ans_token_coo=ratio("ans_sum", "ans_n"),
        qst_token_coo=ratio("qst_sum", "qst_n"),
        text_token_coo=ratio("text_sum", "text_n"),
        num_samples=int(totals["n_seen"]),
        sums=dict(totals),
    )
    print(res.summary(), flush=True)
    return res


def _save_explanation(meta, s, node_labels, mask_s, question_raw,
                      answer_str, label_gt, expl_dir, run, expl_format,
                      save_qst_meta_data) -> None:
    """Render sample ``s``'s subgraph under
    ``<expl_dir>/<image>/<question>/`` and, with ``save_qst_meta_data``,
    its question, answer and label as JSON (``run_token_coo.py:130-140``)."""
    from ..utils.graph_vis import save_graph

    qid, img = meta.question_ids[s], meta.image_ids[s]
    save_graph(graph=meta.graphs[s],
               labels={j: lbl for j, lbl in enumerate(node_labels)},
               path=expl_dir, mask=mask_s,
               question=f"{question_raw} MGat: {answer_str} GT: {label_gt}",
               filename=f"{qid}_{run}.{expl_format}", mode="discrete",
               img_id=img, q_id=qid, threshold=0.0)
    if save_qst_meta_data:
        qdir = os.path.join(expl_dir, str(img), str(qid))
        os.makedirs(qdir, exist_ok=True)
        with open(os.path.join(qdir, f"{qid}_{run}_qst_meta_data.json"),
                  "w") as f:
            json.dump({"question": question_raw, "answer": answer_str,
                       "label": label_gt}, f)
