"""Explanation-quality metrics: token co-occurrence between the masked
subgraph and the answer / question / text explanation.

The port's own copy of ``isubgvqa_tpu/explain/token_coo.py``:
line-for-line semantic equivalents of the reference's
``utils/token_coo_fns.py:4-36`` (pure host-side Python over per-sample
masks and object-label lists).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def compute_ans_token_cooccurrence(
    mask: Sequence[float], ans_token: str, label_gt: str,
    objects: Sequence[str], qst_tokens: str, threshold: float = 0.0,
) -> Tuple[float, int]:
    """token_coo_fns.py:4-10."""
    objects_masked = [obj for i, obj in enumerate(objects) if mask[i] > threshold]
    if (label_gt in objects) and ("color" not in qst_tokens):
        return (1.0, 1) if ans_token in objects_masked else (0.0, 0)
    return (np.nan, 0)


def compute_qst_token_cooccurrence(
    mask: Sequence[float], objects: Sequence[str], qst_tokens,
    threshold: float = 0.0,
) -> Tuple[float, int]:
    """token_coo_fns.py:13-24."""
    if isinstance(qst_tokens, str):
        qst_tokens_mask = qst_tokens.split("?")[0].lower().split(" ")
    else:
        qst_tokens_mask = qst_tokens
    qst_tok_matches = [tok for tok in qst_tokens_mask if tok in objects]
    if len(qst_tok_matches) == 0:
        return (np.nan, 0)
    objects_masked = [obj for i, obj in enumerate(objects) if mask[i] > threshold]
    kept = [q for q in qst_tokens_mask if q in objects_masked]
    return (len(kept) / len(qst_tok_matches), len(qst_tok_matches))


def compute_text_expl_token_cooccurrence(
    mask: Sequence[float], objects: Sequence[str],
    text_expl_tokens: Sequence[str], qst_tokens: str,
    threshold: float = 0.0,
) -> float:
    """token_coo_fns.py:27-36."""
    candidates = [t for t in text_expl_tokens if t in objects]
    if len(candidates) == 0:
        return np.nan
    objects_masked = [obj for i, obj in enumerate(objects) if mask[i] > threshold]
    kept = [q for q in candidates if q in objects_masked]
    return len(kept) / len(candidates)
