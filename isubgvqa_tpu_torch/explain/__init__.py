"""Explanation extraction and its quality metrics (the port of
``isubgvqa_tpu/explain/``)."""

from .runner import ExplainResults, run_token_coo_exp
from .token_coo import (
    compute_ans_token_cooccurrence,
    compute_qst_token_cooccurrence,
    compute_text_expl_token_cooccurrence,
)

__all__ = [
    "compute_ans_token_cooccurrence",
    "compute_qst_token_cooccurrence",
    "compute_text_expl_token_cooccurrence",
    "ExplainResults",
    "run_token_coo_exp",
]
