"""Per-graph top-k by ratio or count on the dense node layout (the port
of ``isubgvqa_tpu/ops/topk_ratio.py``; the reference's
``utils/topk.py:5-46``, used by its vestigial ``topk_sampling`` path):
each graph keeps ``ceil(ratio * num_nodes)`` nodes for a float ratio, or
``min(k, num_nodes)`` for an int ``k`` or a float above 1, by score."""

from __future__ import annotations

from typing import Union

import torch


def topk_per_graph(scores: torch.Tensor, ratio_or_k: Union[float, int],
                   node_mask: torch.Tensor) -> torch.Tensor:
    """``scores [B, N]``, ``node_mask [B, N]`` -> 0/1 mask at ``scores``'
    dtype selecting each graph's top nodes.  Ranks come from a stable
    descending sort, so tied scores are taken in index order, as JAX's
    stable ``argsort`` takes them."""
    n = scores.shape[1]
    num_nodes = node_mask.sum(1)                              # [B]
    if isinstance(ratio_or_k, int) or ratio_or_k > 1:
        k_per_graph = num_nodes.clamp_max(int(ratio_or_k))
    else:
        k_per_graph = torch.ceil(ratio_or_k * num_nodes.float()).long()
    masked = torch.where(node_mask, scores,
                         torch.tensor(-1.0e30, dtype=scores.dtype,
                                      device=scores.device))
    order = torch.argsort(-masked, dim=1, stable=True)        # descending
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=scores.device).expand_as(order))
    keep = ranks < k_per_graph[:, None]
    return (keep & node_mask).to(scores.dtype)
