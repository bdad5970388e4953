"""Global edge-rewiring policies and their tensor utilities (the port of
``isubgvqa_tpu/sampling/rewiring.py``; the reference's PR-MPNN support
code, which the VQA path does not run but the sampler library exposes):

* :func:`rewire_global_directed` / :func:`rewire_global_undirected`,
  the dense-adjacency top-k rewiring MAP solvers
  (``sampling/methods/deterministic_scheme.py:6-33``);
* :func:`masked_softmax`, :func:`weighted_cross_entropy`,
  :func:`batched_edge_index_to_batched_adj`, :func:`non_merge_coalesce`
  and :func:`batch_repeat_edge_index` (``tensor_utils.py:8-124``).

The top-k is a ``>=`` threshold at the k-th largest score, so ties can
select more than k entries, as in the reference and the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

LARGE_NUMBER = 1.0e10
INT32_MAX = torch.iinfo(torch.int32).max


def _existing_penalty(scores: torch.Tensor,
                      adj: Optional[torch.Tensor]) -> torch.Tensor:
    """``LARGE_NUMBER`` off the scores of existing edges (dense boolean
    ``adj [B, N, N]``), so they are never selected again
    (``deterministic_scheme.py:10,24``)."""
    if adj is None:
        return scores
    return scores - adj[..., None].to(scores.dtype) * LARGE_NUMBER


def _kth_largest(flat: torch.Tensor, k: int) -> torch.Tensor:
    """``flat [B, T, E]`` -> the k-th largest over ``T``, ``[B, 1, E]``."""
    return torch.topk(flat, min(k, flat.shape[1]), dim=1).values[:, -1:]


def rewire_global_directed(scores: torch.Tensor, k: int,
                           adj: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Top-k over all N^2 directed pairs of each graph
    (``deterministic_scheme.py:6-16``): ``scores [B, N, N, E]`` -> 0/1
    mask of the k best new edges."""
    b, n, _, e = scores.shape
    flat = _existing_penalty(scores, adj).reshape(b, n * n, e)
    mask = (flat >= _kth_largest(flat, k)).to(scores.dtype)
    return mask.reshape(b, n, n, e)


def rewire_global_undirected(scores: torch.Tensor, k: int,
                             adj: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Top-k over the strict upper triangle of the symmetrized scores,
    mirrored (``deterministic_scheme.py:19-33``)."""
    n = scores.shape[1]
    scores = _existing_penalty(scores, adj)
    scores = scores + scores.transpose(1, 2)
    iu, ju = torch.triu_indices(n, n, 1, device=scores.device)
    flat = scores[:, iu, ju, :]                               # [B, T, E]
    tri_mask = (flat >= _kth_largest(flat, k)).to(scores.dtype)
    out = torch.zeros_like(scores)
    out[:, iu, ju, :] = tri_mask
    return out + out.transpose(1, 2)


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor,
                   axis: int = -1) -> torch.Tensor:
    """Softmax over the entries where ``mask > 0``; the rest read 0
    (``tensor_utils.py:50-65``)."""
    keep = mask > 0
    masked = torch.where(keep, logits, torch.tensor(
        -1.0e30, dtype=logits.dtype, device=logits.device))
    return torch.where(keep, torch.softmax(masked, axis),
                       torch.zeros((), dtype=logits.dtype,
                                   device=logits.device))


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """Per-sample weighted cross entropy over the weights' sum (at least
    1) (``tensor_utils.py:68-88``)."""
    logp = torch.log_softmax(logits, -1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    return (nll * weights).sum() / weights.sum().clamp_min(1.0)


def batched_edge_index_to_batched_adj(src: torch.Tensor, dst: torch.Tensor,
                                      edge_mask: torch.Tensor,
                                      node_mask: torch.Tensor):
    """Dense ``batched_edge_index_to_batched_adj``
    (``tensor_utils.py:8-47``): per-graph edge positions ``src`` / ``dst
    [B, E]`` with their validity -> boolean ``(original_adj, rewire_adj)
    [B, N, N]``.  ``original_adj`` marks every edge; ``rewire_adj`` the
    pairs the rewiring policies must not sample, the existing non-loop
    edges and the whole diagonal of valid nodes (the reference strips
    self-loops and adds one per node, ``tensor_utils.py:27-39``)."""
    n = node_mask.shape[1]
    nodes = torch.arange(n, device=src.device)
    oh_src = (src.long()[..., None] == nodes).float()
    oh_dst = (dst.long()[..., None] == nodes).float()
    ev = edge_mask.float()[..., None]
    original = torch.einsum("ben,bem->bnm", oh_src * ev, oh_dst) > 0
    eye = torch.eye(n, dtype=torch.bool, device=src.device)[None]
    non_loop = original & ~eye
    diag = eye & node_mask[:, :, None] & node_mask[:, None, :]
    return original, non_loop | diag


def non_merge_coalesce(src: torch.Tensor, dst: torch.Tensor,
                       edge_attr: Optional[torch.Tensor],
                       edge_weight: Optional[torch.Tensor], num_nodes: int,
                       edge_mask: Optional[torch.Tensor] = None,
                       sort_by_row: bool = True):
    """Edges sorted by (row, col), or by (col, row), attributes and
    weights carried along, duplicates kept (``tensor_utils.py:91-114``):
    a stable argsort of the int32 key ``major * num_nodes + minor``, with
    invalid edges at ``INT32_MAX`` so they sort last.  ``[E]`` or batched
    ``[B, E]`` indices; returns ``(src, dst, edge_attr, edge_weight)``
    and, given ``edge_mask``, the mask sorted too."""
    major, minor = (src, dst) if sort_by_row else (dst, src)
    key = major.to(torch.int32) * num_nodes + minor.to(torch.int32)
    if edge_mask is not None:
        key = torch.where(edge_mask, key, torch.tensor(
            INT32_MAX, dtype=torch.int32, device=key.device))
    perm = torch.argsort(key, dim=-1, stable=True)
    axis = perm.dim() - 1

    def take(x):
        idx = perm.reshape(perm.shape + (1,) * (x.dim() - perm.dim()))
        return torch.gather(x, axis, idx.expand_as(x))

    out = (take(src), take(dst),
           take(edge_attr) if edge_attr is not None else None,
           take(edge_weight) if edge_weight is not None else None)
    if edge_mask is not None:
        out = out + (take(edge_mask),)
    return out


def batch_repeat_edge_index(edge_index: torch.Tensor, num_nodes: int,
                            repeats: int) -> torch.Tensor:
    """A flat ``[2, E]`` edge index tiled ``repeats`` times, each copy
    offset by ``num_nodes`` (``tensor_utils.py:117-124``)."""
    if repeats == 1:
        return edge_index
    e = edge_index.shape[1]
    offsets = (torch.arange(repeats, dtype=edge_index.dtype,
                            device=edge_index.device)
               * num_nodes).repeat_interleave(e)
    return edge_index.repeat(1, repeats) + offsets[None, :]
