"""Dense per-graph graph ops (the port of
``isubgvqa_tpu/ops/dense_graph.py``): the batch as a ``[B, N_max, ...]``
node layout and a ``[B, E_max, ...]`` edge layout, every edge <-> node
move a gather or a batched product with a one-hot incidence.  Masks are
explicit; padding rows contribute exact zeros.

Index rules follow JAX: a one-hot row of an out-of-range position is
all zeros, and :func:`gather_nodes` / :func:`edge_softmax`'s gathers
(``jnp.take_along_axis``) wrap a negative position once and read NaN for
one still out of range.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG = -1.0e30
TINY = torch.finfo(torch.float32).tiny


def _take_nodes(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``x [B, N, F]`` at ``pos [B, E]`` -> ``[B, E, F]``, out-of-range
    rows NaN (``jnp.take_along_axis``'s fill)."""
    n = x.shape[1]
    pos = pos.long()
    pos = torch.where(pos < 0, pos + n, pos)
    valid = (pos >= 0) & (pos < n)
    idx = pos.clamp(0, n - 1)[..., None].expand(-1, -1, x.shape[2])
    out = torch.gather(x, 1, idx)
    return torch.where(valid[..., None], out,
                       torch.tensor(float("nan"), dtype=x.dtype,
                                    device=x.device))


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """``einsum`` summed in f32 (XLA's ``preferred_element_type``), the
    result at ``dtype``."""
    return torch.einsum(eq, a.float(), b.float()).to(dtype)


def edge_onehot(pos: torch.Tensor, num_nodes: int,
                edge_mask: Optional[torch.Tensor] = None,
                dtype=torch.bfloat16) -> torch.Tensor:
    """One-hot incidence ``[B, E, N]`` of per-edge node positions; masked
    edges and out-of-range positions give all-zero rows."""
    oh = (pos.long()[..., None] == torch.arange(
        num_nodes, device=pos.device)).to(dtype)
    if edge_mask is not None:
        oh = oh * edge_mask[..., None].to(dtype)
    return oh


def gather_nodes(x: torch.Tensor, pos: torch.Tensor,
                 via: str = "take") -> torch.Tensor:
    """``x [B, N, F]``, ``pos [B, E]`` -> per-edge features ``[B, E, F]``:
    a gather (``via='take'``) or a product with the one-hot incidence
    (``via='onehot'``, whose backward is a product too)."""
    if via == "take":
        return _take_nodes(x, pos)
    oh = edge_onehot(pos, x.shape[1], dtype=x.dtype)
    return _einsum_f32("ben,bnf->bef", oh, x, x.dtype)


def gather_nodes_oh(x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Gather with a prebuilt (possibly masked) incidence matrix."""
    return _einsum_f32("ben,bnf->bef", onehot.to(x.dtype), x, x.dtype)


def aggregate_edges(msg: torch.Tensor, onehot_dst: torch.Tensor
                    ) -> torch.Tensor:
    """Sum per-edge messages ``msg [B, E, F]`` into their destination
    nodes through ``onehot_dst [B, E, N]`` -> ``[B, N, F]``."""
    return _einsum_f32("ben,bef->bnf", onehot_dst.to(msg.dtype), msg,
                       msg.dtype)


def edge_softmax(logits: torch.Tensor, dst: torch.Tensor,
                 onehot_dst: torch.Tensor,
                 edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax of per-edge logits ``[B, E, H]`` over each destination
    node's incoming edges (GATv2's attention normalization), from the
    incidence and dense reductions; masked edges get 0."""
    if edge_mask is not None:
        logits = torch.where(edge_mask[..., None], logits,
                             torch.tensor(NEG, dtype=logits.dtype,
                                          device=logits.device))
    lf = logits.float()
    inc = onehot_dst > 0                                       # [B, E, N]
    per_node_max = torch.where(inc[..., None], lf[:, :, None, :],
                               torch.tensor(NEG, device=lf.device)
                               ).amax(1)                       # [B, N, H]
    maxima = _take_nodes(per_node_max, dst)
    expv = torch.exp(lf - maxima.clamp_min(NEG))
    if edge_mask is not None:
        expv = torch.where(edge_mask[..., None], expv,
                           torch.zeros((), device=expv.device))
    denom = torch.einsum("ben,beh->bnh", onehot_dst.float(), expv)
    denom = _take_nodes(denom, dst)
    return (expv / denom.clamp_min(TINY)).to(logits.dtype)


def node_softmax(logits: torch.Tensor,
                 node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax over each graph's nodes (axis 1), masked: the per-graph
    attention-pooling normalization."""
    lf = logits.float()
    if node_mask is not None:
        lf = torch.where(node_mask, lf, torch.full_like(lf, NEG))
    lf = lf - lf.amax(1, keepdim=True)
    expv = torch.exp(lf)
    if node_mask is not None:
        expv = torch.where(node_mask, expv, torch.zeros_like(expv))
    denom = torch.clamp(expv.sum(1, keepdim=True), min=TINY)
    return (expv / denom).to(logits.dtype)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor],
                axis: int = 1, keepdims: bool = False) -> torch.Tensor:
    """Mean over ``axis`` counting only masked-in rows (at least one)."""
    if mask is None:
        return x.mean(axis, keepdim=keepdims)
    m = mask.to(x.dtype)
    m = m.reshape(m.shape + (1,) * (x.dim() - m.dim()))
    s = (x * m).sum(axis, keepdim=keepdims)
    c = m.sum(axis, keepdim=keepdims).clamp_min(1.0)
    return s / c


def graph_norm_dense(x: torch.Tensor, node_mask: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor,
                     mean_scale: torch.Tensor, eps: float = 1e-5
                     ) -> torch.Tensor:
    """GraphNorm per graph over the node axis, in f32: the same math as
    :func:`~.segment.segment_normalize` on the flat layout, then the
    affine."""
    xf = x.float()
    mean = masked_mean(xf, node_mask, axis=1, keepdims=True)
    shifted = xf - mean_scale * mean
    var = masked_mean(shifted * shifted, node_mask, axis=1, keepdims=True)
    out = shifted * torch.rsqrt(var + eps)
    out = torch.where(node_mask[..., None], out, torch.zeros((),
                                                             device=x.device))
    return (out * weight + bias).to(x.dtype)
