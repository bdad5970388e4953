"""Node mask -> edge mask with the reference's backward (the port of
``isubgvqa_tpu/sampling/node_edge.py``; ``NodeMaskToEdgeMask``,
``sampling/node_edge_masks.py:5-19`` of the reference).

Forward: ``edge[e] = mask[src[e]] * mask[dst[e]]``.  Backward: the
incoming cotangent is summed to the **destination** nodes only
(``node_edge_masks.py:13-19``), not by the product rule.  Two layouts:

* :func:`node_mask_to_edge_mask`, flat: ``mask [N]`` or ``[N, 1]`` and
  ``src`` / ``dst [E]``.  Its gathers follow JAX's indexing (a negative
  index wraps once, the rest are clamped) and its backward drops
  destinations outside ``[0, num_nodes)``, as ``jax.ops.segment_sum``
  does;
* :func:`dense_node_gate_to_edge_gate`, per graph: the gate ``[B, N]``
  and ``src`` / ``dst`` / ``edge_mask [B, E]``, 0 on padding edges; the
  version the GAT path trains through.  The CUDA training conv
  (``csrc/gat_train.cu``) reproduces the same rule.
"""

from __future__ import annotations

import torch

from ..ops.segment import gather_segments, segment_sum


class _NodeMaskToEdgeMask(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mask, src, dst, num_nodes):
        ctx.save_for_backward(dst)
        ctx.num_nodes, ctx.shape = num_nodes, mask.shape
        return gather_segments(mask, src) * gather_segments(mask, dst)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        grad = segment_sum(g, dst, ctx.num_nodes).reshape(ctx.shape)
        return grad, None, None, None


def node_mask_to_edge_mask(mask: torch.Tensor, src: torch.Tensor,
                           dst: torch.Tensor, num_nodes: int
                           ) -> torch.Tensor:
    """``mask [N, 1]`` (or ``[N]``), ``src`` / ``dst [E]`` -> edge mask
    ``[E, 1]`` (or ``[E]``) with the dst-only backward."""
    return _NodeMaskToEdgeMask.apply(mask, src, dst, num_nodes)


def _inside(idx, n, edge_mask):
    return edge_mask & (idx >= 0) & (idx < n)


class _NodeGateToEdgeGate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gate, src, dst, edge_mask):
        n = gate.shape[1]
        valid = _inside(src, n, edge_mask) & _inside(dst, n, edge_mask)
        s = torch.where(valid, src.long(), 0)
        d = torch.where(valid, dst.long(), 0)
        ctx.save_for_backward(d, valid)
        ctx.n = n
        eg = torch.gather(gate, 1, s) * torch.gather(gate, 1, d)
        return torch.where(valid, eg, torch.zeros((), dtype=eg.dtype,
                                                  device=eg.device))

    @staticmethod
    def backward(ctx, g):
        d, valid = ctx.saved_tensors
        gv = torch.where(valid, g, torch.zeros((), dtype=g.dtype,
                                               device=g.device))
        dgate = torch.zeros(g.shape[0], ctx.n, dtype=g.dtype, device=g.device)
        dgate.scatter_add_(1, d, gv)
        return dgate, None, None, None


def dense_node_gate_to_edge_gate(gate: torch.Tensor, src: torch.Tensor,
                                 dst: torch.Tensor,
                                 edge_mask: torch.Tensor) -> torch.Tensor:
    """``gate [B, N]``, ``src/dst/edge_mask [B, E]`` -> edge gate
    ``[B, E]`` with the dst-only backward."""
    return _NodeGateToEdgeGate.apply(gate, src, dst, edge_mask)
