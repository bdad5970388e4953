"""Node gate -> edge gate with the reference's backward (the port of
``isubgvqa_tpu/sampling/node_edge.py:dense_node_gate_to_edge_gate``).

Forward: ``egate[e] = gate[src[e]] * gate[dst[e]]`` on valid edges, 0 on
padding.  Backward: the incoming cotangent is summed to the
**destination** nodes only (``sampling/node_edge_masks.py:13-19`` of the
reference), not by the product rule.  The CUDA training conv
(``csrc/gat_train.cu``) reproduces the same rule.
"""

from __future__ import annotations

import torch


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
