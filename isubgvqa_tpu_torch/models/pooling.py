"""Question-conditioned global attention readout (the port of
``isubgvqa_tpu/models/pooling.py``):
``gate = softmax_graph(node_nn(x) . ques_nn(u) / sqrt(d))``,
``out = sum_graph gate * node_nn(x)``, with the node-mask pre-multiply."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..ops.dense_graph import node_softmax
from .layers import mlp


class GlobalAttentionPooling(nn.Module):
    def __init__(self, num_node_features: int = 300,
                 num_out_features: int = 300):
        super().__init__()
        c = num_out_features
        self.node_nn = mlp(num_node_features, c, c, gelu_last=False)
        self.ques_nn = mlp(c, c, c, gelu_last=False)

    def forward(self, x, u, node_mask_b,
                node_mask: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None):
        """``x [B, N, F]``, ``u [B, C]``, ``node_mask_b [B, N]`` validity,
        ``node_mask [B, N, 1]`` the sampled mask -> (pooled [B, C],
        gate [B, N, 1]); products at ``dtype``."""
        xn = self.node_nn(x, dtype)
        if node_mask is not None:
            xn = xn * node_mask
        uq = self.ques_nn(u, dtype)
        gate = torch.einsum("bnd,bd->bn", xn.float(), uq.float())
        gate = gate / math.sqrt(xn.shape[-1])
        gate = node_softmax(gate, node_mask_b)[..., None].to(xn.dtype)
        masked = torch.where(node_mask_b[..., None], gate * xn,
                             torch.zeros((), dtype=xn.dtype, device=xn.device))
        return masked.sum(1), gate
