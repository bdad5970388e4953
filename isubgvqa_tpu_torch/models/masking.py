"""Mask head, gumbel branch (the port of ``isubgvqa_tpu/models/masking.py``).

gate = GELU(node_nn(x) . ques_nn(u) / sqrt(d)), scored node by node
against **its own** graph's question vector (the JAX package's
documented deviation from the reference's ``ques_nn(u)[batch]`` double
index, ``masking.py:22-33``); then the dense scores with zero-filled
padding slots (which compete in the top-k, as ``to_dense_batch``'s fill
does in the reference) go through the gumbel sampler.  In training the
gate first gets dropout 0.2 (``masking.py:128``), drawn from the step's
generator, and the sampler runs its train ensemble; its relaxed rounds
carry the straight-through gradient.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..sampling.gumbel import GumbelSamplerConfig, gumbel_topk_sample
from .layers import keep_mask, mlp


class MaskingModel(nn.Module):
    def __init__(self, dim_nodes: int, dim_questions: int, sample_k: int,
                 dropout: float = 0.2):
        super().__init__()
        self.node_nn = mlp(dim_nodes, dim_questions)
        self.ques_nn = mlp(dim_questions, dim_questions)
        self.sampler = GumbelSamplerConfig(k=sample_k)
        self.dropout = dropout

    def forward(self, x, u, node_mask,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None, train: bool = False):
        """``x [B, N, C]``, ``u [B, C]`` -> gate ``[B, N, 1]``."""
        xq = self.node_nn(x, dtype)
        uq = self.ques_nn(u, dtype)
        gate = torch.einsum("bnd,bd->bn", xq.float(), uq.float())
        gate = F.gelu((gate / math.sqrt(xq.shape[-1])).to(xq.dtype))
        if train and self.dropout > 0.0:
            gate = gate * keep_mask(gate.shape, self.dropout, generator,
                                    gate.device).to(gate.dtype)
        dense = torch.where(node_mask, gate.float(),
                            torch.zeros((), device=gate.device))
        out = gumbel_topk_sample(dense, self.sampler, train=train,
                                 generator=generator, noise=noise)[0]
        out = torch.where(node_mask, out, torch.zeros((), device=out.device))
        return out.to(xq.dtype)[..., None]
