"""Masked GATv2 stack (the port of ``isubgvqa_tpu/models/mgat.py``).

Per layer: instruction fusion ``gelu(h * instr)``; on a masked layer
(threshold != 1.0, the last one in the config of record) the mask head
samples a node gate with the configured sampler (aimle with the layer's
own adaptive state, as in ``mgat.py:326-343``); then the layer itself.
Eval runs one :func:`~isubgvqa_tpu_torch.ops.gat_kernel.fused_gat_layer`
call (the GATv2 conv, x_proj, the instruction SDP reweighting, GraphNorm
and the residual); on unmasked layers the kernel computes the instruction fusion
itself (``fuse_instr``), as the TPU path does.  Training computes
``gelu(h * instr)`` in plain torch on every layer (``fuse_instr`` is
eval-only, ``mgat.py:172-173``) and runs
:func:`~isubgvqa_tpu_torch.ops.gat_train.fused_gat_layer_train`: the
differentiable conv on the card plus the plain node-space head.

Parameters keep upstream's layout: ``convs.<i>.{lin_l, lin_r, lin_edge,
att, bias, mask}``, ``x_proj.<i>``, ``bns.<i>``.  The JAX package
stacks the four ``lin_edge`` weights under one ``lin_edge_all`` param
(a TPU layout choice, ``mgat.py:311-341``); here each conv keeps its
own, and ``convert_state_dict`` does the stacking.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.gat_kernel import fused_gat_layer
from ..ops.gat_train import fused_gat_layer_train
from .layers import GraphNorm, mlp
from .masking import MaskingModel


class MGATConv(nn.Module):
    """``MaskingGATv2Conv`` parameters (``mgat_v2_conv.py``)."""

    def __init__(self, channels: int, heads: int, masked: bool,
                 sample_k: Optional[int], mask_dropout: float = 0.2,
                 **sampler):
        super().__init__()
        hc = heads * channels
        self.lin_l = nn.Linear(channels, hc)
        self.lin_r = nn.Linear(channels, hc)
        self.lin_edge = nn.Linear(channels, hc, bias=False)
        self.att = nn.Parameter(torch.empty(1, heads, channels))
        self.bias = nn.Parameter(torch.zeros(hc))
        nn.init.xavier_uniform_(self.att)
        self.mask = (MaskingModel(channels, channels, sample_k, mask_dropout,
                                  **sampler)
                     if masked else None)


class MGAT(nn.Module):
    def __init__(self, channels: int = 300, num_ins: int = 4, heads: int = 4,
                 masking_thresholds: Sequence[float] = (1.0, 1.0, 1.0, 0.15),
                 sample_k: Optional[int] = None, mask_dropout: float = 0.2,
                 **sampler):
        """``sampler`` holds the mask head's sampler options
        (``sampler_type``, ``nb_samples``, ``alpha``, ``beta``, ``tau``)."""
        super().__init__()
        self.heads = heads
        masked = [float(t) != 1.0 for t in masking_thresholds]
        self.convs = nn.ModuleList(
            [MGATConv(channels, heads, masked[i], sample_k, mask_dropout,
                      **sampler)
             for i in range(num_ins)])
        self.x_proj = nn.ModuleList(
            [mlp(heads * channels, channels * heads // 2, channels)
             for _ in range(num_ins)])
        self.bns = nn.ModuleList([GraphNorm(channels) for _ in range(num_ins)])

    def layer_params(self, i: int) -> dict:
        conv, proj, bn = self.convs[i], self.x_proj[i], self.bns[i]
        return {
            "wl": conv.lin_l.weight, "bl": conv.lin_l.bias,
            "wr": conv.lin_r.weight, "br": conv.lin_r.bias,
            "we": conv.lin_edge.weight, "att": conv.att[0],
            "cbias": conv.bias, "w1": proj[0].weight, "b1": proj[0].bias,
            "w2": proj[2].weight, "b2": proj[2].bias,
            "gn_w": bn.weight, "gn_b": bn.bias, "gn_a": bn.mean_scale,
        }

    def forward(self, x, batch, edge_attr, instr_vectors, lang,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None, train: bool = False,
                aimle_states: Optional[dict] = None):
        """-> (h [B, N, C], last mask [B, N, 1] | None, alphas).  Masked
        layer ``i`` samples with ``aimle_states[i]`` (aimle only)."""
        h = x
        mask = None
        alphas = []
        for i, conv in enumerate(self.convs):
            ins = instr_vectors[:, i, :]
            fuse = conv.mask is None and not train
            xf = h if fuse else F.gelu(h * ins[:, None, :])
            if conv.mask is not None:
                gate = conv.mask(xf, lang, batch.node_mask, generator, noise,
                                 dtype, train, (aimle_states or {}).get(i))
                mask = gate
            else:
                gate = torch.ones(h.shape[:2] + (1,), dtype=h.dtype,
                                  device=h.device)
            args = (h, xf, ins, gate, batch.edge_src, batch.edge_dst,
                    batch.edge_mask, batch.node_mask, edge_attr,
                    self.layer_params(i))
            if train:
                h, alpha = fused_gat_layer_train(*args)
            else:
                h, alpha = fused_gat_layer(*args, fuse_instr=fuse)
            alphas.append(alpha)
        return h, mask, alphas
