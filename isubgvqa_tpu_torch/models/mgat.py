"""Masked GATv2 stack (the port of ``isubgvqa_tpu/models/mgat.py``).

Per layer: with the explainer bypass at this layer, its input is
replaced (``mgat.py:140-141``); instruction fusion ``gelu(h * instr)``,
or ``[h | instr]`` with ``concat_instr`` (``in_ch = 2C``), or ``h`` with
the instruction off; on a masked layer (threshold != 1.0, the last one
in the config of record) the mask head samples a node gate with the
configured sampler (aimle with the layer's own adaptive state, as in
``mgat.py:326-343``); then the layer itself, whose output the gate also
multiplies under ``interpretable_mode`` (not with ``use_global_mask``);
then the node head's logits (``node_classification``) and the global
mask's product (``use_global_mask``: the running product of the layers'
gates multiplies ``h``, ``mgat.py:318-320,351-354``).
Eval runs one :func:`~isubgvqa_tpu_torch.ops.gat_kernel.fused_gat_layer`
call (the GATv2 conv, x_proj, the instruction SDP reweighting, GraphNorm,
the residual and the gate's multiply); on unmasked, non-concat layers
with the instruction on the kernel computes the instruction fusion
itself (``fuse_instr``), as the TPU path does; a concat layer's input
``[h | instr]`` is built first (``concat_instr_features``).  Training
computes each layer's input in plain torch (``fuse_instr`` is eval-only,
``mgat.py:172-173``) and runs
:func:`~isubgvqa_tpu_torch.ops.gat_train.fused_gat_layer_train`: the
differentiable conv on the card plus the plain node-space head.

Parameters keep upstream's layout: ``convs.<i>.{lin_l, lin_r, lin_edge,
att, bias, mask}``, ``x_proj.<i>``, ``bns.<i>``, ``node_logits``.  The
JAX package stacks the four ``lin_edge`` weights under one
``lin_edge_all`` param (a TPU layout choice, ``mgat.py:311-341``); here
each conv keeps its own, and the weights bridge does the stacking.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.gat_kernel import concat_instr_features, fused_gat_layer
from ..ops.gat_train import fused_gat_layer_train
from .layers import GraphNorm, mlp
from .masking import MaskingModel

NUM_NODE_CLASSES = 2577         # the node head's width (mgat.py:98-102)


def site_noise(noise: Union[None, torch.Tensor, Mapping], site):
    """The noise of one sampling site: a masked layer's index or
    ``"text"``.  A bare tensor is every masked layer's noise; a mapping
    gives each site its own; a site it lacks draws from the generator."""
    if noise is None or isinstance(noise, torch.Tensor):
        return None if site == "text" else noise
    return noise.get(site)


class MGATConv(nn.Module):
    """``MaskingGATv2Conv`` parameters (``mgat_v2_conv.py``); ``in_channels``
    is the layer input's width (``2 * channels`` under ``concat_instr``)."""

    def __init__(self, channels: int, heads: int, masked: bool,
                 sample_k: Optional[int], mask_dropout: float = 0.2,
                 in_channels: Optional[int] = None, use_topk: bool = True,
                 use_all_instrs: bool = False, **sampler):
        super().__init__()
        hc = heads * channels
        c_in = in_channels or channels
        self.lin_l = nn.Linear(c_in, hc)
        self.lin_r = nn.Linear(c_in, hc)
        self.lin_edge = nn.Linear(channels, hc, bias=False)
        self.att = nn.Parameter(torch.empty(1, heads, channels))
        self.bias = nn.Parameter(torch.zeros(hc))
        nn.init.xavier_uniform_(self.att)
        self.mask = (MaskingModel(c_in, channels, sample_k, mask_dropout,
                                  use_topk=use_topk,
                                  use_all_instrs=use_all_instrs, **sampler)
                     if masked else None)


class MGAT(nn.Module):
    def __init__(self, channels: int = 300, num_ins: int = 4, heads: int = 4,
                 masking_thresholds: Sequence[float] = (1.0, 1.0, 1.0, 0.15),
                 sample_k: Optional[int] = None, mask_dropout: float = 0.2,
                 use_instr: bool = True, use_topk: bool = True,
                 interpretable_mode: bool = False, concat_instr: bool = False,
                 use_all_instrs: bool = False, use_global_mask: bool = False,
                 node_classification: bool = False, **sampler):
        """``sampler`` holds the mask head's sampler options
        (``sampler_type``, ``nb_samples``, ``alpha``, ``beta``, ``tau``);
        the flags are the config's variants (``mgat.py:266-279``)."""
        super().__init__()
        self.heads = heads
        self.use_instr = use_instr
        self.concat_instr = concat_instr and use_instr
        self.use_global_mask = use_global_mask
        self.apply_mask = interpretable_mode and not use_global_mask
        in_ch = 2 * channels if concat_instr else channels
        masked = [float(t) != 1.0 for t in masking_thresholds]
        self.convs = nn.ModuleList(
            [MGATConv(channels, heads, masked[i], sample_k, mask_dropout,
                      in_ch, use_topk, use_all_instrs, **sampler)
             for i in range(num_ins)])
        self.x_proj = nn.ModuleList(
            [mlp(heads * channels, channels * heads // 2, channels)
             for _ in range(num_ins)])
        self.bns = nn.ModuleList([GraphNorm(channels) for _ in range(num_ins)])
        self.node_logits = (mlp(channels, 512, NUM_NODE_CLASSES,
                                gelu_last=False)
                            if node_classification else None)

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
                noise: Union[None, torch.Tensor, Mapping] = None,
                dtype: Optional[torch.dtype] = None, train: bool = False,
                aimle_states: Optional[dict] = None,
                bypass: Optional[tuple] = None):
        """-> (h [B, N, C], last mask [B, N, 1] | None, alphas, node
        logits of each layer).  Masked layer ``i`` samples with
        ``aimle_states[i]`` (aimle only) and ``site_noise(noise, i)``;
        ``bypass = (layer, x)`` replaces that layer's input with ``x``."""
        h = x
        mask = None
        alphas, node_logits = [], []
        global_mask = (torch.ones(h.shape[:2] + (1,), dtype=h.dtype,
                                  device=h.device)
                       if self.use_global_mask else None)
        for i, conv in enumerate(self.convs):
            if bypass is not None and bypass[0] == i:
                h = bypass[1].to(h.dtype)
            ins = instr_vectors[:, i, :]
            masked = conv.mask is not None
            fuse = (not masked and not train and self.use_instr
                    and not self.concat_instr)
            if fuse:
                xf = h                # the kernel makes the layer's input
            elif self.concat_instr:
                xf = concat_instr_features(h, ins)
            elif self.use_instr:
                xf = F.gelu(h * ins[:, None, :])
            else:
                xf = h
            if masked:
                gate = conv.mask(xf, lang, batch.node_mask, generator,
                                 site_noise(noise, i), dtype, train,
                                 (aimle_states or {}).get(i), instr_vectors)
                mask = gate
            else:
                gate = torch.ones(h.shape[:2] + (1,), dtype=h.dtype,
                                  device=h.device)
            args = (h, xf, ins, gate, batch.edge_src, batch.edge_dst,
                    batch.edge_mask, batch.node_mask, edge_attr,
                    self.layer_params(i))
            apply_mask = self.apply_mask and masked
            if train:
                h, alpha = fused_gat_layer_train(
                    *args, apply_mask_to_h=apply_mask)
            else:
                h, alpha = fused_gat_layer(
                    *args, fuse_instr=fuse, apply_mask_to_h=apply_mask)
            alphas.append(alpha)
            if self.node_logits is not None:
                node_logits.append(self.node_logits(h, dtype))
            if global_mask is not None:
                if masked:
                    global_mask = gate * global_mask
                h = global_mask * h
        return h, mask, alphas, node_logits
