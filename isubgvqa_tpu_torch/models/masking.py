"""Mask head (the port of ``isubgvqa_tpu/models/masking.py``).

gate = GELU(node_nn(x) . ques_nn(u) / sqrt(d)), scored node by node
against **its own** graph's question vector (the JAX package's
documented deviation from the reference's ``ques_nn(u)[batch]`` double
index, ``masking.py:22-33``); with ``use_all_instrs`` instead each
instruction's softmax over the graph's node slots (padding slots as zero
vectors), summed over the instructions (``masking.py:111-117``), and no
``ques_nn``.  Then, with ``use_topk``, the dense scores with zero-filled
padding slots (which compete in the top-k, as ``to_dense_batch``'s fill
does in the reference) go through the configured sampler; without it the
gate goes through a sigmoid and a hard ``> 0.5`` with no gradient
(``masking.py:149-153``), padding slots included.  In training the gate
first gets dropout 0.2 (``masking.py:128``), drawn from the step's
generator before the sampler's noise, and the sampler runs its train
branch.

The samplers' train and eval configs are the JAX package's
(``masking.py:74-94``): Gumbel(0, 0.3) noise for imle and aimle at
temperature ``tau``; imle's eval is deterministic at ``nb_samples == 1``,
aimle's and simple's (``simple_sample`` with ``train=False``) and
gumbel's stay noisy.  AIMLE's adaptive state comes in as ``aimle_state``
and is updated by the sampler's backward.

``noise`` replaces the sampler's standard Gumbel draw, in the shape the
JAX sampler asks ``jax.random.gumbel`` for: ``[S * B, N]`` for gumbel,
``[B, S, N]`` for imle and aimle (scaled by 0.3 in the sampler),
``[S, B, N]`` for simple.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..sampling import (AIMLEConfig, AIMLEState, GumbelSamplerConfig,
                        IMLEConfig, SimpleConfig, aimle_topk,
                        gumbel_topk_sample, imle_topk, simple_sample)
from .layers import keep_mask, mlp


def sampler_configs(sampler_type: str, k: int, nb_samples: int = 1,
                    alpha: float = 1.0, beta: float = 10.0, tau: float = 1.0):
    """``(train config, eval config)`` of a sampler (``masking.py:74-94``)."""
    if sampler_type == "imle":
        train = IMLEConfig(k=k, nb_samples=nb_samples,
                           input_noise_temperature=tau,
                           target_noise_temperature=tau, alpha=alpha,
                           beta=beta)
        return train, train.for_eval()
    if sampler_type == "aimle":
        train = AIMLEConfig(k=k, nb_samples=nb_samples,
                            theta_noise_temperature=tau,
                            target_noise_temperature=tau, alpha=alpha)
        return train, train.for_eval()
    if sampler_type == "simple":
        cfg = SimpleConfig(k=k)
        return cfg, cfg
    if sampler_type == "gumbel":
        cfg = GumbelSamplerConfig(k=k)
        return cfg, cfg
    raise ValueError(f"unknown sampler_type {sampler_type!r}")


class MaskingModel(nn.Module):
    def __init__(self, dim_nodes: int, dim_questions: int, sample_k: int,
                 dropout: float = 0.2, sampler_type: str = "gumbel",
                 nb_samples: int = 1, alpha: float = 1.0, beta: float = 10.0,
                 tau: float = 1.0, use_topk: bool = True,
                 use_all_instrs: bool = False):
        super().__init__()
        self.node_nn = mlp(dim_nodes, dim_questions)
        self.ques_nn = (None if use_all_instrs
                        else mlp(dim_questions, dim_questions))
        self.use_topk = use_topk
        self.sampler_type = sampler_type
        self.train_cfg, self.eval_cfg = sampler_configs(
            sampler_type, sample_k, nb_samples, alpha, beta, tau)
        self.dropout = dropout

    def sample(self, dense: torch.Tensor, train: bool,
               generator: Optional[torch.Generator],
               noise: Optional[torch.Tensor],
               aimle_state: Optional[AIMLEState]) -> torch.Tensor:
        """The first sample ``[B, N]`` of the sampler over ``dense``."""
        cfg = self.train_cfg if train else self.eval_cfg
        st = self.sampler_type
        if st == "imle":
            return imle_topk(dense, cfg, generator, noise)[0]
        if st == "aimle":
            if aimle_state is None:
                raise ValueError("the aimle sampler needs its aimle_state")
            return aimle_topk(dense, aimle_state, cfg, generator, noise)[0]
        if st == "simple":
            return simple_sample(dense, cfg, train, generator, noise)[0][0]
        return gumbel_topk_sample(dense, cfg, train=train, generator=generator,
                                  noise=noise)[0]

    def forward(self, x, u, node_mask,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None, train: bool = False,
                aimle_state: Optional[AIMLEState] = None,
                all_instrs: Optional[torch.Tensor] = None):
        """``x [B, N, C_in]``, ``u [B, C]`` (``all_instrs [B, T, C]`` with
        ``use_all_instrs``) -> gate ``[B, N, 1]``."""
        xq = self.node_nn(x, dtype)
        if self.ques_nn is None:
            xq_m = torch.where(node_mask[..., None], xq.float(),
                               torch.zeros((), device=xq.device))
            scores = torch.einsum("bmd,bnd->bmn", all_instrs.float(), xq_m)
            gate = torch.softmax(scores, dim=2).sum(1).to(xq.dtype)
        else:
            uq = self.ques_nn(u, dtype)
            gate = torch.einsum("bnd,bd->bn", xq.float(), uq.float())
            gate = F.gelu((gate / math.sqrt(xq.shape[-1])).to(xq.dtype))
        if train and self.dropout > 0.0:
            gate = gate * keep_mask(gate.shape, self.dropout, generator,
                                    gate.device).to(gate.dtype)
        if not self.use_topk:
            # hard threshold, no gradient (masking.py:149-153)
            hard = torch.sigmoid(gate.detach()) > 0.5
            return hard.to(gate.dtype)[..., None]
        dense = torch.where(node_mask, gate.float(),
                            torch.zeros((), device=gate.device))
        out = self.sample(dense, train, generator, noise, aimle_state)
        out = torch.where(node_mask, out, torch.zeros((), device=out.device))
        return out.to(xq.dtype)[..., None]
