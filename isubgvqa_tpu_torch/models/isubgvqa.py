"""The top ISubGVQA model, eval and training forward (the port of
``isubgvqa_tpu/models/isubgvqa.py``).

Question encoding, program decoding into instruction vectors,
scene-graph encoding, the masked GAT stack, question-conditioned
pooling and the fusion classifier.  The instruction tensor is taken
with the proper transpose, not the reference's ``.view`` scramble
(the JAX package's documented deviation, ``isubgvqa.py:9-15``).

On a CUDA device the fused layers run their hand-written kernels;
``cfg.use_pallas=False`` there is an error.  On the CPU the kernels'
plain versions run.  Products run at ``cfg.compute_dtype``: an eval
model holds its weight matrices at that dtype (:meth:`ISubGVQA.cast_`),
a training model holds f32 masters that every call casts, so their
gradients stay f32 (flax ``Dense(dtype=...)`` with f32 params).
``forward(train=True)`` draws every dropout mask and then the sampler's
noise from the caller's generator and updates the BatchNorm running
statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import Config
from ..data.batching import GraphBatch
from .layers import keep_mask, linear, mlp
from .mgat import MGAT
from .pooling import GlobalAttentionPooling
from .question_decoder import QuestionDecoder
from .question_encoder import QuestionEncoder, TextEmbedding
from .scene_graph_encoder import SceneGraphEncoder

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class ModelOutput:
    """The eval outputs of the reference forward's 5-tuple
    (``isubgvqa.py:297``) that the config of record produces."""

    logits: torch.Tensor                    # [B, num_answers] f32
    node_mask: Optional[torch.Tensor]       # [B, N, 1] last-layer mask
    gate: Optional[torch.Tensor]            # [B, N, 1] pooling attention


class ISubGVQA(nn.Module):
    def __init__(self, cfg: Config, sg_vocab_size: int = 2000,
                 sg_vocab_vectors=None):
        super().__init__()
        self.cfg = cfg
        hid, tdim = cfg.general_hidden_dim, cfg.text_emb_dim
        self.text_vocab_embedding = TextEmbedding(cfg.text_vocab_size, tdim)
        self.question_encoder = QuestionEncoder(
            tdim, cfg.num_heads, 4 * 512, cfg.encoder_layers, cfg.dropout)
        self.program_decoder = QuestionDecoder(
            cfg.mgat_layers, tdim, cfg.num_heads, 4 * 512, cfg.decoder_layers,
            cfg.dropout)
        self.scene_graph_encoder = SceneGraphEncoder(
            sg_vocab_size, hid, sg_vocab_vectors)
        self.gat_seq = MGAT(hid, cfg.mgat_layers, cfg.gat_heads,
                            cfg.mgat_masks, cfg.sample_k, cfg.mask_dropout,
                            sampler_type=cfg.sampler_type,
                            nb_samples=cfg.nb_samples, alpha=cfg.alpha,
                            beta=cfg.beta, tau=cfg.tau)
        self.graph_global_attention_pooling = GlobalAttentionPooling(hid, hid)
        self.qsts_reduction = mlp(tdim * cfg.mgat_layers, hid)
        self.instr_reduction = mlp(tdim, hid)
        self.embedding = nn.Sequential(nn.Linear(3 * hid, 512), nn.GELU(),
                                       nn.Dropout(cfg.head_dropout))
        self.logit_fc = nn.Linear(512, cfg.num_answers)

    @property
    def compute_dtype(self) -> torch.dtype:
        """``cfg.compute_dtype`` (never the weights' dtype: a training
        model keeps f32 masters and still computes at this dtype)."""
        return DTYPES[self.cfg.compute_dtype]

    def cast_(self, dtype: torch.dtype) -> "ISubGVQA":
        """Ship the weight matrices and embedding tables at ``dtype`` (flax
        ``Dense(dtype=...)`` rounds them the same way on every call);
        biases, norms, ``att`` and BatchNorm statistics stay f32."""
        for module in self.modules():
            for name, p in module.named_parameters(recurse=False):
                if name == "weight" and p.dim() == 2 or name == "in_proj_weight":
                    p.data = p.data.to(dtype)
        return self

    def forward(self, batch: GraphBatch,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                train: bool = False,
                aimle_states: Optional[dict] = None) -> ModelOutput:
        """Eval (``train=False``) or training forward.  The sampler's noise
        for the masked layer, and in training every dropout mask, come
        from ``generator``; ``noise`` replaces the sampler's standard
        Gumbel draw (its shape per sampler: :mod:`.masking`).
        ``aimle_states`` (:func:`~.build.make_aimle_states`) maps a masked
        layer to its AIMLE state, which a training backward updates."""
        cfg = self.cfg
        if batch.node_mask.is_cuda and not cfg.use_pallas:
            raise ValueError("use_pallas=False: on a CUDA device the port "
                             "always runs its CUDA kernels")
        dtype = self.compute_dtype

        x = self.text_vocab_embedding(batch.qst_tokens, dtype)
        enc = self.question_encoder(x, batch.qst_mask, train, generator)
        qst_feats = self.program_decoder(enc, train, generator)  # [B, 4, 512]
        lang = self.qsts_reduction(qst_feats.reshape(qst_feats.shape[0], -1),
                                   dtype)
        instr = self.instr_reduction(qst_feats, dtype)      # [B, 4, 300]

        x_enc, e_enc = self.scene_graph_encoder(batch, dtype, train)
        h, node_mask, _ = self.gat_seq(x_enc, batch, e_enc, instr, lang,
                                       generator, noise, dtype, train,
                                       aimle_states)
        pooled, gate = self.graph_global_attention_pooling(
            h, lang, batch.node_mask, node_mask, dtype)

        fused = torch.cat([pooled, lang, pooled * lang], dim=1)
        fused = F.gelu(linear(fused, self.embedding[0], dtype))
        if train and cfg.head_dropout > 0.0:
            fused = fused * keep_mask(fused.shape, cfg.head_dropout,
                                      generator, fused.device).to(dtype)
        logits = linear(fused, self.logit_fc, dtype)
        return ModelOutput(logits=logits.float(), node_mask=node_mask,
                           gate=gate)
