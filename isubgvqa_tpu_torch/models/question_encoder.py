"""Question encoder: CLIP-style token + position tables and a 4-layer
post-LN transformer (the port of ``isubgvqa_tpu/models/question_encoder.py``).

Reference quirk kept: the CLIP attention mask (1 real, 0 padding) is a
float ``src_key_padding_mask``, which torch ADDS to the key logits, so
real tokens get +1 and padding is attended.  In eval the final
LayerNorm folds into the last layer's kernel call, as on the TPU.  In
training each layer draws its four dropout keep masks from the step's
generator and runs
:func:`~isubgvqa_tpu_torch.ops.text_train.fused_encoder_layer_train`;
the final LayerNorm stays plain torch (``question_encoder.py:122``).

Under tensor parallelism (:mod:`~isubgvqa_tpu_torch.parallel`) each model
rank holds rows ``[m V/M, (m+1) V/M)`` of the token table: an id outside
them reads zero, and the ranks' partial embeddings are summed by
``reduce_from_model_region`` (exact: one rank adds each row to zeros),
whose backward leaves the table's gradient on its shard.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.text_kernel import fused_encoder_layer, ln_plain
from ..ops.text_train import fused_encoder_layer_train
from ..parallel.mesh import (model_size, reduce_from_model_region,
                             shard_bounds, shard_dim)
from .layers import EncoderLayer, TransformerStack, draw_encoder_dropout_masks


class TextEmbedding(nn.Module):
    """CLIPTextEmbeddings equivalent: token + learned position tables."""

    def __init__(self, vocab_size: int = 49408, dim: int = 512,
                 max_positions: int = 77):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, dim)
        self.position_embedding = nn.Embedding(max_positions, dim)

    def forward(self, ids: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Token + position rows, each at ``dtype`` (flax ``Embed(dtype)``),
        summed at ``dtype``."""
        pos = torch.arange(ids.shape[1], device=ids.device)
        table = self.token_embedding.weight
        ids = ids.long()
        if shard_dim(table) is None:
            tok = self.token_embedding(ids)
        else:                         # this model rank's rows of the table
            start, rows = shard_bounds(table.shape[0] * model_size())
            local = ids - start
            inside = (local >= 0) & (local < rows)
            tok = self.token_embedding(torch.where(inside, local, 0))
            tok = reduce_from_model_region(
                tok.float() * inside[..., None]).to(table.dtype)
        dt = dtype or tok.dtype
        return tok.to(dt) + self.position_embedding(pos)[None].to(dt)


class QuestionEncoder(nn.Module):
    def __init__(self, dim: int = 512, num_heads: int = 8,
                 ffn_dim: int = 2048, num_layers: int = 4,
                 dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.transformer_encoder = TransformerStack(
            [EncoderLayer(dim, ffn_dim) for _ in range(num_layers)])

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``x [B, L, D]`` embedded tokens, ``attn_mask [B, L]`` ->
        encoded ``[B, L, D]``."""
        stack = self.transformer_encoder
        mask_f = attn_mask.to(torch.float32)
        if train:
            b, l, d = x.shape
            for layer in stack.layers:
                masks = draw_encoder_dropout_masks(
                    generator, b, l, dim=d,
                    ffn_dim=layer.linear1.out_features,
                    num_heads=self.num_heads, rate=self.dropout,
                    device=x.device)
                x = fused_encoder_layer_train(x, mask_f, masks,
                                              layer.kernel_params(),
                                              self.num_heads)
            return ln_plain(x, stack.norm.weight, stack.norm.bias).to(x.dtype)
        final = (stack.norm.weight, stack.norm.bias)
        for i, layer in enumerate(stack.layers):
            last = i == len(stack.layers) - 1
            x = fused_encoder_layer(x, mask_f, layer.kernel_params(),
                                    num_heads=self.num_heads,
                                    final_ln=final if last else None)
        return x
