"""Program decoder: learned queries -> instruction vectors (the port of
``isubgvqa_tpu/models/question_decoder.py``).

``n_instructions`` (= 4) learned queries cross-attend the encoded
question through a 3-layer post-LN decoder, non-autoregressively, with
the final LayerNorm folded into the last layer in eval.  The reference
passes no memory padding mask, so padded question tokens are attended.
Training draws each layer's six dropout keep masks from the step's
generator and runs
:func:`~isubgvqa_tpu_torch.ops.text_train.fused_decoder_layer_train`;
the final LayerNorm stays plain torch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.text_kernel import fused_decoder_layer, ln_plain
from ..ops.text_train import fused_decoder_layer_train
from .layers import DecoderLayer, TransformerStack, draw_decoder_dropout_masks


class QuestionDecoder(nn.Module):
    def __init__(self, n_instructions: int = 4, dim: int = 512,
                 num_heads: int = 8, ffn_dim: int = 2048,
                 num_layers: int = 3, dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.query_embed = nn.Embedding(n_instructions, dim)
        self.coarse_decoder = TransformerStack(
            [DecoderLayer(dim, ffn_dim) for _ in range(num_layers)])

    def forward(self, memory: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``memory [B, L, D]`` -> instruction vectors ``[B, n_instr, D]``."""
        b = memory.shape[0]
        q = self.query_embed.weight
        tgt = q[None].expand(b, *q.shape).to(memory.dtype)
        stack = self.coarse_decoder
        if train:
            t, (l, d) = tgt.shape[1], memory.shape[1:]
            for layer in stack.layers:
                masks = draw_decoder_dropout_masks(
                    generator, b, t, l, dim=d,
                    ffn_dim=layer.linear1.out_features,
                    num_heads=self.num_heads, rate=self.dropout,
                    device=memory.device)
                tgt = fused_decoder_layer_train(tgt, memory, masks,
                                                layer.kernel_params(),
                                                self.num_heads)
            return ln_plain(tgt, stack.norm.weight,
                            stack.norm.bias).to(memory.dtype)
        final = (stack.norm.weight, stack.norm.bias)
        for i, layer in enumerate(stack.layers):
            last = i == len(stack.layers) - 1
            tgt = fused_decoder_layer(tgt, memory, layer.kernel_params(),
                                      num_heads=self.num_heads,
                                      final_ln=final if last else None)
        return tgt
