"""Scene-graph encoder (the port of
``isubgvqa_tpu/models/scene_graph_encoder.py``).

* node feature = sum of the 4 token embeddings, concatenated with the
  bbox MLP (masked BatchNorm -> 4 -> 16 -> 32 with GELUs), reduced
  332 -> 300 after a BatchNorm;
* edge embeddings multiplied by the batch's per-edge sign (added
  symmetric edges are negated, ``scene_graph_encoder.py:80``);
* one MetaLayer round + GraphNorm through
  :func:`~isubgvqa_tpu_torch.ops.metalayer_kernel.fused_metalayer`
  (eval) or the differentiable
  :func:`~isubgvqa_tpu_torch.ops.metalayer_train.fused_metalayer_train`
  (training, where the three masked BatchNorms use batch statistics and
  update their running ones, ``scene_graph_encoder.py:103-117``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.batching import GraphBatch
from ..ops.metalayer_kernel import fused_metalayer
from ..ops.metalayer_train import fused_metalayer_train
from .layers import GraphNorm, MaskedBatchNorm, linear, mlp


class _Holder(nn.Module):
    """Named container so parameter keys follow upstream's
    ``edge_model.edge_mlp`` / ``node_model.node_mlp_*`` nesting."""


class SceneGraphEncoder(nn.Module):
    def __init__(self, sg_vocab_size: int, hidden_dim: int = 300,
                 vocab_vectors: Optional[np.ndarray] = None):
        super().__init__()
        c = hidden_dim
        self.sg_vocab_embedding = nn.Embedding(sg_vocab_size, c)
        if vocab_vectors is not None and vocab_vectors.shape[1] == c:
            with torch.no_grad():
                self.sg_vocab_embedding.weight.copy_(
                    torch.from_numpy(np.asarray(vocab_vectors, np.float32)))
        self.bbox_encoding = nn.Sequential(
            MaskedBatchNorm(4), nn.Linear(4, 16), nn.GELU(),
            MaskedBatchNorm(16), nn.Linear(16, 32), nn.GELU())
        self.feat_reduc = nn.Sequential(
            MaskedBatchNorm(c + 32), nn.Linear(c + 32, c), nn.GELU())
        layer = _Holder()
        layer.edge_model = _Holder()
        layer.edge_model.edge_mlp = mlp(3 * c, c, c, gelu_last=False)
        layer.node_model = _Holder()
        layer.node_model.node_mlp_1 = mlp(2 * c, c, c, gelu_last=False)
        layer.node_model.node_mlp_2 = mlp(2 * c, c, c, gelu_last=False)
        self.scene_graph_encoding_layer = layer
        self.graph_layer_norm = GraphNorm(c)

    def kernel_params(self) -> dict:
        layer = self.scene_graph_encoding_layer
        em = layer.edge_model.edge_mlp
        n1 = layer.node_model.node_mlp_1
        n2 = layer.node_model.node_mlp_2
        gn = self.graph_layer_norm
        return {
            "ew1": em[0].weight, "eb1": em[0].bias,
            "ew2": em[2].weight, "eb2": em[2].bias,
            "n1w1": n1[0].weight, "n1b1": n1[0].bias,
            "n1w2": n1[2].weight, "n1b2": n1[2].bias,
            "n2w1": n2[0].weight, "n2b1": n2[0].bias,
            "n2w2": n2[2].weight, "n2b2": n2[2].bias,
            "gn_w": gn.weight, "gn_b": gn.bias, "gn_a": gn.mean_scale,
        }

    def forward(self, batch: GraphBatch, dtype: torch.dtype,
                train: bool = False,
                expl_x_embed_sum: Optional[torch.Tensor] = None):
        """-> (x_encoded [B, N, 300], edge_attr_encoded [B, E, 300]).
        ``expl_x_embed_sum [B, N, 300]`` (the explainer's stage-0 bypass,
        ``scene_graph_encoder.py:72-100``) replaces the token sum; the bbox
        branch, the reduction and the MetaLayer run on it."""
        emb = self.sg_vocab_embedding.weight
        if expl_x_embed_sum is not None:
            x_sum = expl_x_embed_sum.to(dtype)
        else:
            tok = F.embedding(batch.node_tokens.long(), emb)  # [B, N, 4, C]
            x_sum = tok.to(dtype).float().sum(-2).to(dtype)
        node_mask = batch.node_mask

        bb = batch.node_bbox.to(dtype)
        seq = self.bbox_encoding
        bb = seq[0](bb, node_mask, train)
        bb = F.gelu(linear(bb, seq[1], dtype))
        bb = seq[3](bb, node_mask, train)
        bb = F.gelu(linear(bb, seq[4], dtype))

        x = torch.cat([x_sum, bb.to(dtype)], dim=-1)
        x = self.feat_reduc[0](x, node_mask, train)
        x = F.gelu(linear(x, self.feat_reduc[1], dtype))

        e = (F.embedding(batch.edge_token.long(), emb).to(dtype)
             * batch.edge_sign[..., None].to(dtype))
        layer = fused_metalayer_train if train else fused_metalayer
        return layer(x, e, batch.edge_src, batch.edge_dst, batch.edge_mask,
                     batch.node_mask, self.kernel_params())
