"""Shared building blocks of the port: Dense numerics, MLPs, the
post-LN transformer layers' parameters, GraphNorm and masked BatchNorm.

Parameters carry the upstream repo's names and layouts (torch
``Linear.weight`` is ``[out, in]``; attention keeps ``in_proj_weight``),
so a port ``state_dict()`` goes through
``isubgvqa_tpu/convert.py:convert_state_dict`` unchanged and upstream
checkpoints load as they are.

Numerics follow the JAX package: a Dense layer rounds its input, weight
and bias to the model dtype (flax ``Dense(dtype=...)``), which in
training means casting the f32 master weights on every call so that the
gradients reach them; LayerNorm uses flax's fast variance with eps 1e-6
(``layers.py:95-105``) — never ``nn.LayerNorm``'s forward with its 1e-5,
nor ``nn.TransformerEncoderLayer``; BatchNorm and GraphNorm compute in
f32.  Training draws its dropout keep masks explicitly from a
``torch.Generator`` (:func:`keep_mask`, :func:`draw_encoder_dropout_masks`,
:func:`draw_decoder_dropout_masks`) so that the CUDA layers and their
plain versions consume the same masks; the plain counterparts of the JAX
package's ``encoder_layer_reference`` / ``decoder_layer_reference``
(``layers.py:346-391``) are
:func:`~isubgvqa_tpu_torch.ops.text_train.fused_encoder_layer_train_plain`
and ``fused_decoder_layer_train_plain``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_sum, shard_draw


def linear(x: torch.Tensor, lin: nn.Linear,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: operands, weight and bias at ``dtype``
    (the weight's own dtype by default)."""
    dt = dtype or lin.weight.dtype
    b = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x.to(dt), lin.weight.to(dt), b)


class MLP(nn.Sequential):
    """``nn.Sequential`` of Linear / GELU / Dropout as upstream builds its
    MLPs (so the parameter keys are ``<name>.0.weight`` ...), applied
    with Dense numerics at ``dtype`` and exact GELU.  No dropout: the
    JAX package's MLPs have none."""

    def forward(self, x, dtype: Optional[torch.dtype] = None):
        for m in self:
            if isinstance(m, nn.Linear):
                x = linear(x, m, dtype)
            elif isinstance(m, nn.GELU):
                x = F.gelu(x)
        return x


def keep_mask(shape, rate: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """Scaled dropout keep mask, f32 values ``{0, 1/(1-rate)}`` (keep with
    probability ``1 - rate``, ``layers.py:_keep_mask``)."""
    u = shard_draw(lambda s: torch.rand(s, generator=generator,
                                        device=device), shape)
    return (u < 1.0 - rate).float() / (1.0 - rate)


def draw_encoder_dropout_masks(generator, b, l, *, dim, ffn_dim, num_heads,
                               rate, device):
    """Keep masks of one encoder layer's four dropout sites (attention
    probabilities, after attention, after the FFN ReLU, after the FFN);
    None when ``rate`` is 0 (``layers.py:276-290``)."""
    if rate <= 0.0:
        return None
    draw = lambda *shape: keep_mask(shape, rate, generator, device)
    return {"attn": draw(b, num_heads, l, l), "post_attn": draw(b, l, dim),
            "ffn": draw(b, l, ffn_dim), "post_ffn": draw(b, l, dim)}


def draw_decoder_dropout_masks(generator, b, t, l, *, dim, ffn_dim,
                               num_heads, rate, device):
    """Keep masks of one decoder layer's six dropout sites
    (``layers.py:293-308``); None when ``rate`` is 0."""
    if rate <= 0.0:
        return None
    draw = lambda *shape: keep_mask(shape, rate, generator, device)
    return {"self_attn": draw(b, num_heads, t, t), "post_sa": draw(b, t, dim),
            "cross_attn": draw(b, num_heads, t, l), "post_ca": draw(b, t, dim),
            "ffn": draw(b, t, ffn_dim), "post_ffn": draw(b, t, dim)}


def mlp(*sizes: int, gelu_last: bool = True) -> MLP:
    mods = []
    for i in range(len(sizes) - 1):
        mods.append(nn.Linear(sizes[i], sizes[i + 1]))
        if i < len(sizes) - 2 or gelu_last:
            mods.append(nn.GELU())
    return MLP(*mods)


class MultiheadAttentionParams(nn.Module):
    """The parameters of ``torch.nn.MultiheadAttention`` under its own
    names (``in_proj_weight [3D, D]``, ``in_proj_bias``, ``out_proj``);
    the fused text kernels consume them directly."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)


def _ln(dim: int) -> nn.LayerNorm:
    # holds weight/bias under LayerNorm's names; applied by the kernels
    return nn.LayerNorm(dim, eps=1e-6)


class EncoderLayer(nn.Module):
    """``nn.TransformerEncoderLayer`` parameters (post-LN, ReLU FFN)."""

    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.self_attn = MultiheadAttentionParams(dim)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = _ln(dim)
        self.norm2 = _ln(dim)

    def kernel_params(self) -> dict:
        a = self.self_attn
        return {
            "in_w": a.in_proj_weight, "in_b": a.in_proj_bias,
            "out_w": a.out_proj.weight, "out_b": a.out_proj.bias,
            "n1s": self.norm1.weight, "n1b": self.norm1.bias,
            "w1": self.linear1.weight, "b1": self.linear1.bias,
            "w2": self.linear2.weight, "b2": self.linear2.bias,
            "n2s": self.norm2.weight, "n2b": self.norm2.bias,
        }


class DecoderLayer(nn.Module):
    """``nn.TransformerDecoderLayer`` parameters."""

    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.self_attn = MultiheadAttentionParams(dim)
        self.multihead_attn = MultiheadAttentionParams(dim)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = _ln(dim)
        self.norm2 = _ln(dim)
        self.norm3 = _ln(dim)

    def kernel_params(self) -> dict:
        s, c = self.self_attn, self.multihead_attn
        return {
            "s_in_w": s.in_proj_weight, "s_in_b": s.in_proj_bias,
            "s_out_w": s.out_proj.weight, "s_out_b": s.out_proj.bias,
            "n1s": self.norm1.weight, "n1b": self.norm1.bias,
            "c_in_w": c.in_proj_weight, "c_in_b": c.in_proj_bias,
            "c_out_w": c.out_proj.weight, "c_out_b": c.out_proj.bias,
            "n2s": self.norm2.weight, "n2b": self.norm2.bias,
            "w1": self.linear1.weight, "b1": self.linear1.bias,
            "w2": self.linear2.weight, "b2": self.linear2.bias,
            "n3s": self.norm3.weight, "n3b": self.norm3.bias,
        }


class TransformerStack(nn.Module):
    """``nn.TransformerEncoder`` / ``nn.TransformerDecoder`` parameter
    layout: ``layers.<i>`` and the final ``norm``."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = _ln(layers[0].linear1.in_features)


class GraphNorm(nn.Module):
    """``torch_geometric.nn.norm.GraphNorm`` parameters (weight, bias,
    mean_scale); applied by the MetaLayer and GAT kernels in f32."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.mean_scale = nn.Parameter(torch.ones(dim))


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid rows of a padded array, in f32, under
    ``BatchNorm1d``'s parameter and buffer names (``layers.py:417-476``).

    Eval normalizes with the running statistics.  Training normalizes
    with the batch's mean and two-pass (centred) variance over the rows
    where ``mask`` is set (count clamped at 1), and updates the running
    statistics in place with keep factor 0.9, storing the unbiased
    variance ``var * count / max(count - 1, 1)`` as torch does.

    In a data-parallel run the batch is every data rank's rows, as under
    the JAX package's ``axis_name`` psum: the count with the sum, then the
    centred squares, are summed over the data group by
    :func:`~isubgvqa_tpu_torch.parallel.all_reduce_sum` (over the world
    they would count each sample once for each model rank), whose
    backward sums their gradients over it (``SyncBatchNorm``'s rule), so
    the statistics, the gradients and the running buffers agree on
    every rank."""

    momentum = 0.9

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x, mask=None, train: bool = False):
        dim = self.weight.shape[0]
        xf = x.float().reshape(-1, dim)
        if not train:     # running statistics ignore the padding mask
            mean, var = self.running_mean, self.running_var
        else:
            m = (torch.ones_like(xf[:, :1]) if mask is None
                 else mask.float().reshape(-1, 1))
            sums = all_reduce_sum(torch.cat([(xf * m).sum(0), m.sum(0)]))
            count = torch.clamp(sums[dim], min=1.0)
            mean = sums[:dim] / count
            d = xf - mean
            var = torch.clamp(all_reduce_sum((d * d * m).sum(0)) / count,
                              min=0.0)
            with torch.no_grad():
                unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
                k = self.momentum
                self.running_mean.mul_(k).add_((1 - k) * mean)
                self.running_var.mul_(k).add_((1 - k) * unbiased)
        out = ((xf - mean) * torch.rsqrt(var + self.eps)
               * self.weight.float() + self.bias.float())
        return out.reshape(x.shape).to(x.dtype)
