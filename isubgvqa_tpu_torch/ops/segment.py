"""Segment reductions over flat graph arrays (the port of
``isubgvqa_tpu/ops/segment.py``; the reference's ``torch_scatter``
``scatter_mean`` / ``scatter_add`` / ``scatter_softmax`` and PyG's
per-segment softmax).

Every function takes a static ``num_segments``.  An optional boolean
``mask`` drops padding entries: they add exactly zero to sums and means
and get probability zero in a softmax.  Index rules follow
``jax.ops.segment_*`` and JAX's indexing, where torch's differ:

* a reduction drops ids outside ``[0, num_segments)`` (``index_add_``
  would raise on the CPU and fault on CUDA);
* a gather of a per-segment value at an element's id wraps a negative
  id once (``-1`` is the last segment) and clamps the rest into range;
* an empty segment reduces to ``initial`` under max / min and to zeros
  under mean and softmax.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1.0e30


def _expand(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``m`` with trailing singleton axes up to ``like``'s rank."""
    return m.reshape(m.shape + (1,) * (like.dim() - m.dim()))


def _apply_mask(data: torch.Tensor, mask: Optional[torch.Tensor],
                fill: float = 0.0) -> torch.Tensor:
    if mask is None:
        return data
    return torch.where(_expand(mask, data), data,
                       torch.tensor(fill, dtype=data.dtype,
                                    device=data.device))


def _in_range(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return (ids >= 0) & (ids < num_segments)


def gather_segments(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``values[ids]`` with JAX's gather rule: a negative id wraps once,
    then every id is clamped to ``[0, len(values) - 1]``."""
    n = values.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    return values[ids]


def _reduce(data: torch.Tensor, ids: torch.Tensor, num_segments: int,
            op: str, initial: float) -> torch.Tensor:
    """``data``'s rows reduced by ``op`` into ``num_segments`` rows that
    start at ``initial``; rows of out-of-range ids are dropped."""
    valid = _in_range(ids, num_segments)
    out = torch.full((num_segments,) + tuple(data.shape[1:]), initial,
                     dtype=data.dtype, device=data.device)
    idx = _expand(torch.where(valid, ids.long(), 0), data).expand_as(data)
    src = torch.where(_expand(valid, data), data,
                      torch.tensor(initial, dtype=data.dtype,
                                   device=data.device))
    if op == "sum":
        return out.scatter_add_(0, idx, src)
    return out.scatter_reduce_(0, idx, src, op, include_self=True)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum ``data``'s rows into ``num_segments`` buckets (scatter_add)."""
    return _reduce(_apply_mask(data, mask), segment_ids, num_segments,
                   "sum", 0.0)


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  mask: Optional[torch.Tensor] = None,
                  dtype=torch.float32) -> torch.Tensor:
    ones = torch.ones(segment_ids.shape, dtype=dtype,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean per segment; an empty segment gives zeros
    (``torch_scatter.scatter_mean``, reference
    ``scene_graph_encoder.py:141``)."""
    total = segment_sum(data, segment_ids, num_segments, mask)
    count = segment_count(segment_ids, num_segments, mask, dtype=total.dtype)
    return total / _expand(count, total).clamp_min(1.0)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: Optional[torch.Tensor] = None,
                initial: float = NEG_INF) -> torch.Tensor:
    """Max per segment; an empty segment gives ``initial``, and no
    segment reads below it."""
    return _reduce(_apply_mask(data, mask, initial), segment_ids,
                   num_segments, "amax", initial)


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: Optional[torch.Tensor] = None,
                initial: float = -NEG_INF) -> torch.Tensor:
    """Min per segment; an empty segment gives ``initial``, and no
    segment reads above it."""
    return _reduce(_apply_mask(data, mask, initial), segment_ids,
                   num_segments, "amin", initial)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax within each segment, shifted by the segment's max
    (``torch_geometric.utils.softmax``, reference
    ``mgat_v2_conv.py:272``).  Masked entries get 0, and a fully masked
    segment gives zeros, not NaN: the denominator is floored at the
    dtype's smallest normal number."""
    logits = _apply_mask(logits, mask, NEG_INF)
    seg_max = segment_max(logits, segment_ids, num_segments)
    shifted = logits - gather_segments(seg_max, segment_ids)
    if mask is not None:
        shifted = _apply_mask(shifted, mask, NEG_INF)
    expv = torch.exp(shifted)
    denom = segment_sum(expv, segment_ids, num_segments).clamp_min(
        torch.finfo(expv.dtype).tiny)
    return expv / gather_segments(denom, segment_ids)


def segment_normalize(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int, mask: Optional[torch.Tensor] = None,
                      alpha: Optional[torch.Tensor] = None,
                      eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GraphNorm's per-segment standardization,
    ``(data - alpha * mean) / sqrt(var + eps)`` with ``var`` the biased
    variance of the shifted values (``torch_geometric.nn.norm.GraphNorm``,
    reference ``scene_graph_encoder.py:33,101``).  Returns
    ``(normalized, mean, var)``; masked rows read 0."""
    mean = segment_mean(data, segment_ids, num_segments, mask)
    m = gather_segments(mean, segment_ids)
    shifted = data - (m if alpha is None else alpha * m)
    var = segment_mean(shifted * shifted, segment_ids, num_segments, mask)
    out = shifted * torch.rsqrt(gather_segments(var, segment_ids) + eps)
    return _apply_mask(out, mask), mean, var
