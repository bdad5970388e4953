"""Flat (segment) <-> dense per-graph views, and the hard top-k mask on
the dense layout (the port of ``isubgvqa_tpu/ops/dense.py``).

The batcher gives each node its position inside its own graph
(``pos``), so a conversion is one fixed-shape scatter or gather.
Padding nodes carry ``segment_ids == num_segments`` (one past the last
graph): the scatter writes into one extra row that it then drops, so
padding never lands on a real slot.  Unused dense slots hold ``fill``
(0 by default, ``to_dense_batch``'s ``fill_value`` in the reference,
whose samplers see those zeros, ``masking.py:162-176``).  Two nodes at
the same ``(segment, pos)`` leave that slot undefined, here as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def to_dense_batch(flat: torch.Tensor, segment_ids: torch.Tensor,
                   pos: torch.Tensor, num_segments: int,
                   max_per_segment: int, fill: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter flat per-node values into a dense ``[B, N_max, ...]``
    view; returns ``(dense, valid)``, ``valid[b, n]`` marking real slots
    (``to_dense_batch``'s ``(out, mask)``).  Ids above ``num_segments``
    go to the extra row, a negative id wraps once over the ``B + 1``
    rows (JAX's ``.at[...].set(mode="drop")``) and one still negative is
    dropped; positions are clamped to ``[0, max_per_segment - 1]``."""
    rows = num_segments + 1
    seg = segment_ids.long().clamp_max(num_segments)
    seg = torch.where(seg < 0, seg + rows, seg)
    keep = seg >= 0
    seg, p = seg[keep], pos.long().clamp(0, max_per_segment - 1)[keep]
    dense = torch.full((rows, max_per_segment) + tuple(flat.shape[1:]), fill,
                       dtype=flat.dtype, device=flat.device)
    dense[seg, p] = flat[keep]
    valid = torch.zeros((rows, max_per_segment), dtype=torch.bool,
                        device=flat.device)
    valid[seg, p] = segment_ids[keep] < num_segments
    return dense[:num_segments], valid[:num_segments]


def from_dense_batch(dense: torch.Tensor, segment_ids: torch.Tensor,
                     pos: torch.Tensor,
                     valid_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Gather dense ``[B, N_max, ...]`` values back to the flat layout.
    Ids and positions are clamped into range; rows where the flat
    boolean ``valid_mask`` is false read 0."""
    seg = segment_ids.long().clamp(0, dense.shape[0] - 1)
    p = pos.long().clamp(0, dense.shape[1] - 1)
    out = dense[seg, p]
    if valid_mask is not None:
        m = valid_mask.reshape(valid_mask.shape
                               + (1,) * (out.dim() - valid_mask.dim()))
        out = torch.where(m, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))
    return out


def dense_topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """0/1 mask of the top-``k`` entries per row.  Every entry ``>=`` the
    k-th largest value is selected (ties can give more than k ones), and
    ``k >= N`` selects everything — the reference's
    ``select_from_edge_candidates`` (``deterministic_scheme.py:36-43``)."""
    n = scores.shape[-1]
    if k >= n:
        return torch.ones_like(scores)
    thresh = torch.topk(scores, k, dim=-1).values[..., -1:]
    return (scores >= thresh).to(scores.dtype)
