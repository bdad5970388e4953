"""Samplers of the port: the gumbel sampler (forward and its
straight-through backward) and the node -> edge gate with its dst-only
backward.  The imle, aimle and simple samplers are still to port
(ROADMAP.md, Queue 1)."""

from .gumbel import GumbelSamplerConfig, draw_gumbel, gumbel_topk_sample
from .topk import topk_mask

__all__ = ["GumbelSamplerConfig", "draw_gumbel", "gumbel_topk_sample",
           "topk_mask"]
