"""Samplers of the port: the four differentiable top-k samplers of the
mask head (gumbel, imle, aimle with its adaptive state, simple), their
noise, the node -> edge mask with its dst-only backward (flat and
dense), and the global rewiring policies with their utilities."""

from .aimle import AIMLEConfig, AIMLEState, aimle_topk, init_aimle_state
from .gumbel import (GumbelSamplerConfig, draw_gumbel, gumbel_topk_sample,
                     gumbel_validation)
from .imle import IMLEConfig, imle_topk
from .node_edge import dense_node_gate_to_edge_gate, node_mask_to_edge_mask
from .noise import draw_gamma, gumbel_noise, sum_of_gamma_noise
from .rewiring import (batch_repeat_edge_index,
                       batched_edge_index_to_batched_adj, masked_softmax,
                       non_merge_coalesce, rewire_global_directed,
                       rewire_global_undirected, weighted_cross_entropy)
from .simple import (SimpleConfig, exact_k_marginals, gumbel_topk_hard,
                     log1mexp, simple_sample, simple_validation)
from .topk import topk_mask

__all__ = ["AIMLEConfig", "AIMLEState", "aimle_topk", "init_aimle_state",
           "GumbelSamplerConfig", "draw_gumbel", "gumbel_topk_sample",
           "gumbel_validation", "IMLEConfig", "imle_topk", "draw_gamma",
           "gumbel_noise", "sum_of_gamma_noise", "SimpleConfig",
           "exact_k_marginals", "gumbel_topk_hard", "log1mexp",
           "simple_sample", "simple_validation", "topk_mask",
           "node_mask_to_edge_mask", "dense_node_gate_to_edge_gate",
           "batch_repeat_edge_index", "batched_edge_index_to_batched_adj",
           "masked_softmax", "non_merge_coalesce", "rewire_global_directed",
           "rewire_global_undirected", "weighted_cross_entropy"]
