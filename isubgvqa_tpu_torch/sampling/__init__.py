"""Samplers of the port: the four differentiable top-k samplers of the
mask head (gumbel, imle, aimle with its adaptive state, simple), their
noise, and the node -> edge gate with its dst-only backward."""

from .aimle import AIMLEConfig, AIMLEState, aimle_topk, init_aimle_state
from .gumbel import (GumbelSamplerConfig, draw_gumbel, gumbel_topk_sample,
                     gumbel_validation)
from .imle import IMLEConfig, imle_topk
from .noise import draw_gamma, gumbel_noise, sum_of_gamma_noise
from .simple import (SimpleConfig, exact_k_marginals, gumbel_topk_hard,
                     log1mexp, simple_sample, simple_validation)
from .topk import topk_mask

__all__ = ["AIMLEConfig", "AIMLEState", "aimle_topk", "init_aimle_state",
           "GumbelSamplerConfig", "draw_gumbel", "gumbel_topk_sample",
           "gumbel_validation", "IMLEConfig", "imle_topk", "draw_gamma",
           "gumbel_noise", "sum_of_gamma_noise", "SimpleConfig",
           "exact_k_marginals", "gumbel_topk_hard", "log1mexp",
           "simple_sample", "simple_validation", "topk_mask"]
