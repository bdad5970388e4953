"""Noise for perturb-and-MAP sampling (the port of
``isubgvqa_tpu/sampling/noise.py``): Gumbel(loc, scale), the one the
mask head uses (scale 0.3 for imle and aimle), and the Sum-of-Gamma
distribution of the I-MLE paper.  Every draw comes from the caller's
``torch.Generator``."""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel.mesh import shard_draw
from .gumbel import draw_gumbel


def gumbel_noise(shape, generator: Optional[torch.Generator], device,
                 loc: float = 0.0, scale: float = 1.0) -> torch.Tensor:
    """Gumbel(loc, scale) samples, f32 (``noise.py:17-20``)."""
    return loc + scale * draw_gumbel(shape, generator, device)


def draw_gamma(shape, concentration: float,
               generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Gamma(concentration) samples at rate 1, f32 (the
    ``jax.random.gamma`` distribution)."""
    alpha = torch.full(shape, concentration, dtype=torch.float32,
                       device=device)
    return torch._standard_gamma(alpha, generator=generator)


def sum_of_gamma_noise(shape, k: float, nb_iterations: int = 10,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> torch.Tensor:
    """``(sum_{i=1..s} Gamma(1/k, k/i) - log s) / k`` (``noise.py:23-37``):
    for integer k the sum of k iid copies is close to a Gumbel.  The
    Gamma(1/k) draws are at rate 1 and scaled by ``k/i``, as in JAX."""
    total = torch.zeros(shape, dtype=torch.float32, device=device)
    for i in range(1, nb_iterations + 1):
        total = total + draw_gamma(shape, 1.0 / k, generator, device) * (k / i)
    return (total - math.log(nb_iterations)) / k


def perturbation(shape, cfg, generator: Optional[torch.Generator], device,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The perturbation ``eps`` of the imle and aimle samplers (their
    ``_sample_noise``): ``cfg.noise_scale`` times a standard Gumbel draw,
    or Sum-of-Gamma noise at ``k = max(cfg.k, 1)``.  ``noise`` replaces the
    draw: the standard Gumbel draw (scaled here), or the Sum-of-Gamma
    sample itself."""
    if cfg.noise == "gumbel":
        std = (shard_draw(lambda s: draw_gumbel(s, generator, device), shape)
               if noise is None
               else noise.to(device, torch.float32).reshape(shape))
        return cfg.noise_scale * std
    if cfg.noise == "sum_of_gamma":
        if noise is None:
            return shard_draw(lambda s: sum_of_gamma_noise(
                s, float(max(cfg.k, 1)), cfg.sog_iterations, generator,
                device), shape)
        return noise.to(device, torch.float32).reshape(shape)
    raise ValueError(f"unknown noise {cfg.noise!r}")
