"""Iterative relaxed Gumbel top-k sampler with its straight-through
gradient.

The port of ``isubgvqa_tpu/sampling/gumbel.py:gumbel_topk_sample``
(``:73-86,126-152``): k rounds of softmax at temperature ``tau`` with a
``log(max(1 - onehot, FLT_MIN))`` accumulator, then the hard top-k with
the straight-through expression ``hard - khot.detach() + khot``, so the
relaxed rounds carry the gradient.

At tau = 0.1 a round's softmax saturates to exactly 1.0 in f32 once the
score gap passes about 1.7, and the log's backward then contributes
``1/FLT_MIN`` per round, which overflows the step (``gumbel.py:32-52``).
On a CUDA tensor the port therefore applies the JAX package's
accelerator remedy: the log keeps its exact forward value but its
gradient is cut below 1e-3 (:func:`_bounded_log`), and the whole
relaxation's input gradient is clamped to +-100.  The saturation is a
property of f32 at tau = 0.1, not of the TPU.  On the CPU the port keeps
the exact gradient, as the JAX package's CPU path does; the branch
follows ``scores.is_cuda`` (the JAX package's ``_on_tpu()``).

Eval still adds Gumbel noise: the reference's mask head calls the
sampler's forward with ``train=False``, which only picks the ensemble
size (``gumbel.py:9-16``).  That is reference parity, not a bug.

Noise comes from the caller's ``torch.Generator`` or is given
explicitly as ``noise`` (the tests hand both packages the same array).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .topk import topk_mask

EPSILON = float(torch.finfo(torch.float32).tiny)
BWD_FLOOR = 1e-3        # gumbel.py:_BWD_FLOOR
GRAD_LIMIT = 100.0      # gumbel.py:_GRAD_LIMIT


@dataclasses.dataclass(frozen=True)
class GumbelSamplerConfig:
    k: int
    tau: float = 0.1          # reference gumbel_scheme.py:15
    hard: bool = True
    train_ensemble: int = 1
    val_ensemble: int = 1


def draw_gumbel(shape, generator: Optional[torch.Generator],
                device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))``, ``U`` uniform on
    ``[FLT_MIN, 1)`` (the ``jax.random.gumbel`` construction)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(torch.clamp(u, min=EPSILON)))


def _bounded_log(m: torch.Tensor, floor: float) -> torch.Tensor:
    """``log(m)`` whose gradient is ``1/m`` where ``m > floor`` and 0
    below (the forward value is exact everywhere)."""
    safe = torch.clamp(m, min=floor)
    return torch.log(safe) + (torch.log(m) - torch.log(safe)).detach()


class _ClampGrad(torch.autograd.Function):
    """Identity whose backward clamps the gradient to +-``limit``."""

    @staticmethod
    def forward(ctx, x, limit):
        ctx.limit = limit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, -ctx.limit, ctx.limit), None


def relaxed_topk(scores: torch.Tensor, k: int, tau: float,
                 bounded: bool = False) -> torch.Tensor:
    """k rounds of masked softmax (gumbel_scheme.py:72-81).  ``bounded``
    cuts the log-mask gradient below :data:`BWD_FLOOR` and clamps the
    input gradient to +-:data:`GRAD_LIMIT` (the JAX package's
    ``_clamped_relaxed_topk``)."""
    if bounded:
        scores = _ClampGrad.apply(scores, GRAD_LIMIT)
    khot = torch.zeros_like(scores)
    onehot = torch.zeros_like(scores)
    for _ in range(k):
        mask = torch.clamp(1.0 - onehot, min=EPSILON)
        scores = scores + (_bounded_log(mask, BWD_FLOOR) if bounded
                           else torch.log(mask))
        onehot = torch.softmax(scores / tau, dim=-1)
        khot = khot + onehot
    return khot


def gumbel_topk_sample(scores: torch.Tensor, cfg: GumbelSamplerConfig,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hard top-k masks ``[S, B, N]`` from scores ``[B, N]``; ``S`` is the
    ensemble size (``train_ensemble`` or ``val_ensemble``).  ``noise``
    (``[S * B, N]``) replaces the draw from ``generator``.  Gradients
    reach ``scores`` through the relaxed rounds."""
    b, n = scores.shape
    local_k = min(cfg.k, n)
    repeat = cfg.train_ensemble if train else cfg.val_ensemble
    tiled = scores[None].expand(repeat, b, n).reshape(repeat * b, n)
    if noise is None:
        noise = draw_gumbel(tiled.shape, generator, scores.device)
    perturbed = tiled + noise.to(tiled.device, tiled.dtype).reshape(
        tiled.shape)
    khot = relaxed_topk(perturbed, local_k, cfg.tau, bounded=scores.is_cuda)
    if cfg.hard:
        hard = topk_mask(khot.detach(), local_k)
        res = hard - khot.detach() + khot
    else:
        res = khot
    return res.reshape(repeat, b, n)
