"""I-MLE: implicit maximum-likelihood estimation by perturb-and-MAP (the
port of ``isubgvqa_tpu/sampling/imle.py``; Niepert, Minervini &
Franceschi, NeurIPS 2021).

* forward: tile the scores ``nb_samples`` times, add the perturbation
  (Gumbel(0, 0.3) by default) times the input temperature, take the
  per-row top-k (``imle.py:67-74``);
* backward: the target ``theta' = alpha * theta - beta * dy``,
  re-perturbed with the **saved** forward noise at the target
  temperature and re-solved; the gradient is
  ``mean_samples(MAP(theta + eps) - MAP(theta' + eps))``
  (``imle.py:77-96``).

The JAX ``custom_vjp`` becomes a ``torch.autograd.Function`` that saves
theta, the noise and the forward's solution.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .noise import perturbation
from .topk import topk_mask


@dataclasses.dataclass(frozen=True)
class IMLEConfig:
    k: int
    nb_samples: int = 1
    input_noise_temperature: float = 1.0
    target_noise_temperature: float = 1.0
    alpha: float = 1.0
    beta: float = 10.0
    noise_scale: float = 0.3               # Gumbel(0, 0.3), masking.py:227
    noise: str = "gumbel"                  # or "sum_of_gamma"
    sog_iterations: int = 10

    def for_eval(self) -> "IMLEConfig":
        """The validation sampler: deterministic (input temperature 0) when
        ``nb_samples == 1`` (``imle.py:44-48``)."""
        temp = self.input_noise_temperature if self.nb_samples > 1 else 0.0
        return dataclasses.replace(self, input_noise_temperature=temp)


class _IMLETopK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, eps, cfg):
        z = topk_mask(theta[:, None, :] + eps * cfg.input_noise_temperature,
                      cfg.k)                                   # [B, S, N]
        ctx.save_for_backward(theta, eps, z)
        ctx.cfg = cfg
        return z.transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, dy):
        theta, eps, z = ctx.saved_tensors
        cfg = ctx.cfg
        dy = dy.transpose(0, 1)                                # [B, S, N]
        target = cfg.alpha * theta[:, None, :] - cfg.beta * dy
        z_target = topk_mask(target + eps * cfg.target_noise_temperature,
                             cfg.k)
        return (z - z_target).mean(1).to(theta.dtype), None, None


def imle_topk(theta: torch.Tensor, cfg: IMLEConfig,
              generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Perturb-and-MAP top-k over ``theta [B, N]`` -> masks ``[S, B, N]``,
    the sample axis first as in JAX.  The noise is drawn from
    ``generator`` as ``[B, S, N]``; ``noise`` of that shape replaces the
    draw (see :func:`~.noise.perturbation`)."""
    b, n = theta.shape
    eps = perturbation((b, cfg.nb_samples, n), cfg, generator, theta.device,
                       noise)
    return _IMLETopK.apply(theta, eps, cfg)
