"""Adaptive I-MLE (AIMLE) with symmetric perturbation and an explicit
adaptive-target state (the port of ``isubgvqa_tpu/sampling/aimle.py``).

* forward: ``z = MAP(theta + eps * tau_theta)``, the noise saved
  (``aimle.py:100-112``);
* backward: the targets ``theta'_R = alpha * theta - lam * dy`` and
  ``theta'_L = alpha * theta + lam * dy`` (``alpha * theta`` without
  symmetric perturbation), ``lam = beta * |theta_tiled| / |dy|`` (0 when
  ``|dy| = 0``), re-perturbed with the saved noise; the gradient is
  ``mean_samples((MAP(theta'_L + eps) - MAP(theta'_R + eps)) / 2 /
  lam_process)`` with ``lam_process`` taken over the **untiled** theta,
  a quirk of the reference that the JAX package keeps
  (``aimle.py:115-163``), and a divisor of 1 where it is 0.

The adaptive beta update (``target_aimle.py:130-161``) changes state.
JAX threads it out of the backward as the state input's cotangent; here
the backward writes the new ``beta``, ``grad_norm`` and ``prev_update``
**in place** into the :class:`AIMLEState`'s tensors, which live on the
model's device.  Every rule is a ``torch.where`` on the device, so the
backward never waits on it.  In a data-parallel run the norms and the
count of nonzero entries are taken over every rank's rows (the JAX
package's, over a sharded batch), so each rank writes the same state.
The state is read only in the backward (an
eval forward leaves it as it is), and no autograd graph holds it, so
the in-place write meets no version check.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..parallel.mesh import all_reduce_, data_size
from .noise import perturbation
from .topk import topk_mask


@dataclasses.dataclass(frozen=True)
class AIMLEConfig:
    k: int
    nb_samples: int = 1
    theta_noise_temperature: float = 1.0
    target_noise_temperature: float = 1.0
    symmetric_perturbation: bool = True
    alpha: float = 1.0
    beta_update_step: float = 1e-4
    beta_update_momentum: float = 0.0
    grad_norm_decay_rate: float = 0.9
    target_norm: float = 1.0
    noise_scale: float = 0.3               # Gumbel(0, 0.3), masking.py:262
    noise: str = "gumbel"                  # or "sum_of_gamma"
    sog_iterations: int = 10

    def for_eval(self) -> "AIMLEConfig":
        """The validation sampler keeps the forward noise at ``tau`` when
        ``nb_samples == 1`` (``aimle.py:53-58``): a noisy eval, as in the
        reference."""
        temp = 1.0 if self.nb_samples > 1 else self.theta_noise_temperature
        return dataclasses.replace(self, theta_noise_temperature=temp)


@dataclasses.dataclass
class AIMLEState:
    """The adaptive target distribution's state, three 0-d f32 tensors."""

    beta: torch.Tensor
    grad_norm: torch.Tensor
    prev_update: torch.Tensor

    def to(self, device) -> "AIMLEState":
        return AIMLEState(self.beta.to(device), self.grad_norm.to(device),
                          self.prev_update.to(device))


# the state's field names, in order: the keys of a checkpoint's AIMLE states
AIMLE_FIELDS = tuple(f.name for f in dataclasses.fields(AIMLEState))


def init_aimle_state(device=None, initial_beta: float = 0.0,
                     initial_grad_norm: float = 1.0) -> AIMLEState:
    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return AIMLEState(beta=scalar(initial_beta),
                      grad_norm=scalar(initial_grad_norm),
                      prev_update=scalar(0.0))


def _norms(*ts):
    """The L2 norm of each tensor over the global batch: in a
    data-parallel run the data ranks' squared sums are summed first."""
    if data_size() == 1:
        return [torch.linalg.vector_norm(t) for t in ts]
    sq = all_reduce_(torch.stack([t.float().square().sum() for t in ts]))
    return list(torch.sqrt(sq))


def _perturbation_magnitude(beta, norm_theta, norm_dy):
    """``beta * |theta| / |dy|``, 0 when ``|dy| = 0``."""
    return torch.where(norm_dy > 0.0,
                       beta * norm_theta / torch.clamp(norm_dy, min=1e-30),
                       0.0)


class _AIMLETopK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, eps, cfg, state):
        z = topk_mask(theta[:, None, :] + eps * cfg.theta_noise_temperature,
                      cfg.k)                                   # [B, S, N]
        ctx.save_for_backward(theta, eps)
        ctx.cfg, ctx.state = cfg, state
        return z.transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, dy):
        theta, eps = ctx.saved_tensors
        cfg, state = ctx.cfg, ctx.state
        dy = dy.transpose(0, 1)                                # [B, S, N]
        theta_tiled = theta[:, None, :].expand(dy.shape)

        norm_dy, norm_tiled, norm_theta = _norms(dy, theta_tiled, theta)
        lam = _perturbation_magnitude(state.beta, norm_tiled, norm_dy)
        target_r = cfg.alpha * theta_tiled - lam * dy
        target_l = (cfg.alpha * theta_tiled + lam * dy
                    if cfg.symmetric_perturbation
                    else cfg.alpha * theta_tiled)
        noise = eps * cfg.target_noise_temperature
        grad3d = (topk_mask(target_l + noise, cfg.k)
                  - topk_mask(target_r + noise, cfg.k))
        if cfg.symmetric_perturbation:
            grad3d = grad3d / 2.0

        lam_process = _perturbation_magnitude(state.beta, norm_theta,
                                              norm_dy)
        # nonzero entries per sample, over the global batch: every rank
        # then takes the same beta step
        nnz = (grad3d != 0.0).sum().float()
        rows = float(grad3d.shape[0] * grad3d.shape[1])
        if data_size() > 1:
            nnz, rows = all_reduce_(torch.stack([nnz,
                                                 nnz.new_full((), rows)]))
        decay = cfg.grad_norm_decay_rate
        new_grad_norm = (decay * state.grad_norm
                         + (1.0 - decay) * nnz / rows)
        direction = torch.where(new_grad_norm < cfg.target_norm, 1.0, -1.0)
        beta_update = (cfg.beta_update_momentum * state.prev_update
                       + direction * cfg.beta_update_step)
        new_beta = torch.clamp(state.beta + beta_update, min=0.0)
        state.beta.copy_(new_beta)
        state.grad_norm.copy_(new_grad_norm)
        state.prev_update.copy_(beta_update)

        divisor = torch.where(lam_process > 0.0, lam_process, 1.0)
        grad = (grad3d / divisor).mean(1).to(theta.dtype)
        return grad, None, None, None


def aimle_topk(theta: torch.Tensor, state: AIMLEState, cfg: AIMLEConfig,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """AIMLE top-k over ``theta [B, N]`` -> masks ``[S, B, N]``.  ``state``
    is read and updated only by the backward.  The noise is drawn from
    ``generator`` as ``[B, S, N]``; ``noise`` of that shape replaces the
    draw (see :func:`~.noise.perturbation`)."""
    b, n = theta.shape
    eps = perturbation((b, cfg.nb_samples, n), cfg, generator, theta.device,
                       noise)
    return _AIMLETopK.apply(theta, eps, cfg, state)
