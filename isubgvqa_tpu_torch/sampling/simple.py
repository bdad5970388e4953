"""SIMPLE: exactly-k subset sampling with exact marginals and a
straight-through gradient (the port of ``isubgvqa_tpu/sampling/simple.py``;
Ahmed et al., "SIMPLE: A Gradient Estimator for k-Subset Sampling").

The marginals ``p(i in S | |S| = k)`` come from the elementary symmetric
polynomials of the item weights in log space (``simple.py:59-108``):
with the prefix polynomial over the items before ``i`` and the suffix
polynomial over the items after it,
``p_i = w1_i * [x^(k-1)](prefix_i * suffix_i) / [x^k](all items)``.  The
JAX package builds the prefixes with a ``lax.scan`` of N dependent steps.
A product of polynomials truncated at degree k is associative, so here
the prefixes (and, on the reversed items, the suffixes) come from a
log-depth inclusive scan (Hillis-Steele): ``ceil(log2 N)`` rounds of one
truncated product each, 7 at N = 128 instead of 128 steps, with the
reversed items stacked under the forward ones so that one scan makes
both.  :func:`esp_sequential` is the step-by-step DP, kept as the oracle
the scan is held against.  Autograd through either is the
exact gradient, as JAX's autodiff through its scan is.  The DP runs in
f32.

Literal weights (``simple.py:85-94``): "selected" ``exp(theta)`` (the
gradient flows), "unselected" ``1 - exp(-|theta|)``, detached.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ..parallel.mesh import shard_draw
from .gumbel import draw_gumbel
from .topk import topk_mask

_NEG = -1.0e30          # log of 0 that keeps sums and gradients finite


@dataclasses.dataclass(frozen=True)
class SimpleConfig:
    k: int
    train_ensemble: int = 1
    val_ensemble: int = 1
    logits_activation: Optional[str] = None


def log1mexp(x: torch.Tensor) -> torch.Tensor:
    """``log(1 - exp(-|x|))``, numerically stable, with the JAX package's
    safe branches (``simple.py:46-56``)."""
    x = -x.abs()
    safe_hi = torch.clamp(x, max=-1e-10)
    safe_lo = torch.clamp(x, min=-50.0)
    return torch.where(x > -0.6931471805599453,
                       torch.log(-torch.expm1(safe_hi)),
                       torch.log1p(-torch.exp(safe_lo)))


def _identity(like: torch.Tensor, k: int) -> torch.Tensor:
    """The polynomial 1 in log space, ``[rows, k + 1]`` for ``like``'s
    ``[rows, N]``, made by device ops only (no scalar written into a CUDA
    tensor, which copies it from the host)."""
    zero = torch.zeros_like(like[:, :1])
    return torch.cat([zero, torch.full_like(zero, _NEG).expand(-1, k)], 1)


def esp_sequential(r: torch.Tensor, k: int):
    """The DP of the JAX package's scan (``simple.py:59-80``), one item a
    step, over the items' polynomials ``1 + exp(r_i) x``:
    ``(prefix [B, N, k+1], suffix [B, N, k+1], total [B, k+1])``, the
    log-ESPs over the items before ``i``, after ``i`` and over all."""

    def scan(r):
        carry = _identity(r, k)
        prefix = []
        for i in range(r.shape[1]):
            prefix.append(carry)
            carry = torch.cat([carry[:, :1], torch.logaddexp(
                carry[:, 1:], carry[:, :-1] + r[:, i, None])], dim=1)
        return torch.stack(prefix, 1), carry

    prefix, total = scan(r)
    return prefix, scan(r.flip(1))[0].flip(1), total


@functools.lru_cache(maxsize=None)
def _diagonals(k: int, device: torch.device) -> torch.Tensor:
    """Index ``[k+1, k+1]`` into a flattened ``[k+1, k+1]`` outer sum (plus
    one padding slot at the end): row ``m`` picks the terms ``(j, m - j)``
    of degree m, and the padding slot where ``j > m``.  Made once per
    device, by device ops (a copy from the host would wait on the card)
    and outside inference mode (the bench's eval forwards run in it, and
    a training backward must be able to save the index)."""
    with torch.inference_mode(False):
        m = torch.arange(k + 1, device=device)[:, None]
        j = torch.arange(k + 1, device=device)[None, :]
        return torch.where(j <= m, j * (k + 1) + (m - j), (k + 1) ** 2)


def _poly_mul(a: torch.Tensor, b: torch.Tensor, diag: torch.Tensor):
    """The product of log-space polynomials ``[..., k+1]``, truncated at
    degree k: ``c_m = logsumexp_j (a_j + b_(m-j))``."""
    outer = (a[..., :, None] + b[..., None, :]).flatten(-2)
    outer = torch.cat([outer, torch.full_like(outer[..., :1], _NEG)], -1)
    return torch.logsumexp(outer[..., diag], dim=-1)


def esp_log_depth(r: torch.Tensor, k: int):
    """:func:`esp_sequential`'s result from a log-depth inclusive scan over
    the items and their reverse at once."""
    b, n = r.shape
    diag = _diagonals(k, r.device)
    # item i's polynomial 1 + exp(r_i) x: [2B, N, k+1], reversed items below
    r2 = torch.cat([r, r.flip(1)])[..., None]
    x = torch.cat([torch.zeros_like(r2), r2,
                   torch.full_like(r2, _NEG).expand(-1, -1, k - 1)], -1)
    d = 1
    while d < n:
        x = torch.cat([x[:, :d], _poly_mul(x[:, :-d], x[:, d:], diag)], 1)
        d *= 2
    excl = torch.cat([_identity(r2[:, :, 0], k)[:, None], x[:, :-1]], 1)
    return excl[:b], excl[b:].flip(1), x[:b, -1]


def exact_k_marginals(scores: torch.Tensor, k: int,
                      esp=esp_log_depth) -> torch.Tensor:
    """Exact marginals ``p(i in S | |S| = k)`` for ``scores [B, N]``, in f32
    (or f64 for f64 scores); ``esp`` picks the DP (:func:`esp_log_depth` or
    :func:`esp_sequential`).

    Each item's weights are divided by its "unselected" weight, which
    leaves every marginal as it is (each subset holds one weight of every
    item): the DP runs on ``1 + exp(r_i) x`` with the log-ratio
    ``r_i = log w1_i - log w0_i``.  The JAX package runs it on the raw log
    weights, whose sums reach magnitudes of hundreds at N = 128 with
    zero-filled padding slots (``log w0 = -23`` there), and f32 rounding
    moves its marginals by about 3e-5 from an f64 evaluation; the ratios
    keep the log-ESPs near ``k * max r``, and the port's marginals about
    100 times closer (``tests/test_torch_port_samplers.py`` prints
    both)."""
    scores = scores.to(torch.promote_types(scores.dtype, torch.float32))
    if k <= 0:
        return torch.zeros_like(scores)
    k = min(k, scores.shape[-1])
    lw0 = torch.clamp(log1mexp(-scores.detach()), min=_NEG)
    r = scores - lw0
    prefix, suffix, total = esp(r, k)
    # log p_i = r_i + logsumexp_j (prefix_i[j] + suffix_i[k-1-j]) - log Z
    combo = prefix[..., :k] + suffix[..., :k].flip(-1)
    log_p = r + torch.logsumexp(combo, dim=-1) - total[:, k, None]
    return torch.exp(torch.clamp(log_p, max=0.0))


def gumbel_topk_hard(scores: torch.Tensor, k: int, times_sampled: int,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hard Gumbel-top-k samples ``[S, B, N]`` (``simple.py:111-117``);
    ``noise`` (a standard Gumbel draw ``[S, B, N]``) replaces the draw."""
    shape = (times_sampled,) + tuple(scores.shape)
    g = (shard_draw(lambda s: draw_gumbel(s, generator, scores.device),
                    shape, axis=1) if noise is None
         else noise.to(scores.device, scores.dtype).reshape(shape))
    return topk_mask((scores[None] + g).detach(), k)


def simple_sample(scores: torch.Tensor, cfg: SimpleConfig,
                  train: bool = True,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None):
    """``(masks [S, B, N], marginals [B, N])``; the masks carry the
    straight-through gradient ``(sample - marginal).detach() + marginal``
    (``simple.py:120-139``).  ``S`` is the train or val ensemble."""
    local_k = min(cfg.k, scores.shape[-1])
    times = cfg.train_ensemble if train else cfg.val_ensemble
    marginals = exact_k_marginals(scores, local_k)
    samples = gumbel_topk_hard(scores, local_k, times, generator,
                               noise)
    ste = (samples - marginals[None]).detach() + marginals[None]
    return ste, marginals


def simple_validation(scores: torch.Tensor, cfg: SimpleConfig,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None):
    """The deterministic eval path (``simple.py:142-150``): the marginals
    and the hard top-k of the scores when ``val_ensemble == 1``, else
    :func:`simple_sample`'s eval branch.  The mask head never calls it:
    its eval runs :func:`simple_sample` with ``train=False``."""
    if cfg.val_ensemble == 1:
        _, marginals = simple_sample(scores, cfg, False, generator, noise)
        mask = topk_mask(scores.detach(), min(cfg.k, scores.shape[-1]))
        return mask[None], marginals
    return simple_sample(scores, cfg, False, generator, noise)
