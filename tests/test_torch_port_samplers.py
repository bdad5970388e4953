"""The port's imle, aimle and simple samplers, their noise and
``gumbel_validation`` against the JAX package's, on the CPU.

Noise is shared: ``jax.random.gumbel`` and ``jax.random.gamma`` are
monkeypatched to return numpy draws that the port gets through
``noise=`` (or through its own patched ``draw_gamma``).  Scores carry
zero-filled padding slots, which compete in the top-k as in the model.

Tolerances: masks exactly; imle and aimle gradients, simple's marginals
and gradients 1e-5 abs; aimle's state 1e-6 abs after 1 and after 3
backwards.  Simple's marginals are also held against a brute-force sum
over all k-subsets (N <= 7) and, at the model's N = 128, against an f64
evaluation of the same DP, where the port's log-ratio DP stays within
1e-5 and closer than the JAX package's f32 DP (both are printed).
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from isubgvqa_tpu.sampling import aimle as jaimle
from isubgvqa_tpu.sampling import gumbel as jgumbel
from isubgvqa_tpu.sampling import imle as jimle
from isubgvqa_tpu.sampling import noise as jnoise
from isubgvqa_tpu.sampling import simple as jsimple
from isubgvqa_tpu_torch.convert import aimle_states_from_jax
from isubgvqa_tpu_torch.sampling import aimle as taimle
from isubgvqa_tpu_torch.sampling import gumbel as tgumbel
from isubgvqa_tpu_torch.sampling import imle as timle
from isubgvqa_tpu_torch.sampling import noise as tnoise
from isubgvqa_tpu_torch.sampling import simple as tsimple
from isubgvqa_tpu_torch.sampling import topk_mask

from test_torch_port_model import one_torch_thread, shared_gumbel  # noqa: F401
from test_torch_port_model import quick_xla  # noqa: F401

B, N, K = 5, 12, 3
TOL = 1e-5
STATE_TOL = 1e-6


def scores(seed, b=B, n=N, pad=3):
    s = np.random.default_rng(seed).normal(size=(b, n)).astype(np.float32)
    s[:, n - pad:] = 0.0                    # zero-filled padding slots
    return s


def gumbel_draw(seed, shape):
    return np.random.default_rng(seed).gumbel(size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def shared_gamma(monkeypatch, shape, a, n=10, seed=12):
    """Make ``jax.random.gamma`` and the port's ``draw_gamma`` return the
    same ``n`` numpy Gamma(a) draws, in call order."""
    rng = np.random.default_rng(seed)
    draws = [rng.gamma(a, size=shape).astype(np.float32) for _ in range(n)]
    j_calls, t_calls = iter(draws), iter(draws)
    monkeypatch.setattr(jax.random, "gamma",
                        lambda key, a, shape, dtype=jnp.float32:
                        jnp.asarray(next(j_calls), dtype))
    monkeypatch.setattr(tnoise, "draw_gamma",
                        lambda shape, a, generator, device: t(next(t_calls)))


def port_vjp(fn, theta, dy):
    """``(out, d theta)`` of the port's ``fn(theta)`` under cotangent
    ``dy``."""
    x = t(theta).requires_grad_()
    out = fn(x)
    out = out[0] if isinstance(out, tuple) else out
    (g,) = torch.autograd.grad(out, x, t(dy))
    return out.detach().numpy(), g.numpy()


def jax_vjp(fn, theta, dy, jit=False):
    """``(out, d theta)`` of the JAX package's ``fn(theta)``; ``jit``
    compiles it (simple's DP costs seconds op by op).  The imle and aimle
    samplers run op by op: jitted, XLA:CPU may recompute their top-k in a
    consumer fusion and select other entries than the mask it returned
    (``test_torch_port_sampler_model.py:host_solver``)."""
    def run(x, d):
        out, vjp = jax.vjp(fn, x)
        if isinstance(out, tuple):
            (g,) = vjp((d, jnp.zeros_like(out[1])))
            return out[0], g
        return out, vjp(d)[0]

    out, g = (jax.jit(run) if jit else run)(jnp.asarray(theta),
                                            jnp.asarray(dy))
    return np.asarray(out), np.asarray(g)


# ------------------------------------------------------------------ imle

@pytest.mark.parametrize("nb_samples,mode", [(1, "train"), (2, "train"),
                                             (1, "eval"), (2, "eval"),
                                             (2, "sum_of_gamma")])
def test_imle_forward_backward_match_jax(monkeypatch, nb_samples, mode):
    noise_kind = "sum_of_gamma" if mode == "sum_of_gamma" else "gumbel"
    cfg_j = jimle.IMLEConfig(k=K, nb_samples=nb_samples, noise=noise_kind)
    cfg_t = timle.IMLEConfig(k=K, nb_samples=nb_samples, noise=noise_kind)
    if mode == "eval":
        cfg_j, cfg_t = cfg_j.for_eval(), cfg_t.for_eval()
    theta = scores(1)
    dy = np.random.default_rng(2).normal(
        size=(nb_samples, B, N)).astype(np.float32)
    noise = None
    if noise_kind == "gumbel":      # the standard draw, scaled by 0.3
        noise = gumbel_draw(3, (B, nb_samples, N))
        shared_gumbel(monkeypatch, noise)
    else:                           # both packages sum the same Gammas
        shared_gamma(monkeypatch, (B, nb_samples, N), 1.0 / K)
    z_j, g_j = jax_vjp(lambda s: jimle.imle_topk(s, jax.random.PRNGKey(0),
                                                  cfg_j), theta, dy)
    z_t, g_t = port_vjp(lambda s: timle.imle_topk(
        s, cfg_t, noise=None if noise is None else t(noise)), theta, dy)
    assert z_t.shape == (nb_samples, B, N)
    np.testing.assert_array_equal(z_t, z_j)
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=TOL)
    assert np.any(g_t != 0)
    if mode == "eval" and nb_samples == 1:   # temperature 0: top-k of theta
        np.testing.assert_array_equal(
            z_t, np.broadcast_to(topk_mask(t(theta), K).numpy(), z_t.shape))


# ----------------------------------------------------------------- aimle

def _jax_aimle_step(cfg):
    """One aimle forward + backward, op by op: ``(z, d theta, new
    state)``; the new state is the state input's cotangent.  Jitted,
    the symmetric case's first backward selects other entries (see
    :func:`jax_vjp`)."""
    def f(theta, state, dy):
        def run(th, st):
            return jaimle.aimle_topk(th, st, jax.random.PRNGKey(0), cfg)
        z, vjp = jax.vjp(run, theta, state)
        g, new = vjp(dy)
        return z, g, new

    return f


@pytest.mark.parametrize("symmetric", [True, False],
                         ids=["symmetric", "one_sided"])
def test_aimle_backward_and_state_match_jax(monkeypatch, symmetric):
    """Three backwards in a row, each with its own dy (the last one zero):
    masks, gradients and the state after each, against JAX's state
    cotangent."""
    s = 2
    noise = gumbel_draw(5, (B, s, N))
    shared_gumbel(monkeypatch, noise)
    cfg_j = jaimle.AIMLEConfig(k=K, nb_samples=s,
                               symmetric_perturbation=symmetric)
    cfg_t = taimle.AIMLEConfig(k=K, nb_samples=s,
                               symmetric_perturbation=symmetric)
    step = _jax_aimle_step(cfg_j)
    st_j = jaimle.init_aimle_state(initial_beta=5.0)
    st_t = taimle.init_aimle_state("cpu", initial_beta=5.0)
    theta = scores(6)
    rng = np.random.default_rng(7)
    dys = [rng.normal(size=(s, B, N)).astype(np.float32) for _ in range(2)]
    dys.append(np.zeros((s, B, N), np.float32))          # |dy| = 0
    for i, dy in enumerate(dys):
        z_j, g_j, st_j = step(jnp.asarray(theta), st_j, jnp.asarray(dy))
        x = t(theta).requires_grad_()
        z_t = taimle.aimle_topk(x, st_t, cfg_t, noise=t(noise))
        (g_t,) = torch.autograd.grad(z_t, x, t(dy))
        np.testing.assert_array_equal(z_t.detach().numpy(), np.asarray(z_j))
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                                   atol=TOL, err_msg=f"backward {i + 1}")
        for f in ("beta", "grad_norm", "prev_update"):
            np.testing.assert_allclose(
                float(getattr(st_t, f)), float(getattr(st_j, f)), rtol=0,
                atol=STATE_TOL, err_msg=f"{f} after backward {i + 1}")
        if i < 2:
            assert np.any(g_t.numpy() != 0)
        else:                # lambda = 0: both targets equal, no gradient
            assert not np.any(g_t.numpy())
    assert float(st_t.beta) != 5.0


def test_aimle_forward_never_touches_the_state():
    st = taimle.init_aimle_state("cpu", initial_beta=2.0)
    cfg = taimle.AIMLEConfig(k=K).for_eval()
    with torch.no_grad():
        z = taimle.aimle_topk(t(scores(8)), st, cfg,
                              torch.Generator().manual_seed(0))
    assert z.shape == (1, B, N)
    assert (float(st.beta), float(st.grad_norm), float(st.prev_update)) \
        == (2.0, 1.0, 0.0)


def test_aimle_states_convert_from_jax(monkeypatch):
    """A JAX state after a backward (the cotangent), carried across by
    ``aimle_states_from_jax``, continues on the port as it does in JAX."""
    cfg_j, cfg_t = jaimle.AIMLEConfig(k=K), taimle.AIMLEConfig(k=K)
    noise = gumbel_draw(9, (B, 1, N))
    theta, dy = scores(10), gumbel_draw(11, (1, B, N))
    st = jaimle.init_aimle_state(initial_beta=3.0)
    step = lambda th, s, d: jax.vjp(                    # noqa: E731
        lambda a, b: jaimle.aimle_topk(a, b, jax.random.PRNGKey(0), cfg_j),
        th, s)[1](d)
    shared_gumbel(monkeypatch, noise)
    _, st = step(jnp.asarray(theta), st, jnp.asarray(dy))
    ported = aimle_states_from_jax({3: jax.device_get(st)})
    assert set(ported) == {3}
    for f in ("beta", "grad_norm", "prev_update"):
        v = getattr(ported[3], f)
        assert v.dtype == torch.float32 and v.dim() == 0
        assert float(v) == float(getattr(st, f))
    _, st2 = step(jnp.asarray(theta), st, jnp.asarray(dy))
    x = t(theta).requires_grad_()
    z = taimle.aimle_topk(x, ported[3], cfg_t, noise=t(noise))
    torch.autograd.grad(z, x, t(dy))
    for f in ("beta", "grad_norm", "prev_update"):
        assert abs(float(getattr(ported[3], f))
                   - float(getattr(st2, f))) <= STATE_TOL
    assert aimle_states_from_jax(None) is None


# ----------------------------------------------------------------- noise

def test_sum_of_gamma_noise_matches_jax(monkeypatch):
    shape, k, iters = (4, 2, 7), 3.0, 10
    shared_gamma(monkeypatch, shape, 1.0 / k, iters)
    ref = jnoise.sum_of_gamma_noise(jax.random.PRNGKey(0), shape, k=k,
                                    nb_iterations=iters)
    got = tnoise.sum_of_gamma_noise(shape, k, iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_noise_draws_come_from_the_generator():
    """Same generator seed, same draws; Gamma(a) has mean a and the
    standard Gumbel mean 0.5772 (Euler's constant), over 2e5 draws."""
    def gen():
        return torch.Generator().manual_seed(3)

    g1 = tnoise.draw_gamma((200_000,), 0.5, gen(), "cpu")
    assert torch.equal(g1, tnoise.draw_gamma((200_000,), 0.5, gen(), "cpu"))
    assert abs(float(g1.mean()) - 0.5) < 0.01
    gn = tnoise.gumbel_noise((200_000,), gen(), "cpu", loc=1.0, scale=0.3)
    assert abs(float(gn.mean()) - (1.0 + 0.3 * 0.5772)) < 0.01
    sog = tnoise.sum_of_gamma_noise((4, 5), 3.0, 10, gen(), "cpu")
    assert sog.shape == (4, 5) and torch.isfinite(sog).all()


# ---------------------------------------------------------------- simple

def brute_force_marginals(theta, k):
    """Every k-subset with the reference's literal weights, in f64."""
    n = len(theta)
    w1, w0 = np.exp(theta), 1.0 - np.exp(-np.abs(theta))
    total, per_item = 0.0, np.zeros(n)
    for subset in itertools.combinations(range(n), k):
        w = np.prod([w1[i] if i in subset else w0[i] for i in range(n)])
        total += w
        per_item[list(subset)] += w
    return per_item / total


@pytest.mark.parametrize("n,k", [(5, 2), (6, 3), (7, 1), (4, 4), (7, 3)])
def test_simple_marginals_match_brute_force_and_jax(n, k):
    theta = scores(13, b=3, n=n, pad=1)
    got = tsimple.exact_k_marginals(t(theta), k).numpy()
    ref = np.stack([brute_force_marginals(r.astype(np.float64), k)
                    for r in theta])
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    ref_j = jax.jit(lambda x: jsimple.exact_k_marginals(x, k))(theta)
    np.testing.assert_allclose(got, np.asarray(ref_j), rtol=0, atol=TOL)


@pytest.mark.parametrize("n", [12, 16])
def test_simple_marginals_and_their_gradient_match_jax(n):
    theta = scores(14, b=6, n=n, pad=n // 4)
    w = np.random.default_rng(15).normal(size=theta.shape).astype(np.float32)
    m_j, g_j = jax_vjp(lambda s: jsimple.exact_k_marginals(s, K), theta, w,
                       jit=True)
    m_t, g_t = port_vjp(lambda s: tsimple.exact_k_marginals(s, K), theta, w)
    np.testing.assert_allclose(m_t, m_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(m_t.sum(-1), K, rtol=1e-5)


def test_simple_log_depth_scan_at_full_node_count(capsys):
    """N = 128 with a quarter of padding slots, the model's largest
    bucket: the log-depth scan against the step-by-step DP in f64, for
    the marginals and their gradient.  The JAX package's f32 DP on the
    raw log weights is printed beside it, and is farther from f64."""
    theta = scores(16, b=8, n=128, pad=32)
    w = np.random.default_rng(17).normal(size=theta.shape)
    x64 = torch.from_numpy(theta.astype(np.float64)).requires_grad_()
    m64 = tsimple.exact_k_marginals(x64, K, esp=tsimple.esp_sequential)
    (g64,) = torch.autograd.grad(m64, x64, torch.from_numpy(w))
    m_t, g_t = port_vjp(lambda s: tsimple.exact_k_marginals(s, K), theta,
                        w.astype(np.float32))
    np.testing.assert_allclose(m_t, m64.detach().numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(g_t, g64.numpy(), rtol=0, atol=TOL)
    seq = tsimple.exact_k_marginals(t(theta), K, esp=tsimple.esp_sequential)
    np.testing.assert_allclose(m_t, seq.numpy(), rtol=0, atol=TOL)
    m_j = np.asarray(jax.jit(lambda x: jsimple.exact_k_marginals(x, K))(
        theta))
    port_err = float(np.abs(m_t - m64.detach().numpy()).max())
    jax_err = float(np.abs(m_j - m64.detach().numpy()).max())
    with capsys.disabled():
        print(f"\n[simple N=128] marginals from f64: port {port_err:.3g}, "
              f"JAX {jax_err:.3g}")
    assert port_err < jax_err


def test_simple_marginals_backward_after_an_inference_mode_forward():
    """The DP's cached index, made first under ``torch.inference_mode()``
    (as the bench's eval forwards run), still serves a training backward."""
    tsimple._diagonals.cache_clear()
    theta = t(scores(26))
    with torch.inference_mode():
        m_inf = tsimple.exact_k_marginals(theta, K)
    x = theta.clone().requires_grad_()
    m = tsimple.exact_k_marginals(x, K)
    (g,) = torch.autograd.grad(m.sum(), x)
    assert torch.equal(m.detach(), m_inf) and torch.isfinite(g).all()


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_simple_sample_straight_through_matches_jax(monkeypatch, train):
    cfg_j = jsimple.SimpleConfig(k=K, train_ensemble=2)
    cfg_t = tsimple.SimpleConfig(k=K, train_ensemble=2)
    s = 2 if train else 1
    theta = scores(18)
    noise = gumbel_draw(19, (s, B, N))
    shared_gumbel(monkeypatch, noise)
    dy = np.random.default_rng(20).normal(size=(s, B, N)).astype(np.float32)
    z_j, g_j = jax_vjp(lambda x: jsimple.simple_sample(
        x, jax.random.PRNGKey(0), cfg_j, train=train), theta, dy, jit=True)
    z_t, g_t = port_vjp(lambda x: tsimple.simple_sample(
        x, cfg_t, train, noise=t(noise)), theta, dy)
    np.testing.assert_array_equal(np.round(z_t), np.round(z_j))
    np.testing.assert_allclose(z_t, z_j, rtol=0, atol=TOL)
    assert np.all(np.round(z_t).sum(-1) == K)
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=TOL)
    # the straight-through gradient is the marginals' gradient
    _, g_m = port_vjp(lambda x: tsimple.exact_k_marginals(x, K), theta,
                      dy.sum(0))
    np.testing.assert_allclose(g_t, g_m, rtol=0, atol=1e-6)


def test_simple_validation_matches_jax(monkeypatch):
    theta = scores(21)
    noise = gumbel_draw(22, (1, B, N))
    shared_gumbel(monkeypatch, noise)
    for val_ensemble in (1, 2):
        cfg_j = jsimple.SimpleConfig(k=K, val_ensemble=val_ensemble)
        cfg_t = tsimple.SimpleConfig(k=K, val_ensemble=val_ensemble)
        if val_ensemble == 2:
            noise = gumbel_draw(23, (2, B, N))
            shared_gumbel(monkeypatch, noise)
        m_j, p_j = jax.jit(lambda x: jsimple.simple_validation(
            x, jax.random.PRNGKey(0), cfg_j))(jnp.asarray(theta))
        m_t, p_t = tsimple.simple_validation(t(theta), cfg_t,
                                             noise=t(noise))
        np.testing.assert_array_equal(np.round(m_t.numpy()),
                                      np.round(np.asarray(m_j)))
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                                   atol=TOL)


def test_log1mexp_matches_jax_on_every_branch():
    x = np.array([0.0, 1e-12, 1e-3, 0.5, 0.6931, 0.7, 3.0, 49.0, 60.0,
                  -2.0], np.float32)
    np.testing.assert_allclose(tsimple.log1mexp(t(x)).numpy(),
                               np.asarray(jsimple.log1mexp(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- gumbel

@pytest.mark.parametrize("val_ensemble", [1, 2])
def test_gumbel_validation_matches_jax(monkeypatch, val_ensemble):
    theta = scores(24)
    noise = gumbel_draw(25, (val_ensemble * B, N))
    shared_gumbel(monkeypatch, noise)
    cfg_j = jgumbel.GumbelSamplerConfig(k=K, val_ensemble=val_ensemble)
    cfg_t = tgumbel.GumbelSamplerConfig(k=K, val_ensemble=val_ensemble)
    ref = jgumbel.gumbel_validation(jnp.asarray(theta),
                                    jax.random.PRNGKey(0), cfg_j)
    got = tgumbel.gumbel_validation(t(theta), cfg_t, noise=t(noise))
    assert got.shape == (val_ensemble, B, N)
    np.testing.assert_array_equal(np.round(got.numpy()),
                                  np.round(np.asarray(ref)))
