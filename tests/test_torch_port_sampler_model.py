"""The whole model under the imle, aimle and simple samplers against the
JAX package, in float32 on the CPU: the eval forward, one train step
against ``isubgvqa_tpu.train.steps.make_train_step``, and aimle's
adaptive state over 3 steps.

The config is ``small_cfg`` cut to one encoder and one decoder layer and
two GAT layers, the last one masked, with every dropout at 0.  The JAX
params are built once and serve all three samplers (a sampler adds no
parameters).  The sampler's standard Gumbel draw is shared: JAX's
``jax.random.gumbel`` is patched to return it, and the port gets it
through ``noise=`` or its patched ``draw_gumbel``.

Two test-side measures, neither changing what the JAX package computes:

* **taps** (:class:`Taps`): identity functions around the sampler in
  both packages' mask heads record its input theta, its output, the
  cotangent dy that reaches it and the gradient it returns;
* **host solver** (:func:`host_solver`): under ``jit``, XLA:CPU fuses
  the imle / aimle backward's target arithmetic into both the top-k sort
  and, recomputed, into the consumer of the ``>=`` compare, and the
  recomputation can select other entries than the mask the solver
  returned (jitted, ``test_torch_port_samplers.py``'s aimle backward at
  B = 5, N = 12 disagrees with the op-by-op JAX result, which equals the
  port's).  The JAX
  samplers' MAP solver is therefore run as the same ``>=``-threshold
  top-k in numpy through ``jax.pure_callback``, which XLA cannot
  recompute.

Tolerances: logits 1e-3 abs and the node mask identical (simple's mask
values ``(s - m) + m`` within 1e-6); one step's loss 1e-4 relative and
every gradient leaf at rtol 1e-4 / atol 1e-6; aimle's state 1e-6.  The
margin rule: the sampler's gradient is asserted exactly equal (aimle's:
the same entries, values within 1e-5 relative, since its divisor is a
float norm) only where the smallest gap between the k-th and (k+1)-th
perturbed target of any row exceeds twice the largest difference of
those targets between the packages (alpha |d theta| + beta |d dy|, with
aimle's lambda in place of beta and its own difference); the test
asserts that it does and prints both numbers.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.flatten_util
import jax.numpy as jnp

from isubgvqa_tpu.data import (AnswerMap, BucketSpec, Collator,
                               HashWordTokenizer, SceneGraphVocab,
                               SyntheticGQA)
from isubgvqa_tpu.models import masking as jmasking
from isubgvqa_tpu.models.build import build_model, make_aimle_states
from isubgvqa_tpu.sampling import aimle as jaimle
from isubgvqa_tpu.sampling import imle as jimle
from isubgvqa_tpu.train.schedule import make_optimizer
from isubgvqa_tpu.train.state import TrainState
from isubgvqa_tpu.train.steps import make_train_step
from isubgvqa_tpu_torch import data as tdata
from isubgvqa_tpu_torch.models import masking as tmasking
from isubgvqa_tpu_torch.models.build import (build_model as tbuild,
                                             check_supported,
                                             make_aimle_states as tstates)
from isubgvqa_tpu_torch.sampling import aimle as taimle
from isubgvqa_tpu_torch.sampling import noise as tnoise
from isubgvqa_tpu_torch.sampling import simple as tsimple
from isubgvqa_tpu_torch.serve import Predictor
from isubgvqa_tpu_torch.train import create_train_state
from isubgvqa_tpu_torch.train import make_train_step as t_train_step

from test_model import small_cfg
from test_torch_port_model import (one_torch_thread,  # noqa: F401
                                   port_and_jax, port_cfg, shared_gumbel,
                                   to_port_batch)
from test_torch_port_model import quick_xla  # noqa: F401
from test_torch_port_train import _adam_mu, _flat, _port_tree

SAMPLERS = ("imle", "aimle", "simple")
STEPS_PER_EPOCH = 4
# aimle's starting beta: the init's 0 gives lambda = 0 and no gradient, and
# at 1 no target leaves the forward's top-k at random init
AIMLE_BETA = 5.0
# imle's beta (``--beta``): at random init the cotangent that reaches the
# mask is ~1e-4, and at the default beta 10 no target leaves the forward's
# top-k, so imle's gradient would be all zero; 1000 moves them by ~0.1
IMLE_BETA = 1000.0
MASKED = 1                # the masked GAT layer
K = 3


def base_cfg(sampler):
    return small_cfg(dropout=0.0, head_dropout=0.0, mask_dropout=0.0,
                     encoder_layers=1, decoder_layers=1, mgat_layers=2,
                     mgat_masks=(1.0, 0.15), sampler_type=sampler,
                     beta=IMLE_BETA)


@pytest.fixture(scope="module")
def setup():
    cfg = base_cfg("imle")
    vocab = SceneGraphVocab.synthetic()
    answers = AnswerMap.synthetic(cfg.num_answers)
    ds = SyntheticGQA(vocab, answers, size=16, seed=0)
    spec = BucketSpec(batch_size=4, max_nodes_per_graph=cfg.max_nodes_per_graph,
                      max_edges_per_graph=cfg.max_edges_per_graph,
                      question_len=cfg.question_len)
    tok = HashWordTokenizer(vocab_size=cfg.text_vocab_size,
                            max_len=cfg.question_len)
    batch, _ = Collator(tok, spec, vocab=vocab).collate(
        [ds[i] for i in range(4)])
    _, sd, params, stats = port_and_jax(cfg, vocab)
    # one standard Gumbel draw, [B, 1, N] for imle / aimle, [1, B, N] for
    # simple: the same B * N numbers either way
    noise = np.random.default_rng(8).gumbel(
        size=(4, cfg.max_nodes_per_graph)).astype(np.float32)
    return vocab, batch, to_port_batch(batch), sd, params, stats, noise


def noise_for(sampler, noise):
    b, n = noise.shape
    return noise.reshape((1, b, n) if sampler == "simple" else (b, 1, n))


def host_solver(theta_bsn, k):
    """The JAX samplers' MAP solver (``>=`` the k-th largest), in numpy."""
    def top_k(s):
        s = np.asarray(s)
        return (s >= -np.sort(-s, axis=-1)[..., k - 1:k]).astype(s.dtype)

    s = jax.lax.stop_gradient(theta_bsn)
    return jax.pure_callback(top_k, jax.ShapeDtypeStruct(s.shape, s.dtype), s)


class Taps:
    """Records, around each sampler call, theta (its input), out (its
    sample), dy (the cotangent of the sample) and grad (theta's)."""

    def __init__(self):
        self.steps = []

    def jax(self, mp):
        rec = self

        def tap(name):
            @jax.custom_vjp
            def ident(x):
                return x

            def fwd(x):
                jax.debug.callback(lambda v: rec._put(name, v), x)
                return x, None

            def bwd(_, g):
                jax.debug.callback(
                    lambda v: rec._put("dy" if name == "out" else "grad", v),
                    g)
                return (g,)

            ident.defvjp(fwd, bwd)
            return ident

        tap_in, tap_out = tap("theta"), tap("out")
        for name in ("imle_topk", "aimle_topk"):
            orig = getattr(jmasking, name)
            mp.setattr(jmasking, name, lambda th, *a, _f=orig:
                       tap_out(_f(tap_in(th), *a)))
        orig_simple = jmasking.simple_sample
        mp.setattr(jmasking, "simple_sample",
                   lambda th, *a, **kw: (lambda r: (tap_out(r[0]), r[1]))(
                       orig_simple(tap_in(th), *a, **kw)))

    def port(self, mp):
        rec = self

        def wrap(orig, first=False):
            def f(theta, *a, **kw):
                rec._put("theta", theta.detach())
                theta.register_hook(lambda g: rec._put("grad", g))
                out = orig(theta, *a, **kw)
                z = out[0] if first else out
                rec._put("out", z.detach())
                if z.requires_grad:
                    z.register_hook(lambda g: rec._put("dy", g))
                return out
            return f

        for name in ("imle_topk", "aimle_topk"):
            mp.setattr(tmasking, name, wrap(getattr(tmasking, name)))
        mp.setattr(tmasking, "simple_sample",
                   wrap(tmasking.simple_sample, first=True))

    def _put(self, name, v):
        v = np.array(v.detach().numpy() if isinstance(v, torch.Tensor) else v,
                     np.float64)
        if name == "theta":
            self.steps.append({})
        self.steps[-1][name] = v


def patch_jax(mp, sampler, noise):
    shared_gumbel(mp, noise_for(sampler, noise))
    mp.setattr(jimle, "_solve", host_solver)
    mp.setattr(jaimle, "_solve", host_solver)


def patch_port_draws(mp, sampler, noise):
    draw = (lambda shape, generator, device:
            torch.from_numpy(noise_for(sampler, noise)).reshape(shape))
    mp.setattr(tnoise, "draw_gumbel", draw)
    mp.setattr(tsimple, "draw_gumbel", draw)


@pytest.fixture(scope="module")
def jax_programs(setup):
    """Each sampler's JAX eval forward and ``make_train_step``, traced
    here in turn under the sampler's patches (the shared draw is a
    constant of the trace; the train step's taps are installed) and
    compiled by a pool of threads meanwhile, so that XLA's compiles
    overlap the tracing and each other.  Per sampler: the compiled
    forward and step, the step's taps and its initial state."""
    vocab, batch, tb, sd, params, stats, noise = setup
    variables = {"params": params, "batch_stats": stats}
    programs = {}
    with ThreadPoolExecutor(3) as pool:
        for sampler in SAMPLERS:
            cfg = base_cfg(sampler)
            model = build_model(cfg, vocab)
            eval_states = make_aimle_states(cfg)
            with pytest.MonkeyPatch.context() as mp:
                patch_jax(mp, sampler, noise)
                forward = jax.jit(lambda v, a, m=model, st=eval_states:
                                  m.apply(v, *a, train=False, aimle_states=st,
                                          rngs={"sampler":
                                                jax.random.PRNGKey(0)})
                                  ).lower(variables, (batch,))
            taps = Taps()
            optimizer = make_optimizer(cfg.lr, STEPS_PER_EPOCH)
            states = ({MASKED: jaimle.init_aimle_state(
                initial_beta=AIMLE_BETA)} if sampler == "aimle" else None)
            state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                               opt_state=optimizer.init(params),
                               batch_stats=stats, aimle_states=states)
            with pytest.MonkeyPatch.context() as mp:
                patch_jax(mp, sampler, noise)
                taps.jax(mp)
                step = jax.jit(make_train_step(model, optimizer, cfg)).lower(
                    state, batch, jax.random.PRNGKey(0))
            programs[sampler] = dict(forward=pool.submit(forward.compile),
                                     step=pool.submit(step.compile),
                                     taps=taps, state=state)
        return {s: dict(p, forward=p["forward"].result(),
                        step=p["step"].result())
                for s, p in programs.items()}


# ------------------------------------------------------------------ eval

@pytest.mark.parametrize("sampler", SAMPLERS)
def test_eval_forward_matches_jax(setup, jax_programs, sampler):
    """imle's eval is deterministic (input temperature 0), aimle's and
    simple's draw noise; the eval forward leaves aimle's state alone."""
    vocab, batch, tb, sd, params, stats, noise = setup
    cfg = base_cfg(sampler)
    tm = tbuild(port_cfg(cfg), tdata.SceneGraphVocab.synthetic(),
                device="cpu", state_dict=sd)
    states = tstates(port_cfg(cfg), "cpu")
    with torch.no_grad():
        out_t = tm(tb, noise=torch.from_numpy(noise_for(sampler, noise)),
                   aimle_states=states)
        again = tm(tb, noise=torch.from_numpy(noise_for(sampler, -noise)),
                   aimle_states=states)
    out_j = jax_programs[sampler]["forward"](
        {"params": params, "batch_stats": stats}, (batch,))
    np.testing.assert_allclose(out_t.logits.numpy(), np.asarray(out_j.logits),
                               rtol=0, atol=1e-3)
    nm_t, nm_j = out_t.node_mask.numpy(), np.asarray(out_j.node_mask)
    np.testing.assert_array_equal(np.round(nm_t), np.round(nm_j))
    np.testing.assert_allclose(nm_t, nm_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out_t.gate.numpy(), np.asarray(out_j.gate),
                               rtol=0, atol=1e-4)
    valid = batch.node_mask
    assert np.all(np.round(nm_t[..., 0]).sum(-1) <= K + valid.shape[1]
                  - valid.sum(-1))        # padding slots compete in the top-k
    assert np.all(nm_t[..., 0][~valid] == 0)
    same = np.array_equal(again.node_mask.numpy(), nm_t)
    assert same == (sampler == "imle"), "only imle's eval ignores the noise"
    if states is not None:
        st = states[MASKED]
        assert (float(st.beta), float(st.grad_norm), float(st.prev_update)) \
            == (0.0, 1.0, 0.0)


# ------------------------------------------------------------ train step

_JAX_RUNS = {}


def jax_run(setup, jax_programs, sampler, n_steps):
    """``make_train_step`` jitted (:func:`jax_programs`), ``n_steps`` steps
    on the same batch and noise: losses, grad norms, the first step's
    gradients (from Adam's first moment after one update from zero), the
    taps of each step and aimle's state after each."""
    if sampler in _JAX_RUNS:
        return _JAX_RUNS[sampler]
    vocab, batch, tb, sd, params, stats, noise = setup
    cfg = base_cfg(sampler)
    prog = jax_programs[sampler]
    step, taps, state = prog["step"], prog["taps"], prog["state"]
    losses, norms, aimle = [], [], []
    for i in range(n_steps):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        losses.append(float(m["loss_sum"] / m["count"]))
        norms.append(float(m["grad_norm"]))
        if state.aimle_states is not None:
            aimle.append(jax.device_get(state.aimle_states[MASKED]))
        if i == 0:
            clip = min(1.0, cfg.grad_clip_norm / norms[0])
            g = _adam_mu(state) / (1.0 - 0.9) / clip
            grads0 = jax.flatten_util.ravel_pytree(params)[1](g)
    jax.effects_barrier()                   # the taps' callbacks have run
    _JAX_RUNS[sampler] = dict(losses=losses, norms=norms, grads0=grads0,
                              taps=taps.steps, aimle=aimle)
    return _JAX_RUNS[sampler]


def port_run(setup, sampler, n_steps, monkeypatch):
    vocab, batch, tb, sd, params, stats, noise = setup
    cfg = port_cfg(base_cfg(sampler))
    st = create_train_state(cfg, tdata.SceneGraphVocab.synthetic(),
                            STEPS_PER_EPOCH, device="cpu", state_dict=sd)
    if sampler == "aimle":
        assert set(st.aimle_states) == {MASKED}
        st.aimle_states = {
            MASKED: taimle.init_aimle_state("cpu", initial_beta=AIMLE_BETA)}
    patch_port_draws(monkeypatch, sampler, noise)
    taps = Taps()
    taps.port(monkeypatch)
    step = t_train_step(st.model, st.optimizer, cfg)
    losses, norms, aimle, grads0 = [], [], [], None
    for i in range(n_steps):
        st, m = step(st, tb)
        losses.append(float(m["loss_sum"] / m["count"]))
        norms.append(float(m["grad_norm"]))
        if sampler == "aimle":
            s = st.aimle_states[MASKED]
            aimle.append({f: float(getattr(s, f))
                          for f in ("beta", "grad_norm", "prev_update")})
        if i == 0:
            grads0 = {n: p.grad.clone() for n, p in
                      st.model.named_parameters()}
    return dict(losses=losses, norms=norms, grads0=grads0, model=st.model,
                taps=taps.steps, aimle=aimle)


def perturbed_targets(sampler, tap, noise, beta):
    """The sampler's perturbed targets ``[B, S, N]`` in its backward, in
    f64: ``alpha theta - beta dy + eps`` (imle; aimle with lambda and
    both signs), or the forward's ``theta + g`` (simple)."""
    theta = tap["theta"][:, None, :]
    if sampler == "simple":
        return [theta[:, 0][None] + noise_for("simple", noise)], 0.0
    eps = 0.3 * noise_for(sampler, noise).astype(np.float64)
    dy = np.swapaxes(tap["dy"], 0, 1)
    if sampler == "imle":
        return [theta - IMLE_BETA * dy + eps], IMLE_BETA
    lam = beta * np.linalg.norm(np.broadcast_to(theta, dy.shape)) \
        / np.linalg.norm(dy)
    return [theta - lam * dy + eps, theta + lam * dy + eps], lam


def smallest_margin(targets):
    srt = -np.sort(-targets, axis=-1)
    return float((srt[..., K - 1] - srt[..., K]).min())


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_train_step_matches_jax(setup, jax_programs, sampler, monkeypatch,
                                capsys):
    n_steps = 3 if sampler == "aimle" else 1
    ref = jax_run(setup, jax_programs, sampler, n_steps)
    got = port_run(setup, sampler, n_steps, monkeypatch)
    noise = setup[-1]
    np.testing.assert_allclose(got["losses"][0], ref["losses"][0], rtol=1e-4)
    np.testing.assert_allclose(got["norms"][0], ref["norms"][0], rtol=1e-4)

    # the sampler's forward sample (the node mask before the padding fill)
    tj, tt = ref["taps"][0], got["taps"][0]
    np.testing.assert_array_equal(np.round(tt["out"]), np.round(tj["out"]))

    # the margin rule, then the sampler's gradient
    beta = AIMLE_BETA
    targets_t, scale = perturbed_targets(sampler, tt, noise, beta)
    targets_j, scale_j = perturbed_targets(sampler, tj, noise, beta)
    margin = min(smallest_margin(x) for x in targets_t)
    d_theta = float(np.abs(tt["theta"] - tj["theta"]).max())
    d_dy = (0.0 if sampler == "simple"
            else float(np.abs(tt["dy"] - tj["dy"]).max()))
    d_target = max(float(np.abs(a - b).max())
                   for a, b in zip(targets_t, targets_j))
    bound = 2.0 * max(d_target, d_theta + scale * d_dy)
    with capsys.disabled():
        print(f"\n[{sampler}] smallest top-k margin {margin:.3g}, bound "
              f"{bound:.3g} (|d theta| {d_theta:.3g}, |d dy| {d_dy:.3g})")
    assert margin > bound, (
        f"{sampler}: a top-k margin of {margin:.3g} is within twice the "
        f"targets' difference between the packages ({bound:.3g}): the "
        f"selection is not decided by f32 here")
    g_t, g_j = tt["grad"], tj["grad"]
    if sampler == "imle":
        np.testing.assert_array_equal(g_t, g_j)
    elif sampler == "aimle":
        np.testing.assert_array_equal(np.sign(g_t), np.sign(g_j))
        np.testing.assert_allclose(g_t, g_j, rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-5)
    assert np.any(g_t != 0), "the sampler passed no gradient"

    # every gradient leaf
    want = _flat(ref["grads0"])
    got_leaves = _flat(_port_tree(got["model"], got["grads0"])[0])
    assert set(got_leaves) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got_leaves[k], w, rtol=1e-4, atol=1e-6,
                                   err_msg=k)

    if sampler == "aimle":       # the adaptive state over 3 steps
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
        for i, (s_t, s_j) in enumerate(zip(got["aimle"], ref["aimle"])):
            for f, v in s_t.items():
                assert abs(v - float(getattr(s_j, f))) <= 1e-6, (i, f)
        assert got["aimle"][-1]["beta"] != AIMLE_BETA


# --------------------------------------------------------- entry points

@pytest.mark.parametrize("sampler", SAMPLERS)
def test_entry_points_take_every_sampler(setup, sampler):
    """``check_supported`` accepts the sampler with masks (1, 1, 1, 0.15);
    serving, ``build_model``, ``create_train_state`` and a train step run
    on the CPU when asked for it, and with no device given they ask for
    the card (and raise without one)."""
    vocab_t = tdata.SceneGraphVocab.synthetic()
    cfg = port_cfg(small_cfg(sampler_type=sampler, encoder_layers=1,
                             decoder_layers=1, meta_dir=""))
    check_supported(cfg)
    assert cfg.mgat_masks == (1.0, 1.0, 1.0, 0.15)
    pred = Predictor.from_seed(cfg, device="cpu")
    ds = tdata.SyntheticGQA(pred.vocab, pred.answers, size=3, seed=1)
    res = pred.predict([ds.samples[i][2] for i in range(3)],
                       [ds.store.scene_graphs[ds.samples[i][1]]
                        for i in range(3)], batch_size=4)
    assert len(res) == 3 and all(np.isfinite(r.confidence) for r in res)
    assert all(np.round(r.node_mask).sum() <= K for r in res)
    if sampler == "aimle":
        assert set(pred.aimle_states) == {3}
    st = create_train_state(cfg, vocab_t, STEPS_PER_EPOCH, device="cpu")
    tb = setup[2]
    st, m = t_train_step(st.model, st.optimizer, cfg)(st, tb)
    assert np.isfinite(float(m["loss_sum"])) and st.step == 1
    if sampler == "aimle":     # the backward moved the state, in place
        assert float(st.aimle_states[3].grad_norm) != 1.0
    if not torch.cuda.is_available():
        makers = [lambda: tbuild(cfg, vocab_t),
                  lambda: create_train_state(cfg, vocab_t, 4),
                  lambda: Predictor.from_seed(cfg)]
        if sampler == "aimle":
            makers.append(lambda: tstates(cfg))
        for make in makers:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
