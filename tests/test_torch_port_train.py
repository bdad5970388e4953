"""The port's training step against the JAX package's, in float32 on the
CPU (``small_cfg``: the config of record's structure at narrow widths).

Both sides start from the same weights (a seeded port init crossed to
flax by ``isubgvqa_tpu.convert.convert_state_dict``), take the same
numpy batch, run with every dropout at 0 and share the gumbel noise
(``jax.random.gumbel`` patched to return the numpy draw the port gets
through its own ``draw_gumbel``).  The JAX side is
``isubgvqa_tpu.train.steps.make_train_step`` with
``isubgvqa_tpu.train.schedule.make_optimizer`` at the same
``steps_per_epoch``, jitted (the patched noise is a constant of the
trace, so every step sees the same draw on both sides).

Tolerances (f32 on both sides, summation orders differ): the loss 1e-4
relative; each gradient leaf 2e-3 of its own max abs, floored at 1e-4 of
the largest gradient (the attention q/k and softmax backward subtract
near-equal terms, which amplifies forward noise of ~1e-6 into ~1e-4 of
the leaf's scale, and a leaf whose exact gradient is zero holds only
rounding noise); the
node mask exactly; the 3-step losses 1e-4 relative; the BatchNorm
running statistics 1e-4 relative; Adam's first moment after 3 steps by
cosine > 0.999 and norm ratio within 1 % (Adam turns f32 noise into
near-sign updates, so parameter deltas are the wrong measure; see
``test_torch_golden_trajectory.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.flatten_util
import jax.numpy as jnp

from isubgvqa_tpu.data import (AnswerMap, BucketSpec, Collator,
                               HashWordTokenizer, SceneGraphVocab,
                               SyntheticGQA)
from isubgvqa_tpu.models.build import build_model
from isubgvqa_tpu.train.schedule import make_optimizer
from isubgvqa_tpu.train.state import TrainState
from isubgvqa_tpu.train.steps import cross_entropy_loss, make_train_step
from isubgvqa_tpu_torch import data as tdata
from isubgvqa_tpu_torch.sampling import gumbel as tgumbel
from isubgvqa_tpu_torch.train import (create_train_state,
                                      make_eval_step as t_eval_step,
                                      make_train_step as t_train_step)
from isubgvqa_tpu_torch.train.steps import cross_entropy_loss as t_ce

from test_model import small_cfg
from test_torch_port_model import (jax_weights, one_torch_thread,  # noqa: F401
                                   port_and_jax, port_cfg, shared_gumbel,
                                   to_port_batch)

STEPS_PER_EPOCH = 4
N_STEPS = 3


@pytest.fixture(scope="module")
def setup():
    cfg = small_cfg(dropout=0.0, head_dropout=0.0, mask_dropout=0.0)
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
    tm, sd, params, stats = port_and_jax(cfg, vocab)
    noise = np.random.default_rng(6).gumbel(
        size=(4, cfg.max_nodes_per_graph)).astype(np.float32)
    return cfg, vocab, batch, to_port_batch(batch), sd, params, stats, noise


def _patch_port_noise(monkeypatch, noise):
    monkeypatch.setattr(tgumbel, "draw_gumbel",
                        lambda shape, generator, device:
                        torch.from_numpy(noise).reshape(shape))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_tree(model, values):
    """Port values keyed like the model's parameters (gradients, Adam
    moments) -> the flax params tree, through the JAX converter."""
    sd = {k: v.detach().float() for k, v in model.state_dict().items()}
    sd.update({k: v.detach().float() for k, v in values.items()})
    cfg = model.cfg
    return jax_weights(cfg, sd)


def _adam_mu(state):
    """Adam's first moment: of the two full-length vectors of the flat
    optimizer's state (mu, nu), the one with negative entries."""
    n_total = sum(x.size for x in jax.tree_util.tree_leaves(state.params))
    full = [np.asarray(x) for x in jax.tree_util.tree_leaves(state.opt_state)
            if getattr(x, "size", 0) == n_total]
    assert len(full) == 2
    return next(v for v in full if np.any(v < 0))


@pytest.fixture(scope="module")
def jax_run(setup):
    """The JAX side: the first step's loss and node mask (a jitted train
    forward), then 3 steps of ``make_train_step``.  The first step's
    gradients come out of Adam's first moment after one update from
    zero, ``mu = (1 - b1) * clip(g)``: one compile of the step instead of
    a second one of ``jax.grad``."""
    cfg, vocab, batch, tb, sd, params, stats, noise = setup
    model = build_model(cfg, vocab)
    mp = pytest.MonkeyPatch()
    try:
        shared_gumbel(mp, noise)
        rngs = {"dropout": jax.random.PRNGKey(1),
                "sampler": jax.random.PRNGKey(2)}
        out0, _ = jax.jit(lambda p: model.apply(
            {"params": p, "batch_stats": stats}, batch, train=True,
            rngs=rngs, mutable=["batch_stats"]))(params)
        loss0 = cross_entropy_loss(out0.logits, batch.labels,
                                   batch.sample_mask)
        optimizer = make_optimizer(cfg.lr, STEPS_PER_EPOCH)
        state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                           opt_state=optimizer.init(params),
                           batch_stats=stats, aimle_states=None)
        step = jax.jit(make_train_step(model, optimizer, cfg))
        losses, norms = [], []
        for i in range(N_STEPS):
            state, m = step(state, batch, jax.random.PRNGKey(0))
            losses.append(float(m["loss_sum"] / m["count"]))
            norms.append(float(m["grad_norm"]))
            if i == 0:
                clip = min(1.0, cfg.grad_clip_norm / norms[0])
                g = _adam_mu(state) / (1.0 - 0.9) / clip
                grads0 = jax.flatten_util.ravel_pytree(params)[1](g)
    finally:
        mp.undo()
    return dict(loss0=float(loss0), mask0=np.asarray(out0.node_mask),
                grads0=grads0, losses=losses, norms=norms, state=state)


def _port_state(setup):
    cfg, vocab, batch, tb, sd, params, stats, noise = setup
    return create_train_state(port_cfg(cfg), tdata.SceneGraphVocab.synthetic(),
                              STEPS_PER_EPOCH, device="cpu", state_dict=sd)


def test_first_step_loss_grads_and_mask_match_jax(setup, jax_run):
    cfg, vocab, batch, tb, sd, params, stats, noise = setup
    st = _port_state(setup)
    out = st.model(tb, noise=torch.from_numpy(noise), train=True)
    loss = t_ce(out.logits, tb.labels, tb.sample_mask)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jax_run["loss0"],
                               rtol=1e-4)
    np.testing.assert_array_equal(out.node_mask.detach().numpy(),
                                  jax_run["mask0"])
    grads = {n: p.grad for n, p in st.model.named_parameters()}
    assert all(g is not None for g in grads.values())
    got = _flat(_port_tree(st.model, grads)[0])
    want = _flat(jax_run["grads0"])
    assert set(got) == set(want)
    # a leaf whose true gradient is zero (the attention key bias, which
    # shifts a whole softmax row) holds only rounding noise: its scale
    # is floored at 1e-4 of the largest gradient
    floor = 1e-4 * max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(got[k] - w).max()) / scale
        assert err <= 2e-3, f"{k}: {err:.3g} of scale {scale:.3g}"


def test_three_steps_track_jax(setup, jax_run, monkeypatch):
    cfg, vocab, batch, tb, sd, params, stats, noise = setup
    st = _port_state(setup)
    _patch_port_noise(monkeypatch, noise)
    step = t_train_step(st.model, st.optimizer, st.model.cfg)
    losses, norms = [], []
    for _ in range(N_STEPS):
        st, m = step(st, tb)
        losses.append(float(m["loss_sum"] / m["count"]))
        norms.append(float(m["grad_norm"]))
    assert st.step == N_STEPS and st.optimizer.count == N_STEPS
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-4)
    np.testing.assert_allclose(norms, jax_run["norms"], rtol=2e-3)

    # BatchNorm running statistics after three updates
    _, stats_t = _port_tree(st.model, {})
    for k, v in _flat(stats_t).items():
        np.testing.assert_allclose(v, _flat(jax_run["state"].batch_stats)[k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)

    # Adam's first moment, raveled in optax.flatten's order
    mu_j = _adam_mu(jax_run["state"])
    names = {p: n for n, p in st.model.named_parameters()}
    mu_tree = _port_tree(st.model, {
        names[p]: s["exp_avg"] for p, s in st.optimizer.adam.state.items()})[0]
    mu_t = np.asarray(jax.flatten_util.ravel_pytree(mu_tree)[0])
    nj, nt = np.linalg.norm(mu_j), np.linalg.norm(mu_t)
    cos = float(np.dot(mu_j, mu_t) / (nj * nt))
    assert cos > 0.999, cos
    assert 0.99 < nj / nt < 1.01, nj / nt


def test_train_step_with_dropout_runs_and_moves(setup):
    """The config's dropouts on (0.1 text, 0.2 mask head and classifier),
    drawn from the step's generator: finite loss, every parameter
    moves, BatchNorm statistics move, and the eval step runs after."""
    cfg, vocab, batch, tb, sd, params, stats, noise = setup
    tcfg = dataclasses.replace(port_cfg(cfg), dropout=0.1, head_dropout=0.2,
                               mask_dropout=0.2, lr=1e-3, warmup_epochs=0)
    st = create_train_state(tcfg, tdata.SceneGraphVocab.synthetic(),
                            STEPS_PER_EPOCH, device="cpu", state_dict=sd)
    before = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
    step = t_train_step(st.model, st.optimizer, tcfg)
    st, m = step(st, tb)
    assert np.isfinite(float(m["loss_sum"])) and float(m["count"]) == 4
    assert np.isfinite(float(m["grad_norm"]))
    after = st.model.state_dict()
    unmoved = [k for k, v in before.items()
               if torch.equal(v, after[k]) and not k.endswith("num_batches_tracked")]
    assert unmoved == [], unmoved
    metrics = t_eval_step(st.model, tcfg)(st, tb,
                                          torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss_sum"]))
