"""The port's multistep train step and its sync-free optimizer, on the CPU.

Against the JAX package (``isubgvqa_tpu.train.steps`` and
``isubgvqa_tpu.train.schedule``):

* ``make_multistep_train_step`` at K = 2 against the JAX package's (a
  ``lax.scan`` of the step), on ``tests/test_multistep.py``'s
  deterministic model (masks 1.0, no sampler; every dropout at 0 here,
  so the two sides draw nothing) from the same weights and batches.
  Tolerances of ``test_torch_port_train.py:test_three_steps_track_jax``
  (f32 on both sides, summation orders differ): each inner step's loss
  1e-4 relative, its gradient norm 2e-3 relative, the BatchNorm running
  statistics 1e-4 relative / 1e-6 absolute, Adam's first moment by
  cosine > 0.999;
* the optimizer's skip, clip and schedule against ``skip_nonfinite`` over
  ``optax.chain(clip_by_global_norm, adam(schedule))`` step by step: an
  unclipped step, a clipped one, one whose gradient holds an ``inf`` (no
  update, Adam's count unchanged, ``notfinite_count`` + 1) and two across
  the warmup -> decay boundary; parameters 1e-6 relative / 1e-7 absolute
  (``test_optimizer_matches_optax``'s bounds), the moments likewise, the
  counts exactly.  ``Optimizer.step`` runs with ``bool``, ``float`` and
  ``int`` of a tensor, ``.item`` and ``.tolist`` patched to raise.

Against the port itself (the mirrors of ``tests/test_multistep.py``):
the multistep step against K sequential steps (metrics 5e-4 relative,
99 % of the parameters within 1e-5 and none beyond 4 lr), each inner
step's noise its own (gumbel), and a Trainer epoch at ``multistep = 2``
against ``multistep = 1`` (one bucket, an even batch count).  On the
CPU the K steps run one after another; the CUDA graph that holds them on
the card is checked by ``chip_smoke.py`` phase 19.
"""

import dataclasses

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isubgvqa_tpu.data import (AnswerMap, BucketSpec, Collator,
                               HashWordTokenizer, SceneGraphVocab,
                               SyntheticGQA)
from isubgvqa_tpu.data.batching import iterate_batches
from isubgvqa_tpu.models.build import build_model
from isubgvqa_tpu.train.schedule import make_optimizer as jax_optimizer
from isubgvqa_tpu.train.state import TrainState as JTrainState
from isubgvqa_tpu.train.steps import (
    make_multistep_train_step as jax_multistep)
from isubgvqa_tpu_torch import data as tdata
from isubgvqa_tpu_torch.train import (Trainer, create_train_state,
                                      make_multistep_train_step,
                                      make_train_step)
from isubgvqa_tpu_torch.train import loop as tloop
from isubgvqa_tpu_torch.train.schedule import make_optimizer
from isubgvqa_tpu_torch.train.steps import step_generator

from test_model import small_cfg
from test_torch_port_model import (one_torch_thread,  # noqa: F401
                                   port_and_jax, port_cfg, to_port_batch)
from test_torch_port_model import quick_xla  # noqa: F401
from test_torch_port_train import _adam_mu, _flat, _port_tree

STEPS_PER_EPOCH = 4
K = 2
# narrow widths (the trainer tests' tiny config): one encoder and one
# decoder layer of width 64, hidden 32
NARROW = dict(encoder_layers=1, decoder_layers=1, text_emb_dim=64,
              num_heads=4, general_hidden_dim=32)


def _batches(cfg, n):
    vocab = SceneGraphVocab.synthetic()
    answers = AnswerMap.synthetic(cfg.num_answers)
    ds = SyntheticGQA(vocab, answers, size=8 * n, seed=0)
    spec = BucketSpec(batch_size=8, max_nodes_per_graph=32,
                      max_edges_per_graph=128, question_len=12)
    coll = Collator(HashWordTokenizer(vocab_size=cfg.text_vocab_size,
                                      max_len=12), spec, vocab=vocab)
    return vocab, [b for b, _ in iterate_batches(ds, coll, drop_last=True)]


@pytest.fixture(scope="module")
def det():
    """``test_multistep.py:det_setup``'s model with every dropout at 0:
    the JAX multistep program's two steps and the port's weights."""
    cfg = small_cfg(batch_size=8, lr=3e-4, warmup_epochs=0,
                    mgat_masks=(1.0,) * 4, sampler_type=None, sample_k=None,
                    dropout=0.0, head_dropout=0.0, mask_dropout=0.0,
                    **NARROW)
    vocab, batches = _batches(cfg, K)
    _, sd, params, stats = port_and_jax(cfg, vocab)
    model = build_model(cfg, vocab)
    opt = jax_optimizer(cfg.lr, STEPS_PER_EPOCH, cfg.warmup_epochs,
                        cfg.warmup_start_lr, cfg.lr_gamma, cfg.grad_clip_norm)
    state = JTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                        opt_state=opt.init(params), batch_stats=stats,
                        aimle_states=None)
    stacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *batches)
    state, m = jax.jit(jax_multistep(model, opt, cfg))(
        state, stacked, jax.random.PRNGKey(0))
    return cfg, sd, [to_port_batch(b) for b in batches], state, \
        jax.device_get(m)


def test_multistep_tracks_jax(det):
    cfg, sd, batches, jstate, jm = det
    st = create_train_state(port_cfg(cfg), tdata.SceneGraphVocab.synthetic(),
                            STEPS_PER_EPOCH, device="cpu", state_dict=sd)
    multi = make_multistep_train_step(st.model, st.optimizer, st.model.cfg)
    st, m = multi(st, batches)
    assert st.step == K and st.optimizer.count == K
    assert all(v.shape == (K,) for v in m.values())
    np.testing.assert_allclose((m["loss_sum"] / m["count"]).numpy(),
                               jm["loss_sum"] / jm["count"], rtol=1e-4)
    np.testing.assert_allclose(m["grad_norm"].numpy(), jm["grad_norm"],
                               rtol=2e-3)
    _, stats_t = _port_tree(st.model, {})
    for k, v in _flat(stats_t).items():
        np.testing.assert_allclose(v, _flat(jstate.batch_stats)[k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    names = {p: n for n, p in st.model.named_parameters()}
    mu_tree = _port_tree(st.model, {
        names[p]: s["exp_avg"] for p, s in st.optimizer.adam.state.items()})[0]
    mu_t = np.asarray(jax.flatten_util.ravel_pytree(mu_tree)[0])
    mu_j = _adam_mu(jstate)
    cos = float(np.dot(mu_j, mu_t)
                / (np.linalg.norm(mu_j) * np.linalg.norm(mu_t)))
    assert cos > 0.999, cos


@pytest.fixture(scope="module")
def noisy():
    """``test_multistep.py:setup``: gumbel at k = 4, with dropout."""
    cfg = port_cfg(small_cfg(batch_size=8, lr=3e-4, warmup_epochs=0,
                             sampler_type="gumbel", sample_k=4, **NARROW))
    _, batches = _batches(cfg, 3)
    sd = create_train_state(cfg, tdata.SceneGraphVocab.synthetic(),
                            STEPS_PER_EPOCH, device="cpu",
                            seed=1).model.state_dict()
    return cfg, sd, [to_port_batch(b) for b in batches]


def _fresh(noisy):
    cfg, sd, _ = noisy
    return create_train_state(cfg, tdata.SceneGraphVocab.synthetic(),
                              STEPS_PER_EPOCH, device="cpu", state_dict=sd)


def test_multistep_matches_sequential(noisy):
    cfg, _, batches = noisy
    seq = _fresh(noisy)
    single = make_train_step(seq.model, seq.optimizer, cfg)
    want = []
    for b in batches[:K]:
        seq, m = single(seq, b)
        want.append({k: float(v) for k, v in m.items()})
    st = _fresh(noisy)
    st, mm = make_multistep_train_step(st.model, st.optimizer, cfg)(
        st, batches[:K])
    for j, m in enumerate(want):
        for key, v in m.items():
            np.testing.assert_allclose(float(mm[key][j]), v, rtol=5e-4,
                                       err_msg=f"metric {key} step {j}")
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(
        seq.model.parameters(), st.model.parameters())]).detach().numpy()
    assert np.quantile(diffs, 0.99) < 1e-5
    assert diffs.max() < 4 * cfg.lr
    assert st.step == seq.step == K
    assert st.optimizer.count == seq.optimizer.count


def test_multistep_noise_differs_per_inner_step(noisy):
    """The same batch three times: three distinct losses (each inner
    step's generator is seeded from its own step); the first inner
    step's metrics are one single step's from the same state."""
    cfg, _, batches = noisy
    st = _fresh(noisy)
    _, mm = make_multistep_train_step(st.model, st.optimizer, cfg)(
        st, [batches[0]] * 3)
    losses = mm["loss_sum"].tolist()
    assert len(set(losses)) == 3, losses
    st = _fresh(noisy)
    _, m0 = make_train_step(st.model, st.optimizer, cfg)(st, batches[0])
    for key, v in m0.items():
        np.testing.assert_allclose(float(mm[key][0]), float(v), rtol=5e-4,
                                   err_msg=f"metric {key} first step")
    # the steps' generators given explicitly: the same draws
    st = _fresh(noisy)
    _, mg = make_multistep_train_step(st.model, st.optimizer, cfg)(
        st, [batches[0]] * 3, [step_generator(cfg, j, "cpu")
                               for j in range(3)])
    assert mg["loss_sum"].tolist() == losses


def test_trainer_multistep_epoch_matches_single(tmp_path):
    base = port_cfg(small_cfg(synthetic=True, synthetic_size=64,
                              meta_dir="", batch_size=8, epochs=1,
                              bucket_node_caps=(), bucket_question_lens=(),
                              **NARROW))
    groups = []

    def run(multistep):
        cfg = dataclasses.replace(base, multistep=multistep,
                                  output_dir=str(tmp_path / str(multistep)))
        data = tdata.build_datasets(cfg)
        cfg = dataclasses.replace(cfg, num_answers=len(data.answers))
        trainer = Trainer(cfg, data, device="cpu")
        if trainer.multi_step is not None:
            inner = trainer.multi_step

            def counted(state, batches):
                groups.append(len(batches))
                return inner(state, batches)

            trainer.multi_step = counted
        loss = trainer.train_epoch(0)
        return loss, trainer.state

    loss1, s1 = run(1)
    loss2, s2 = run(2)
    assert groups and groups == [K] * len(groups)
    assert s1.step == s2.step == K * len(groups)
    assert np.isfinite(loss1) and loss1 == pytest.approx(loss2, rel=1e-4)
    for a, b in zip(s1.model.parameters(), s2.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=5e-4, atol=1e-6)


def test_gloo_on_cuda_refuses_multistep(monkeypatch):
    """Gloo's collectives run on the host, where no CUDA graph holds them:
    the Trainer refuses ``multistep > 1`` there and says why."""
    dist = tloop.dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    with pytest.raises(ValueError, match="Gloo's collectives run on the host"):
        tloop.refuse_uncapturable(torch.device("cuda"), 2)
    tloop.refuse_uncapturable(torch.device("cuda"), 1)
    tloop.refuse_uncapturable(torch.device("cpu"), 2)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    tloop.refuse_uncapturable(torch.device("cuda"), 2)


def _no_host_reads(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a host read in Optimizer.step")

    for name in ("__bool__", "__float__", "__int__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


def test_skip_clip_and_schedule_match_optax(monkeypatch):
    spe, warm, base, start, gamma = 1, 2, 1e-2, 1e-4, 0.5
    rng = np.random.default_rng(5)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    scales = (0.05, 3.0, 1.0, 0.1, 0.08)   # norms about 0.2, 12, -, 0.5, 0.3
    grads = [[rng.normal(size=s).astype(np.float32) * c for s in shapes]
             for c in scales]
    grads[2][1][3] = np.inf
    opt_j = jax_optimizer(base, spe, warmup_epochs=warm,
                          warmup_start_lr=start, gamma=gamma,
                          grad_clip_norm=2.0, flat=False)
    pj = [jnp.asarray(p) for p in p0]
    sj = opt_j.init(pj)
    update = jax.jit(opt_j.update)
    pt = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = make_optimizer(pt, base, spe, warmup_epochs=warm,
                         warmup_start_lr=start, gamma=gamma,
                         grad_clip_norm=2.0)
    for i, g in enumerate(grads):
        upd, sj = update([jnp.asarray(x) for x in g], sj, pj)
        pj = optax.apply_updates(pj, upd)
        for p, x in zip(pt, g):
            p.grad = torch.from_numpy(x.copy())
        with monkeypatch.context() as mp:
            _no_host_reads(mp)
            norm = opt.step()
        adam = sj.inner_state[1][0]
        np.testing.assert_allclose(float(norm), np.sqrt(sum(
            float(np.sum(np.square(x.astype(np.float64)))) for x in g)),
            rtol=1e-6)
        assert int(opt.count) == int(adam.count), i
        assert int(opt.notfinite_count) == int(sj.notfinite_count), i
        for j, p in enumerate(pt):
            st = opt.adam.state[p]
            for got, want in ((p.detach(), pj[j]),
                              (st["exp_avg"], adam.mu[j]),
                              (st["exp_avg_sq"], adam.nu[j])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"step {i} leaf {j}")
    # the skipped third step: count 4 of 5 updates, notfinite back to 0;
    # the last two steps ran at the decay's rates, base and base * gamma
    assert int(opt.count) == 4 and int(opt.notfinite_count) == 0
    assert [float(opt.schedule(c)) for c in (1, 2, 3)] == pytest.approx(
        [start + (base - start) / warm, base, base * gamma], rel=1e-6)


def test_skip_leaves_the_state_and_counts_the_step(monkeypatch):
    """One step with an ``inf`` in the gradient after an update: the
    parameters, both moments and Adam's count stay bitwise what they
    were, ``notfinite_count`` goes 0 -> 1 -> 2, and the next finite step
    updates and sets it back to 0."""
    p = torch.nn.Parameter(torch.randn(6, generator=torch.Generator()
                                       .manual_seed(0)))
    opt = make_optimizer([p], 1e-2, 1, warmup_epochs=0)
    p.grad = torch.ones(6)
    opt.step()
    before = [t.clone() for t in (p.detach(), opt.adam.state[p]["exp_avg"],
                                  opt.adam.state[p]["exp_avg_sq"])]
    for n in (1, 2):
        p.grad = torch.ones(6)
        p.grad[n] = float("inf") if n == 1 else float("nan")
        with monkeypatch.context() as mp:
            _no_host_reads(mp)
            norm = opt.step()
        assert not torch.isfinite(norm)
        after = (p.detach(), opt.adam.state[p]["exp_avg"],
                 opt.adam.state[p]["exp_avg_sq"])
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        assert int(opt.count) == 1 and int(opt.notfinite_count) == n
    p.grad = torch.ones(6)
    opt.step()
    assert int(opt.count) == 2 and int(opt.notfinite_count) == 0
    assert not torch.equal(p.detach(), before[0])

