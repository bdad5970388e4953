"""A JAX run's whole train state exported to the port
(``tools/export_torch_checkpoint.py``, ``convert.train_payload_from_jax``)
and resumed there, on the CPU.

The JAX package takes two train steps at an aimle config (so AIMLE's
state moves), saves the state with its ``CheckpointManager`` (orbax) and
takes a third.  The tool exports the orbax directory; the port's
``CheckpointManager.restore`` loads the file into a fresh train state
and takes the third step with the same sampler draw.  Both optimizer
layouts are saved and exported: ``make_optimizer(flat=True)``'s
(``optax.flatten``: flat moment vectors), which the steps ran, and
``flat=False``'s (per-leaf moments), the same values in that layout's
state.

The config is ``small_cfg`` cut as ``tests/test_torch_port_sampler_model
.py`` cuts it (one encoder and one decoder layer, two GAT layers, the
second masked), every dropout at 0, learning rate 1e-3 with no warmup
so that the two steps move the weights; the shared Gumbel draw and the
JAX samplers' MAP solver on the host are that file's seams.

Tolerances: the restored weights, BatchNorm statistics, Adam moments,
Adam's per-parameter step, the counts, the step and AIMLE's state are
bitwise equal to ``state_dict_from_jax`` of the JAX trees.  The resumed
step: the loss and the gradient norm within 1e-4 relative, AIMLE's state
within 1e-6 (``test_torch_port_sampler_model.py``); Adam's moments and
the step's parameter update by cosine > 0.999 and norm ratio within 1 %
(``test_torch_port_train.py``'s measure for Adam's moments: Adam turns
f32 noise into near-sign updates).
"""

import dataclasses
import os
import runpy
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isubgvqa_tpu.data import (AnswerMap, BucketSpec, Collator,
                               HashWordTokenizer, SceneGraphVocab,
                               SyntheticGQA)
from isubgvqa_tpu.models.build import build_model
from isubgvqa_tpu.sampling import aimle as jaimle
from isubgvqa_tpu.train.checkpoint import CheckpointManager as JManager
from isubgvqa_tpu.train.schedule import make_optimizer
from isubgvqa_tpu.train.state import TrainState
from isubgvqa_tpu.train.steps import make_train_step
from isubgvqa_tpu_torch import convert
from isubgvqa_tpu_torch import data as tdata
from isubgvqa_tpu_torch.convert import (state_dict_from_jax,
                                        train_payload_from_jax)
from isubgvqa_tpu_torch.sampling.aimle import AIMLE_FIELDS
from isubgvqa_tpu_torch.train import create_train_state
from isubgvqa_tpu_torch.train import make_train_step as t_train_step
from isubgvqa_tpu_torch.train.checkpoint import CheckpointManager, \
    state_payload
from isubgvqa_tpu_torch.train.schedule import warmup_exponential_schedule

from test_torch_port_model import (one_torch_thread,  # noqa: F401
                                   port_and_jax, port_cfg, to_port_batch)
from test_torch_port_model import quick_xla  # noqa: F401
from test_torch_port_sampler_model import (AIMLE_BETA, MASKED, base_cfg,
                                           patch_jax, patch_port_draws)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORT = os.path.join(ROOT, "tools", "export_torch_checkpoint.py")
STEPS_PER_EPOCH = 4
LAYOUTS = ("flat", "per_leaf")


def cfg_of():
    return dataclasses.replace(base_cfg("aimle"), lr=1e-3, warmup_epochs=0)


def per_leaf_state(state, cfg):
    """``state`` (of ``make_optimizer(flat=True)``) with its optimizer state
    in ``make_optimizer(flat=False)``'s layout: the same counts, Adam's
    ``mu`` and ``nu`` unravelled into params-shaped trees (the state a
    per-leaf run at the same values holds)."""
    opt = make_optimizer(cfg.lr, STEPS_PER_EPOCH, cfg.warmup_epochs,
                         flat=False)
    fresh = opt.init(state.params)
    unravel = jax.flatten_util.ravel_pytree(state.params)[1]
    adam, sched = state.opt_state.inner_state[1]
    leaf = fresh._replace(
        notfinite_count=state.opt_state.notfinite_count,
        inner_state=(fresh.inner_state[0], (adam._replace(
            mu=unravel(adam.mu), nu=unravel(adam.nu)), sched)))
    assert jax.tree_util.tree_structure(leaf) == \
        jax.tree_util.tree_structure(fresh)
    return state.replace(opt_state=leaf)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX state after 2 steps, saved in each optimizer layout and
    exported, and the third step's loss, norm and state."""
    cfg = cfg_of()
    vocab = SceneGraphVocab.synthetic()
    answers = AnswerMap.synthetic(cfg.num_answers)
    ds = SyntheticGQA(vocab, answers, size=16, seed=0)
    spec = BucketSpec(batch_size=4,
                      max_nodes_per_graph=cfg.max_nodes_per_graph,
                      max_edges_per_graph=cfg.max_edges_per_graph,
                      question_len=cfg.question_len)
    tok = HashWordTokenizer(vocab_size=cfg.text_vocab_size,
                            max_len=cfg.question_len)
    batch, _ = Collator(tok, spec, vocab=vocab).collate(
        [ds[i] for i in range(4)])
    _, _, params, stats = port_and_jax(cfg, vocab)
    noise = np.random.default_rng(8).gumbel(
        size=(4, cfg.max_nodes_per_graph)).astype(np.float32)
    model = build_model(cfg, vocab)
    key = jax.random.PRNGKey(0)
    opt = make_optimizer(cfg.lr, STEPS_PER_EPOCH, cfg.warmup_epochs)
    state = TrainState(
        step=jnp.asarray(0, jnp.int32), params=params,
        opt_state=opt.init(params), batch_stats=stats,
        aimle_states={MASKED: jaimle.init_aimle_state(
            initial_beta=AIMLE_BETA)})
    with pytest.MonkeyPatch.context() as mp:
        patch_jax(mp, "aimle", noise)
        step = jax.jit(make_train_step(model, opt, cfg))
        for _ in range(2):
            state, _ = step(state, batch, key)
        state3, m = step(state, batch, key)
    tmp = tmp_path_factory.mktemp("export")
    saved = {"flat": state, "per_leaf": per_leaf_state(state, cfg)}
    out = dict(state2=jax.device_get(state), state3=jax.device_get(state3),
               loss=float(m["loss_sum"] / m["count"]),
               norm=float(m["grad_norm"]), paths={}, payloads={})
    for layout, st in saved.items():
        JManager(str(tmp / layout)).save("ckpt", st, 0, cfg)
        path = str(tmp / f"{layout}.pt")
        out["payloads"][layout] = runpy.run_path(EXPORT)["main"](
            [str(tmp / layout / "ckpt"), path])
        out["paths"][layout] = path
    return cfg, to_port_batch(batch), noise, out


def moments(state):
    """The JAX state's Adam ``(mu, nu, count)``, moments as params trees."""
    adam = state.opt_state.inner_state[1][0]
    mu, nu = adam.mu, adam.nu
    if not isinstance(mu, dict):
        unravel = jax.flatten_util.ravel_pytree(state.params)[1]
        mu, nu = unravel(mu), unravel(nu)
    return (jax.tree_util.tree_map(np.asarray, mu),
            jax.tree_util.tree_map(np.asarray, nu), int(adam.count))


def port_state(cfg):
    return create_train_state(port_cfg(cfg), tdata.SceneGraphVocab.synthetic(),
                              STEPS_PER_EPOCH, device="cpu")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_export_reads_back_bitwise(runs, layout):
    cfg, _, _, run = runs
    st2, path = run["state2"], run["paths"][layout]
    st = port_state(cfg)
    fresh_group = st.optimizer.adam.state_dict()["param_groups"][0]
    epoch, restored_cfg = CheckpointManager(os.path.dirname(path)).restore(
        path, st)
    assert epoch == 1 and restored_cfg == port_cfg(cfg)

    want_sd = state_dict_from_jax(st2.params, st2.batch_stats)
    got_sd = st.model.state_dict()
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k

    mu, nu, count = moments(st2)
    mu_sd, nu_sd = (state_dict_from_jax(t, st2.batch_stats) for t in (mu, nu))
    adam = st.optimizer.adam
    assert count == 2 and st.optimizer.count == 2 and st.step == 2
    assert st.optimizer.notfinite_count == 0
    for n, p in st.model.named_parameters():
        s = adam.state[p]
        assert torch.equal(s["exp_avg"], mu_sd[n]), n
        assert torch.equal(s["exp_avg_sq"], nu_sd[n]), n
        assert s["step"].dtype == torch.float32 and float(s["step"]) == 2.0
    # the group is the port Optimizer's own; the next update's rate is
    # the schedule's at the restored count
    assert adam.state_dict()["param_groups"][0] == fresh_group
    sched = warmup_exponential_schedule(cfg.lr, STEPS_PER_EPOCH,
                                        cfg.warmup_epochs,
                                        cfg.warmup_start_lr, cfg.lr_gamma)
    assert st.optimizer.lr() == sched(2)

    js = st2.aimle_states[MASKED]
    for f in AIMLE_FIELDS:
        assert np.array_equal(getattr(st.aimle_states[MASKED], f).numpy(),
                              np.asarray(getattr(js, f)))
    assert float(js.beta) != AIMLE_BETA           # the steps moved it

    # what the port would write back is what was read
    again = state_payload(st, 0, port_cfg(cfg))
    for i, s in run["payloads"][layout]["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(again["optimizer"]["state"][i][k], v), (i, k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_resumed_step_tracks_the_jax_step(runs, layout, monkeypatch):
    cfg, tb, noise, run = runs
    st = port_state(cfg)
    path = run["paths"][layout]
    CheckpointManager(os.path.dirname(path)).restore(path, st)
    before = {n: p.detach().clone() for n, p in st.model.named_parameters()}
    patch_port_draws(monkeypatch, "aimle", noise)
    st, m = t_train_step(st.model, st.optimizer, st.model.cfg)(st, tb)
    assert st.step == 3 and st.optimizer.count == 3
    np.testing.assert_allclose(float(m["loss_sum"] / m["count"]),
                               run["loss"], rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), run["norm"], rtol=1e-4)
    js = run["state3"].aimle_states[MASKED]
    for f in AIMLE_FIELDS:
        assert abs(float(getattr(st.aimle_states[MASKED], f))
                   - float(getattr(js, f))) <= 1e-6, f

    st2, st3 = run["state2"], run["state3"]
    mu, nu, _ = moments(st3)
    names = [n for n, _ in st.model.named_parameters()]
    adam = st.optimizer.adam
    sd3 = state_dict_from_jax(st3.params, st3.batch_stats)
    sd2 = state_dict_from_jax(st2.params, st2.batch_stats)
    pairs = {
        "exp_avg": ([adam.state[p]["exp_avg"] for p in st.model.parameters()],
                    state_dict_from_jax(mu, st3.batch_stats)),
        "exp_avg_sq": ([adam.state[p]["exp_avg_sq"]
                        for p in st.model.parameters()],
                       state_dict_from_jax(nu, st3.batch_stats)),
        "update": ([p.detach() - before[n]
                    for n, p in st.model.named_parameters()],
                   {n: sd3[n] - sd2[n] for n in names}),
    }
    for what, (got, want) in pairs.items():
        g = torch.cat([t.reshape(-1) for t in got]).double()
        w = torch.cat([want[n].reshape(-1) for n in names]).double()
        cos = float(g @ w / (g.norm() * w.norm()))
        ratio = float(g.norm() / w.norm())
        assert cos > 0.999 and abs(ratio - 1) < 0.01, (what, cos, ratio)


def test_payload_refuses_what_cannot_carry_moments(runs, monkeypatch):
    """``mu`` without ``nu`` is refused; so is a mapping that is not a pure
    re-layout, naming the port parameter whose values it computes (here
    one doubled) or the flax leaf whose elements reach the port other
    than once each (here twice)."""
    cfg, _, _, run = runs
    st2 = run["state2"]
    mu, _, _ = moments(st2)
    with pytest.raises(ValueError, match="in pairs"):
        train_payload_from_jax(st2.params, st2.batch_stats, port_cfg(
            cfg).to_json(), mu=mu)
    names = [n for n, _ in port_state(cfg).model.named_parameters()]
    convert._check_relayout(st2.params, names)     # the real mapping passes
    with pytest.raises(ValueError, match=r"flax parameter .* not a "
                                         r"re-layout"):
        convert._check_relayout(st2.params, names + [names[0]])
    real = convert.state_dict_from_jax

    def doubled(params, stats):
        sd = real(params, stats)
        sd["logit_fc.bias"] = 2.0 * sd["logit_fc.bias"]
        return sd

    monkeypatch.setattr(convert, "state_dict_from_jax", doubled)
    with pytest.raises(ValueError, match="logit_fc.bias: .* not a re-layout"):
        convert._check_relayout(st2.params, names)
