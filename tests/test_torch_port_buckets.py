"""The port's gumbel training trajectory against the JAX package's across
the four default node buckets (16, 32, 64, 128), in float32 on the CPU.

``small_cfg`` with the gumbel sampler, its dropouts on (0.1 text, 0.2
mask head and classifier), one encoder and one decoder layer and a
128-node cap takes 8 train steps that
cycle through the buckets: two GQA-shaped batches of 4 questions per
bucket (the JAX package's ``iterate_batches_bucketed`` over
``build_bucket_collators``), the first four steps on the first batch of
each bucket, the last four on the second.  Both packages start from the
same weights and get the same batches, the same dropout keep masks and
the same Gumbel noise:

* a keep mask is a function of its shape and of how many masks of that
  shape the step drew before it (``jax.random.bernoulli`` patched on the
  JAX side, ``keep_mask`` on the port's); the two packages draw their
  sites in the same order;
* the Gumbel draw is a function of its size (``jax.random.gumbel`` and
  the port's ``draw_gumbel`` patched).

The JAX step is ``isubgvqa_tpu.train.steps.make_train_step``, one jit
for each bucket (the patched draws are constants of its trace, as in
``test_torch_port_train.py``), with the forward's last-layer node mask
carried out of the step through the BatchNorm collection.

Tolerances, those of ``test_torch_port_train.py:test_three_steps_track_jax``
(f32 on both sides, summation orders differ): each step's loss 1e-4
relative and its grad norm 2e-3 relative, the node mask exactly.  The
BatchNorm running statistics are held at 1e-4 of each leaf's largest
element (the reference test's 1e-4 relative, over the leaf: after
several steps a running mean near zero carries the f32 noise of the
whole leaf's activations, as a gradient leaf does there).  Each parameter
after each step is held at 1e-4 relative plus twice the sum of the
learning rates so far: Adam moves an element by up to ``lr`` a step
whatever its gradient's size, so an element whose gradient is f32
rounding noise may step the other way (why that test holds Adam's
moment by cosine rather than the parameters).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from isubgvqa_tpu.data import (AnswerMap, HashWordTokenizer,
                               SceneGraphVocab, SyntheticGQA)
from isubgvqa_tpu.data.batching import iterate_batches_bucketed
from isubgvqa_tpu.data.build import build_bucket_collators
from isubgvqa_tpu.models.build import build_model
from isubgvqa_tpu.train.schedule import make_optimizer
from isubgvqa_tpu.train.state import TrainState
from isubgvqa_tpu.train.steps import make_train_step
from isubgvqa_tpu_torch import data as tdata
from isubgvqa_tpu_torch.models import isubgvqa as tisubgvqa
from isubgvqa_tpu_torch.models import layers as tlayers
from isubgvqa_tpu_torch.models import masking as tmasking
from isubgvqa_tpu_torch.sampling import gumbel as tgumbel
from isubgvqa_tpu_torch.train import create_train_state
from isubgvqa_tpu_torch.train import make_train_step as t_train_step

from test_model import small_cfg
from test_torch_port_model import (jax_weights, one_torch_thread,  # noqa: F401
                                   port_and_jax, port_cfg, to_port_batch)
from test_torch_port_model import quick_xla  # noqa: F401

CAPS = (16, 32, 64, 128)
STEPS_PER_EPOCH = 4
N_STEPS = 8
NODE_MASK_KEY = "__node_mask__"


class DrawBank:
    """Dropout keep masks and Gumbel draws as functions of their shape
    and of the count of same-shape draws before them in the step."""

    def __init__(self):
        self.seen = {}

    def reset(self):
        self.seen = {}

    def _rng(self, kind, shape):
        shape = tuple(int(s) for s in shape)
        i = self.seen.get((kind, shape), 0)
        self.seen[(kind, shape)] = i + 1
        return np.random.default_rng([len(kind), i, *shape])

    def keep(self, shape, keep_prob) -> np.ndarray:
        return self._rng("keep", shape).random(tuple(shape)) < keep_prob

    def gumbel(self, shape) -> np.ndarray:
        n = int(np.prod(shape))
        return self._rng("gumbel", (n,)).gumbel(size=n).astype(
            np.float32).reshape(tuple(shape))


def _cfg():
    """``small_cfg`` with one encoder and one decoder layer (the text
    side does not change with the node bucket; the four GAT layers and
    their masks stay) and a 128-node cap."""
    return small_cfg(encoder_layers=1, decoder_layers=1,
                     max_nodes_per_graph=128, max_edges_per_graph=384,
                     bucket_node_caps=CAPS, bucket_question_lens=(12,),
                     warmup_epochs=0)


def _batches(cfg, vocab):
    """Two full batches of 4 for each node bucket, in step order."""
    ds = SyntheticGQA(vocab, AnswerMap.synthetic(cfg.num_answers), size=1024,
                      seed=0, shape_mix="gqa")
    tok = HashWordTokenizer(vocab_size=cfg.text_vocab_size,
                            max_len=cfg.question_len)
    colls = build_bucket_collators(cfg, tok, vocab, batch_size=4)
    per_cap = {c: [] for c in CAPS}
    for batch, meta in iterate_batches_bucketed(ds, colls, drop_last=True):
        cap = batch.node_mask.shape[1]
        if meta.num_real == 4 and len(per_cap[cap]) < 2:
            per_cap[cap].append(batch)
    assert all(len(v) == 2 for v in per_cap.values()), \
        {c: len(v) for c, v in per_cap.items()}
    return [per_cap[CAPS[i % 4]][i // 4] for i in range(N_STEPS)]


class _CarryNodeMask:
    """The flax model, its ``apply`` handing the forward's last-layer
    node mask out through the mutated BatchNorm collection."""

    def __init__(self, model):
        self.model = model

    def apply(self, *args, **kw):
        out, mutated = self.model.apply(*args, **kw)
        stats = dict(mutated["batch_stats"])
        stats[NODE_MASK_KEY] = out.node_mask
        return out, {**mutated, "batch_stats": stats}


@pytest.fixture(scope="module")
def run(one_torch_thread):  # noqa: F811
    cfg = _cfg()
    vocab = SceneGraphVocab.synthetic()
    batches = _batches(cfg, vocab)
    _, sd, params, stats = port_and_jax(cfg, vocab)
    bank = DrawBank()

    # ---- the JAX package: one jitted make_train_step for each bucket
    optimizer = make_optimizer(cfg.lr, STEPS_PER_EPOCH, cfg.warmup_epochs)
    step = make_train_step(_CarryNodeMask(build_model(cfg, vocab)),
                           optimizer, cfg)

    def traced(state, batch, rng):
        bank.reset()                       # each trace starts a step
        new, m = step(state, batch, rng)
        bs = dict(new.batch_stats)
        mask = bs.pop(NODE_MASK_KEY)
        return new.replace(batch_stats=bs), m, mask

    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       opt_state=optimizer.init(params), batch_stats=stats,
                       aimle_states=None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli",
                   lambda key, p=0.5, shape=None:
                   jnp.asarray(bank.keep(shape, float(p))))
        mp.setattr(jax.random, "gumbel",
                   lambda key, shape, dtype=jnp.float32:
                   jnp.asarray(bank.gumbel(shape), dtype))
        lowered = [jax.jit(traced).lower(state, b, jax.random.PRNGKey(0))
                   for b in batches[:4]]

    # ---- the port, on the same draws, while the JAX steps compile (XLA
    # lets go of the GIL)
    def port_run():
        """The port's 8 steps on the same draws."""
        tcfg = port_cfg(cfg)
        st = create_train_state(tcfg, tdata.SceneGraphVocab.synthetic(),
                                STEPS_PER_EPOCH, device="cpu", state_dict=sd)
        masks = []
        port_forward = st.model.forward

        def forward(*a, **kw):
            out = port_forward(*a, **kw)
            masks.append(out.node_mask.detach().clone())
            return out

        def keep_mask(shape, rate, generator, device):
            return torch.from_numpy(bank.keep(shape, 1.0 - rate)).float() \
                / (1.0 - rate)

        port_steps, lrs = [], []
        with pytest.MonkeyPatch.context() as mp:
            for mod in (tlayers, tisubgvqa, tmasking):
                mp.setattr(mod, "keep_mask", keep_mask)
            mp.setattr(tgumbel, "draw_gumbel",
                       lambda shape, generator, device:
                       torch.from_numpy(bank.gumbel(shape)))
            mp.setattr(st.model, "forward", forward)
            train_step = t_train_step(st.model, st.optimizer, tcfg)
            for b in batches:
                bank.reset()
                lrs.append(st.optimizer.lr())
                st, m = train_step(st, to_port_batch(b))
                # copies: the converter's arrays may share their memory
                sd_now = {k: v.detach().float().clone()
                          for k, v in st.model.state_dict().items()}
                p_tree, s_tree = jax_weights(tcfg, sd_now)
                port_steps.append(dict(
                    loss=float(m["loss_sum"] / m["count"]),
                    norm=float(m["grad_norm"]), mask=masks[-1].numpy(),
                    params=p_tree, stats=s_tree))
        return port_steps, lrs

    with ThreadPoolExecutor(4) as pool:
        futures = [pool.submit(low.compile) for low in lowered]
        port_steps, lrs = port_run()
        compiled = [f.result() for f in futures]
    jax_steps = []
    for i, b in enumerate(batches):
        state, m, mask = compiled[i % 4](state, b, jax.random.PRNGKey(0))
        jax_steps.append(dict(
            loss=float(m["loss_sum"] / m["count"]),
            norm=float(m["grad_norm"]), mask=np.asarray(mask),
            params=jax.tree_util.tree_map(np.asarray, state.params),
            stats=jax.tree_util.tree_map(np.asarray, state.batch_stats)))
    return dict(jax=jax_steps, port=port_steps, lrs=lrs,
                caps=[b.node_mask.shape[1] for b in batches])


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_steps_cycle_through_the_four_buckets(run):
    assert run["caps"] == list(CAPS) * 2


@pytest.mark.parametrize("i", range(N_STEPS))
def test_step_tracks_jax(run, i):
    j, p = run["jax"][i], run["port"][i]
    np.testing.assert_allclose(p["loss"], j["loss"], rtol=1e-4)
    np.testing.assert_allclose(p["norm"], j["norm"], rtol=2e-3)
    np.testing.assert_array_equal(p["mask"].reshape(j["mask"].shape),
                                  j["mask"])
    assert 0 < float(j["mask"].sum()) < j["mask"].size
    atol = 2.0 * sum(run["lrs"][:i + 1])
    want, got = _flat(j["params"]), _flat(p["params"])
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=atol,
                                   err_msg=k)
    want, got = _flat(j["stats"]), _flat(p["stats"])
    assert set(got) == set(want)
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), (k, err)
