"""Data-parallel training of the port over ``torch.distributed`` (Gloo on
the CPU): one two-rank job for the module
(``tests/torch_port_ddp_worker.py``, a ``FileStore`` under the module's
temporary directory, a 60 s process-group timeout and a join timeout),
held against one process.

* ``small_cfg`` cut to one encoder layer, one decoder layer and two GAT
  layers (the second masked) with the aimle sampler (beta 5, so its
  gradient and its state update are live) and its dropouts on, trained
  by the ``Trainer``
  for one epoch of two steps a rank: parameters, BatchNorm running
  statistics and the AIMLE state equal one process's two steps on the
  ranks' batches concatenated in rank order, within 1e-5 relative in
  f32 (each leaf's max abs error over its max abs; the ranks' sums are
  taken in another order than one process's); so do the step's metric
  totals.  Both ranks hold the same state, validation reduces the ranks'
  sums, only rank 0 prints and writes the checkpoints.
* ``reduce_dict``, ``all_gather_objects`` and ``SmoothedValue``'s sync
  give the one-process values of the ranks' data.
* One step of the two ranks (a gumbel config, no dropout, the global
  Gumbel draw handed to both packages) against the JAX package's
  ``make_train_step`` on the global batch, with the tolerances of
  ``tests/test_torch_port_train.py``: the loss 1e-4 relative, each
  gradient leaf 2e-3 of its max abs, floored at 1e-4 of the largest.
"""

import dataclasses
import os
import subprocess
import sys
import threading

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
from isubgvqa_tpu.train.schedule import make_optimizer
from isubgvqa_tpu.train.state import TrainState
from isubgvqa_tpu.train.steps import make_train_step
from isubgvqa_tpu_torch import data as tdata
from isubgvqa_tpu_torch.train import create_train_state
from isubgvqa_tpu_torch.train import make_train_step as t_train_step

from test_model import small_cfg
from test_torch_port_model import (jax_weights, one_torch_thread,  # noqa: F401
                                   port_and_jax, port_cfg, shared_gumbel,
                                   to_port_batch)
from test_torch_port_model import quick_xla  # noqa: F401

WORLD = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_port_ddp_worker.py")
JOIN_TIMEOUT = 180
STEPS_PER_EPOCH = 4
REL = 1e-5


def _small(**kw):
    """``small_cfg`` cut to one encoder and one decoder layer and two GAT
    layers, the second masked (as ``test_torch_port_sampler_model.py``)."""
    return small_cfg(encoder_layers=1, decoder_layers=1, mgat_layers=2,
                     mgat_masks=(1.0, 0.15), **kw)


def _trainer_cfg(out):
    """aimle, dropouts on, one bucket, 16 training questions: two steps
    of 4 a rank."""
    return dataclasses.replace(
        port_cfg(_small(sampler_type="aimle")), synthetic=True,
        synthetic_size=16, bucket_node_caps=(), bucket_question_lens=(),
        epochs=1, warmup_epochs=0, lr=1e-3, print_freq=1, meta_dir="",
        output_dir=out)


def _step_inputs():
    """``test_torch_port_train.py``'s batch and draw at the cut config: 4
    questions, no dropout, the gumbel sampler."""
    cfg = _small(dropout=0.0, head_dropout=0.0, mask_dropout=0.0)
    vocab = SceneGraphVocab.synthetic()
    ds = SyntheticGQA(vocab, AnswerMap.synthetic(cfg.num_answers), size=16,
                      seed=0)
    spec = BucketSpec(batch_size=4, max_nodes_per_graph=cfg.max_nodes_per_graph,
                      max_edges_per_graph=cfg.max_edges_per_graph,
                      question_len=cfg.question_len)
    tok = HashWordTokenizer(vocab_size=cfg.text_vocab_size,
                            max_len=cfg.question_len)
    batch, _ = Collator(tok, spec, vocab=vocab).collate(
        [ds[i] for i in range(4)])
    _, sd, params, stats = port_and_jax(cfg, vocab)
    noise = np.random.default_rng(6).gumbel(
        size=(4, cfg.max_nodes_per_graph)).astype(np.float32)
    return cfg, vocab, batch, sd, params, stats, noise


def _jax_step(cfg, vocab, batch, params, stats, noise):
    """One jitted ``make_train_step`` on the global batch: the loss, and
    the gradients from Adam's first moment after one update from zero
    (``mu = (1 - b1) * clip(g)``)."""
    model = build_model(cfg, vocab)
    optimizer = make_optimizer(cfg.lr, STEPS_PER_EPOCH)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       opt_state=optimizer.init(params), batch_stats=stats,
                       aimle_states=None)
    mp = pytest.MonkeyPatch()
    try:
        shared_gumbel(mp, noise)
        state, m = jax.jit(make_train_step(model, optimizer, cfg))(
            state, batch, jax.random.PRNGKey(0))
        loss = float(m["loss_sum"] / m["count"])
        norm = float(m["grad_norm"])
    finally:
        mp.undo()
    n_total = sum(x.size for x in jax.tree_util.tree_leaves(params))
    mu = next(np.asarray(x) for x in jax.tree_util.tree_leaves(
        state.opt_state) if getattr(x, "size", 0) == n_total
        and np.any(np.asarray(x) < 0))
    clip = min(1.0, cfg.grad_clip_norm / norm)
    grads = jax.flatten_util.ravel_pytree(params)[1](mu / (1.0 - 0.9) / clip)
    return loss, grads


def _one_process(ranks, tcfg, n_steps=None):
    """One process's steps (all the ranks took, or ``n_steps``) on the
    ranks' batches concatenated in rank order, from the ranks' initial
    state: the state, each step's metrics and each step's gradients."""
    vocab = tdata.SceneGraphVocab.build(tcfg.meta_dir, seed=tcfg.seed)
    st = create_train_state(tcfg, vocab, STEPS_PER_EPOCH, device="cpu",
                            state_dict=ranks[0]["init"])
    for s in st.aimle_states.values():
        s.beta.fill_(5.0)
    grads = []
    opt_step = st.optimizer.step

    def recorded():
        grads.append({n: p.grad.clone()
                      for n, p in st.model.named_parameters()})
        return opt_step()

    st.optimizer.step = recorded
    step = t_train_step(st.model, st.optimizer, tcfg)
    metrics = []
    for i in range(n_steps or len(ranks[0]["steps"])):
        parts = [r["steps"][i]["batch"] for r in ranks]
        glob = tdata.GraphBatch(**{k: torch.cat([p[k] for p in parts])
                                   for k in parts[0]})
        st, m = step(st, glob)
        metrics.append({k: float(v) for k, v in m.items()})
    return st, metrics, grads


@pytest.fixture(scope="module")
def job(tmp_path_factory, one_torch_thread):  # noqa: F811
    """The two-rank job, the JAX step meanwhile, then the one-process
    reference of the Trainer's two steps."""
    work = str(tmp_path_factory.mktemp("ddp"))
    tcfg = _trainer_cfg(os.path.join(work, "out"))
    with open(os.path.join(work, "trainer.json"), "w") as f:
        f.write(tcfg.to_json())
    cfg, vocab, batch, sd, params, stats, noise = _step_inputs()
    tb = to_port_batch(batch)
    torch.save({"config": port_cfg(cfg).to_json(), "state_dict": sd,
                "batch": vars(tb), "noise": torch.from_numpy(noise),
                "steps_per_epoch": STEPS_PER_EPOCH},
               os.path.join(work, "step.pt"))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    logs = [open(os.path.join(work, f"log{r}.txt"), "w")
            for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, WORKER, work, str(r),
                               str(WORLD)], cwd=ROOT, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    # the JAX step compiles on a thread (XLA lets go of the GIL) while
    # the ranks run and the one-process references follow them
    jax_out = {}

    def jax_thread():
        try:
            jax_out["step"] = _jax_step(cfg, vocab, batch, params, stats,
                                        noise)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            jax_out["error"] = exc

    compile_thread = threading.Thread(target=jax_thread, daemon=True)
    compile_thread.start()
    try:
        for p in procs:
            p.wait(timeout=JOIN_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        with open(os.path.join(work, f"log{r}.txt")) as f:
            assert p.returncode == 0, f"rank {r}:\n{f.read()[-4000:]}"
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(WORLD)]

    one, metrics, grads = _one_process(ranks, tcfg)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        _, _, floor_grads = _one_process(ranks, tcfg, n_steps=1)
    finally:
        torch.set_num_threads(threads)
    compile_thread.join(timeout=JOIN_TIMEOUT)
    if "error" in jax_out:
        raise jax_out["error"]
    jax_loss, jax_grads = jax_out["step"]
    return dict(ranks=ranks, one=one, one_metrics=metrics, one_grads=grads,
                floor_grads=floor_grads, work=work,
                tcfg=tcfg, jax_loss=jax_loss, jax_grads=jax_grads, cfg=cfg,
                step_sd=sd)


def _digest(tensors):
    return {k: float(v.double().sum()) for k, v in tensors.items()}


def _rel(got, want) -> float:
    """The error's L2 norm over the leaf's."""
    want = want.float()
    return (float((got.float() - want).norm())
            / max(float(want.norm()), 1e-30))


def test_two_ranks_equal_one_process_on_the_concatenated_batch(job):
    """The first step's summed gradients; after the two steps the
    parameters, BatchNorm running statistics and AIMLE's state.

    Each gradient leaf is held within 1e-5 relative (L2), or, where one
    process's own gradient moves by more than that when its reductions
    run in another order (4 threads against 1: the leaf's f32 floor,
    about 2e-5 for the GAT biases), within twice that floor.  The running
    statistics and the AIMLE state are held at 1e-5.  A parameter leaf
    is held at 1e-5 relative, or at 1e-3 of its update over the two
    steps: Adam moves an element by ``lr * g / (|g| + eps)``, which turns
    the f32 rounding of a gradient near zero into a large share of that
    element's update (why ``test_torch_port_train.py`` compares Adam's
    moment by cosine).  The one leaf whose whole gradient is rounding
    noise (its floor above 1e-3) is named and left out of that."""
    r0 = job["ranks"][0]
    assert [r["world"] for r in job["ranks"]] == [WORLD, WORLD]
    assert len(r0["steps"]) == 2
    want, floor = job["one_grads"][0], job["floor_grads"][0]
    bad = {k: (e, f) for k, w in want.items()
           if (e := _rel(r0["grads0"][k], w)) > max(
               REL, 2.0 * (f := _rel(floor[k], w)))}
    assert not bad, bad

    # a leaf whose gradient is rounding noise (the bias before GraphNorm,
    # which its mean subtraction cancels) takes a noise-driven update
    noise_only = {k for k, w in want.items() if _rel(floor[k], w) > 1e-3}
    assert noise_only == {
        "scene_graph_encoder.scene_graph_encoding_layer.node_model."
        "node_mlp_2.2.bias"}, noise_only
    one = job["one"].model.state_dict()
    init = r0["init"]
    assert set(r0["final"]) == set(one)
    bad = {}
    for k, w in one.items():
        if k in noise_only:
            continue
        err = float((r0["final"][k].float() - w.float()).norm())
        moved = float((w.float() - init[k].float()).norm())
        if err > max(REL * float(w.float().norm()), 1e-3 * moved):
            bad[k] = (err, moved)
    assert not bad, bad
    buffers = [k for k in one if "running" in k]
    assert len(buffers) == 6
    for k in buffers:
        assert _rel(r0["final"][k], one[k]) <= REL, k
        assert not torch.equal(one[k], init[k]), k
    want = {i: [float(s.beta), float(s.grad_norm), float(s.prev_update)]
            for i, s in job["one"].aimle_states.items()}
    for i, vals in r0["aimle"].items():
        np.testing.assert_allclose(vals, want[i], rtol=REL)
    assert r0["count"] == job["one"].optimizer.count == 2


def test_ranks_hold_the_same_state(job):
    r0, r1 = job["ranks"]
    for key in ("init", "grads0", "final", "step_grads"):
        assert _digest(r0[key]) == r1[key], key
    assert r0["aimle"] == r1["aimle"]
    for s0, s1 in zip(r0["steps"], r1["steps"]):
        assert s0["metrics"] == s1["metrics"]


def test_step_metrics_and_validation_totals(job):
    """The step's metric totals over the global batch, and validation's
    sums reduced over the ranks."""
    for got, want in zip((s["metrics"] for s in job["ranks"][0]["steps"]),
                         job["one_metrics"]):
        assert got["count"] == want["count"] == 8
        for k in ("loss_sum", "correct", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=REL, err_msg=k)
    r0, r1 = job["ranks"]
    total = r0["val_totals"]
    assert total == r1["val_totals"]
    for k in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(
            total[k], r0["val_local"][k] + r1["val_local"][k], rtol=1e-12)
    assert total["count"] == max(job["tcfg"].synthetic_size // 4, 1)
    assert r0["val_local"]["count"] > 0 and r1["val_local"]["count"] > 0


def test_collectives_give_one_process_values(job):
    for r in job["ranks"]:
        assert r["reduce_avg"] == {"a": 1.5, "b": 2.0}
        assert r["reduce_sum"] == {"a": 3.0, "b": 4.0}
        assert r["gathered"] == [{"rank": 0, "ids": [0]},
                                 {"rank": 1, "ids": [1, 1]}]
        assert r["meter"] == (5, 1.0 * 2 + 2.0 * 3)


def test_only_rank_zero_writes_and_prints(job):
    r0, r1 = job["ranks"]
    assert set(r0["written"]) >= {"checkpoint", "checkpoint_lowest_val_loss"}
    assert r1["written"] == [] and r1["printed"] == ""
    assert "Epoch: [0]" in r0["printed"] and "Val epoch [0]" in r0["printed"]
    out = os.path.join(job["work"], "out")
    assert os.path.isfile(os.path.join(out, "checkpoint"))
    saved = torch.load(os.path.join(out, "checkpoint"), weights_only=True)
    for k, v in saved["state_dict"].items():
        assert torch.equal(v, r0["final"][k].float()), k


def test_two_rank_step_matches_jax(job):
    r0 = job["ranks"][0]
    m = r0["step_metrics"]
    np.testing.assert_allclose(m["loss_sum"] / m["count"], job["jax_loss"],
                               rtol=1e-4)
    sd = dict(job["step_sd"])
    sd.update({k: v.float() for k, v in r0["step_grads"].items()})
    got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
           jax.tree_util.tree_flatten_with_path(
               jax_weights(job["cfg"], sd)[0])[0]}
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(job["jax_grads"])[0]}
    assert set(got) == set(want)
    floor = 1e-4 * max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(got[k] - w).max()) / scale
        assert err <= 2e-3, f"{k}: {err:.3g} of scale {scale:.3g}"


def test_init_distributed_refuses_the_cpu_unasked(tmp_path, monkeypatch):
    """Under ``torchrun``'s environment on a machine without CUDA,
    ``init_distributed()`` with no device raises with ``resolve_device``'s
    message instead of joining a Gloo group on the CPU; ``device="cpu"``
    still joins Gloo."""
    from isubgvqa_tpu_torch import parallel

    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    init = f"file://{tmp_path / 'store'}"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.init_distributed(init_method=init)
    assert not parallel.is_initialized()
    try:
        assert parallel.init_distributed("cpu", init_method=init)
        assert torch.distributed.get_backend() == "gloo"
        assert parallel.world_size() == 1 and parallel.is_main_process()
    finally:
        parallel.shutdown()
    assert not parallel.is_initialized()
