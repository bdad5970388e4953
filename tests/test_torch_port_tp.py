"""Tensor parallelism of the port over ``torch.distributed`` (Gloo on the
CPU): one job of 4 processes, 2 data ranks x 2 model ranks
(``tests/torch_port_tp_worker.py``, a ``FileStore`` under the module's
temporary directory, a 120 s process-group timeout and a join timeout),
held against the JAX package's tensor-parallel step and against one
process of the port.

``small_cfg`` cut to one encoder layer, one decoder layer and two GAT
layers (the second masked), every dropout at 0, a global batch of 8 (4 a
data rank): the token table ``[512, 64]`` and ``logit_fc``'s weight
``[32, 512]`` are cut over the model group, as the JAX package's
``TP_PARAM_RULES`` cut its ``[512, 64]`` and ``[512, 32]`` tables.

* 3 gumbel steps and 1 aimle step (beta 5, the JAX samplers' MAP solver
  run on the host as in ``test_torch_port_sampler_model.py``) against the
  JAX package's step on ``shard_state`` over ``make_mesh(2, num_model=2)``
  with the per-leaf optimizer and pinned output shardings, with the
  Gumbel draw shared; the bounds of ``tests/test_parallel.py:224-231``:
  the loss 2e-4 relative, the parameters and Adam's moments (the port's
  tables gathered) rtol 2e-3 / atol 2e-5;
* the same steps against one port process on the data ranks' batches
  concatenated, rtol 1e-5 / atol 1e-6 in f32;
* each rank holds half of each table; the two model-region functions'
  backwards (an identity, a sum);
* ``cli.main --model_parallel 2`` trains an epoch: its validation totals
  equal one process's over the same two data shards, only rank 0 prints
  and writes, and its checkpoint, in the one-process format, resumes at
  M = 2 (bitwise), at M = 1 (one more epoch through ``cli.main``) and
  serves in ``Predictor.from_checkpoint``.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isubgvqa_tpu.data import (AnswerMap, BucketSpec, Collator,
                               HashWordTokenizer, SceneGraphVocab,
                               SyntheticGQA)
from isubgvqa_tpu.models.build import build_model
from isubgvqa_tpu.parallel.mesh import make_mesh, shard_batch, shard_state
from isubgvqa_tpu.sampling import aimle as jaimle
from isubgvqa_tpu.train.schedule import make_optimizer
from isubgvqa_tpu.train.state import TrainState
from isubgvqa_tpu.train.steps import make_train_step
from isubgvqa_tpu_torch import cli
from isubgvqa_tpu_torch import data as tdata
from isubgvqa_tpu_torch.config import Config as TConfig
from isubgvqa_tpu_torch.sampling import gumbel as tgumbel
from isubgvqa_tpu_torch.sampling import noise as tnoise
from isubgvqa_tpu_torch.serve import Predictor
from isubgvqa_tpu_torch.train import create_train_state
from isubgvqa_tpu_torch.train import make_train_step as t_train_step
from isubgvqa_tpu_torch.train.loop import Trainer

from test_model import small_cfg
from test_torch_port_model import (jax_weights, one_torch_thread,  # noqa: F401
                                   port_and_jax, port_cfg, shared_gumbel,
                                   to_port_batch)
from test_torch_port_model import quick_xla  # noqa: F401
from test_torch_port_sampler_model import host_solver

WORLD = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_port_tp_worker.py")
JOIN_TIMEOUT = 240
STEPS_PER_EPOCH = 4
AIMLE_BETA = 5.0
N_STEPS = {"gumbel": 3, "aimle": 1}
TABLES = ("text_vocab_embedding.token_embedding.weight", "logit_fc.weight")


def _cfg(sampler):
    return small_cfg(dropout=0.0, head_dropout=0.0, mask_dropout=0.0,
                     encoder_layers=1, decoder_layers=1, mgat_layers=2,
                     mgat_masks=(1.0, 0.15), sampler_type=sampler,
                     text_emb_dim=64, num_heads=4)


def _cli_argv(out):
    """``cli.main``'s flags for a one-epoch run of the cut config (the
    flags' defaults override a ``--config`` base, so each is given)."""
    base = os.path.join(out, "base.json")
    with open(base, "w") as f:
        f.write(TConfig.from_json(_cfg("gumbel").to_json()).to_json())
    return ["--device", "cpu", "--config", base, "--synthetic",
            "--synthetic_size", "16", "--batch-size", "4", "--epochs", "1",
            "--question_len", "12", "--sampler_type", "gumbel",
            "--sample_k", "3", "--general_hidden_dim", "32",
            "--num_answers", "32", "--compute_dtype", "float32",
            "--mgat_layers", "2", "--mgat_masks", "1.0", "0.15",
            "--meta_dir=", "--output_dir", out]


def _inputs():
    """The global batch of 8 and the shared draw, with the weights."""
    cfg = _cfg("gumbel")
    vocab = SceneGraphVocab.synthetic()
    ds = SyntheticGQA(vocab, AnswerMap.synthetic(cfg.num_answers), size=16,
                      seed=0)
    spec = BucketSpec(batch_size=8,
                      max_nodes_per_graph=cfg.max_nodes_per_graph,
                      max_edges_per_graph=cfg.max_edges_per_graph,
                      question_len=cfg.question_len)
    tok = HashWordTokenizer(vocab_size=cfg.text_vocab_size,
                            max_len=cfg.question_len)
    batch, _ = Collator(tok, spec, vocab=vocab).collate(
        [ds[i] for i in range(8)])
    _, sd, params, stats = port_and_jax(cfg, vocab)
    noise = np.random.default_rng(6).gumbel(
        size=(8, cfg.max_nodes_per_graph)).astype(np.float32)
    return vocab, batch, sd, params, stats, noise


def _adam(opt_state):
    """``(mu, nu)`` of the per-leaf optimizer's Adam state."""
    st = next(x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu"))
    return st.mu, st.nu


def _jax_tp_lowered(sampler, vocab, batch, params, stats, noise):
    """The JAX package's step on a 2 x 2 mesh (``shard_state``, the
    per-leaf optimizer, pinned output shardings), lowered under the
    shared draw, with its sharded state and batch."""
    cfg = _cfg(sampler)
    model = build_model(cfg, vocab)
    optimizer = make_optimizer(cfg.lr, STEPS_PER_EPOCH, flat=False)
    states = ({1: jaimle.init_aimle_state(initial_beta=AIMLE_BETA)}
              if sampler == "aimle" else None)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       opt_state=optimizer.init(params), batch_stats=stats,
                       aimle_states=states)
    mesh = make_mesh(2, num_model=2, devices=jax.devices()[:4])
    state = shard_state(state, mesh)
    shardings = jax.tree_util.tree_map(lambda x: x.sharding, state)
    batch = shard_batch(batch, mesh)
    mp = pytest.MonkeyPatch()
    try:
        shared_gumbel(mp, noise)
        mp.setattr(jaimle, "_solve", host_solver)
        step = jax.jit(make_train_step(model, optimizer, cfg),
                       out_shardings=(shardings, None)).lower(
            state, batch, jax.random.PRNGKey(0))
    finally:
        mp.undo()
    return step, state, batch


def _jax_tp_run(sampler, step, state, batch):
    """Each step's loss, then the parameters and Adam's moments."""
    losses = []
    for _ in range(N_STEPS[sampler]):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        losses.append(float(m["loss_sum"] / m["count"]))
    mu, nu = _adam(state.opt_state)
    n_sharded = sum(1 for x in jax.tree_util.tree_leaves(state)
                    if getattr(x, "sharding", None) is not None
                    and x.sharding.spec == jax.sharding.PartitionSpec(
                        "model", None))
    get = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(losses=losses, params=get(state.params), mu=get(mu),
                nu=get(nu), n_sharded=n_sharded)


def _one_process(sampler, blob):
    """One port process's steps on the global batch."""
    cfg = TConfig.from_json(blob["config"])
    st = create_train_state(cfg, tdata.SceneGraphVocab.synthetic(),
                            STEPS_PER_EPOCH, device="cpu",
                            state_dict=blob["state_dict"])
    if st.aimle_states is not None:
        for s in st.aimle_states.values():
            s.beta.fill_(AIMLE_BETA)
    step = t_train_step(st.model, st.optimizer, cfg)
    batch = tdata.GraphBatch(**blob["batch"])
    draw = blob["noise"]
    mp = pytest.MonkeyPatch()
    try:
        for mod in (tgumbel, tnoise):
            mp.setattr(mod, "draw_gumbel",
                       lambda shape, generator, device: draw.reshape(shape))
        metrics = []
        for _ in range(blob["n_steps"]):
            st, m = step(st, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        mp.undo()
    names = {p: n for n, p in st.model.named_parameters()}
    adam = {names[p]: {k: s[k] for k in ("exp_avg", "exp_avg_sq")}
            for p, s in st.optimizer.adam.state.items()}
    return dict(metrics=metrics, state_dict={
        k: v.detach().clone() for k, v in st.model.state_dict().items()},
        adam=adam)


@pytest.fixture(scope="module")
def job(tmp_path_factory, one_torch_thread):  # noqa: F811
    """The 2 x 2 job; the JAX steps are traced and compiled (two at a
    time: XLA lets go of the GIL) meanwhile; then one port process's
    steps."""
    work = str(tmp_path_factory.mktemp("tp"))
    vocab, batch, sd, params, stats, noise = _inputs()
    blobs = {}
    for sampler in N_STEPS:
        blobs[sampler] = {
            "config": port_cfg(_cfg(sampler)).to_json(), "state_dict": sd,
            "batch": vars(to_port_batch(batch)),
            "noise": torch.from_numpy(noise), "n_steps": N_STEPS[sampler],
            "steps_per_epoch": STEPS_PER_EPOCH, "beta": AIMLE_BETA}
        torch.save(blobs[sampler], os.path.join(work, f"{sampler}.pt"))
    out = os.path.join(work, "out")
    os.makedirs(out)
    with open(os.path.join(work, "argv.txt"), "w") as f:
        f.write(" ".join(_cli_argv(out) + ["--model_parallel", "2"]))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    logs = [open(os.path.join(work, f"log{r}.txt"), "w")
            for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, WORKER, work, str(r),
                               str(WORLD)], cwd=ROOT, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    jax_out = {}

    def jax_thread():
        try:
            lowered = {smp: _jax_tp_lowered(smp, vocab, batch, params, stats,
                                            noise) for smp in N_STEPS}
            with ThreadPoolExecutor(len(lowered)) as pool:
                steps = dict(zip(lowered, pool.map(
                    lambda low: low[0].compile(), lowered.values())))
            for smp, (_, state, sharded) in lowered.items():
                jax_out[smp] = _jax_tp_run(smp, steps[smp], state, sharded)
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
    one = {s: _one_process(s, blobs[s]) for s in N_STEPS}
    compile_thread.join(timeout=JOIN_TIMEOUT)
    if "error" in jax_out:
        raise jax_out["error"]
    return dict(ranks=ranks, one=one, jax=jax_out, work=work, out=out,
                sd=sd)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _as_jax(sd, cfg, values=None):
    """Port tensors (the state dict, parameters replaced by ``values``)
    as the flax params tree, flattened."""
    full = {k: v.detach().float().clone() for k, v in sd.items()}
    full.update({k: v.detach().float().clone()
                 for k, v in (values or {}).items()})
    return _flat(jax_weights(cfg, full)[0])


@pytest.mark.parametrize("sampler", list(N_STEPS))
def test_tp_steps_match_jax_tp_step(job, sampler):
    r0, want = job["ranks"][0][sampler], job["jax"][sampler]
    assert want["n_sharded"] >= 6          # the tables and their moments
    got_losses = [m["loss_sum"] / m["count"] for m in r0["metrics"]]
    np.testing.assert_allclose(got_losses, want["losses"], rtol=2e-4)
    cfg = _cfg(sampler)
    sd = r0["state_dict"]
    pairs = [(_as_jax(sd, cfg), _flat(want["params"]))]
    for key, ref in (("exp_avg", want["mu"]), ("exp_avg_sq", want["nu"])):
        pairs.append((_as_jax(sd, cfg, {n: s[key] for n, s in
                                        r0["adam"].items()}), _flat(ref)))
    for got, ref in pairs:
        assert set(got) == set(ref)
        for k, w in ref.items():
            np.testing.assert_allclose(got[k], w, rtol=2e-3, atol=2e-5,
                                       err_msg=k)


@pytest.mark.parametrize("sampler", list(N_STEPS))
def test_tp_steps_equal_one_process(job, sampler):
    r0, one = job["ranks"][0][sampler], job["one"][sampler]
    for got, want in zip(r0["metrics"], one["metrics"]):
        assert got["count"] == want["count"] == 8
        for k in ("loss_sum", "correct", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for k, w in one["state_dict"].items():
        np.testing.assert_allclose(r0["state_dict"][k].numpy(),
                                   w.float().numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert set(r0["adam"]) == set(one["adam"])
    for n, moments in one["adam"].items():
        for k, w in moments.items():
            np.testing.assert_allclose(r0["adam"][n][k].numpy(), w.numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{n} {k}")


def test_each_rank_holds_half_of_each_table(job):
    full = {k: tuple(job["sd"][k].shape) for k in TABLES}
    assert full == {TABLES[0]: (512, 64), TABLES[1]: (32, 512)}
    for r in job["ranks"]:
        assert (r["data_rank"], r["model_rank"]) == divmod(r["rank"], 2)
        for sampler in N_STEPS:
            assert r[sampler]["shapes"] == {TABLES[0]: (256, 64),
                                            TABLES[1]: (32, 256)}
        assert r["resume"]["sharded"] == sorted(TABLES)


def test_model_region_backwards(job):
    """``reduce_from_model_region`` sums forward and passes the gradient
    through (the data axis's ``_AllReduceSum`` would double it);
    ``copy_to_model_region`` passes forward and sums the gradients."""
    for r in job["ranks"]:
        d, m = r["data_rank"], r["model_rank"]
        up = torch.arange(3.0) + 10.0 * m
        y, g = r["reduce"]
        assert torch.equal(y, torch.full((3,), float(4 * d + 3)))
        assert torch.equal(g, up)
        y, g = r["copy"]
        assert torch.equal(y, torch.full((3,), float(r["rank"] + 1)))
        assert torch.equal(g, 2 * torch.arange(3.0) + 10.0)


def test_cli_epoch_prints_writes_and_validates_like_one_process(job):
    """Rank 0 alone prints and writes; the validation totals equal one
    process's over the same two data shards of the checkpointed state."""
    ranks = job["ranks"]
    assert "data parallel: 2 ranks x model parallel: 2, global batch 8" \
        in ranks[0]["printed"]
    assert "Val epoch [0]" in ranks[0]["printed"]
    assert all(r["printed"] == "" for r in ranks[1:])
    totals = ranks[0]["val_totals"]
    assert all(r["val_totals"] == totals for r in ranks)
    ckpt = os.path.join(job["out"], "checkpoint")
    blob = torch.load(ckpt, weights_only=True)
    for k in TABLES:
        assert tuple(blob["state_dict"][k].shape) == tuple(job["sd"][k].shape)
    cfg = TConfig.from_json(blob["config"])
    assert cfg.model_parallel == 2
    one_cfg = dataclasses.replace(cfg, model_parallel=1)
    data = tdata.build_datasets(one_cfg)
    sums = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
    for shard in range(2):
        trainer = Trainer(one_cfg, data, device="cpu", shard_index=shard,
                          num_shards=2)
        trainer.resume(ckpt)
        with contextlib.redirect_stdout(io.StringIO()):
            trainer.validate_epoch(0)
        for k in sums:
            sums[k] += trainer.val_totals[k]
    assert totals["count"] == sums["count"] > 0
    assert totals["correct"] == sums["correct"]
    np.testing.assert_allclose(totals["loss_sum"], sums["loss_sum"],
                               rtol=1e-5)


def test_tp_checkpoint_resumes_at_m2_and_m1_and_serves(job, tmp_path):
    ranks = job["ranks"]
    for r in ranks:
        assert r["resume"]["params"] and r["resume"]["adam"]
        assert r["resume"]["count"] == r["count"] == 2
    ckpt = os.path.join(job["out"], "checkpoint")
    argv = _cli_argv(str(tmp_path)) + ["--resume", ckpt, "--epochs", "2"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        trainer = cli.main(argv)
    assert "=> step 2, optimizer count 2" in printed.getvalue()
    assert "Epoch: [1]" in printed.getvalue()
    assert trainer.cfg.model_parallel == 1
    # the bucketed iterator drops each bucket's tail: 3 or 4 more steps
    assert trainer.state.optimizer.count > 4
    blob = torch.load(ckpt, weights_only=True)
    predictor = Predictor.from_checkpoint(ckpt, device="cpu")
    served = predictor.model.state_dict()
    for k in TABLES:
        assert torch.equal(served[k].float(), blob["state_dict"][k])


def test_cli_refuses_layouts_the_group_cannot_take():
    cfg = dataclasses.replace(TConfig(), model_parallel=2)
    with pytest.raises(ValueError, match="does not divide the 3 rank"):
        cli.check_cli_supported(cfg, world=3)
    with pytest.raises(ValueError, match="has 4 rank"):
        cli.check_cli_supported(dataclasses.replace(cfg, num_data_shards=4),
                                world=4)
    cli.check_cli_supported(dataclasses.replace(cfg, num_data_shards=2),
                            world=4)
