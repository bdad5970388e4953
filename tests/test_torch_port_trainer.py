"""The port's Trainer, checkpoints and CLI on the CPU.

Against the JAX package: the meters' printed lines, ``accuracy_topk``,
``config_from_args(...).scaled()`` over several argument lists, the
``group_multistep`` item sequence over one bucketed stream, and the
names the three-checkpoint policy writes over 60 scripted epochs (the
JAX side's ``save`` is patched to record them; no JAX file changes).

The port's own properties, at a narrow config (one encoder and one
decoder layer of width 64, hidden 32, three GAT layers; the aimle
sampler, so the AIMLE state is checkpointed): ``cli.main`` trains two
epochs and prints the JAX package's lines; a checkpoint restores the
weights, Adam's moments, the count, the step and the AIMLE state,
opens with ``weights_only=True`` and loads into ``Predictor``; one
epoch, a resume and one more epoch end on parameters bitwise equal to
two epochs straight; ``-e`` restores the model only; the
``run_token_coo`` entry prints the five metric lines; the CLI refuses
what the port does not run yet.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from isubgvqa_tpu import cli as jcli
from isubgvqa_tpu.config import Config as JConfig
from isubgvqa_tpu.data.batching import group_multistep as jgroup
from isubgvqa_tpu.data.batching import iterate_batches_bucketed as jbucketed
from isubgvqa_tpu.data.build import build_datasets as jbuild_datasets
from isubgvqa_tpu.train import checkpoint as jcheckpoint
from isubgvqa_tpu.train import metrics as jmetrics
from isubgvqa_tpu_torch import cli, run_token_coo
from isubgvqa_tpu_torch.config import Config
from isubgvqa_tpu_torch.data import build_datasets, group_multistep
from isubgvqa_tpu_torch.data import iterate_batches_bucketed
from isubgvqa_tpu_torch.serve import Predictor
from isubgvqa_tpu_torch.train import checkpoint, metrics
from isubgvqa_tpu_torch.train.schedule import Optimizer
from isubgvqa_tpu_torch.train.state import TrainState, create_train_state

from test_model import small_cfg
from test_torch_port_data import _assert_same_batch
from test_torch_port_model import one_torch_thread  # noqa: F401

# ------------------------------------------------------------ text, config

METERS = [("Time", ":4.2f", [0.123, 4.5]), ("Loss", ":.2e", [7.52, 7.49]),
          ("Acc@Short-MGat", ":4.2f", [0.0, 25.0]), ("GradNorm", ":f", [1.5])]


@pytest.mark.parametrize("num_batches,estimate,batch",
                         [(8, False, 0), (8, True, 7), (123, True, 45)])
def test_meter_and_progress_lines_match_jax(capsys, num_batches, estimate,
                                            batch):
    lines = []
    for mod in (jmetrics, metrics):
        meters = []
        for name, fmt, vals in METERS:
            m = mod.AverageMeter(name, fmt)
            for i, v in enumerate(vals):
                m.update(v, i + 1)
            meters.append(m)
        mod.ProgressMeter(num_batches, meters, prefix="Epoch: [3]",
                          estimate=estimate).display(batch)
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1]
    assert lines[1].startswith("Epoch: [3][")


def test_accuracy_topk_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 10))
    labels = rng.integers(0, 10, 16)
    mask = (rng.random(16) > 0.3).astype(np.float32)
    for kw in ({}, {"sample_mask": mask}):
        assert (metrics.accuracy_topk(logits, labels, (1, 3), **kw)
                == jmetrics.accuracy_topk(logits, labels, (1, 3), **kw))


ARGVS = {
    "defaults": [],
    "resume": ["--resume", "ckpt", "-e", "--batch-size", "64",
               "--scale_factor", "2", "--meta_dir", "m"],
    "masks": ["--mgat_masks", "1", "1", "1", "0.3", "--sampler_type",
              "aimle", "--sample_k", "5", "--use_topk", "0",
              "--concat_instr", "1"],
    "scale": ["--scale_factor", "4", "--lr", "1e-4", "--start-epoch", "3",
              "--epochs", "9", "-p", "7"],
    "ignored": ["--lr_drop", "10", "--momentum", "0.5", "--wd", "0.1",
                "--num_workers", "2", "--work_dir", "x", "--distributed",
                "--launcher", "pytorch", "--gpus", "2", "--gpu-ids", "0",
                "1", "--evaluate_sets", "a", "--use_mgat", "1",
                "--bi_qa", "--embed_cat", "1"],
    "data": ["--synthetic", "--synthetic_shape_mix", "gqa",
             "--compute_dtype", "float32", "--multistep", "3",
             "--num_data_shards", "2", "--question_len", "16"],
    "config_file": ["--config", "{json}", "--epochs", "7"],
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_config_from_args_scaled_matches_jax(name, tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(dataclasses.replace(
        Config(), encoder_layers=2, text_emb_dim=64, seed=11).to_json())
    argv = [a.replace("{json}", str(path)) for a in ARGVS[name]]

    def parse(mod):
        parser = argparse.ArgumentParser(parents=[mod.get_argparser()])
        return mod.config_from_args(parser.parse_args(argv)).scaled()

    got = dataclasses.asdict(parse(cli))
    want = dataclasses.asdict(parse(jcli))
    if "--meta_dir" not in argv:      # the one default that differs
        got.pop("meta_dir"), want.pop("meta_dir")
    assert got == want


def _tiny_bundles(size=48):
    jcfg = small_cfg(synthetic=True, synthetic_size=size, meta_dir="")
    tcfg = Config.from_json(jcfg.to_json())
    return jcfg, tcfg, jbuild_datasets(jcfg), build_datasets(tcfg)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_group_multistep_matches_jax(k):
    jcfg, tcfg, jd, td = _tiny_bundles()
    assert len(td.bucket_collators["train"]) > 1

    def stream(fn, d):
        return fn(d.datasets["train"], d.bucket_collators["train"],
                  shuffle=True, seed=5, drop_last=True)

    jitems = list(jgroup(stream(jbucketed, jd), k))
    titems = list(group_multistep(stream(iterate_batches_bucketed, td), k))
    assert [t for t, _, _ in titems] == [t for t, _, _ in jitems]
    if k > 1:
        assert {"multi", "single"} <= {t for t, _, _ in titems}
    for (jt, jb, jm), (tt, tb, tm) in zip(jitems, titems, strict=True):
        if tt == "single":
            assert jm.question_ids == tm.question_ids
            _assert_same_batch(jb, tb)
            continue
        assert isinstance(tb, list) and len(tb) == len(tm) == k
        assert [m.question_ids for m in jm] == [m.question_ids for m in tm]
        for i, b in enumerate(tb):
            _assert_same_batch(
                jax.tree_util.tree_map(lambda a: np.asarray(a)[i], jb), b)


# ------------------------------------------------------------ checkpoints

def test_save_policy_names_match_jax(tmp_path, monkeypatch):
    """60 epochs of scripted validation results (new lows and highs, ties,
    and a zero accuracy) through both policies."""
    rng = np.random.default_rng(3)
    losses = 5.0 - 0.05 * np.arange(60) + rng.normal(0, 0.2, 60)
    losses[7] = losses[6]                                 # a tie
    accs = np.maximum(rng.normal(10.0, 8.0, 60), 0.0)
    accs[:4] = 0.0

    jnames, tnames = [], []
    jm = jcheckpoint.CheckpointManager(str(tmp_path / "jax"))
    monkeypatch.setattr(jm, "save", lambda name, state, epoch, cfg,
                        _host_state=None: jnames.append((epoch, name)))
    tm = checkpoint.CheckpointManager(str(tmp_path / "port"))
    save = tm.save
    monkeypatch.setattr(tm, "save", lambda name, *a, **kw: (
        tnames.append((a[1], name)), save(name, *a, **kw)))
    model = torch.nn.Linear(3, 2)
    state = TrainState(step=0, model=model, optimizer=Optimizer(
        model.parameters(), lambda step: 1e-3))
    jcfg, tcfg = JConfig(), Config()
    jbest = tbest = (float("inf"), 0.0)
    for epoch in range(60):
        jbest = jm.save_policy({}, epoch, jcfg, losses[epoch], accs[epoch],
                               *jbest)
        tbest = tm.save_policy(state, epoch, tcfg, losses[epoch],
                               accs[epoch], *tbest)
        assert tbest == jbest
    assert tnames == jnames
    assert ("checkpoint0049" in {n for _, n in tnames}
            and len({n for _, n in tnames}) == 4)
    on_disk = sorted(os.listdir(tmp_path / "port"))
    assert on_disk == sorted([n for n in {n for _, n in tnames}]
                             + [n + ".meta.json" for n in
                                {n for _, n in tnames}])
    with open(tmp_path / "port" / "checkpoint0049.meta.json") as f:
        meta = json.load(f)
    assert meta["epoch"] == 49
    assert (JConfig.from_json(json.dumps(meta["config"]))
            == JConfig.from_json(tcfg.to_json()))


# ------------------------------------------------------------ the CLI

def tiny_argv(cfg_path, out, *extra):
    """A narrow aimle config: the flags the CLI has, and a JSON base for
    the fields it has none for (argparse's defaults override the base,
    as in the JAX package)."""
    return ["--config", str(cfg_path), "--device", "cpu", "--synthetic",
            "--synthetic_size", "16", "--batch-size", "4", "--num_answers",
            "32", "--question_len", "12", "--general_hidden_dim", "32",
            "--mgat_layers", "3", "--mgat_masks", "1", "1", "0.15",
            "--compute_dtype", "float32", "--sampler_type", "aimle",
            "--sample_k", "3", "--meta_dir", "", "-p", "1", "--output_dir",
            str(out), *extra]


def run_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trainer = cli.main(argv)
    return trainer, buf.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs through ``cli.main``."""
    root = tmp_path_factory.mktemp("cli")
    cfg_path = root / "tiny.json"
    cfg_path.write_text(Config(
        encoder_layers=1, decoder_layers=1, text_emb_dim=64, num_heads=4,
        text_vocab_size=512, max_nodes_per_graph=32,
        max_edges_per_graph=128).to_json())
    out = root / "straight"
    trainer, text = run_cli(tiny_argv(cfg_path, out, "--epochs", "2"))
    return dict(root=root, cfg_path=cfg_path, out=out, trainer=trainer,
                text=text)


def test_cli_trains_and_prints_the_jax_lines(trained):
    text, out = trained["text"], trained["out"]
    assert re.search(r"^Epoch: \[0\]\[0/~4\]\tTime \d+\.\d\d \(\d+\.\d\d\)"
                     r"\tData \d+\.\d\d \(\d+\.\d\d\)\tLoss \d\.\d\de[+-]\d\d "
                     r"\(\d\.\d\de[+-]\d\d\)\tGradNorm \d+\.\d\d \(\d+\.\d\d\)"
                     r"\tAcc@Short-MGat \d+\.\d\d \(\d+\.\d\d\)$", text, re.M)
    for epoch in (0, 1):
        assert re.search(rf"^Val epoch \[{epoch}\] dev: Acc@Short \d+\.\d\d "
                         rf"Loss \d\.\d\de[+-]\d\d$", text, re.M)
    assert "Top validation accuracy so far was " in text
    names = set(os.listdir(out))
    assert {"checkpoint", "checkpoint.meta.json",
            "checkpoint_lowest_val_loss",
            "checkpoint_lowest_val_loss.meta.json"} <= names
    top = float(re.findall(r"so far was (\S+)", text)[-1])
    assert ("checkpoint_top_res" in names) == (top > 0)
    st = trained["trainer"].state
    assert st.step == st.optimizer.count > 0
    assert all(np.isfinite(float(p.detach().abs().max()))
               for p in st.model.parameters())


@pytest.mark.parametrize("model_only", [False, True])
def test_checkpoint_round_trip(trained, model_only):
    src = trained["trainer"]
    path = os.path.join(trained["out"], "checkpoint")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    assert {"config", "state_dict", "optimizer", "count", "notfinite_count",
            "step", "aimle_states", "epoch"} <= set(blob)
    fresh = create_train_state(src.cfg, src.data.vocab, 4, device="cpu")
    start, cfg = checkpoint.CheckpointManager(trained["out"]).restore(
        "checkpoint", fresh, model_only=model_only)
    assert start == 2 and cfg == dataclasses.replace(src.cfg,
                                                     start_epoch=0)
    want = src.state.model.state_dict()
    got = fresh.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert src.state.aimle_states and fresh.aimle_states
    for i, st in src.state.aimle_states.items():
        for f in checkpoint.AIMLE_FIELDS:
            assert torch.equal(getattr(fresh.aimle_states[i], f),
                               getattr(st, f))
    if model_only:
        assert fresh.step == fresh.optimizer.count == 0
        assert not fresh.optimizer.adam.state
        return
    assert fresh.step == src.state.step
    assert fresh.optimizer.count == src.state.optimizer.count
    for p, q in zip(src.state.optimizer.params, fresh.optimizer.params):
        a, b = (src.state.optimizer.adam.state[p],
                fresh.optimizer.adam.state[q])
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a[key], b[key])


def test_trainer_checkpoint_loads_into_predictor(trained):
    src = trained["trainer"]
    pred = Predictor.from_checkpoint(
        os.path.join(trained["out"], "checkpoint"), device="cpu")
    want = src.state.model.state_dict()
    assert all(torch.equal(v, want[k])
               for k, v in pred.model.state_dict().items())
    ds = src.data.datasets["dev"]
    sample = ds[0]
    got = pred.predict([sample.question], [ds.store.scene_graphs[sample.image_id]])
    assert got[0].answer in pred.answers.label2ans


def test_resume_is_bitwise_exact(trained):
    """One epoch, then a resume from its checkpoint for the second: the
    parameters, BatchNorm buffers, Adam's moments, the count and the AIMLE
    state equal those of two epochs straight, bit for bit."""
    out = trained["root"] / "resumed"
    cfg_path = trained["cfg_path"]
    run_cli(tiny_argv(cfg_path, out, "--epochs", "1"))
    resumed, text = run_cli(tiny_argv(cfg_path, out, "--epochs", "2",
                                      "--resume", "checkpoint"))
    assert "Epoch: [0]" not in text and "Epoch: [1][0/" in text
    assert re.search(r"^=> step 3, optimizer count 3, learning rate ", text,
                     re.M)
    a, b = trained["trainer"].state, resumed.state
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert (a.step, a.optimizer.count) == (b.step, b.optimizer.count)
    for p, q in zip(a.optimizer.params, b.optimizer.params):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.adam.state[p][key],
                               b.optimizer.adam.state[q][key])
    for i, st in a.aimle_states.items():
        for f in checkpoint.AIMLE_FIELDS:
            assert torch.equal(getattr(st, f), getattr(b.aimle_states[i], f))


def test_cli_evaluate_restores_the_model_only(trained):
    trainer, text = run_cli(tiny_argv(
        trained["cfg_path"], trained["out"], "-e", "--resume",
        "checkpoint_lowest_val_loss"))
    assert re.search(r"^Val epoch \[-1\] dev: Acc@Short \d+\.\d\d Loss ",
                     text, re.M)
    assert "Epoch: [" not in text
    assert trainer.state.optimizer.count == 0 and trainer.state.step == 0


def test_cli_multistep_runs_every_batch(trained):
    """``--multistep 2`` groups same-shape batches and runs their steps
    one after another: the epoch trains on every batch once."""
    trainer, text = run_cli(tiny_argv(
        trained["cfg_path"], trained["root"] / "multi", "--epochs", "1",
        "--multistep", "2"))
    assert trainer.state.step == 3
    assert re.search(r"^Epoch: \[0\]\[3/~4\]", text, re.M)


def test_run_token_coo_entry_prints_the_five_lines(trained, capsys):
    res = run_token_coo.main([
        "--ckpt", os.path.join(trained["out"], "checkpoint_lowest_val_loss"),
        "--device", "cpu", "--max_batches", "1"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out[-5:]] == [
        "Accuracy", "Accuracy AT", "Ans. Tok. Coo", "Qst. Tok. Coo",
        "Qst. Text Tok. Coo"]
    assert 0 < res.num_samples <= 4


@pytest.mark.parametrize("flags,item", [
    (["--model_parallel", "2"], "item 13"),
    (["--num_data_shards", "2"], "item 13"),
    (["--text_sampling"], "item 15"),
    (["--use_all_instrs"], "item 15"),
    (["--concat_instr", "1"], "item 15"),
    (["--use_global_mask"], "item 15"),
    (["--interpretable_mode", "1"], "item 15"),
    (["--node_classification"], "item 15"),
    (["--use_topk", "0"], "item 15"),
])
def test_cli_refuses_what_the_port_does_not_run(tmp_path, flags, item):
    """More than one process (item 13) raises; the config variants
    (item 15) are ported and pass the CLI's check."""
    argv = ["--device", "cpu", "--output_dir", str(tmp_path), *flags]
    if item == "item 13":
        with pytest.raises(NotImplementedError, match=item):
            cli.main(argv)
        return
    cfg = cli.config_from_args(cli.get_argparser().parse_args(argv))
    assert cfg != cli.config_from_args(cli.get_argparser().parse_args(
        argv[:4]))
    cli.check_cli_supported(cfg)
