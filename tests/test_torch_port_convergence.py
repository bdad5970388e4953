"""The port's convergence tooling on the CPU: ``make_eval_step(...,
return_output=True)`` and ``train_convergence.mask_statistics`` against
the JAX package's (``isubgvqa_tpu.train.steps.make_eval_step`` and
``scripts/train_convergence.py:mask_statistics``, loaded by path), the
``train_convergence`` end to end with a resume, ``nan_localizer``
on a clean and a poisoned checkpoint, and ``merge_trainruns``.

Weights start as a seeded port init and cross to flax through the JAX
package's converter; the gumbel sampler's eval noise is shared (JAX's
``jax.random.gumbel`` and the port's ``draw_gumbel`` patched to return
one numpy draw).  Tolerances: logits within 1e-5 abs (f32 on both
sides), the node mask identical and the pooling gate within 1e-6;
``mask_statistics`` equal field for field.

The convergence runs use a narrow config (one encoder and one decoder layer of
width 64, hidden 32, 32 answers) on 64 training questions at batch 16.
"""

import importlib.util
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isubgvqa_tpu.data.batching import iterate_batches as jiterate
from isubgvqa_tpu.data.build import build_datasets as jbuild_datasets
from isubgvqa_tpu.models.build import build_model as jbuild_model
from isubgvqa_tpu.train.state import TrainState as JTrainState
from isubgvqa_tpu.train.steps import make_eval_step as jmake_eval_step
from isubgvqa_tpu_torch import merge_trainruns, nan_localizer
from isubgvqa_tpu_torch import train_convergence
from isubgvqa_tpu_torch.config import Config
from isubgvqa_tpu_torch.data import (SceneGraphVocab, build_datasets,
                                     iterate_batches)
from isubgvqa_tpu_torch.models.build import build_model as tbuild
from isubgvqa_tpu_torch.sampling import gumbel as tgumbel
from isubgvqa_tpu_torch.train.steps import make_eval_step

from test_model import small_cfg
from test_torch_port_model import one_torch_thread  # noqa: F401
from test_torch_port_model import quick_xla  # noqa: F401
from test_torch_port_model import (jax_weights, port_cfg, set_bn_stats,
                                   shared_gumbel)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGITS_ATOL = 1e-5
GATE_ATOL = 1e-6


def jax_script():
    """``scripts/train_convergence.py`` as a module (it is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_convergence",
        os.path.join(ROOT, "scripts", "train_convergence.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ against JAX

@pytest.fixture(scope="module")
def parity():
    """Both packages' bundles from one narrow config (2 dev batches of 8),
    a seeded port model and its weights as flax trees, one eval noise."""
    jcfg = small_cfg(encoder_layers=1, decoder_layers=1, batch_size=2,
                     synthetic=True, synthetic_size=64, meta_dir="",
                     bucket_node_caps=(32,), bucket_question_lens=(12,))
    tcfg = port_cfg(jcfg)
    jdata = jbuild_datasets(jcfg)
    tdata = build_datasets(tcfg)
    tm = tbuild(tcfg, tdata.vocab, device="cpu", seed=0)
    set_bn_stats(tm)
    sd = {k: v.float() for k, v in tm.state_dict().items()}
    params, stats = jax_weights(jcfg, sd)
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                         opt_state=None, batch_stats=stats,
                         aimle_states=None)
    jmodel = jbuild_model(jcfg, jdata.vocab)
    noise = np.random.default_rng(13).gumbel(
        size=(8, jcfg.max_nodes_per_graph)).astype(np.float32)
    return jcfg, tcfg, jdata, tdata, tm, jmodel, jstate, noise


def share_noise(monkeypatch, noise):
    shared_gumbel(monkeypatch, noise)
    monkeypatch.setattr(tgumbel, "draw_gumbel",
                        lambda shape, generator, device:
                        torch.from_numpy(noise).reshape(shape))


def test_eval_step_return_output_matches_jax(parity, monkeypatch):
    jcfg, tcfg, jdata, tdata, tm, jmodel, jstate, noise = parity
    share_noise(monkeypatch, noise)
    jbatch, _ = next(jiterate(jdata.datasets["dev"], jdata.collators["dev"]))
    tbatch, _ = next(iterate_batches(tdata.datasets["dev"],
                                     tdata.collators["dev"]))
    state = types.SimpleNamespace(aimle_states=None)
    tm_metrics, out_t = make_eval_step(tm, tcfg, return_output=True)(
        state, tbatch, torch.Generator().manual_seed(0))
    assert isinstance(make_eval_step(tm, tcfg)(state, tbatch), dict)
    jm, out_j = jax.jit(jmake_eval_step(jmodel, jcfg, return_output=True))(
        jstate, jbatch, jax.random.PRNGKey(0))
    np.testing.assert_allclose(out_t.logits.numpy(), np.asarray(out_j.logits),
                               rtol=0, atol=LOGITS_ATOL)
    np.testing.assert_array_equal(out_t.node_mask.numpy(),
                                  np.asarray(out_j.node_mask))
    np.testing.assert_allclose(out_t.gate.numpy(), np.asarray(out_j.gate),
                               rtol=0, atol=GATE_ATOL)
    for k in ("correct", "count"):
        assert float(tm_metrics[k]) == float(jm[k])
    np.testing.assert_allclose(float(tm_metrics["loss_sum"]),
                               float(jm["loss_sum"]), rtol=1e-5)


def test_mask_statistics_matches_jax(parity, monkeypatch):
    jcfg, tcfg, jdata, tdata, tm, jmodel, jstate, noise = parity
    share_noise(monkeypatch, noise)
    want = jax_script().mask_statistics(
        types.SimpleNamespace(model=jmodel, state=jstate), jdata, jcfg)
    trainer = types.SimpleNamespace(
        state=types.SimpleNamespace(model=tm, aimle_states=None),
        device=torch.device("cpu"))
    got = train_convergence.mask_statistics(trainer, tdata, tcfg)
    assert got == want
    assert got["n_graphs"] == 16 and got["k"] == 3


# ------------------------------------------------------------ the runs

def tiny_config(path):
    path.write_text(Config(
        encoder_layers=1, decoder_layers=1, text_emb_dim=64, num_heads=4,
        text_vocab_size=512, general_hidden_dim=32, num_answers=32,
        max_edges_per_graph=128, compute_dtype="float32",
        meta_dir="").to_json())
    return str(path)


def run_argv(root, out, *extra):
    return ["--device", "cpu", "--config", str(root / "tiny.json"),
            "--synthetic_size", "64", "--batch-size", "16",
            "--question_len", "12", "--node_cap", "32",
            "--output_root", str(root / "runs"), "--out", str(root / out),
            *extra]


@pytest.fixture(scope="module")
def driven(tmp_path_factory):
    """Two samplers for 2 epochs, then a resume of aimle for a third."""
    root = tmp_path_factory.mktemp("convergence")
    tiny_config(root / "tiny.json")
    first = train_convergence.main(run_argv(
        root, "first.json", "--epochs", "2", "--samplers", "gumbel",
        "aimle"))
    resumed = train_convergence.main(run_argv(
        root, "resumed.json", "--epochs", "3", "--samplers", "aimle",
        "--resume"))
    return root, first, resumed


def assert_schema(got, want, path="record"):
    """``got`` has every key of ``want`` at every level (the epoch rows
    against the first of ``want``'s)."""
    assert isinstance(got, dict), path
    assert set(want) <= set(got), (path, set(want) - set(got))
    for k, v in want.items():
        if isinstance(v, dict) and k != "runs":
            assert_schema(got[k], v, f"{path}.{k}")
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            assert got[k], f"{path}.{k}"
            for row in got[k]:
                assert_schema(row, v[0], f"{path}.{k}[]")


def test_train_convergence_writes_the_trainrun_schema(driven):
    root, first, resumed = driven
    with open(os.path.join(ROOT, "TRAINRUN_r05.json")) as f:
        r05 = json.load(f)
    with open(root / "first.json") as f:
        on_disk = json.load(f)
    assert on_disk == json.loads(json.dumps(first))
    assert_schema(first, r05)
    assert list(first["runs"]) == ["gumbel", "aimle"]
    assert first["device"] == "cpu" and first["backend"] == "cpu"
    task = first["task"]
    assert task["num_answers"] == 1842 and task["meta"].startswith(
        "GQA-like meta_info stand-in")
    assert 0.6 < task["answer_in_question_frac"] < 1.0
    for run in first["runs"].values():
        assert_schema(run, r05["runs"]["simple"])
        assert [r["epoch"] for r in run["epochs"]] == [0, 1]
        assert all(np.isfinite(r["train_loss"]) and r["skipped_steps"] == 0
                   for r in run["epochs"])
        assert run["final_mask_stats"]["n_graphs"] == 16
        assert run["params"] > 0


def test_resume_continues_the_trajectory(driven):
    """The resumed third epoch of aimle (its AIMLE state and the step's
    generator restored) equals the third epoch of three straight."""
    root, first, resumed = driven
    run = resumed["runs"]["aimle"]
    assert [r["epoch"] for r in run["epochs"]] == [2]
    straight = train_convergence.main(run_argv(
        root, "straight.json", "--epochs", "3", "--samplers", "aimle",
        "--output_root", str(root / "straight")))["runs"]["aimle"]
    drop = lambda r: {k: v for k, v in r.items() if k != "epoch_s"}
    assert drop(run["epochs"][0]) == drop(straight["epochs"][2])
    assert run["final_mask_stats"] == straight["final_mask_stats"]


def test_merge_joins_per_sampler_files(driven, tmp_path):
    root, first, resumed = driven
    paths = []
    for s in ("gumbel", "aimle"):
        one = dict(first, runs={s: first["runs"][s]})
        if s == "aimle":           # a per-sampler file without the header
            one = {"runs": one["runs"]}
        paths.append(tmp_path / f"{s}.json")
        paths[-1].write_text(json.dumps(one))
    paths.append(root / "resumed.json")
    merged = merge_trainruns.main(["--out", str(tmp_path / "all.json"),
                                   *map(str, paths)])
    with open(os.path.join(ROOT, "TRAINRUN_r05.json")) as f:
        assert_schema(merged, json.load(f))
    assert list(merged["runs"]) == ["gumbel", "aimle"]
    aimle = merged["runs"]["aimle"]
    assert [r["epoch"] for r in aimle["epochs"]] == [0, 1, 2]
    assert aimle["best_val_acc"] == max(
        first["runs"]["aimle"]["best_val_acc"],
        resumed["runs"]["aimle"]["best_val_acc"])
    assert aimle["final_mask_stats"] == resumed["runs"]["aimle"][
        "final_mask_stats"]
    assert merged["runs"]["gumbel"] == first["runs"]["gumbel"]
    # a run with fewer epochs that does not continue the other is dropped
    again = merge_trainruns.merge([merged, first])
    assert again["runs"]["aimle"] == aimle


# ------------------------------------------------------------ the localizer

def poisoned_copy(root, name, edit):
    src = str(root / "runs" / "aimle" / "checkpoint")
    blob = torch.load(src, map_location="cpu", weights_only=True)
    edit(blob)
    dst = str(root / name)
    torch.save(blob, dst)
    with open(src + ".meta.json") as f, open(dst + ".meta.json", "w") as g:
        g.write(f.read())
    return dst


def test_localizer_finds_no_nonfinite_step_on_a_clean_checkpoint(driven):
    root = driven[0]
    lines = []
    rep = nan_localizer.localize(str(root / "runs" / "aimle" / "checkpoint"),
                                 max_steps=4, device="cpu",
                                 say=lines.append)
    assert lines[-1] == "no nonfinite step found"
    assert not rep["offender"] and len(rep["steps"]) == 4
    assert [g for g, _ in rep["health"]] == [
        "parameters", "buffers", "exp_avg", "exp_avg_sq", "aimle_states"]
    assert all(not bad for _, bad in rep["health"])
    # the replay leaves the state as it found it: the same losses again
    again = nan_localizer.localize(str(root / "runs" / "aimle" / "checkpoint"),
                                   max_steps=4, device="cpu",
                                   say=lambda s: None)
    assert again["steps"] == rep["steps"]


def test_localizer_names_the_poisoned_layer_first(driven):
    name = "gat_seq.convs.3.lin_l.weight"

    def edit(blob):
        blob["state_dict"][name][0, 0] = float("inf")

    lines = []
    rep = nan_localizer.localize(poisoned_copy(driven[0], "poisoned", edit),
                                 max_steps=4, device="cpu", say=lines.append)
    assert rep["health"][0] == ("parameters", [name])
    assert rep["offender"] and len(rep["steps"]) == 1
    assert rep["forward"][0][0] == "gat_seq [fused_gat_layer_train call 3]"
    assert rep["forward"][0][1] > 0
    assert "first nonfinite outputs (module call order):" in lines


def test_localizer_names_the_group_of_a_poisoned_moment(driven):
    ckpt = driven[0] / "runs" / "aimle" / "checkpoint"
    with open(str(ckpt) + ".meta.json") as f:
        cfg = Config.from_json(json.dumps(json.load(f)["config"]))
    first_param = next(tbuild(cfg, SceneGraphVocab.synthetic(),
                              device="cpu").named_parameters())[0]

    def edit(blob):
        blob["optimizer"]["state"][0]["exp_avg_sq"].view(-1)[0] = float("nan")

    lines = []
    rep = nan_localizer.localize(poisoned_copy(driven[0], "moment", edit),
                                 max_steps=1, device="cpu", say=lines.append)
    assert dict(rep["health"])["exp_avg_sq"] == [first_param]
    assert f"exp_avg_sq: NONFINITE in {[first_param]}" in lines
    assert dict(rep["health"])["exp_avg"] == []
    assert lines[-1] == "no nonfinite step found"


def test_bf16_agreement_on_a_checkpoint(driven):
    """On the CPU every path is the plain version: every row agrees and
    the f32 paths are equal; a variant whose parameters differ from the
    checkpoint's is not run."""
    from isubgvqa_tpu_torch import bf16_agreement

    ckpt = str(driven[0] / "runs" / "gumbel" / "checkpoint")
    res = bf16_agreement.agreement(ckpt, "cpu", say=lambda s: None)
    assert res["real"] == 16 and res["batches"] == 1
    assert (res["agree_f32_plain"] == res["plain_bf16_agree_f32_plain"]
            == res["agree_bf16_plain"] == 16)
    assert res["also_bf16_plain"] == res["inside_rounding"] == 0
    assert len(set(res["accuracy"].values())) == 1
    assert res["f32_kernel_max_abs"] == 0.0 and res["node_mask_rows"] == 0
    over = bf16_agreement.main(["--ckpt", ckpt, "--device", "cpu", "--set",
                                "mgat_masks=0.3,1,0.5,0.15"])
    assert over["skipped"].startswith("parameters differ")


def test_bf16_agreement_holds_the_kernels_against_bf16_rounding():
    """A kernel disagreement counts as rounding only by the bf16 plain
    path's own error: a flip on a near tie that bf16 plain flips too is
    shared and inside; a flip of a clear lead, where bf16 plain stays
    within 1e-3 of the reference, is neither, however far the kernel
    moved; a padding row is not counted."""
    from isubgvqa_tpu_torch.bf16_agreement import compare

    ref = torch.tensor([[3.0, 1.0, 0.0], [1.0, 0.99, 0.0],
                        [2.0, 1.0, 0.0], [2.0, 1.0, 0.0]])
    plain16 = ref + torch.tensor([[0.0, 0.0, 0.0], [-0.01, 0.01, 0.0],
                                  [1e-3, 0.0, 0.0], [0.0, 0.0, 0.0]])
    kern16 = ref + torch.tensor([[0.0, 0.0, 0.0], [-0.01, 0.01, 0.0],
                                 [-0.6, 0.6, 0.0], [-2.0, 0.0, 0.0]])
    rows = torch.tensor([True, True, True, False])
    assert compare(ref, plain16, kern16.to(torch.bfloat16), rows) == {
        "real": 3, "agree_f32_plain": 1, "also_bf16_plain": 1,
        "inside_rounding": 1, "plain_bf16_agree_f32_plain": 2,
        "agree_bf16_plain": 2}


def fused_sites():
    from isubgvqa_tpu_torch.models.fused_sites import FUSED_SITES, site_module

    return [(site_module(m), n) for m, names in FUSED_SITES for n in names]


def test_plain_layers_swaps_every_fused_site_and_restores():
    from isubgvqa_tpu_torch import ops
    from isubgvqa_tpu_torch.models.fused_sites import plain_layers

    sites = fused_sites()
    before = [getattr(mod, n) for mod, n in sites]
    with pytest.raises(RuntimeError):
        with plain_layers():
            for mod, n in sites:
                assert getattr(mod, n) is getattr(ops, n + "_plain"), n
            raise RuntimeError
    assert [getattr(mod, n) for mod, n in sites] == before
    with plain_layers(False):
        assert [getattr(mod, n) for mod, n in sites] == before


@pytest.mark.parametrize("plain", [False, True])
def test_cli_plain_layers_trains_on_the_plain_versions(plain, monkeypatch):
    """``cli.main --plain_layers`` runs the whole training and validation
    inside the switch, and without it on the kernels' wrappers."""
    from isubgvqa_tpu_torch import cli, ops

    sites = fused_sites()
    before = [getattr(mod, n) for mod, n in sites]
    seen = []
    monkeypatch.setattr(cli, "_run", lambda cfg, device: seen.append(
        [getattr(mod, n) for mod, n in sites]))
    cli.main(["--device", "cpu", "--synthetic"]
             + (["--plain_layers"] if plain else []))
    want = ([getattr(ops, n + "_plain") for _, n in sites] if plain
            else before)
    assert seen == [want]
    assert [getattr(mod, n) for mod, n in sites] == before


# ------------------------------------------------------------ the meta stand-in

def test_meta_stand_in_reads_like_the_gqa_assets(tmp_path):
    """The stand-in passes the JAX package's asset check at the GQA
    counts, both packages' loaders read the same vocabulary and answer
    map from it, and about 81 % of the synthetic answers are the asked
    object's name (none without meta-info)."""
    import sys

    from isubgvqa_tpu.data.gqa import AnswerMap as JAnswerMap
    from isubgvqa_tpu.data.vocab import SceneGraphVocab as JVocab
    from isubgvqa_tpu_torch.data import AnswerMap, SyntheticGQA
    from isubgvqa_tpu_torch.data.meta_fixture import write_gqa_like_meta

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from fetch_meta_assets import validate

    dst = write_gqa_like_meta(str(tmp_path / "meta"))
    assert validate(dst, strict_counts=True) == []
    vocab, answers = SceneGraphVocab.build(dst), AnswerMap.build(dst)
    assert vocab.itos == JVocab.build(dst).itos
    assert answers.label2ans == JAnswerMap.build(dst).label2ans
    for meta, lo, hi in ((dst, 0.78, 0.84), ("", 0.0, 0.0)):
        v, a = SceneGraphVocab.build(meta), AnswerMap.build(meta)
        ds = SyntheticGQA(v, a, size=2048, seed=3407, shape_mix="gqa")
        named = np.mean([ans in {o["name"] for o in ds.store.scene_graphs[
            img]["objects"].values()} for _, img, _, ans in ds.samples])
        assert lo <= named <= hi, (meta, named)
