"""The port's parity report (``python -m isubgvqa_tpu_torch.parity_report``)
against the JAX package's (``scripts/parity_report.py``) on the same mini
upstream ``.pth`` and the synthetic fixture, on the CPU; and the config
that both derive from an upstream checkpoint's ``args``.

The reports' ``.pth`` holds a seeded port model at ``small_cfg``'s
widths, unmasked (``sampler_type`` None, as ``tests/test_parity_report.py``
builds its checkpoint), under DDP's ``module.`` prefix, with an
``argparse.Namespace`` ``args`` and an ``epoch``.  Unmasked, the answer
accuracy is deterministic on both sides: the two reports must have the
same keys (top level and metrics), the same sample count and an equal
accuracy; their full-graph masks match a recorded all-ones reference
exactly.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import runpy

import numpy as np
import pytest
import torch

from isubgvqa_tpu.convert import convert_reference_checkpoint
from isubgvqa_tpu_torch import cli, parity_report, run_token_coo
from isubgvqa_tpu_torch.config import Config as TConfig
from isubgvqa_tpu_torch.convert import config_from_reference_args
from isubgvqa_tpu_torch.data import build_datasets
from isubgvqa_tpu_torch.models.build import build_model
from isubgvqa_tpu_torch.serve import Predictor

from test_torch_port_model import one_torch_thread  # noqa: F401
from test_torch_port_model import quick_xla  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "parity_report.py")
EXPORT = os.path.join(ROOT, "tools", "export_torch_checkpoint.py")
QLEN, N_CAP, E_CAP, TEXT_VOCAB = 12, 32, 128, 512
SETS = ["--set", "batch_size=4", "--set", "eval_batch_factor=1",
        "--set", f"question_len={QLEN}",
        "--set", f"max_nodes_per_graph={N_CAP}",
        "--set", f"max_edges_per_graph={E_CAP}",
        "--set", f"bucket_node_caps=[{N_CAP}]",
        "--set", f"bucket_question_lens=[{QLEN}]",
        "--set", f"text_vocab_size={TEXT_VOCAB}",
        "--set", 'compute_dtype="float32"']
UNMASKED_ARGS = dict(
    mgat_layers=2, sampler_type=None, sample_k=None, nb_samples=1,
    alpha=1.0, beta=10.0, tau=1.0, use_topk=True, interpretable_mode=False,
    concat_instr=False, use_all_instrs=False, use_global_mask=False,
    text_sampling=False, general_hidden_dim=300,
    mgat_masks=[1.0, 1.0])


def export_tool():
    return runpy.run_path(EXPORT)


def upstream_pth(path, args, lift_dev_answers=False, **cfg_kw):
    """A seeded port model saved as an upstream training checkpoint."""
    cfg = dataclasses.replace(config_from_reference_args(args), meta_dir="",
                              synthetic=True, synthetic_size=32, **cfg_kw)
    data = build_datasets(cfg)
    cfg = dataclasses.replace(cfg, num_answers=len(data.answers))
    model = build_model(cfg, data.vocab, "cpu", seed=0, train=True)
    if lift_dev_answers:
        # random weights answer near-uniformly over 1842 labels: lift the
        # dev questions' answers above the rest and spread the logits, so
        # the argmax among them, and the accuracy, rest on the forward
        labels = [ds.label for ds in data.datasets["dev"]]
        with torch.no_grad():
            model.logit_fc.weight.mul_(20.0)
            model.logit_fc.bias[labels] += 5.0
    torch.save({"model": {f"module.{k}": v.detach()
                          for k, v in model.state_dict().items()},
                "args": args, "epoch": 5}, path)
    return cfg


@pytest.mark.parametrize("case", ("unmasked", "masked_aimle", "variants"))
def test_config_from_reference_args_matches_the_jax_converter(tmp_path,
                                                              case):
    """``config_from_reference_args`` gives the config that
    ``convert_reference_checkpoint`` writes into its meta, field by field
    (``meta_dir`` aside: its default differs by design, ROADMAP Queue 3),
    and ``Predictor.from_checkpoint`` on a ``.pth`` takes it with no
    ``cfg`` (one case: the args carry no text vocabulary, so that
    ``.pth`` has CLIP's 49,408 tokens)."""
    kw = dict(UNMASKED_ARGS)
    if case == "masked_aimle":
        kw.update(sampler_type="aimle", sample_k=2, beta=5.0, tau=0.5,
                  mgat_layers=3, mgat_masks=[1.0, 0.3, 0.15], nb_samples=2)
    elif case == "variants":
        kw.update(sampler_type="simple", sample_k=3, use_topk=0,
                  interpretable_mode=1, text_sampling=True,
                  use_global_mask=True, mgat_masks=[1.0, 1.0, 1.0, 0.15],
                  general_hidden_dim=64)
        del kw["tau"], kw["nb_samples"]        # not every args has all
    args = argparse.Namespace(**kw)
    src = str(tmp_path / "ckpt.pth")
    upstream_pth(src, args, text_vocab_size=TEXT_VOCAB)
    _, jcfg = convert_reference_checkpoint(src, str(tmp_path / "converted"))
    with open(str(tmp_path / "converted") + ".meta.json") as f:
        meta = json.load(f)
    want = TConfig.from_json(json.dumps(meta["config"]))
    got = config_from_reference_args(args)
    assert json.loads(got.to_json()) == {**json.loads(want.to_json()),
                                         "meta_dir": got.meta_dir}
    assert want == TConfig.from_json(jcfg.to_json())
    if case == "unmasked":       # at the args' own (CLIP) text vocabulary
        upstream_pth(src, args)
        pred = Predictor.from_checkpoint(src, device="cpu")
        assert pred.cfg == dataclasses.replace(
            got, num_answers=len(pred.answers))
        torch.save({"model": {}}, str(tmp_path / "bare.pth"))
        with pytest.raises(ValueError, match="without args needs a Config"):
            Predictor.from_checkpoint(str(tmp_path / "bare.pth"),
                                      device="cpu")


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """The port's report and the JAX script's on the same ``.pth``, with
    the JAX run's standard output (its five metric lines)."""
    tmp = tmp_path_factory.mktemp("reports")
    args = argparse.Namespace(**UNMASKED_ARGS)
    src = str(tmp / "ref_ckpt.pth")
    upstream_pth(src, args, lift_dev_answers=True,
                 text_vocab_size=TEXT_VOCAB)
    # the recorded reference: every node of every dev question (unmasked)
    cfg = dataclasses.replace(config_from_reference_args(args), meta_dir="",
                              synthetic=True, synthetic_size=32,
                              max_nodes_per_graph=N_CAP)
    ds = build_datasets(cfg).datasets["dev"]
    masks = tmp / "ref_masks.npz"
    np.savez(masks, **{str(ds[i].question_id): np.ones(
        min(ds[i].graph.num_nodes, N_CAP), np.float32)
        for i in range(len(ds))})
    common = ["--torch_ckpt", src, "--synthetic", "--synthetic_size", "32",
              "--reference_masks", str(masks)] + SETS
    port = parity_report.main(common + [
        "--out", str(tmp / "port"), "--device", "cpu",
        "--work_dir", str(tmp / "pw")])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_report = runpy.run_path(SCRIPT)["main"](
            common + ["--out", str(tmp / "jax"),
                      "--work_dir", str(tmp / "jw")])
    return dict(tmp=tmp, port=port, jax=jax_report, jax_stdout=out.getvalue(),
                n_dev=len(ds), converted=str(tmp / "jw" / "converted"))


def test_port_report_matches_the_jax_report(reports):
    got, want = reports["port"], reports["jax"]
    assert set(got) == set(want)
    assert set(got["metrics"]) == set(want["metrics"])
    assert got["num_samples"] == want["num_samples"] == reports["n_dev"]
    assert got["metrics"]["accuracy"] == want["metrics"]["accuracy"] > 0
    for k in ("sampler_type", "mgat_masks", "split", "synthetic", "notes"):
        assert got[k] == want[k], k
    assert got["metrics"]["mask_iou"] == want["metrics"]["mask_iou"] == 1.0
    assert got["metrics"]["mask_exact"] == 1.0
    with open(str(reports["tmp"] / "port.json")) as f:
        assert set(json.load(f)) == set(got)
    md = open(str(reports["tmp"] / "port.md")).read()
    assert "| accuracy |" in md and "delta" in md


def metric_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith(METRIC_LINES)]


METRIC_LINES = ("Accuracy:", "Accuracy AT:", "Ans. Tok. Coo:",
                "Qst. Tok. Coo:", "Qst. Text Tok. Coo:")


def test_model_only_export_validates_and_explains(reports, capsys):
    """The JAX converter's orbax directory of the same ``.pth`` (params and
    batch statistics only), its meta given the reports' settings, exported
    model-only: the port's ``run_token_coo --ckpt`` prints the JAX run's
    five metric lines, ``--resume -e`` validates it at the JAX run's
    accuracy, and a training ``--resume`` refuses it, naming what is
    missing."""
    converted = reports["converted"]
    cfg = dataclasses.replace(
        config_from_reference_args(argparse.Namespace(**UNMASKED_ARGS)),
        meta_dir="", synthetic=True, synthetic_size=32,
        **parity_report.parse_overrides(SETS[1::2]))
    with open(converted + ".meta.json") as f:
        meta = json.load(f)
    meta["config"] = json.loads(cfg.to_json())
    with open(converted + ".meta.json", "w") as f:
        json.dump(meta, f)
    out = str(reports["tmp"] / "exported")
    payload = export_tool()["main"]([converted, out])
    assert "optimizer" not in payload and payload["epoch"] == 5
    blob = torch.load(out, map_location="cpu", weights_only=True)
    assert set(blob) == {"config", "state_dict", "aimle_states", "epoch"}

    capsys.readouterr()
    run_token_coo.main(["--ckpt", out, "--synthetic", "--device", "cpu"])
    want = metric_lines(reports["jax_stdout"])
    assert len(want) == 5
    assert metric_lines(capsys.readouterr().out) == want

    flags = ["--synthetic", "--synthetic_size", "32", "--device", "cpu",
             "--output_dir", str(reports["tmp"] / "cli"), "--resume", out]
    cli.main(flags + ["-e"])
    val = re.findall(r"^Val epoch \[-1\] dev: Acc@Short (\S+) ",
                     capsys.readouterr().out, re.M)
    assert val == [f"{reports['jax']['metrics']['accuracy'] * 100:4.2f}"]
    with pytest.raises(ValueError, match="optimizer, count, notfinite_count"
                                         ", step"):
        cli.main(flags)


def test_meta_assets_copy_and_validation(tmp_path):
    """``--meta_src`` copies a local directory and validates it, as
    ``tools/fetch_meta_assets.py`` does: warnings for other entry counts,
    errors for a missing file and for answer maps that are no
    bijection."""
    src = tmp_path / "src"
    src.mkdir()
    for name, kind, _ in parity_report.META_ASSETS:
        body = {"txt": "a\nb\n", "json_list": '["x", "y"]',
                "json_dict": '{"x": 0, "y": 1}'}[kind]
        (src / name).write_text(body)
    warnings = parity_report.copy_meta_assets(str(src), str(tmp_path / "d"))
    assert len(warnings) == len(parity_report.META_ASSETS)
    (src / "trainval_label2ans.json").write_text('["y", "x"]')
    with pytest.raises(ValueError, match="bijection"):
        parity_report.copy_meta_assets(str(src), str(tmp_path / "d"))
    os.remove(src / "rel_gqa.txt")
    with pytest.raises(FileNotFoundError):
        parity_report.copy_meta_assets(str(src), str(tmp_path / "d"))
