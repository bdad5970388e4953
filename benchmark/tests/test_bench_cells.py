"""A cell added as data files only is found and run; the no-JAX guard;
and the checks' faults, each of which has to turn ``correct`` false.

The cells run here on the CPU at a narrow width (the port's plain
layers), with the harness's look for a chip skipped."""

import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import forbidden_modules, run_cell
from benchmark.tests.conftest import ROOT, add_tiny_cell


def _run(root, kind, seed=987654321012):
    return run_cell(f"tiny-{kind}", seed, 1.0, False, time.perf_counter(),
                    require_cuda=False, root=root, device="cpu")


@pytest.mark.parametrize("kind,sampler", [("infer", "gumbel"),
                                          ("train", "gumbel"),
                                          ("train", "simple")])
def test_a_cell_of_data_files_only_is_found_and_run(tmp_path, kind, sampler):
    root = add_tiny_cell(tmp_path, kind, sampler)
    out = _run(root, kind)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    e2e = "infer_qps" if kind == "infer" else "train_qps"
    assert out["metrics"][e2e]["value"] > 0


def test_the_same_seed_gives_the_same_inputs(tmp_path):
    from benchmark.fixture import Fixture
    from benchmark.harness import load_cell
    root = add_tiny_cell(tmp_path, "infer")
    cell = load_cell("tiny-infer", root)
    a, b = (Fixture(cell, 2 ** 31 + 5, 4, 3, 12) for _ in range(2))
    for k in a.keys:
        assert a.pools[k].questions == b.pools[k].questions
        assert all((x == y).all() for x, y in zip(a.comps[k], b.comps[k]))
    c = Fixture(cell, 2 ** 31 + 6, 4, 3, 12)
    assert any(a.pools[k].questions != c.pools[k].questions for k in a.keys)


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("isubgvqa_tpu_torch", "isubgvqa_tpu_torch.ops",
                 "jaxtyping", "flaxish"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = forbidden_modules()
    assert not any(m.startswith(("isubgvqa_tpu_torch", "jaxtyping",
                                 "flaxish")) for m in found)
    for name in ("jax", "jax.numpy", "isubgvqa_tpu", "isubgvqa_tpu.ops",
                 "flax", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert {"jax", "jax.numpy", "isubgvqa_tpu", "isubgvqa_tpu.ops", "flax",
            "jaxlib"} <= set(forbidden_modules())


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    root = add_tiny_cell(tmp_path, "infer")
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from benchmark.harness import run_cell, forbidden_modules\n"
        "out = run_cell('tiny-infer', 1, 0.5, False, time.perf_counter(),\n"
        "               require_cuda=False, root=%r, device='cpu')\n"
        "print(forbidden_modules())\n" % (ROOT, root))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_the_card_prints_no_result():
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "infer-gumbel-b2048-gqamix", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_an_altered_answer_fails_the_check(tmp_path, monkeypatch):
    from isubgvqa_tpu_torch.models import isubgvqa
    orig = isubgvqa.ISubGVQA.forward

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw)
        if not self.training:
            best = out.logits[0].argmax()
            out.logits[0, best] = out.logits[0].min() - 1.0
        return out

    root = add_tiny_cell(tmp_path, "infer")
    monkeypatch.setattr(isubgvqa.ISubGVQA, "forward", altered)
    out = _run(root, "infer")
    assert not out["correct"]
    c = out["checks"]["answer_gap"]
    assert c["value"] > c["limit"]


def test_a_step_that_leaves_the_state_unchanged_fails_the_check(
        tmp_path, monkeypatch):
    from isubgvqa_tpu_torch.train import schedule
    orig = schedule.Optimizer.step

    def unchanged(self):
        saved = [p.detach().clone() for p in self.params]
        norm = orig(self)
        with torch.no_grad():
            for p, s in zip(self.params, saved):
                p.copy_(s)
        return norm

    root = add_tiny_cell(tmp_path, "train")
    monkeypatch.setattr(schedule.Optimizer, "step", unchanged)
    out = _run(root, "train")
    assert not out["correct"]
    c = out["checks"]["change_gap"]
    assert c["value"] > c["limit"]


def test_half_the_batch_left_out_fails_the_check(tmp_path, monkeypatch):
    from isubgvqa_tpu_torch.train import steps
    orig = steps.cross_entropy_loss

    def half(logits, labels, sample_mask, count=None):
        keep = sample_mask.clone()
        keep[keep.shape[0] // 2:] = 0
        return orig(logits, labels, keep, count)

    root = add_tiny_cell(tmp_path, "train")
    monkeypatch.setattr(steps, "cross_entropy_loss", half)
    out = _run(root, "train")
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_an_altered_answer_in_a_later_step_of_a_group_fails_the_check(
        tmp_path, monkeypatch):
    from isubgvqa_tpu_torch.models import isubgvqa
    orig = isubgvqa.ISubGVQA.forward
    calls = []

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw)
        if self.training:
            calls.append(1)
            if len(calls) % 2 == 0:
                best = out.logits[0].argmax()
                out.logits[0, best] = out.logits[0].min().detach() - 1.0
        return out

    root = add_tiny_cell(tmp_path, "train")
    monkeypatch.setattr(isubgvqa.ISubGVQA, "forward", altered)
    out = _run(root, "train")
    assert not out["correct"]
    c = out["checks"]["logit_gap_steps"]
    assert c["value"] > c["limit"]
