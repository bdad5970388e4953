"""Settings of the benchmark's own tests (``python -m pytest benchmark/tests``):
the ``gpu`` marker, and a tiny cell added to a copy of the benchmark as
data files only."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the chip runs these")


TINY = {"general_hidden_dim": 32, "text_emb_dim": 64, "encoder_layers": 1,
        "decoder_layers": 1, "num_answers": 32, "text_vocab_size": 512,
        "compute_dtype": "float32"}


def add_tiny_cell(tmp, kind: str, sampler: str = "gumbel",
                  like: str = None) -> str:
    """A copy of the benchmark under ``tmp`` with one more cell,
    ``tiny-<kind>``, made of data files only: a narrow configuration, a
    small mix of ``kind`` and the limits of the real cell ``like``.
    Returns the copy's root."""
    root = str(tmp)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    real = next(w for w in bench["workloads"]
                if json.load(open(os.path.join(
                    ROOT, "benchmark", "traffic",
                    w["traffic"] + ".json")))["kind"] == kind)
    like = like or real["name"]
    conf_file = next(c["file"] for c in bench["configs"]
                     if c["name"] == real["config"])
    with open(os.path.join(ROOT, conf_file)) as f:
        conf = json.load(f)
    conf.update(TINY, sampler_type=sampler)
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           real["traffic"] + ".json")) as f:
        mix = json.load(f)
    mix.update(batch_size=4, questions_per_bucket=12,
               batches_per_bucket=3 if kind == "infer" else 6)
    if kind == "train":
        mix["group"] = 2
    name = f"tiny-{kind}"
    b = os.path.join(root, "benchmark")
    json.dump(conf, open(os.path.join(b, "configs", "tiny.json"), "w"))
    json.dump(mix, open(os.path.join(b, "traffic", f"{name}.json"), "w"))
    shutil.copy(os.path.join(b, "limits", like + ".json"),
                os.path.join(b, "limits", name + ".json"))
    bench["configs"].append({"name": "tiny", "source": "https://arxiv.org/abs/2403.17647",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": ["general_hidden_dim"], "why": "a test's"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if real["name"] in m.get("workloads", ()):
            m["workloads"].append(name)
    bench["workloads"].append({"name": name, "config": "tiny",
                               "traffic": name, "chips": 1,
                               "why": "a cell added as data files only"})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return root
