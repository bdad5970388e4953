"""The port's profiling and host-collate tools on the CPU at a small size:
``profile_breakdown`` (the CPU operators' self time over a stream of one
bucket, inference and train step; each prints its table and its shares
add to 100 %), ``profile_components`` (five rows) and
``bench_host_collate`` (the native fill against the Python fill, per
bucket).  On the card ``chip_smoke.py`` phase 18 runs them at full
width."""

import dataclasses
import json
import math

import pytest

from isubgvqa_tpu_torch import (bench, bench_host_collate, profile_breakdown,
                                profile_components)

from test_model import small_cfg
from test_torch_port_model import one_torch_thread, port_cfg  # noqa: F401

BUCKET = (32, 12)


def _cfg():
    return port_cfg(small_cfg(bucket_node_caps=(16, 32), encoder_layers=1,
                              decoder_layers=1))


@pytest.fixture(scope="module")
def setup(one_torch_thread):  # noqa: F811
    return bench.build_bench_setup(_cfg(), num_batches=3, min_timed=2,
                                   device="cpu")


def _check_shares(out):
    shares = [r[2] for r in out["rows"]]
    assert abs(sum(shares) - 100.0) <= 0.1, sum(shares)
    assert all(s >= 0 for s in shares)
    assert out["busy_share"] > 0 and out["busy_us_per_batch"] > 0
    assert out["batches"] == 2


@pytest.mark.parametrize("group", [False, True])
def test_breakdown_of_the_forward(setup, group):
    out = profile_breakdown.run(setup.cfg, BUCKET, iters=2, group=group,
                                setup=setup)
    _check_shares(out)
    names = [r[0] for r in out["rows"]]
    if group:        # CPU operators belong to no kernel family
        assert names == [profile_breakdown.OTHER]
    else:
        assert "aten::mm" in names or "aten::addmm" in names
    table = profile_breakdown.format_table(out, top=3)
    assert "busy share" in table
    assert ("(rest)" in table) == (len(names) > 3)


def test_breakdown_of_the_train_step(setup):
    tsetup = bench.for_sampler(setup, "gumbel", train=True)
    out = profile_breakdown.run(setup.cfg, BUCKET, train=True, iters=2,
                                setup=tsetup)
    _check_shares(out)
    assert tsetup.state.step == 3                 # warm-up and two profiled
    assert any("backward" in r[0] for r in out["rows"])


def test_breakdown_main_prints_its_table(tmp_path, capsys):
    path = tmp_path / "cfg.json"
    path.write_text(_cfg().to_json())
    out = profile_breakdown.main([
        "--device", "cpu", "--config", str(path), "--bucket", "16", "12",
        "--batch-size", "4", "--iters", "1", "--top", "4"])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("CPU operator self time:")
    assert printed[1].split() == ["us/batch", "%", "calls", "op"]
    assert len(printed) == 2 + min(4, len(out["rows"])) + (
        len(out["rows"]) > 4)
    assert out["bucket"] == [16, 12]
    assert out["batch_size"] == 4 and out["batches"] == 1


def test_kernel_families_by_name():
    fam = profile_breakdown.kernel_family
    assert fam("gemm_gather_sm90_kernel<bf16>") == "gemm_gather"
    assert fam("gat_edge_bwd_kernel") == "gat_edge_bwd"
    assert fam("gat_edge_kernel") == "gat_edge"
    assert fam("void at::native::elementwise_kernel") == \
        profile_breakdown.OTHER
    out = profile_breakdown.breakdown(
        {"gat_edge_k": [30.0, 2], "gat_edge_k2": [10.0, 2],
         "gemm_gather_a": [60.0, 4]}, wall_us=200.0, n=2, group=True)
    assert out["rows"] == [("gemm_gather", 30.0, 60.0, 2.0),
                           ("gat_edge", 20.0, 40.0, 2.0)]
    assert out["busy_share"] == 0.5 and out["busy_us_per_batch"] == 50.0


def test_profile_components_five_rows(setup, capsys):
    out = profile_components.run(setup.cfg, BUCKET, iters=2, setup=setup)
    rows = out["rows"]
    assert [r["component"].split(" ")[0] for r in rows] == [
        "question_encoder", "program_decoder", "scene_graph_encoder",
        "MGAT", "global_attention_pooling"]
    assert all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows)
    assert out["timer"] == "host clock" and out["iters"] == 2


def test_bench_host_collate_native_and_python(capsys):
    cfg = dataclasses.replace(_cfg(), bucket_question_lens=(6, 12),
                              meta_dir="")
    out = bench_host_collate.run(batch_size=32, reps=1, cfg=cfg, size=256)
    assert out["batch_size"] == 32 and len(out["buckets"]) >= 2
    for row in out["buckets"].values():
        for fill in ("native", "python"):
            assert row[fill]["samples_per_sec"] > 0
        assert row["speedup"] > 0
    printed = bench_host_collate.main(["--batch-size", "16", "--reps", "1"])
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(printed))
