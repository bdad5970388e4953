"""The frozen arithmetic against the port's, the schedule's shares, and
the reduction of a device timeline."""

import json
import os

import pytest

from benchmark import gqa_gen, yardstick
from benchmark.harness import ROOT, load_cell


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("cell", _cells())
@pytest.mark.parametrize("shape", [(2048, 16, 64, 16), (2048, 128, 384, 32),
                                   (256, 64, 256, 32), (1, 7, 19, 11)])
def test_frozen_padded_count_equals_the_ports(cell, shape):
    from isubgvqa_tpu_torch.ops.flops import forward_flops
    from benchmark.harness import port_config
    c = load_cell(cell)
    cfg = port_config(c.config, c.mix, 0)
    assert yardstick.forward_flops(c.config, *shape) == \
        pytest.approx(forward_flops(cfg, *shape), rel=1e-12)


def test_frozen_peaks_and_families_equal_the_ports():
    from isubgvqa_tpu_torch.ops import flops
    from isubgvqa_tpu_torch.profile_breakdown import KERNEL_FAMILIES
    assert yardstick.PEAK_FLOPS == flops.PEAK_FLOPS
    assert yardstick.PEAK_BYTES == flops.PEAK_BYTES
    assert yardstick.KERNEL_FAMILIES == KERNEL_FAMILIES


def test_frozen_layer_work_equals_the_ports():
    from isubgvqa_tpu_torch.ops import flops
    for n, e in ((300, 900), (4096, 12000)):
        assert yardstick.gat_layer_flops(n, e) == pytest.approx(
            flops.gat_layer_flops(n, e))
        assert yardstick.gat_layer_flops(n, e, fuse_instr=True) == \
            pytest.approx(flops.gat_layer_flops(n, e, fuse_instr=True))
        assert yardstick.metalayer_flops(n, e) == pytest.approx(
            flops.metalayer_flops(n, e))
    for b, l in ((2048, 16), (7, 32)):
        for last in (False, True):
            assert yardstick.encoder_layer_flops(b, l, final_ln=last) == \
                pytest.approx(flops.encoder_layer_flops(b, l, final_ln=last))
            assert yardstick.decoder_layer_flops(b, 4, l, final_ln=last) == \
                pytest.approx(flops.decoder_layer_flops(b, 4, l,
                                                        final_ln=last))


def test_real_sizes_count_less_than_padded():
    c = load_cell(_cells()[0])
    real = yardstick.real_forward_flops(c.config, [(10, 30, 9)] * 8)
    assert real < yardstick.forward_flops(c.config, 8, 16, 64, 16)
    assert real == pytest.approx(8 * yardstick.forward_flops(c.config, 1, 10,
                                                             30, 9))


@pytest.mark.parametrize("mix", ["infer-b2048", "train-b256-k8"])
def test_every_prefix_of_the_schedule_keeps_the_shares(mix):
    with open(os.path.join(ROOT, "benchmark", "traffic", mix + ".json")) as f:
        shares = json.load(f)["shares"]
    w = [round(10 * s) for s in shares]
    total = sum(w)
    sched = gqa_gen.schedule(shares, 3 * total)
    counts = [0] * len(w)
    for t, b in enumerate(sched, 1):
        counts[b] += 1
        for i, wi in enumerate(w):
            assert abs(counts[i] - t * wi / total) < 1.0
    assert sched == gqa_gen.schedule(shares, 3 * total)


def test_idle_share_is_read_from_the_union_of_kernel_intervals():
    us = 1e6
    events = [
        {"ph": "X", "name": "bench::traced_window", "cat": "user_annotation",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "name": "bench::phase::forward", "cat": "user_annotation",
         "ts": 0, "dur": 40, "tid": 1},
        {"ph": "X", "name": "bench::phase::wait", "cat": "user_annotation",
         "ts": 40, "dur": 60, "tid": 1},
        # two overlapping kernels (10-30 and 20-40) and a copy (60-70)
        {"ph": "X", "name": "gemm_gather_kernel", "cat": "kernel", "ts": 10,
         "dur": 20, "args": {"correlation": 1}},
        {"ph": "X", "name": "elementwise", "cat": "kernel", "ts": 20,
         "dur": 20, "args": {"correlation": 2}},
        {"ph": "X", "name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 60,
         "dur": 10, "args": {"correlation": 3}},
        {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime",
         "ts": 5, "dur": 1, "args": {"correlation": 1}, "tid": 1},
    ]
    tr = yardstick.Trace(events, "bench::traced_window")
    assert tr.window_s == pytest.approx(100 / us)
    assert tr.busy_s() == pytest.approx(40 / us)     # 10-40 and 60-70
    fam = tr.families()
    assert fam["gemm_gather"] == pytest.approx(20 / us)
    assert fam[yardstick.OTHER] == pytest.approx(30 / us)
    gaps = tr.idle_gaps("bench::phase::")
    assert gaps[0] == ["wait", pytest.approx(30 / us)]        # 70-100
    assert sorted(g[1] for g in gaps) == pytest.approx(
        sorted([10 / us, 20 / us, 30 / us]))
    assert [g[0] for g in gaps].count("forward") == 1


def test_device_time_is_tied_to_the_range_that_launched_it():
    events = [
        {"ph": "X", "name": "bench::traced_window", "cat": "user_annotation",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "name": "bench::module::gat_seq#7",
         "cat": "user_annotation", "ts": 0, "dur": 10, "tid": 1},
        {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime",
         "ts": 2, "dur": 1, "args": {"correlation": 5}, "tid": 1},
        {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime",
         "ts": 20, "dur": 1, "args": {"correlation": 6}, "tid": 1},
        {"ph": "X", "name": "gat_edge", "cat": "kernel", "ts": 30, "dur": 8,
         "args": {"correlation": 5}},
        {"ph": "X", "name": "other", "cat": "kernel", "ts": 40, "dur": 5,
         "args": {"correlation": 6}},
    ]
    tr = yardstick.Trace(events, "bench::traced_window")
    assert tr.device_by_range("bench::module::") == {
        "gat_seq#7": pytest.approx(8e-6)}


def test_union_and_gaps():
    assert yardstick.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert yardstick.gaps([(1, 2), (1.5, 3)], 0, 4) == [(0, 1), (3, 4)]


def test_a_roofline_reader_divides_the_least_time_by_the_traced_device_time():
    import types
    import numpy as np
    from benchmark.harness import load_module
    events = [
        {"ph": "X", "name": "bench::traced_window", "cat": "user_annotation",
         "ts": 0, "dur": 1000, "tid": 1},
        {"ph": "X", "name": "bench::module::gat_seq#3",
         "cat": "user_annotation", "ts": 0, "dur": 10, "tid": 1},
        {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime",
         "ts": 2, "dur": 1, "args": {"correlation": 5}, "tid": 1},
        {"ph": "X", "name": "gat_edge", "cat": "kernel", "ts": 30,
         "dur": 400, "args": {"correlation": 5}},
    ]
    cell = load_cell(_cells()[0])
    sizes = np.array([[20, 60, 9]] * 4)
    req = types.SimpleNamespace(key=(32, 16), batch=0)
    fx = types.SimpleNamespace(sizes={(32, 16): [sizes]})
    run = types.SimpleNamespace(
        trace=yardstick.Trace(events, "bench::traced_window"), cell=cell,
        driver=types.SimpleNamespace(requests={3: req}, fx=fx))
    got = load_module("metrics", "graph_roofline_pct.infer").read(run)
    fl, nbytes = yardstick.graph_work(cell.config, 4, 80, 240)
    assert got == pytest.approx(
        100 * yardstick.least_seconds(fl, nbytes) / 400e-6)
    assert 0 < got < 100
    run.trace = None
    assert load_module("metrics", "graph_roofline_pct.infer").read(run) is None
