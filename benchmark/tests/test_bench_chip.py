"""On the card, at each cell's own size: the control (the reference in the
program's place at float8) and, for a training cell, half of each batch
left out, on three seeds, each fail the cell's check.

    python -m pytest -m gpu benchmark/tests/test_bench_chip.py -q
"""

import json
import os

import pytest

from benchmark.harness import ROOT, Tracer, load_cell, load_module


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", _cells())
@pytest.mark.parametrize("seed", [7001, 7002, 7003])
def test_the_control_and_the_faults_fail_at_the_cells_own_size(cuda, cell,
                                                               seed):
    import torch
    c = load_cell(cell)
    mod = load_module("drivers", c.mix["kind"])
    driver = mod.Driver(c, seed, torch.device("cuda"), Tracer(False, 0, 0))
    driver.setup()
    driver.window(2.0)
    driver.free()
    lim = c.limits()
    assert all(v <= lim[n] for n, v, _ in driver.check())
    readings = [mod.control(driver)]
    if hasattr(mod, "faults"):
        readings += list(mod.faults(driver).values())
    for got in readings:
        assert any(got[n] > lim[n] for n in lim), got
