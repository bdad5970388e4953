"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs its driver, reads its metrics and prints the result line.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<mix>.json``); the mix's ``kind`` names the driver
(``drivers/<kind>.py``) that sets the program up, drives it for the
window and checks its outputs against the plain reference; each
per-layer metric is read by ``metrics/<metric>.py``.  Adding a cell is
adding such files and entries.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "isubgvqa_tpu")
PHASE = "bench::phase::"
MODULE = "bench::module::"
WINDOW = "bench::traced_window"
clock = time.perf_counter


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str = ROOT

    def limits(self) -> dict:
        """The cell's limits on the numbers its check compares."""
        return load_json(os.path.join(self.root, "benchmark", "limits",
                                      self.name + ".json"))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    bench_dir = os.path.join(root, "benchmark")

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name, w["config"], w["traffic"], w["chips"],
                load_json(os.path.join(root, conf["file"])),
                load_json(os.path.join(bench_dir, "traffic",
                                       w["traffic"] + ".json")),
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)], root)


def load_module(kind: str, name: str, root: str = ROOT):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(root, "benchmark", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


_T_PHASE = [None]


def setup_phase(name: str) -> None:
    """Print on standard error how long the set-up's last phase took."""
    now = clock()
    if _T_PHASE[0] is not None:
        print(f"setup: {name} {now - _T_PHASE[0]:.3f} s", file=sys.stderr)
    _T_PHASE[0] = now


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


class Tracer:
    """Phase and module ranges for the profiler, and the traced
    sub-window.  Off (``trace`` false) every range is a null context."""

    def __init__(self, trace: bool, start_s: float, length_s: float):
        self.on = trace
        self.start_s, self.length_s = start_s, length_s
        self.prof = None
        self.window = None
        self.done = False
        self.tag = ""

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so that its first
        start's cost stays out of the window."""
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def phase(self, name: str):
        if not self.on or self.prof is None:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(PHASE + name)

    def tick(self, elapsed: float) -> None:
        """Called by the driver between requests: opens the sub-window at
        ``start_s`` into the window and closes it ``length_s`` later."""
        if not self.on or self.done:
            return
        if self.prof is None and elapsed >= self.start_s:
            import torch
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.window = torch.profiler.record_function(WINDOW)
            self.window.__enter__()
            self.t_open = elapsed
        elif self.prof is not None and elapsed >= self.t_open + self.length_s:
            self.close()

    def close(self) -> None:
        if self.prof is None or self.done:
            return
        import torch
        self.window.__exit__(None, None, None)
        torch.cuda.synchronize()
        self.prof.stop()
        self.done = True

    def hook_modules(self, model, names: List[str]) -> list:
        """Ranges named ``bench::module::<name>#<tag>`` around the forward
        of each named submodule of ``model`` (traced runs only)."""
        if not self.on:
            return []
        import torch
        handles = []
        for name in names:
            mod = getattr(model, name)

            def pre(m, args, name=name):
                if self.prof is not None and not self.done:
                    rf = torch.profiler.record_function(
                        f"{MODULE}{name}#{self.tag}")
                    rf.__enter__()
                    m._bench_range = rf

            def post(m, args, out):
                rf = getattr(m, "_bench_range", None)
                if rf is not None:
                    rf.__exit__(None, None, None)
                    m._bench_range = None

            handles.append(mod.register_forward_pre_hook(pre))
            handles.append(mod.register_forward_hook(post))
        return handles

    def export(self):
        """The sub-window's trace as a :class:`~.yardstick.Trace` (the
        file is removed once read), or None."""
        if self.prof is None:
            return None
        from .yardstick import Trace
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return Trace.load(path, WINDOW)
        finally:
            os.remove(path)


@dataclasses.dataclass
class Run:
    """What the driver hands the metric readers."""

    cell: Cell
    trace: Optional[object]          # yardstick.Trace of the sub-window
    counters: Dict[str, float]
    window_s: float
    driver: object


def port_config(config: dict, mix: dict, seed: int):
    """The program's ``Config`` of a cell's configuration and mix."""
    import dataclasses as dc
    from isubgvqa_tpu_torch.config import Config
    fields = {f.name for f in dc.fields(Config)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in config.items() if k in fields}
    kw["batch_size"] = mix["batch_size"]
    kw["seed"] = seed % (2 ** 31)
    kw["synthetic"] = True
    kw["meta_dir"] = ""
    if "group" in mix:
        kw["multistep"] = mix["group"]
    return Config(**kw)


def device_info(chips: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_process: float, require_cuda: bool = True,
             root: str = ROOT, device: Optional[str] = None) -> dict:
    """One run of cell ``name``; returns the result object (with its
    ``checks``).  ``require_cuda`` false (the CPU tests) runs the program
    on ``device``."""
    import torch
    cell = load_cell(name, root)
    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        raise SystemExit(f"{name} needs {cell.chips} CUDA device(s); "
                         f"{torch.cuda.device_count()} available")
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        torch.cuda.init()
    print(f"setup: process start to CUDA {clock() - t_process:.3f} s",
          file=sys.stderr)
    setup_phase("start")
    driver_mod = load_module("drivers", cell.mix["kind"], root)
    tracer = Tracer(trace and dev.type == "cuda",
                    start_s=max(seconds / 2 - min(3.0, seconds / 4), 0.0),
                    length_s=min(3.0, seconds / 2))
    driver = driver_mod.Driver(cell, seed, dev, tracer)
    driver.setup()
    tracer.warm()
    setup_phase("profiler")
    gc.collect()
    gc.freeze()
    setup_s = clock() - t_process
    counters = driver.window(seconds)
    tracer.close()
    tr = tracer.export() if trace else None
    peak = device_info(cell.chips) if dev.type == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    run = Run(cell, tr, counters, counters["window_s"], driver)
    driver.free()
    checks = driver.check()
    correct = all(v <= lim for _, v, lim in checks)
    metrics = {}
    rates = driver.end_to_end(counters)
    print("window: " + ", ".join(f"{k}={v!r}" for k, v in rates.items())
          + f", seconds={counters['window_s']!r}, setup_s={setup_s!r}",
          file=sys.stderr)
    if trace:
        for m in cell.per_layer:
            value = load_module("metrics", m["name"], root).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        if tr is not None:
            peak["busy_s"] = tr.busy_s()
            peak["window_s"] = tr.window_s
    else:
        e2e = dict(rates, setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
    out = {"correct": bool(correct),
           "attempted": int(counters["attempted"]),
           "failed": int(counters["failed"]),
           "metrics": metrics, "device": peak}
    if tr is not None:
        fam = sorted(tr.families().items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k, v] for k, v in fam],
                            "idle_gaps": tr.idle_gaps(PHASE)}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out
