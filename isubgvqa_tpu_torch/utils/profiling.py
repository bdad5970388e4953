"""Profiling hooks (the port of ``isubgvqa_tpu/utils/profiling.py``):
a ``torch.profiler`` trace around a region, and per-step wall times with
the device's peak memory.  Both cost nothing when disabled.  Beside
them, :func:`gc_pauses` reports the collector's long pauses, which land
in whichever timed chunk they fall in (``with gc_pauses():
bench.main(["--full"])``)."""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import time
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the region (host ops, and
    the card's kernels where CUDA is available) as a Chrome trace
    ``trace-<pid>-<ns>.json`` under ``log_dir``.  Enabled when a
    directory is given or ``ISUBGVQA_TRACE_DIR`` is set."""
    log_dir = log_dir or os.environ.get("ISUBGVQA_TRACE_DIR")
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class StepProfiler:
    """Per-step wall-clock times, with the peak memory allocated on
    ``device`` when it is a CUDA device."""

    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.device = None if device is None else torch.device(device)
        self.times: list[float] = []
        self._t0 = time.perf_counter()

    def step(self):
        if not self.enabled:
            return
        now = time.perf_counter()
        self.times.append(now - self._t0)
        self._t0 = now

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times[1:] or self.times)
        stats = {}
        if self.device is not None and self.device.type == "cuda":
            stats["peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
        stats.update(mean_s=float(arr.mean()), p50_s=float(np.median(arr)),
                     p95_s=float(np.percentile(arr, 95)))
        return stats


@contextlib.contextmanager
def gc_pauses(min_ms: float = 5.0, file=None) -> Iterator[None]:
    """While open, print each garbage collection that holds the
    interpreter for ``min_ms`` or more as one JSON line
    (``gc_pause_ms``, ``generation``, ``collected``) on ``file``
    (standard error by default)."""
    start = [0.0]

    def note(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
            return
        ms = (time.perf_counter() - start[0]) * 1e3
        if ms >= min_ms:
            print(json.dumps({"gc_pause_ms": ms,
                              "generation": info["generation"],
                              "collected": info["collected"]}),
                  file=file or sys.stderr, flush=True)

    gc.callbacks.append(note)
    try:
        yield
    finally:
        gc.callbacks.remove(note)
