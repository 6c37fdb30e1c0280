"""Tracing and per-stage timing — the observability layer the reference
lacks entirely (SURVEY §5: 'Tracing/profiling: none', muted tag_debug taps
and commented printfs).

Two tools:
  * `trace(dir)` — context manager around torch.profiler: CPU and (where
    there is a card) CUDA activity, written as a Chrome trace into `dir`
    (viewable in Perfetto / chrome://tracing); `annotate(name)` marks a
    function as a named region in it;
  * `StageTimer` — lightweight named wall-clock accumulators for the host
    loop's stages (gather/step/drain), queryable like the reference's
    block telemetry probes.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace into `log_dir` (one Chrome-trace JSON
    file per capture)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Decorator: mark a function as a named region in traces."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


class StageTimer:
    """Accumulates wall-clock per named stage; thread-unsafe by design (one
    per host thread, like GR's per-block perf counters)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
