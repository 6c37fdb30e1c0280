"""The traced run's slice: `torch.profiler` (CPU and CUDA activity) over a
steady part of the window, read back from its Chrome trace into device
busy time, device operations by name and the longest idle gaps by what the
host was doing.  The benchmark's own spans (`span`) name the host's side.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def span(name: str):
    """A named region of the benchmark's host loop in the trace."""
    with torch.profiler.record_function(name):
        yield


def sync_fn(dev):
    """A function that waits for `dev` (nothing on the CPU)."""
    return (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)


def warm_profiler() -> None:
    """Start and stop the profiler once: its first start sets up CUPTI,
    which takes seconds, and would otherwise fall inside the window."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        torch.zeros(1, device="cuda" if torch.cuda.is_available()
                    else "cpu").add_(1)


class Slice:
    """Profiles from `start_s` into the window for `length_s` seconds.
    The driver calls `step(now)` between calls and `count()` after each
    call, keeps its window open while the slice is (`open_until`), and
    `close()` stops a slice still open at the window's end.  A traced run
    reports no end-to-end metric, so its window may run past `seconds`."""

    def __init__(self, enabled: bool, start_s: float, length_s: float,
                 sync):
        if enabled:
            warm_profiler()
        self.enabled = enabled
        self.start_s, self.length_s = start_s, length_s
        self.sync = sync
        self.prof = None
        self.t0 = self.t1 = None
        self.calls = 0
        self.done = False
        self.result = None

    def open_until(self, elapsed: float, seconds: float) -> bool:
        """True while the window goes on: before `seconds`, or while the
        slice has yet to start or to end."""
        if elapsed < seconds:
            return True
        return self.enabled and not self.done

    def step(self, elapsed: float) -> None:
        """elapsed: seconds since the window opened."""
        if not self.enabled or self.done:
            return
        if self.prof is None and elapsed >= self.start_s:
            self.sync()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.t0 = time.perf_counter()
        elif self.prof is not None and not self.done and \
                time.perf_counter() - self.t0 >= self.length_s:
            self._stop()

    def count(self) -> None:
        if self.prof is not None and not self.done:
            self.calls += 1

    def close(self) -> None:
        """After the window: stop a slice still open, then read the trace
        (which takes seconds, so never inside the window)."""
        if self.prof is not None and not self.done:
            self._stop()
        if self.prof is None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        self.prof = None
        self.result = read(events, self.t1 - self.t0, self.calls)

    def _stop(self) -> None:
        self.sync()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.done = True


def quantiles_ms(name: str, seconds: list) -> dict:
    """The 10th, 50th and 90th percentiles of durations, in ms, by name."""
    if not seconds:
        return {}
    q = np.percentile(np.asarray(seconds) * 1e3, (10, 50, 90))
    return {f"{name}_p{p}_ms": float(v) for p, v in zip((10, 50, 90), q)}


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_at(host: list, t: float) -> str:
    """The benchmark's span and the innermost operator around host time
    t."""
    cover = [h for h in host if h[0] <= t <= h[1]]
    parts = [min(hs, key=lambda h: h[1] - h[0])[2] for hs in (
        [h for h in cover if h[3] == "user_annotation"],
        [h for h in cover if h[3] == "cpu_op"]) if hs]
    return " > ".join(parts) or "host, no operation"


def read(trace: dict, window_s: float, calls: int) -> dict:
    """The slice's numbers from a Chrome trace: busy and window seconds,
    device operations (count; seconds by name), the longest idle gaps, each
    named by the host operation that launched the device operation ending
    it."""
    evs = trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace
    dev, host, launch = [], [], {}
    for e in evs:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e.get("name", "?"), corr))
        elif cat in ("cpu_op", "user_annotation"):
            host.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         e.get("name", "?"), cat))
        elif cat == "cuda_runtime" and corr is not None:
            launch[corr] = float(e["ts"])
    by_name: dict = {}
    for a, b, name, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    merged = _union([(a, b) for a, b, _, _ in dev])
    busy = sum(b - a for a, b in merged) * 1e-6
    starts = sorted((a, corr) for a, _, _, corr in dev)
    gaps = []
    for (a0, b0), (a1, _) in zip(merged, merged[1:]):
        if a1 > b0:
            gaps.append((a1 - b0, b0, a1))
    gaps.sort(reverse=True)
    idle = []
    for length, a, b in gaps[:10]:
        # the host operation that launched the op ending the gap
        i = bisect.bisect_left(starts, (b, -1))
        t = launch.get(starts[i][1]) if i < len(starts) else None
        idle.append([_host_at(host, t if t is not None else 0.5 * (a + b)),
                     length * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(busy_s=busy, window_s=window_s, calls=calls,
                device_ops=len(dev), by_name=by_name,
                top_ops=[[k, v] for k, v in top[:10]], idle_gaps=idle)
