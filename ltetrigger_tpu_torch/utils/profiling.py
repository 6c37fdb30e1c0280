"""The port's tracer and per-stage timing — the observability layer the
reference lacks entirely (SURVEY §5: 'Tracing/profiling: none', muted
tag_debug taps and commented printfs).

  * `span(name, device=None)` — a named region of the program.  It is on
    exactly while a torch.profiler records on the calling thread
    (`tracing()`); off, it is one shared no-op context: a flag check, no
    allocation.  On, it opens the profiler's user-annotation region that
    `torch.profiler.record_function(name)` opens, so the region lies on the
    profiler's own timeline, the clock of the device operations launched
    inside it, and it keeps a record in memory: name, parent, call id,
    host start and end (`time.perf_counter_ns`).  Given a CUDA `device`, it
    also records a CUDA event pair on that device's current stream at
    enter and exit (no kernel, copy or set).
    `next_call()` starts a new call id: each streaming dispatch does, so
    the spans until the next call, the readback of the call's output
    included, carry the call's id.  `call()` is a call's scope: it starts
    a new id unless a call is already open on the thread, so that a call
    made inside another (`parallel.sharded.channel_scan` inside
    `apps.wideband_scan.scan_band`) is filed under the outer one's id.
    `spans()` returns the records, `reset()` clears them.
  * `annotate(name)` — decorator: a function as a span.
  * `trace(dir)` — the operator's exporter: torch.profiler with CPU and
    (where there is a card) CUDA activity, written as a Chrome trace into
    `dir` (Perfetto / chrome://tracing), every span in it.
  * `StageTimer` — named wall-clock accumulators for a host loop's stages
    (the streaming classes' prep / scan / drain), queryable like the
    reference's block telemetry probes; each stage is also a span.

The spans the engine opens, and what reads each, are listed in PERF.md
section 3.  Records are kept for the last MAX_SPANS spans and written out
only when asked for.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from typing import Iterator, NamedTuple, Optional

import torch

MAX_SPANS = 1 << 17

tracing = torch.autograd._profiler_enabled
"""True while a torch.profiler records on the calling thread."""

_records: deque = deque(maxlen=MAX_SPANS)
_seq = itertools.count()
_calls = itertools.count(1)
_call = 0
_local = threading.local()


class Span(NamedTuple):
    """One closed span: `parent` is the `seq` of the span that enclosed it
    on the same thread (-1 at the top); `device_ms` the time between its
    CUDA events on the stream (None without a CUDA device)."""
    name: str
    seq: int
    parent: int
    call: int
    start_ns: int
    end_ns: int
    device_ms: Optional[float]

    @property
    def host_ms(self) -> float:
        """The span's time on the host clock, ms."""
        return (self.end_ns - self.start_ns) * 1e-6


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


# the profiler's user-annotation region, entered directly: what
# torch.profiler.record_function enters, without its dispatch through an
# operator, whose own profiling would fall between the two clocks' reads
_region_enter = torch._C._autograd._record_function_with_args_enter
_region_exit = torch._C._autograd._record_function_with_args_exit


class _On:
    __slots__ = ("name", "device", "handle", "rec")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        events = stream = None
        dev = self.device
        if dev is not None and torch.device(dev).type == "cuda":
            stream = torch.cuda.current_stream(dev)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        seq = next(_seq)
        # [name, seq, parent, call, start, end, events, stream]
        self.rec = [self.name, seq, stack[-1] if stack else -1, _call,
                    0, 0, events, stream]
        stack.append(seq)
        _records.append(self.rec)
        # the host clock is read just before the region opens and just
        # before it closes: each read and the profiler's own stand a few
        # microseconds apart, in the same direction
        self.rec[4] = time.perf_counter_ns()
        self.handle = _region_enter(self.name)
        return None

    def __exit__(self, *exc):
        rec = self.rec
        rec[5] = time.perf_counter_ns()
        _region_exit(self.handle)
        if rec[6] is not None:
            rec[6][1].record(rec[7])
        _local.stack.pop()
        return False


def span(name: str, device=None):
    """A named region (see the module docstring): `with span("pass_c",
    device=dev): ...`.  `device`: a torch.device (or its name) whose
    current stream gets a CUDA event pair; None or a CPU device, none."""
    if not tracing():
        return _OFF
    return _On(name, device)


def next_call() -> None:
    """Start a new call id for the spans that follow, on every thread."""
    global _call
    _call = next(_calls)


class _CallScope:
    __slots__ = ()

    def __enter__(self):
        depth = getattr(_local, "calls_open", 0)
        if depth == 0:
            next_call()
        _local.calls_open = depth + 1
        return None

    def __exit__(self, *exc):
        _local.calls_open -= 1
        return False


_CALL = _CallScope()


def call():
    """A call of the program: `with call(): ...` starts a new call id
    unless a call is already open on this thread (then the spans inside
    carry the open call's id).  The id stays after the scope closes, so the
    readback of the call's output carries it too."""
    return _CALL


def spans() -> list[Span]:
    """Every closed span kept, in the order they opened.  Event pairs are
    read after one synchronize of each stream they were recorded on."""
    recs = [r for r in list(_records) if r[5]]
    for stream in {id(r[7]): r[7] for r in recs if r[6]}.values():
        stream.synchronize()
    return [Span(*r[:6], r[6][0].elapsed_time(r[6][1]) if r[6] else None)
            for r in recs]


def reset() -> None:
    """Forget every span kept so far."""
    _records.clear()


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
    """Decorator: mark a function as a named region in traces (a span)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


class StageTimer:
    """Accumulates wall-clock per named stage; thread-unsafe by design (one
    per host thread, like GR's per-block perf counters).  Each stage is
    also a span of its name."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
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
