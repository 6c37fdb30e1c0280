"""The live band monitor's traced slice, dispatch by dispatch, and the
channelizer's roofline there.

`Slice` is `slices.Slice` that also notes the program's counters
(`api.stream_counts`) when the profiler starts and stops, and reads from
the same Chrome trace the device time of the channelizer's own kernel
launched inside the program's span `wide.mix` (`band_trace.
device_s_inside` over the trace's device operations named as the
channelizer's kernels, so that the phase origins' copy and the ramp's
strided copy do not count) and the number of those spans (one a segment).
Against a program without the span or the counter `wide_samples` the time
and the counts are 0.

`channelizer` is the least time for the direct-form channelizer's work of
such segments, the count of `chip_smoke.chan_bound` (the kernel table's
bound): 16 x ratio complex taps an output, 4 FFMA each, at one an
instruction, against each segment's wide pair (the payload and a context
block a side) read once and its lanes written once, over the memory rate.

The span metrics read the slice's dispatches as the monitor cells do
(`monitor_trace.per_dispatch`).
"""

from __future__ import annotations

import collections
import json
import os
import tempfile

from ltebench import band_trace, monitor_trace, roofline, slices

KERNELS = ("chan_decimate_kernel", "chan_mix_kernel")
BLOCK = 9600            # a context block each side of a segment, wide samples
per_dispatch = monitor_trace.per_dispatch


def channelizer(wide_samples: int, segments: int, centres: int,
                ratio: int) -> tuple[float, str]:
    """(seconds, what sets it) for the channelizer of `segments` segments
    whose payloads hold `wide_samples` wide samples in all."""
    n_out = wide_samples // ratio
    return roofline.roofline(
        4.0 * 16 * ratio * centres * n_out,
        8.0 * (wide_samples + 2 * BLOCK * segments) + 8.0 * centres * n_out)


def segments(trace) -> int:
    """The spans `wide.mix` on the host: one a segment channelized."""
    evs = trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace
    return sum(1 for e in evs if e.get("ph") == "X"
               and e.get("cat") == "user_annotation"
               and e.get("name") == "wide.mix")


def channelizer_s(trace) -> float:
    """Seconds of device time of the channelizer's kernels launched inside
    the spans `wide.mix`."""
    evs = trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace
    keep = [e for e in evs if e.get("cat", "") not in slices.DEVICE_CATS
            or any(k in e.get("name", "") for k in KERNELS)]
    return band_trace.device_s_inside(keep, "wide.mix")


class Slice(slices.Slice):
    """`slices.Slice` whose result also holds `chan_s` (the channelizer's
    kernels inside `wide.mix`, seconds), `segments` (the spans `wide.mix`)
    and `wide_samples` (the counter's increase while the profiler ran)."""

    def __init__(self, enabled: bool, start_s: float, length_s: float,
                 sync, counts):
        super().__init__(enabled, start_s, length_s, sync)
        self.counts = counts
        self.counts0 = self.counts1 = None

    def step(self, elapsed: float) -> None:
        started = self.prof is not None
        super().step(elapsed)
        if not started and self.prof is not None:
            self.counts0 = collections.Counter(self.counts)

    def _stop(self) -> None:
        super()._stop()
        self.counts1 = collections.Counter(self.counts)

    def close(self) -> None:
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
        self.result = slices.read(events, self.t1 - self.t0, self.calls)
        self.result["chan_s"] = channelizer_s(events)
        self.result["segments"] = segments(events)
        self.result["wide_samples"] = \
            self.counts1["wide_samples"] - self.counts0["wide_samples"]
