"""The band sweep's traced slice and the channelizer's roofline.

`Slice` is `slices.Slice` that also reads, from the same Chrome trace, the
device time of the operations launched inside each of the program's spans
named in `INSIDE` (a device kernel, copy or set counts where the host call
that launched it lies inside such a user annotation on the same thread).
Against a program without those spans the time is 0.

`channelizer` is the least time any channelizer could take for a call, from
its shapes: the wide (re, im) float32 capture read once and the C lanes of
N // ratio (re, im) float32 samples written once, over the memory rate.
It counts bytes only: an FFT or polyphase channelizer needs fewer
operations than the direct form, so no count of operations bounds them
all.
"""

from __future__ import annotations

import json
import os
import tempfile

from ltebench import roofline, slices

INSIDE = ("channelize",)


def channelizer(n_wide: int, centres: int, ratio: int) -> tuple[float, str]:
    """(seconds, what sets it) for one call's channelizer."""
    return roofline.roofline(0.0, 8.0 * n_wide + 8.0 * centres
                             * (n_wide // ratio))


def device_s_inside(trace, name: str) -> float:
    """Seconds of device time (the union of the intervals) of the kernels,
    copies and sets launched inside user annotations called `name`."""
    evs = trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace
    spans, launch, dev = {}, {}, []
    for e in evs:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat == "user_annotation" and e.get("name") == name:
            spans.setdefault(e.get("tid"), []).append((a, b))
        elif cat in ("cuda_runtime", "cuda_driver") \
                and "correlation" in args:
            launch[args["correlation"]] = (a, e.get("tid"))
        elif cat in slices.DEVICE_CATS and "correlation" in args:
            dev.append((a, b, args["correlation"]))
    inside = []
    for a, b, corr in dev:
        if corr not in launch:
            continue
        t, tid = launch[corr]
        if any(s <= t <= e for s, e in spans.get(tid, ())):
            inside.append((a, b))
    return sum(b - a for a, b in slices._union(inside)) * 1e-6


class Slice(slices.Slice):
    """`slices.Slice` whose result also holds `inside`: {span name: device
    seconds launched inside it}."""

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
        self.result["inside"] = {n: device_s_inside(events, n)
                                 for n in INSIDE}
