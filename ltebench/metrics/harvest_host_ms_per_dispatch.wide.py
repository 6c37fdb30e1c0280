"""The harvest on the host at the band's 170 streams, ms a dispatch: the
program's span `stream.harvest` (a drained dispatch's unpack, the tracking
note and its events applied to the cell stores) over the profiled slice's
dispatches (none against a program without the span)."""

from ltebench import wide_trace as wt


def read(rd):
    return wt.per_dispatch(rd, "stream.harvest", lambda s: s.host_ms)
