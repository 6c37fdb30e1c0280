"""The upload on the host, ms a dispatch: the program's span
`stream.upload` (each stream's new samples staged in pinned memory, the
copy to the card and the write into the stream mirror enqueued) over the
profiled slice's dispatches (none against a program without the span)."""

from ltebench import monitor_trace as mt


def read(rd):
    return mt.per_dispatch(rd, "stream.upload", lambda s: s.host_ms)
