"""The wide row's upload on the host, ms a dispatch: the program's span
`wide.upload` (the wide row quantised into pinned memory, its copy to the
card and its dequantisation enqueued) over the profiled slice's dispatches
(none against a program without the span)."""

from ltebench import wide_trace as wt


def read(rd):
    return wt.per_dispatch(rd, "wide.upload", lambda s: s.host_ms)
