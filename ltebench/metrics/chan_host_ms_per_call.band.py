"""The channelizer on the host, ms a call: the program's span `channelize`
(the upload, the phase tables and the chunk loop's launches) over each call
of the profiled slice (none against a program without the span)."""

from ltebench import program_spans as ps


def _host(call):
    ms = [s.host_ms for s in call if s.name == "channelize"]
    return sum(ms) if ms else None


def read(rd):
    return ps.per_call(rd, _host)
