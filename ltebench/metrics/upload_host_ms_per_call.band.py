"""The capture's upload on the host, ms a call: the program's span
`channelize.upload` (the split of the complex64 capture into float32 parts
and their copy from pageable host memory to the card) over each call of the
profiled slice (none against a program without the span)."""

from ltebench import program_spans as ps


def _host(call):
    ms = [s.host_ms for s in call if s.name == "channelize.upload"]
    return sum(ms) if ms else None


def read(rd):
    return ps.per_call(rd, _host)
