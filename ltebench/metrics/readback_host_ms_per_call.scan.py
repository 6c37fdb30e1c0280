"""The readback on the host, ms a call: the program's spans
`readback.copy` (the output's copy to the host, after the card has
drained) and `readback.unpack` (its split into fields), over each
`channel_scan` call of the profiled slice."""

from ltebench import program_spans as ps


def read(rd):
    return ps.per_call(rd, lambda call: sum(
        s.host_ms for s in call
        if s.name in ("readback.copy", "readback.unpack")))
