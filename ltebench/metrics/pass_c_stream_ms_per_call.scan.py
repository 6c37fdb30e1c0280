"""Pass C on the card's stream, ms a call: the time between the CUDA
events the program's span `pass_c` records at its start and end, from pass
C's first operation to its last, idle inside included, over each
`channel_scan` call of the profiled slice (no events, none, on the
CPU)."""

from ltebench import program_spans as ps


def _stream(call):
    ms = [s.device_ms for s in call if s.name == "pass_c"]
    if not ms or None in ms:
        return None
    return sum(ms)


def read(rd):
    return ps.per_call(rd, _stream)
