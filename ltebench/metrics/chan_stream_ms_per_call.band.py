"""The channelizer on the card's stream, ms a call: the time between the
CUDA events the program's span `channelize` records at its start and end
(the upload, the phase tables and the chunk loop, idle inside included),
over each call of the profiled slice (none on the CPU, or against a
program without the span)."""

from ltebench import program_spans as ps


def _stream(call):
    ms = [s.device_ms for s in call if s.name == "channelize"]
    if not ms or None in ms:
        return None
    return sum(ms)


def read(rd):
    return ps.per_call(rd, _stream)
