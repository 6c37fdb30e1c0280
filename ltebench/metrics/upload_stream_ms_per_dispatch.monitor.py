"""The upload on the card's stream, ms a dispatch: the time between the
CUDA events the program's span `stream.upload` records at its start and
end (the copy of the new samples and their write into the mirror, with
whatever the stream ran between), over the profiled slice's dispatches
(none on the CPU, or against a program without the span)."""

from ltebench import monitor_trace as mt


def read(rd):
    return mt.per_dispatch(rd, "stream.upload", lambda s: s.device_ms)
