"""The wide front end's mixing on the card's stream, ms a dispatch: the
time between the CUDA events the program's span `wide.mix` records at its
start and end (the phase origins' copy and the channelizer's kernel, with
whatever the stream ran between), over the profiled slice's dispatches
(none on the CPU, or against a program without the span)."""

from ltebench import wide_trace as wt


def read(rd):
    return wt.per_dispatch(rd, "wide.mix", lambda s: s.device_ms)
