"""The monitor cells' traced slice, dispatch by dispatch: what their
`program_span` metrics read.

Every streaming dispatch of the program starts a new call id
(`profiling.next_call`) and opens one `prep` stage, inside which
`stream.upload` opens; `stream.harvest` opens wherever a drained dispatch
is applied.  A dispatch of the slice is a call id with a `prep` span that
lies inside the slice (the driver adds the slice's bounds, `t0_ns` and
`t1_ns` on `time.perf_counter_ns`'s clock, to its result).  Against a
program without these spans, or a run without a slice, every reader
returns None.
"""

from __future__ import annotations


def slice_spans(rd) -> list | None:
    """The program's spans that lie inside the profiled slice, or None."""
    sl = rd.get("slice")
    if not sl or "t0_ns" not in sl:
        return None
    from ltetrigger_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    return [s for s in spans()
            if sl["t0_ns"] <= s.start_ns and s.end_ns <= sl["t1_ns"]]


def per_dispatch(rd, name: str, value) -> float | None:
    """The sum of value(span) over the slice's spans called `name`, over
    the slice's dispatches; None without such spans or dispatches, or where
    value returns None for one."""
    recs = slice_spans(rd)
    if not recs:
        return None
    dispatches = {s.call for s in recs if s.name == "prep"}
    vals = [value(s) for s in recs if s.name == name]
    if not dispatches or not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(dispatches)
