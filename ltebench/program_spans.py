"""The program's own spans (`ltetrigger_tpu_torch.utils.profiling`) in the
traced slice, call by call: what the `program_span` metrics read.

A span is recorded only while a torch.profiler runs, so the spans of the
slice's `channel_scan` calls are the last ones kept; the call id groups
each call's spans with the readback of its output.  Against a program
without the tracer, or a slice with no `channel_scan` span, every reader
returns None.
"""

from __future__ import annotations

WAITS = ("wait.grid", "wait.emit", "wait.capture", "wait.cp")


def calls(rd) -> list | None:
    """The spans of each of the profiled slice's calls (a list a call), or
    None."""
    sl = rd.get("slice")
    if not sl or not sl.get("calls"):
        return None
    from ltetrigger_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    recs = spans()
    ids = sorted({s.call for s in recs if s.name == "channel_scan"})
    ids = ids[-int(sl["calls"]):]
    if not ids:
        return None
    by = {i: [] for i in ids}
    for s in recs:
        if s.call in by:
            by[s.call].append(s)
    return list(by.values())


def per_call(rd, fn) -> float | None:
    """The mean of fn(a call's spans) over the slice's calls; None without
    calls or where fn returns None for one."""
    cs = calls(rd)
    if not cs:
        return None
    vals = [fn(c) for c in cs]
    if any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)


def under(span, ancestor, by_seq: dict) -> bool:
    """Whether `span` lies inside the span `ancestor` (by parent links)."""
    p = span.parent
    while p >= 0:
        if p == ancestor.seq:
            return True
        p = by_seq[p].parent if p in by_seq else -1
    return False
