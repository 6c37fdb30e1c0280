"""Pass C's launch chain on the host, ms a call: the program's span
`pass_c` less the host waits inside it (`wait.*`), over each
`channel_scan` call of the profiled slice."""

from ltebench import program_spans as ps


def _host(call):
    by_seq = {s.seq: s for s in call}
    total = 0.0
    for pc in (s for s in call if s.name == "pass_c"):
        total += pc.host_ms - sum(
            s.host_ms for s in call
            if s.name.startswith("wait.") and ps.under(s, pc, by_seq))
    return total


def read(rd):
    return ps.per_call(rd, _host)
