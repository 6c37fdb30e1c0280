"""The engine's host waits for the card, ms a call: the program's spans
`wait.grid`, `wait.emit`, `wait.capture` and `wait.cp` (each exactly a
blocking read that `trigger.host_syncs` counts) summed over each
`channel_scan` call of the profiled slice."""

from ltebench import program_spans as ps


def read(rd):
    return ps.per_call(rd, lambda call: sum(
        s.host_ms for s in call if s.name in ps.WAITS))
