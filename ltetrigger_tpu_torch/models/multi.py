"""MultiTrigger: N independent host-fed streams through ONE device pipeline.

Port of ltetrigger_tpu/models/multi.py.  The reference runs one process per
monitored carrier; one card runs the complete trigger far faster than real
time, so the single-stream `api.Trigger` leaves most of it idle.
MultiTrigger batches N host-fed 1.92 Msps streams as the leading axis of ONE
device-resident stream mirror and ONE dispatch pipeline: every scan is one
`scan_engine` call over [N, ...] (the engine takes leading batch axes, and
pass A is one kernel launch for all N rows).

Design invariant, SHARED CONSUMPTION: all streams advance through the same
grid schedule together; a dispatch covers only steps for which EVERY stream
has uploaded data (depth = min backlog).  One scalar n_valid, one mirror
base, one grid start.  The cost is the obvious one: the group advances at
the pace of its slowest stream.  For the intended shape (N equal-rate
real-time streams) backlogs track each other within a chunk; a stream whose
source DROPPED samples must say so via fill_gap(stream, n) (zeros are
inserted, exactly what an SDR reports on overflow), which also
unblocks the group.

Per-stream semantics are otherwise identical to N separate api.Trigger
instances fed the same chunks: per-stream CellStores, telemetry [N, R],
arrival-anchored tracking_start_time, checkpoint/resume of the full [N]
carry.  The pipeline itself is `api._StreamPipeline`, shared with `api.Trigger`.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np

from ..ltecore.constants import (DEFAULT_PSR_THRESHOLD, DEFAULT_TRACK_AFTER,
                                 DEFAULT_TRACK_EVERY)
from ..ops import cplx
from ..runtime.cellstore import Cell, CellStore
from . import api

# the batched mirror functions are the single-stream ones: they take any
# leading shape, with `scale` and `half_bins` of that shape (and so do
# api._rotate and api._stream_cfo_probe, the per-stream rotation and probe)
_mmirror_advance = api._mirror_advance
_mmirror_rotate = api._mirror_rotate


def _mmirror_advance_i4(dev_r, dev_i, up, scale, shift: int, write_off: int,
                        half_bins, seg_start: int) -> cplx.Pair:
    """`api._mirror_advance` for the i4 transport: ONE uint8 per complex
    sample, half the bytes of i8, unpacked on the device."""
    re, im = api._unpack_i4(up)
    return api._mirror_advance(dev_r, dev_i, re, im, scale, shift, write_off,
                               half_bins, seg_start)


class MultiTrigger(api._StreamPipeline):
    """N concurrent streaming detectors behind one dispatch pipeline.

    process(stream, samples) feeds one stream; events surface as
    (stream, Cell) pairs from process()/flush() and in per-stream
    `stores[stream]`.  Telemetry properties are [N, R] arrays.  Runs on
    `device` ("cuda" by default; raises if CUDA is absent).

    transport: "f32" (bit-exact) | "i16" (default, ~84 dB) | "i8" (~36 dB)
    | "i4" (1 byte/sample, ~14 dB, still ~23 dB above the detection knee).
    """

    TRANSPORTS = ("f32", "i16", "i8", "i4")
    _tag_stream = True

    def __init__(self, n_streams: int,
                 psr_threshold: float = DEFAULT_PSR_THRESHOLD,
                 track_after: int = DEFAULT_TRACK_AFTER,
                 track_every: int = DEFAULT_TRACK_EVERY,
                 cellstores: Optional[Sequence[CellStore]] = None,
                 on_track: Optional[Callable[[int, Cell], None]] = None,
                 on_drop: Optional[Callable[[int, int], None]] = None,
                 pipeline: int = 2, transport: str = "i16",
                 cfo_search_range: int = 0, device="cuda"):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        if cellstores is None:
            cellstores = [CellStore() for _ in range(n_streams)]
        if len(cellstores) != n_streams:
            raise ValueError(f"{len(cellstores)} cellstores for "
                             f"{n_streams} streams")
        super().__init__((int(n_streams),), psr_threshold, track_after,
                         track_every, cellstores, on_track, on_drop,
                         pipeline, transport, cfo_search_range, device)

    @property
    def backlog(self) -> np.ndarray:
        """Per-stream samples fed but not yet scanned (a stream lagging the
        others stalls the group at `min(backlog)`: see fill_gap)."""
        return self._backlog()

    def process(self, stream: int, samples: np.ndarray) \
            -> list[tuple[int, Cell]]:
        """Feed a chunk of complex64 at 1.92 Msps into one stream; returns
        (stream, Cell) publish events that drained during this call (with
        pipeline > 0 an event may surface on a later call; flush() forces
        everything out)."""
        return self._process({stream: samples})

    def process_all(self, chunks: Sequence[np.ndarray]) \
            -> list[tuple[int, Cell]]:
        """Feed one chunk per stream (len(chunks) == n), then pump once."""
        if len(chunks) != self.n:
            raise ValueError(f"{len(chunks)} chunks for {self.n} streams")
        return self._process(dict(enumerate(chunks)))

    def _process(self, chunks: dict) -> list[tuple[int, Cell]]:
        t = time.time()
        for stream, samples in chunks.items():
            self._feed(stream, samples, t)
        published: list[tuple[int, Cell]] = []
        self._maybe_rebase()
        self._pump(published, flush_mode=(self.pipeline == 0))
        return published

    def fill_gap(self, stream: int, n_samples: int) \
            -> list[tuple[int, Cell]]:
        """Declare `n_samples` DROPPED samples on one stream (SDR overflow):
        zeros are inserted so the group is not stalled by the gap.  The
        detector sees silence there: tracking hysteresis rides through
        short gaps, exactly as it would on a real muted antenna."""
        return self.process(stream, np.zeros(n_samples, dtype=np.complex64))

    def save_state(self, path: str) -> None:
        """Checkpoint the [N] carry and every stream's buffered samples,
        after a flush; the keys are the JAX package's."""
        self.flush()
        bufs = {f"buf_{i}": b.to_array() for i, b in enumerate(self._bufs)}
        np.savez(path, n=self.n, base=self._base,
                 psr_threshold=self.psr_threshold, cfo_bins=self._cfo_bins,
                 **bufs, **self._state_arrays())

    def load_state(self, path: str) -> None:
        with np.load(path) as data:
            if int(data["n"]) != self.n:
                raise ValueError(f"checkpoint holds {int(data['n'])} "
                                 f"streams, this MultiTrigger {self.n}")
            self._restore(data, [data[f"buf_{i}"] for i in range(self.n)])
            self._cfo_bins = (np.asarray(data["cfo_bins"]).astype(np.int32)
                              if "cfo_bins" in data
                              else np.zeros(self.n, np.int32))
