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

With `mesh=` (parallel/mesh.py: one process per device) the [N] stream axis
is sharded over the `ch` axis.  EVERY RANK constructs the trigger with the
global `n_streams` and is fed the same global chunks; it keeps, quantises,
uploads and scans only its own `local_streams`, and its mirror, state and
telemetry have N / ch rows.  The streaming calls never communicate: each
returns the events of the rank's own streams, with global stream indices
(`parallel.gather_events` merges them), and `stores[i]` of a stream another
rank owns stays empty.  The shared-consumption group is then the rank's own
streams.  `save_state` / `load_state` are the only collectives: one
checkpoint file with global shapes, whatever the mesh.

Tracing and the output hook are the pipeline's (models/api.py module
docstring): a dispatch's `prep` / `scan` / `drain` stages, the spans
`stream.upload` and `stream.harvest`, `api.stream_counts`, and
`on_output`, which receives every drained dispatch's StepOutput
[n_steps, n, R] of this process's streams (`local_streams`).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np

from ..ltecore.constants import (DEFAULT_PSR_THRESHOLD, DEFAULT_TRACK_AFTER,
                                 DEFAULT_TRACK_EVERY)
from ..ops import cplx
from ..parallel import mesh as meshmod
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

    mesh: an optional `parallel.Mesh`; the streams are sharded over its `ch`
    axis and run on `mesh.device` (see the module docstring).  `n` counts
    the streams this process scans (`local_streams`, a range of global
    indices), `n_streams` all of them; telemetry and `backlog` have `n` rows.

    on_output: called with each drained dispatch's StepOutput of host
    arrays, [n_steps, n, R], and the drained positions before it, [n, R]
    (models/api.py module docstring); None by default.
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
                 cfo_search_range: int = 0, device="cuda", mesh=None,
                 on_output: Optional[Callable] = None):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        if cellstores is None:
            cellstores = [CellStore() for _ in range(n_streams)]
        if len(cellstores) != n_streams:
            raise ValueError(f"{len(cellstores)} cellstores for "
                             f"{n_streams} streams")
        self.mesh = mesh
        self.n_streams = int(n_streams)
        lo, hi = (0, self.n_streams) if mesh is None \
            else mesh.local_slice(self.n_streams)
        self.local_streams = range(lo, hi)
        super().__init__((hi - lo,), psr_threshold, track_after,
                         track_every, cellstores, on_track, on_drop,
                         pipeline, transport, cfo_search_range,
                         device if mesh is None else mesh.device,
                         first_stream=lo, on_output=on_output)

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
        """Feed one chunk per stream (len(chunks) == n_streams), then pump
        once."""
        if len(chunks) != self.n_streams:
            raise ValueError(f"{len(chunks)} chunks for {self.n_streams} "
                             "streams")
        return self._process(dict(enumerate(chunks)))

    def _process(self, chunks: dict) -> list[tuple[int, Cell]]:
        """chunks: {global stream index: samples}; another rank's streams
        are passed over."""
        t = time.time()
        for stream, samples in chunks.items():
            if not 0 <= stream < self.n_streams:
                raise IndexError(f"stream {stream} of {self.n_streams}")
            if stream in self.local_streams:
                self._feed(stream - self._first, samples, t)
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

    # ---- checkpoint ------------------------------------------------------
    # One file with the JAX package's keys and GLOBAL shapes, whatever the
    # mesh: a checkpoint saved on one mesh loads unsharded, on another mesh
    # shape and in the JAX class, and the other way round.
    def _settle(self) -> None:
        """Flush, trim the host buffers to the drained position and make
        every rebase that is due, so that `base` and the grid are the same
        on every rank.  A rank rebases when its own buffer passes
        REBASE_AT, at the start of a call, so ranks whose calls differ
        rebase on different calls, and a checkpoint may fall between them;
        after the trim every rank's buffer starts at the same stream sample,
        and rebasing while `_base >= REBASE_AT` leaves every rank with the
        same coordinates."""
        self.flush()
        self._trim_drained()
        while self._base >= self.REBASE_AT:
            self._maybe_rebase()

    def _gather_checkpoint(self, per_stream: dict) -> dict:
        """Every stream's `cfo_bins`, carry and `per_stream` entries,
        gathered along `ch`."""
        rows = dict(cfo_bins=self._cfo_bins, **self._state_arrays())
        if self.mesh is None:
            return {**rows, **per_stream}
        parts = meshmod.all_gather_object(
            (self._grid, rows, per_stream), self.mesh, "ch")
        if len({grid for grid, _, _ in parts}) != 1:
            raise ValueError(
                f"ranks stand at different stream positions "
                f"{[grid for grid, _, _ in parts]}: feed every stream to "
                f"the same length (fill_gap) before a checkpoint")
        out = {k: np.concatenate([r[k] for _, r, _ in parts]) for k in rows}
        for _, _, extra in parts:
            out.update(extra)
        return out

    def _write_checkpoint(self, path: str, **arrays) -> None:
        """The mesh's first rank writes the file; nobody returns before it
        is there."""
        if self.mesh is None or not any(self.mesh.coords.values()):
            np.savez(path, n=self.n_streams, base=self._base,
                     psr_threshold=self.psr_threshold, **arrays)
        if self.mesh is not None:
            meshmod.all_gather_object(None, self.mesh, None)

    def save_state(self, path: str) -> None:
        """Checkpoint the [N] carry and every stream's buffered samples,
        after a flush; the keys are the JAX package's.  With a mesh a
        collective: every rank must call it, at the same point of its feed."""
        self._settle()
        self._write_checkpoint(path, **self._gather_checkpoint(
            {f"buf_{i}": b.to_array()
             for i, b in zip(self.local_streams, self._bufs)}))

    def _restore_rows(self, data, bufs: list) -> None:
        """`_restore` of this process's streams from a global checkpoint."""
        rows = slice(self.local_streams.start, self.local_streams.stop)
        self._restore(data, bufs, rows)
        self._cfo_bins = (np.asarray(data["cfo_bins"])[rows].astype(np.int32)
                          if "cfo_bins" in data
                          else np.zeros(self.n, np.int32))

    def load_state(self, path: str) -> None:
        """Every rank reads the one file and keeps its own streams."""
        with np.load(path) as data:
            if int(data["n"]) != self.n_streams:
                raise ValueError(f"checkpoint holds {int(data['n'])} "
                                 f"streams, this MultiTrigger "
                                 f"{self.n_streams}")
            self._restore_rows(
                data, [data[f"buf_{i}"] for i in self.local_streams])
