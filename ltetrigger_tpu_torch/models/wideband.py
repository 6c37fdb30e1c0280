"""WidebandTrigger: N carriers monitored live from ONE wideband stream.

Port of ltetrigger_tpu/models/wideband.py.  `MultiTrigger` needs N separate
1.92 Msps feeds: N SDRs and N streams of host-to-device transport.  A
wideband SDR gives the same carriers as ONE pipe: this class accepts the
wide stream (an integer multiple of 1.92 Msps), uploads each segment ONCE,
and channelizes ON THE DEVICE (frequency shift to every centre, anti-alias
decimation) directly into the multi-stream mirror that feeds the batched
trigger engine.  The host-side narrow streams never exist.

Transport economics against N narrow streams at the same byte budget: the
wide stream's quantisation noise is spread over the whole band, and the
channelizer keeps only 1/ratio of it per carrier, a 10*log10(ratio) dB
processing gain (+9 dB at ratio 8, +12 dB at 16).  A wide i8 upload
(2 bytes/sample) therefore lands ~45 dB effective per-channel SNR at ratio
8, between narrow i16 (~84 dB) and narrow i8 (~36 dB), and wide i4
(1 byte/sample) ~23 dB, still ~33 dB above the detection knee.

Streaming correctness details:
  * the mixer phase is the host-table decomposition of ops/channelize.py
    (a block origin plus an in-block ramp), evaluated at ABSOLUTE
    wide-stream indices (tracked across coordinate rebases), so every
    channel's oscillator is phase-continuous for the life of the stream.
    The origins are exact integer arithmetic where the centres are whole
    Hz at a whole-Hz rate (`chan._phase_tables`; f64 mod 1 otherwise):
    they depend on the block's absolute index modulo the rate alone, so
    they lose no bits as the stream grows, and two uploads that
    start on the absolute block grid give a sample the same phase, to the
    last bit.  A stream fed in chunks of whole blocks, each taken up whole
    by the next dispatch, repeats its lanes bit for bit wherever it and
    every centre's mixer phase repeat;
  * each upload carries one 9600-sample context block per side, all of it
    real stream samples, so the decimator's transients never land in the
    mirror: segment boundaries are invisible to the detector;
  * everything downstream (shared-consumption grid schedule, per-stream
    events / telemetry / cellstores, integer-CFO probes per carrier applied
    to the channelized rows, checkpoint / resume) is MultiTrigger, unchanged.

One difference from the JAX class: that one pads every upload to a quantum
of 8 half-frames because its jitted programs want static shapes.  This one
channelizes exactly the wide span of the narrow samples the mirror lacks and
writes exactly those; the mirror past its valid end stays zero, the engine
reads nothing past it, and so the events are the same.

Tracing: the wide front end replaces the narrow streams' upload, so its two
spans (`utils.profiling.span`, each with a CUDA event pair on a card) open
inside the pipeline's `stream.upload`: `wide.upload` around the wide row's
quantisation into pinned memory, its `non_blocking` copy and its
dequantisation on the device, and `wide.mix` around the phase origins (the
host table and its copy) and the channelizer's launch.  In
`api.stream_counts` it adds the wide row's staged bytes, its two context
blocks included, to "upload_bytes", and counts in "wide_samples" the wide
samples of each upload's payload.  `resident_lanes()` reads the
channelized samples the device mirror holds.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from ..ltecore.constants import SAMPLE_RATE
from ..ops import channelize as chan
from ..runtime.cellstore import Cell
from ..runtime.chunkbuf import ChunkBuffer
from ..utils import profiling
from . import api
from . import trigger as trig
from .multi import MultiTrigger

LOOKBACK = trig.LOOKBACK
BLOCK = chan.BLOCK                       # wide-side context + phase block


class WidebandTrigger(MultiTrigger):
    """MultiTrigger fed by ONE wideband stream (see module docstring).

    sample_rate: wide input rate, an integer multiple of 1.92 MHz.
    center_offsets_hz: carrier centres relative to the capture centre; one
    monitored stream each (stream i of events / telemetry / cellstores is
    centers[i]).

    Feed with process_wide(samples): complex64 at `sample_rate`.  All other
    MultiTrigger surface (flush, stores, telemetry, checkpoints,
    cfo_search_range, transports incl. packed i4, `device=`, `mesh=`) is
    inherited: with a mesh every rank is fed the same wide stream, quantises
    and uploads it, and channelizes only its own centres;
    the per-stream feeding methods are disabled (one pipe feeds everyone, so
    shared consumption never stalls and fill_gap is just zeros into the wide
    stream).

    The context trimmed from each channelized segment is BLOCK // ratio
    narrow samples, exact only when the ratio divides 9600 (4, 8, 16 do);
    any other ratio is floored silently, as in the JAX package."""

    def __init__(self, sample_rate: float,
                 center_offsets_hz: Sequence[float],
                 transport: str = "i8", **kwargs):
        self.ratio = chan._ratio(sample_rate)
        self.sample_rate = float(sample_rate)
        self.centers = [float(c) for c in center_offsets_hz]
        nyq = sample_rate / 2
        for c in self.centers:
            if abs(c) + SAMPLE_RATE / 2 > nyq + 1e-6:
                raise ValueError(f"center {c/1e6:.2f} MHz exceeds the "
                                 f"{sample_rate/1e6:.2f} MHz band")
        super().__init__(len(self.centers), transport=transport, **kwargs)

        # this process's carriers (all of them without a mesh)
        own = slice(self.local_streams.start, self.local_streams.stop)
        self._offs_hz = np.asarray(self.centers[own], dtype=np.float64)
        self._ramps = api._to_device(
            chan._ramp_table(self._offs_hz / self.sample_rate), self.device)
        self._unit = torch.ones(self._batch, device=self.device)
        # wide host buffer; wide coord = narrow stream coord * ratio.
        # Starts with the LOOKBACK zeros' worth of wide samples plus one
        # decimator context block.
        self._bufs = []                 # the narrow host streams never exist
        self._wbuf = ChunkBuffer(
            np.zeros(LOOKBACK * self.ratio + BLOCK, dtype=np.complex64))
        self._wbase = -LOOKBACK * self.ratio - BLOCK
        # rebase-immune offset: wide index + _wabs = absolute sample count
        # since construction (the mixer phase must NOT jump at a rebase)
        self._wabs = 0

    # ---- feeding ---------------------------------------------------------
    def process_wide(self, samples: np.ndarray) -> list[tuple[int, Cell]]:
        """Feed a chunk of the wide stream (complex64 at sample_rate);
        returns (stream, Cell) events that drained during the call."""
        self._wbuf.append(samples)
        end = self._fed_min()
        t = time.time()
        for q in self._anchors:
            q.append((end, t))
        published: list[tuple[int, Cell]] = []
        self._maybe_rebase()
        self._pump(published, flush_mode=(self.pipeline == 0))
        return published

    def fill_gap_wide(self, n_wide_samples: int) -> list[tuple[int, Cell]]:
        """Declare dropped WIDE samples (SDR overflow): zeros enter the
        band, every channel sees silence there."""
        return self.process_wide(np.zeros(n_wide_samples, np.complex64))

    def process(self, *args, **kwargs):
        raise TypeError("WidebandTrigger is fed through process_wide(); "
                        "per-stream feeding belongs to MultiTrigger")

    process_all = process
    fill_gap = process

    # ---- pipeline hooks --------------------------------------------------
    def _fed_min(self) -> int:
        # producing narrow sample b-1 needs wide data through b*ratio+BLOCK
        return (self._wbase + len(self._wbuf) - BLOCK) // self.ratio

    def _backlog(self) -> np.ndarray:
        return np.full(self.n, self._fed_min(), dtype=np.int64) \
            - self._pos_lb.min(axis=1)

    def _trim_front(self, keep_from: int) -> None:
        self._base += keep_from
        keep_w = self._base * self.ratio - BLOCK
        drop = keep_w - self._wbase
        if drop > 0:
            self._wbuf.drop_front(drop)
            self._wbase = keep_w

    def _maybe_rebase(self) -> None:
        if self._base >= self.REBASE_AT:
            delta_w = self.REBASE_AT * self.ratio
            self._wbase -= delta_w
            self._wabs += delta_w
        super()._maybe_rebase()

    def _upload_segment(self, start: int, new: int):
        """Narrow samples [start, start + new) of every carrier, made on the
        device from ONE upload: the wide span [start * ratio - BLOCK,
        (start + new) * ratio + BLOCK), quantised once as one row, copied
        `non_blocking` from pinned memory, dequantised, mixed to each centre
        with phase origins at absolute wide indices and decimated."""
        if new == 0:                    # a pure slide of the mirror
            empty = torch.zeros(self._batch + (0,), device=self.device)
            return empty, empty, self._unit
        wlo = start * self.ratio - BLOCK
        length = new * self.ratio + 2 * BLOCK
        a = wlo - self._wbase           # >= 0: see _trim_front
        i4 = self.transport == "i4"
        with profiling.span("wide.upload", device=self.device):
            up, view = api._staging((() if i4 else (2,)) + (length,),
                                    api._HOST_TYPE[self.transport],
                                    self.device)
            scale = api._quantize_into(self._wbuf.view(a, a + length),
                                       self.transport, view)
            api.stream_counts["upload_bytes"] += view.nbytes
            api.stream_counts["wide_samples"] += new * self.ratio
            up = up.to(self.device, non_blocking=True)
            xpad = api._unpack_i4(up) if i4 else \
                (up[0].to(torch.float32), up[1].to(torch.float32))
            if scale != 1.0:
                xpad = (xpad[0] * scale, xpad[1] * scale)
        with profiling.span("wide.mix", device=self.device):
            origins = chan._phase_tables(self._offs_hz, self.sample_rate,
                                         self._wabs + wlo,
                                         -(-length // BLOCK))
            seg = chan._channelize_scan(xpad, api._to_device(origins,
                                                             self.device),
                                        self._ramps, self.ratio, new)
        return seg[0], seg[1], self._unit

    def resident_lanes(self) -> tuple[int, torch.Tensor, torch.Tensor]:
        """(first, re, im): a copy of the channelized samples that the
        device mirror holds, re and im [n, L] float32 on the device, column
        j at stream position first + j of every carrier (L = 0 before the
        first upload).  Reads the mirror and changes nothing."""
        if self._dev is None:
            empty = torch.zeros(self._batch + (0,), device=self.device)
            return self._dev_base, empty, empty.clone()
        return (self._dev_base,
                self._dev[0][..., :self._dev_len].clone(),
                self._dev[1][..., :self._dev_len].clone())

    # ---- checkpoint ------------------------------------------------------
    def save_state(self, path: str) -> None:
        """Checkpoint the [N] carry and the buffered wide samples, after a
        flush; the keys are the JAX package's.  With a mesh a collective:
        every rank must call it, at the same point of its feed (the wide
        buffer is then the same on every rank)."""
        self._settle()
        rows = self._gather_checkpoint({})
        self._write_checkpoint(
            path, wide=self._wbuf.to_array(), wbase=self._wbase,
            wabs=self._wabs, sample_rate=self.sample_rate,
            centers=np.asarray(self.centers), **rows)

    def load_state(self, path: str) -> None:
        with np.load(path) as data:
            if int(data["n"]) != self.n_streams \
                    or float(data["sample_rate"]) != self.sample_rate \
                    or not np.allclose(np.asarray(data["centers"]),
                                       np.asarray(self.centers)):
                raise ValueError("checkpoint holds another rate or centre "
                                 "plan than this WidebandTrigger")
            self._restore_rows(data, [])
            self._wbuf = ChunkBuffer(data["wide"])
            self._wbase = int(data["wbase"])
            self._wabs = int(data["wabs"])
