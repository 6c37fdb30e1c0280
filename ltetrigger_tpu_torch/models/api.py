"""High-level detection API: one-shot `search` and the streaming `Trigger`.

Port of ltetrigger_tpu/models/api.py.  `search(iq, fs)`: resample to
1.92 Msps -> scan_engine in chunks -> drain track/drop events into a
CellStore.  `Trigger`: the streaming detector with the reference hier
block's surface (telemetry, track/drop events into a CellStore), fed in
chunks of any size.

The streaming pipeline (`_StreamPipeline`, shared with models/multi.py and
models/wideband.py) keeps a mirror of the stream on the device and, per
dispatch, uploads only the new samples, scans up to 32 half-frame steps and
copies the packed events back.
Everything it enqueues goes to the device's current stream, in order:

  upload   the new segment is written into pinned host memory and copied
           with non_blocking=True.  Each upload takes a fresh pinned tensor:
           PyTorch's caching host allocator hands a freed pinned block out
           again only after the copies that read it have run, so no segment
           is overwritten while its copy is pending.
  mirror   `_mirror_advance` writes the segment behind the valid samples
           and, when the window would overflow, slides it down first.
  scan     `_stream_scan` with the grid start as a host integer: the host
           knows it exactly (every active step consumes 9600 samples), so
           enqueuing a dispatch never waits for the one before.
  drain    the packed output goes to pinned memory with non_blocking=True,
           followed by a torch.cuda.Event; `query()` on it says whether a
           dispatch's events can be read without waiting.

On the CPU device the same code runs with ordinary tensors and every
output is ready at once.  Nothing here moves work to the CPU when a card
was asked for.
"""

from __future__ import annotations

import math
import time
from collections import deque
from fractions import Fraction
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ltecore.constants import (DEFAULT_PSR_THRESHOLD,
                                 DEFAULT_TRACK_AFTER,
                                 DEFAULT_TRACK_EVERY,
                                 HALF_FRAME_LENGTH,
                                 MIN_PSR_THRESHOLD, SAMPLE_RATE)
from ..runtime.cellstore import Cell, CellStore, cell_from_step
from ..runtime.chunkbuf import ChunkBuffer
from ..utils.profiling import StageTimer
from ..ops import correlate, cplx, resample
from ..ops.kernels import matched_filter
from ..ops.device import (resolve_device, staging as _staging,
                          to_device as _to_device)
from . import trigger as trig

LOOKBACK = trig.LOOKBACK
WINDOW = trig.WINDOW
V2_WINDOW = correlate.V2_WINDOW


def ensure_safe_threshold(t: float) -> float:
    """Clamp to MIN_PSR_THRESHOLD (parity: downlink_trigger_c.py:10,71-73)."""
    return t if t > MIN_PSR_THRESHOLD else MIN_PSR_THRESHOLD


def _prepare_buffer(iq: np.ndarray, sample_rate: float,
                    repeat_to: Optional[int] = None,
                    device="cpu") -> cplx.Pair:
    """Resample to 1.92 Msps on `device`, loop to `repeat_to` samples, pad
    LOOKBACK zeros before and WINDOW zeros after.

    Integer ratios use the strided-conv decimator; any other rational rate
    goes through the polyphase rational resampler."""
    frac = Fraction(sample_rate / SAMPLE_RATE).limit_denominator(1000)
    if abs(float(frac) - sample_rate / SAMPLE_RATE) > 1e-9:
        raise ValueError(
            f"Sample rate {sample_rate/1e6:.2f} MHz is not a rational "
            "multiple of 1.92 MHz")
    xp = cplx.from_numpy(np.ascontiguousarray(iq), device)
    if frac.denominator == 1:
        x = resample.decimate(xp, frac.numerator)
    else:
        x = resample.rational_resample(xp, frac.denominator, frac.numerator)
    n = x[0].shape[0]
    if repeat_to is not None and repeat_to > n:
        reps = -(-repeat_to // n)
        x = (x[0].repeat(reps)[:repeat_to], x[1].repeat(reps)[:repeat_to])
    head = torch.zeros(LOOKBACK, device=device)
    tail = torch.zeros(WINDOW, device=device)
    return (torch.cat([head, x[0], tail]), torch.cat([head, x[1], tail]))


def _probe_bins(nbins: int) -> tuple:
    """The probe's half-subcarrier grid, -nbins .. +nbins subcarriers."""
    return tuple(k / 2.0 for k in range(-2 * nbins, 2 * nbins + 1))


def _best_bin(wins: cplx.Pair, nbins: int):
    """wins: pair of [..., K, >= V2_WINDOW] probe windows -> (best bin in
    half-subcarrier units [...] int64, PSR per bin [..., bins] maximised
    over windows and roots).  On the card every bin is one launch of the
    matched-filter kernel over all windows."""
    power = matched_filter.pss_correlate_power_cfo_bins(
        wins, _probe_bins(nbins))                # [.., K, bins, 3, 9600]
    _, psr = correlate.peak_and_psr(power)       # [.., K, bins, 3]
    per_bin = psr.amax(dim=(-3, -1))
    return torch.argmax(per_bin, dim=-1) - 2 * nbins, per_bin


def _cfo_bin_probe(buffer: cplx.Pair, nbins: int):
    """Best coarse-CFO bin (half-subcarrier grid) by PSR over 8 half-frame
    windows spread evenly across the whole prepared buffer (a capture's
    signal may start late).  The residual after correcting by the bin is
    <= 0.25 subcarriers, inside the matched filter's tolerance.

    returns (bin in half-subcarrier units, 0-d int64; PSR per bin)."""
    K = 8
    span = max(buffer[0].shape[0] - V2_WINDOW, 1)
    starts = [(k * span) // K for k in range(K)]
    wins = tuple(torch.stack([c[s:s + V2_WINDOW] for s in starts])
                 for c in buffer)
    return _best_bin(wins, nbins)


def _rotate(x: cplx.Pair, half_bins, n0: int) -> cplx.Pair:
    """x[..., L] * exp(-2j*pi*(half_bins/2)*n/128), n = n0 .. n0 + L the
    absolute stream index.  half_bins: host integers, one for all of x or
    one per leading row ([N] for [N, L]); rows with bin 0 pass unchanged.
    The phase is n * half_bins mod 256 in integers, then one float divide,
    so it is exact and continuous however long the stream."""
    hb = np.asarray(half_bins, dtype=np.int64)
    if not hb.any():
        return x
    dev = x[0].device
    n = n0 + torch.arange(x[0].shape[-1], dtype=torch.int64, device=dev)
    if hb.ndim == 0:
        phase = torch.remainder(n * int(hb), 256)
    else:
        phase = torch.remainder(n * _to_device(hb, dev)[..., None], 256)
    rot = cplx.expi((-2 * math.pi) * (phase.to(torch.float32) / 256.0))
    if hb.ndim == 0:
        return cplx.mul(x, rot)
    return cplx.where(_to_device(hb != 0, dev)[..., None],
                      cplx.mul(x, rot), x)


def _rotate_half_bins(buffer: cplx.Pair, half_bins: int) -> cplx.Pair:
    """Multiply a [N] buffer by exp(-2j*pi*(b/2)*n/128), integer phase."""
    return _rotate(buffer, int(half_bins), 0)


def search(iq: np.ndarray, sample_rate: float,
           psr_threshold: float = DEFAULT_PSR_THRESHOLD,
           exit_on_success: bool = True,
           max_seconds: float = 1.0,
           track_after: int = DEFAULT_TRACK_AFTER,
           track_every: int = DEFAULT_TRACK_EVERY,
           cellstore: Optional[CellStore] = None,
           chunk_steps: int = 25,
           cfo_search_range: int = 0,
           timer: Optional[StageTimer] = None,
           device="cuda") -> list[Cell]:
    """One-shot cell search over a capture (looped to `max_seconds`).

    Equivalent flow to the reference's examples/cell_search_file.py:
    resample -> trigger -> cellstore, with `exit_on_success` stopping at the
    first published cell.  The capture is looped until `max_seconds` of
    stream time has been processed.  Runs on `device` ("cuda" by default;
    raises if CUDA is absent).

    cfo_search_range > 0 enables integer-CFO acquisition: PSR is probed
    against replica banks shifted by up to +-range subcarrier spacings and
    the stream is pre-rotated by the best bin before the normal pipeline,
    which then tracks the fractional residual.
    """
    dev = resolve_device(device)
    psr_threshold = ensure_safe_threshold(psr_threshold)
    timer = timer if timer is not None else StageTimer()
    with timer.stage("prepare"):
        total = int(max_seconds * SAMPLE_RATE)
        buffer = _prepare_buffer(iq, sample_rate, repeat_to=total, device=dev)
        if cfo_search_range > 0:
            best_bin = int(_cfo_bin_probe(buffer, cfo_search_range)[0])
            if best_bin != 0:
                buffer = _rotate_half_bins(buffer, best_bin)
        n_valid = buffer[0].shape[0]

    store = cellstore if cellstore is not None else CellStore()
    state = trig.init_state(device=dev)
    # the grid engine consumes exactly one half-frame per active step
    max_steps = total // HALF_FRAME_LENGTH + 2

    found: list[Cell] = []
    steps_done = 0
    while steps_done < max_steps:
        n = min(chunk_steps, max_steps - steps_done)
        with timer.stage("scan"):
            state, out = trig.scan_engine(buffer, state, n, psr_threshold,
                                          track_after, track_every,
                                          n_valid=n_valid)
        steps_done += n
        with timer.stage("drain"):
            # one device-to-host copy per chunk
            host = trig.unpack_output(trig.pack_output(out).cpu())
            stop = _drain_events(host, store, found)
        if exit_on_success and stop:
            break
        if not np.any(host.consumed):      # all roots exhausted the stream
            break
    return found


def _drain_events(out: trig.StepOutput, store: CellStore,
                  found: list[Cell]) -> bool:
    """Apply a chunk's track/drop events (host numpy, [S, R]) to the store
    in step-then-root order. True if any track."""
    any_track = False
    for s, r in zip(*np.nonzero(out.drop_event | out.track_event)):
        if out.drop_event[s, r]:
            store.drop_cell_id(int(out.drop_cell_id[s, r]))
        if out.track_event[s, r]:
            cell = cell_from_step(
                out.cell_id[s, r], out.nof_prb[s, r],
                out.nof_ports[s, r], out.phich_ext[s, r],
                out.phich_res[s, r], out.sfn_offset[s, r],
                bool(out.normal_cp[s, r]))
            store.track_cell(cell)
            found.append(cell)
            any_track = True
    return any_track


# ======================================================================
# the streaming classes
# ======================================================================
def _mirror_advance(dev_r, dev_i, up_r, up_i, scale, shift: int,
                    write_off: int, half_bins, seg_start: int) -> cplx.Pair:
    """Slide the device stream mirror down by `shift` samples and write the
    newly uploaded segment at `write_off` (mirror coordinates after the
    slide).  The only host-to-device traffic of a steady streaming dispatch
    is `up_*`: the new samples themselves, possibly int-quantized
    (dequantized here by `scale`; the mirror is always float32).

    dev_*: [..., cap] float32; up_*: [..., L] of the transport's type;
    scale: float32 tensor of the leading shape; half_bins / seg_start: the
    integer-CFO pre-rotation of the segment (`_rotate`; seg_start is the
    absolute stream index of its first sample).

    A slide's source and destination overlap, so it copies into a second,
    zeroed buffer, which is returned; without a slide the segment is written
    into `dev_*` in place and those are returned.  Either way the mirror
    past the written samples stays zero."""
    seg = _rotate((up_r.to(torch.float32) * scale[..., None],
                   up_i.to(torch.float32) * scale[..., None]),
                  half_bins, seg_start)
    length = up_r.shape[-1]

    def one(d, u):
        if shift:
            keep = max(d.shape[-1] - shift, 0)
            slid = torch.zeros_like(d)
            slid[..., :keep] = d[..., shift:]
            d = slid
        d[..., write_off:write_off + length] = u
        return d

    return one(dev_r, seg[0]), one(dev_i, seg[1])


def _mirror_rotate(dev_r, dev_i, half_bins, dev_base: int) -> cplx.Pair:
    """Re-rotate the whole mirror ([..., cap], first sample at stream index
    dev_base) by a probe's bin delta, so history and future uploads stay
    coherent.  Returns new tensors."""
    return _rotate((dev_r, dev_i), half_bins, dev_base)


def _stream_cfo_probe(dev: cplx.Pair, start: int, nbins: int) -> torch.Tensor:
    """Best coarse-CFO bin over 4 half-frame windows of the stream mirror
    from `start` (mirror coordinates): the streaming analogue of
    `_cfo_bin_probe`.  dev: pair of [..., cap]; returns the bin delta in
    half-subcarrier units relative to the mirror's current rotation, int64
    of the leading shape."""
    starts = [start + k * HALF_FRAME_LENGTH for k in range(4)]
    wins = tuple(torch.stack([c[..., s:s + V2_WINDOW] for s in starts],
                             dim=-2) for c in dev)
    return _best_bin(wins, nbins)[0]


def _stream_scan(buffer: cplx.Pair, state: trig.TriggerState,
                 psr_threshold: float, n_valid: int, base: int, n_steps: int,
                 track_after: int, track_every: int,
                 grid0: Optional[int] = None):
    """One streaming dispatch: `state.pos` lives in stream coordinates and
    `buffer` (the mirror) starts at stream index `base`.  grid0: the grid
    start in mirror coordinates when the caller knows it (trigger.scan_pass).
    returns (state, packed output [n_steps, ..., 15])."""
    st = state._replace(pos=state.pos - base)
    st, out = trig.scan_engine(buffer, st, n_steps, psr_threshold,
                               track_after, track_every, n_valid=n_valid,
                               grid0=grid0)
    return st._replace(pos=st.pos + base), trig.pack_output(out)


_LIMIT = {"i16": 32767.0, "i8": 127.0, "i4": 7.0}      # full scale
_HOST_TYPE = {"f32": np.float32, "i16": np.int16, "i8": np.int8,
              "i4": np.uint8}


def _quantize_into(seg: np.ndarray, transport: str, out: np.ndarray) -> float:
    """Encode one stream's upload segment (complex64 [L]) into `out`: [2, L]
    (re, im) of the transport's type, or for "i4" [L] uint8 with re in the
    high nibble and im in the low one, each offset by 8.  Returns the scale
    that `_mirror_advance` multiplies back in (peak / limit per segment)."""
    re = np.ascontiguousarray(seg.real)
    im = np.ascontiguousarray(seg.imag)
    if transport == "f32":
        out[0], out[1] = re, im
        return 1.0
    lim = _LIMIT[transport]
    peak = max(float(np.max(np.abs(re), initial=0.0)),
               float(np.max(np.abs(im), initial=0.0)), 1e-30)
    if transport == "i4":
        qr = np.clip(np.round(re * (lim / peak)), -8, 7).astype(np.int32)
        qi = np.clip(np.round(im * (lim / peak)), -8, 7).astype(np.int32)
        out[...] = ((qr + 8) << 4) | (qi + 8)
    else:
        out[0] = np.round(re * (lim / peak))
        out[1] = np.round(im * (lim / peak))
    return peak / lim


def _unpack_i4(up: torch.Tensor) -> cplx.Pair:
    """uint8 [..., L], re nibble | im nibble, each offset by 8 -> the
    float32 (re, im) pair of integers in [-8, 7]."""
    return ((up >> 4).to(torch.float32) - 8.0,
            (up & 0xF).to(torch.float32) - 8.0)


def _host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a numpy array (waits for the device)."""
    return t.cpu().numpy()


class _Dispatch(NamedTuple):
    """One dispatch whose output has not been applied yet."""
    out: torch.Tensor                       # packed output, host side
    ready: Optional[torch.cuda.Event]       # fires when `out` has arrived


class _StreamPipeline:
    """What `Trigger` and `models.multi.MultiTrigger` share: one device
    mirror, one dispatch pipeline and one grid schedule over streams of the
    leading shape `batch` (() for one stream, (N,) for N).

    All streams advance through the same grid together; a dispatch covers
    only steps for which every stream has data.

    Where the samples come from is behind four methods, which
    `models.wideband.WidebandTrigger` overrides to feed every stream from
    one wide host buffer: `_fed_min`, `_backlog`, `_trim_front` and
    `_upload_segment`.

    `first_stream` is the global index of this pipeline's first stream: a
    rank of a process mesh runs the pipeline over its own streams only, while
    `stores`, events and callbacks keep the global stream indices."""

    # rebase threshold (class attribute so tests can exercise the wrap
    # without streaming 4.7 minutes of samples).  Must stay a multiple of
    # 256 so the integer-CFO rotation phase is continuous across the shift.
    REBASE_AT = 2 ** 29
    TRANSPORTS = ("f32", "i16", "i8")
    _tag_stream = False         # events and callbacks carry the stream index

    def __init__(self, batch: tuple, psr_threshold: float, track_after: int,
                 track_every: int, stores: list, on_track, on_drop,
                 pipeline: int, transport: str, cfo_search_range: int,
                 device, first_stream: int = 0):
        if transport not in self.TRANSPORTS:
            raise ValueError(f"transport {transport!r} is not one of "
                             f"{self.TRANSPORTS}")
        self.device = resolve_device(device)
        self._batch = tuple(batch)
        self.n = math.prod(self._batch)
        self._first = int(first_stream)
        self.transport = transport
        self.psr_threshold = ensure_safe_threshold(psr_threshold)
        self.exit_on_success = False
        self.done = False
        self.track_after = track_after
        self.track_every = track_every
        self.stores = list(stores)
        self.on_track = on_track
        self.on_drop = on_drop
        self.pipeline = max(0, int(pipeline))
        # per-stage wall-clock accumulators (prep / scan / drain)
        self.timer = StageTimer()
        # the most dispatches ever unfinished on the device at the moment
        # one more was enqueued, itself included (1 on the CPU)
        self.max_in_flight = 0

        # streaming convention: stream index 0 = first real sample, with
        # LOOKBACK zeros of synthetic history before it.  state.pos lives in
        # STREAM coordinates on the device; each dispatch passes the
        # mirror's base offset.
        self._state = trig.init_state(start_pos=0, batch=self._batch,
                                      device=self.device)
        self._bufs = [ChunkBuffer(np.zeros(LOOKBACK, dtype=np.complex64))
                      for _ in range(self.n)]
        self._base = -LOOKBACK      # stream index of every _bufs[i][0]
        # drained per-root position lower bound (exact when no dispatch is
        # outstanding): the host never waits on device state to plan work
        self._pos_lb = np.zeros(self._batch + (trig.R,), dtype=np.int64)
        # the grid start of the next dispatch, exactly: every active step
        # consumes one half-frame and activity depends on host integers
        # only, so a dispatch is enqueued without reading the one before
        self._grid = 0
        self._outstanding: deque = deque()      # of _Dispatch
        # arrival anchors (end_stream_pos, wall_time) per stream: a track
        # event detected at stream position p is stamped with the arrival
        # time of p, not the (pipeline-delayed) drain time
        self._anchors = [deque() for _ in range(self.n)]
        # adaptive scan depth: one dispatch covers up to 32 half-frame
        # steps when the backlog is deep (dispatches <= K_STEP_CAP steps get
        # one capture slot per step, so capture overflow cannot occur here)
        self._step_buckets = (4, 8, 16, 32)
        # the device mirror covers [pos_lb.min() - LOOKBACK, dev_base +
        # dev_len) of every stream.  Up to (pipeline + 4) * 32 steps can be
        # in flight under the backpressure rule, each holding a half-frame.
        cap_hf = max(256, (self.pipeline + 4) * 32 + 16)
        self._cap = LOOKBACK + cap_hf * HALF_FRAME_LENGTH + WINDOW
        self._dev = None            # device pair [*batch, cap]
        self._dev_base = 0          # stream index of _dev[..., 0]
        self._dev_len = 0           # valid samples in the mirror
        # integer-CFO acquisition: while a stream neither tracks nor scores,
        # probe replica banks shifted by up to +-range subcarriers; on a
        # hit, rotate its mirror rows and all its future uploads by the
        # winning bin.  The normal pipeline then tracks the residual.
        self.cfo_search_range = int(cfo_search_range)
        self._cfo_bins = np.zeros(self.n, dtype=np.int32)   # half-subcarriers
        self._any_tracking = np.zeros(self.n, dtype=bool)
        self._max_score = np.zeros(self.n, dtype=np.int64)
        self._probe_every = 16          # half-frame steps between probes
        self._steps_since_probe = self._probe_every   # probe at first chance

    # ---- telemetry (arrays of [*batch, R]); reflects drained dispatches
    # and waits for the device ------------------------------------------
    @property
    def max_psr(self):
        return _host(self._state.psr_max)

    @property
    def mean_psr(self):
        s = self._state
        return _host(trig._ring_mean(s.psr_ring, s.psr_count))

    @property
    def mean_cfo(self):
        s = self._state
        return _host(trig._ring_mean(s.cfo_ring, s.cfo_count))

    @property
    def tracking_score(self):
        return _host(self._state.score)

    @property
    def tracking(self):
        return _host(self._state.tracking)

    @property
    def cap_overflow(self):
        """Cumulative MIB capture attempts deferred because all K candidate
        slots of a scan chunk were full (each deferral retries next chunk)."""
        return _host(self._state.cap_overflow)

    @property
    def channel_estimate(self):
        """[*batch, 3, 62] complex64: LS channel estimate over the 62 PSS
        subcarriers from the most recent tracked half-frame, per root
        (zeros until a root tracks)."""
        ch = _host(self._state.chest)
        return (ch[..., 0] + 1j * ch[..., 1]).astype(np.complex64)

    def set_psr_threshold(self, t: float):
        self.psr_threshold = ensure_safe_threshold(t)

    def _backlog(self) -> np.ndarray:
        """[n] samples fed but not yet scanned, per stream."""
        fed = np.array([self._base + len(b) for b in self._bufs])
        return fed - self._pos_lb.reshape(self.n, trig.R).min(axis=1)

    # ---- the public pump calls ----------------------------------------
    def _feed(self, stream: int, samples: np.ndarray, t: float) -> None:
        self._bufs[stream].append(samples)
        self._anchors[stream].append(
            (self._base + len(self._bufs[stream]), t))

    def poll(self) -> list:
        """Advance the pipeline WITHOUT feeding samples: dispatch any work
        the buffered backlog allows and drain outputs that are already
        ready (never waits for the device).  A producer pacing itself on
        `backlog` between feeds should call this while it waits: the
        backlog only shrinks when outputs are harvested."""
        published: list = []
        self._pump(published, flush_mode=False)
        return published

    def flush(self) -> list:
        """Drain every outstanding dispatch and scan out all data every
        stream has; returns what was published during the flush."""
        published: list = []
        self._pump(published, flush_mode=True)
        return published

    # ---- the pump -------------------------------------------------------
    def _pump(self, published: list, flush_mode: bool) -> None:
        while not self.done:
            if self._dispatch_one(published):
                continue
            if self._outstanding and (flush_mode or self._ready_head()):
                self._harvest(published, force=flush_mode)
                continue            # drained positions may enable more work
            break

    def _estimated_min_pos(self) -> int:
        """Min root position once every dispatch in flight has run: the
        host's grid, which is exact (see __init__), so planning the next
        dispatch never waits for a harvest."""
        return self._grid

    def _fed_min(self) -> int:
        """The stream index up to which every stream has samples."""
        return min(self._base + len(b) for b in self._bufs)

    def _trim_front(self, keep_from: int) -> None:
        """Drop the first `keep_from` samples of every host buffer: they lie
        below every root's drained position."""
        for buf in self._bufs:
            buf.drop_front(keep_from)
        self._base += keep_from

    def _trim_drained(self) -> None:
        """Discard host samples below every root's drained position."""
        keep_from = int(self._pos_lb.min()) - LOOKBACK - self._base
        if keep_from > 0:
            self._trim_front(keep_from)

    def _dispatch_one(self, published: list) -> bool:
        """Dispatch one adaptive-depth scan if every stream's buffer
        (estimated) holds enough samples; harvest eagerly when over pipeline
        depth.

        Backpressure rule: when the pipeline is full and the oldest output
        is not ready yet, dispatch only at the MAXIMUM scan depth; shallow
        dispatches wait for more input instead.  Bounded accumulation
        converges to deep dispatches with at most pipeline + 3 in flight."""
        headroom = (self._fed_min()
                    - (self._estimated_min_pos() + WINDOW - LOOKBACK))
        if headroom < 0:
            return False
        steps_avail = max(headroom // HALF_FRAME_LENGTH, 1)
        n_steps = self._step_buckets[0]
        for b in self._step_buckets:
            if b <= steps_avail:
                n_steps = b
        if len(self._outstanding) > self.pipeline and not self._ready_head():
            if (n_steps < self._step_buckets[-1]
                    or len(self._outstanding) > self.pipeline + 2):
                return False

        with self.timer.stage("prep"):
            self._trim_drained()
            # sync the device mirror up to what this dispatch can reach
            # (not the whole host backlog: it may exceed the mirror)
            hi_need = (self._estimated_min_pos()
                       + n_steps * HALF_FRAME_LENGTH + WINDOW)
            self._sync_device_window(min(self._fed_min(), hi_need))
            self._maybe_probe_cfo()
            self._steps_since_probe += n_steps
        with self.timer.stage("scan"):
            unfinished = sum(1 for d in self._outstanding
                             if d.ready is not None and not d.ready.query())
            self.max_in_flight = max(self.max_in_flight, unfinished + 1)
            grid0 = self._grid - self._dev_base
            self._state, packed = _stream_scan(
                self._dev, self._state, self.psr_threshold, self._dev_len,
                self._dev_base, n_steps, self.track_after, self.track_every,
                grid0=grid0)
            # steps whose correlator window fits the valid samples ran
            active = (self._dev_len - V2_WINDOW - grid0) \
                // HALF_FRAME_LENGTH + 1
            self._grid += HALF_FRAME_LENGTH * min(max(active, 0), n_steps)
            self._outstanding.append(self._fetch(packed))
        if len(self._outstanding) > self.pipeline:
            self._harvest(published, force=False)
        return True

    def _fetch(self, packed: torch.Tensor) -> _Dispatch:
        """Start the packed output's one copy to the host: into pinned
        memory, followed by an event that says when it has arrived.  On the
        CPU the output is there already."""
        if self.device.type != "cuda":
            return _Dispatch(packed, None)
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return _Dispatch(host, ready)

    def _sync_device_window(self, hi: int) -> None:
        """Bring the device mirror to cover stream samples [lo, hi), where
        lo = min drained position - LOOKBACK, uploading only what the
        mirror lacks, in one copy for all streams."""
        lo = int(self._pos_lb.min()) - LOOKBACK
        if self._dev is None or lo >= self._dev_base + self._dev_len:
            self._dev = cplx.zeros(self._batch + (self._cap,), self.device)
            self._dev_base = lo
            self._dev_len = 0
        shift = lo - self._dev_base if hi - self._dev_base > self._cap else 0
        new_base = self._dev_base + shift
        if hi - new_base > self._cap:
            raise RuntimeError(
                f"stream mirror overflow: window [{lo}, {hi}) exceeds "
                f"capacity {self._cap}: backlog not bounded by backpressure?")
        have_end = self._dev_base + self._dev_len
        new = max(hi - have_end, 0)
        if new == 0 and shift == 0:
            return
        up_r, up_i, scale = self._upload_segment(have_end, new)
        bins = self._cfo_bins.reshape(self._batch)
        self._dev = _mirror_advance(
            self._dev[0], self._dev[1], up_r, up_i, scale, shift,
            have_end - new_base, bins, have_end)
        self._dev_base = new_base
        self._dev_len = max(hi, have_end) - new_base

    def _upload_segment(self, start: int, new: int):
        """Stream samples [start, start + new) of every stream, on the
        device: (re, im) of shape [*batch, new] in the transport's type and
        the float32 scale [*batch] that `_mirror_advance` multiplies back
        in.  One quantisation per stream into one pinned tensor, one copy."""
        a = start - self._base
        i4 = self.transport == "i4"
        up, view = _staging(
            (self.n,) + (() if i4 else (2,)) + (new,),
            _HOST_TYPE[self.transport], self.device)
        scale = np.array([_quantize_into(buf.view(a, a + new),
                                         self.transport, view[i])
                          for i, buf in enumerate(self._bufs)], np.float32)
        up = up.to(self.device, non_blocking=True)
        if i4:
            up_r, up_i = _unpack_i4(up.reshape(self._batch + (new,)))
        else:
            up = up.reshape(self._batch + (2, new))
            up_r, up_i = up[..., 0, :], up[..., 1, :]
        return up_r, up_i, _to_device(scale.reshape(self._batch),
                                      self.device)

    def _maybe_probe_cfo(self) -> None:
        """Coarse-CFO probe of the streams that neither track nor score."""
        if (not self.cfo_search_range or self._dev is None
                or self._steps_since_probe < self._probe_every):
            return
        idle = (~self._any_tracking) & (self._max_score == 0)
        if not idle.any():
            return
        # the next 4 half-frames to scan when the mirror holds them (a deep
        # backlog), else the newest 4 it holds: a pipeline that keeps up with
        # its source never has 4 unscanned half-frames
        start = min(int(self._pos_lb.min()) - self._dev_base,
                    self._dev_len - (3 * HALF_FRAME_LENGTH + V2_WINDOW))
        if start < 0:
            return
        self._steps_since_probe = 0
        trig.host_syncs["probe"] += 1
        deltas = _host(_stream_cfo_probe(self._dev, start,
                                              self.cfo_search_range))
        deltas = np.where(idle, deltas.reshape(self.n), 0).astype(np.int32)
        if deltas.any():
            self._dev = _mirror_rotate(self._dev[0], self._dev[1],
                                       deltas.reshape(self._batch),
                                       self._dev_base)
            self._cfo_bins += deltas

    def _ready_head(self) -> bool:
        if not self._outstanding:
            return False
        ready = self._outstanding[0].ready
        return ready is None or ready.query()

    def _harvest(self, published: list, force: bool) -> None:
        """Apply outstanding outputs that have arrived (all of them when
        force=True).  Never waits on an output unless forced: depth is
        bounded by _dispatch_one's backpressure rule instead.

        Every output's copy to the host was queued at its dispatch, so a
        forced drain waits once, for the newest one, however many are
        pending."""
        if force and self._outstanding \
                and self._outstanding[-1].ready is not None:
            with self.timer.stage("drain"):
                self._outstanding[-1].ready.synchronize()
        while self._outstanding and self._ready_head():
            d = self._outstanding.popleft()
            with self.timer.stage("drain"):
                host = trig.unpack_output(d.out)
            pos_before = self._pos_lb.copy()
            self._pos_lb += host.consumed.sum(axis=0).astype(np.int64)
            self._note_tracking(host)
            self._apply_events(host, published, pos_before)
            self._prune_anchors()
            if self.done:
                self._outstanding.clear()
                return
        if not self._outstanding and int(self._pos_lb.min()) != self._grid:
            raise RuntimeError(
                f"grid schedule lost: drained position "
                f"{int(self._pos_lb.min())}, host grid {self._grid}")

    def _stamp(self, stream: int, stream_pos: int) -> float:
        """Wall time at which stream position `stream_pos` ARRIVED (first
        anchor covering it); falls back to now for positions with no
        recorded arrival (e.g. right after load_state)."""
        for end, t in self._anchors[stream]:
            if end >= stream_pos:
                return t
        return time.time()

    def _prune_anchors(self) -> None:
        lo = int(self._pos_lb.min())
        for q in self._anchors:
            while q and q[0][0] < lo:
                q.popleft()

    def _note_tracking(self, host: trig.StepOutput) -> None:
        """Host-visible acquisition progress per stream (gates the CFO
        probe without ever fetching device state)."""
        self._any_tracking = host.tracking[-1].reshape(self.n, -1).any(axis=1)
        self._max_score = host.score[-1].reshape(self.n, -1).max(axis=1) \
            .astype(np.int64)

    def _apply_events(self, host: trig.StepOutput, published: list,
                      pos_before: np.ndarray) -> None:
        """Apply one dispatch's track/drop events in step, stream, root
        order to the stores, the callbacks and `published`."""
        if not (host.track_event.any() or host.drop_event.any()):
            return
        shape = (-1, self.n, trig.R)
        h = trig.StepOutput(*(a.reshape(shape) for a in host))
        # stream position at the END of each step's half-frame, per root
        pos_after = pos_before.reshape(shape[1:])[None] \
            + np.cumsum(h.consumed, axis=0)
        for s, n, r in zip(*np.nonzero(h.track_event | h.drop_event)):
            store = self.stores[self._first + n]
            tag = (self._first + int(n),) if self._tag_stream else ()
            if h.drop_event[s, n, r]:
                cid = int(h.drop_cell_id[s, n, r])
                store.drop_cell_id(cid)
                if self.on_drop:
                    self.on_drop(*tag, cid)
            if h.track_event[s, n, r]:
                cell = cell_from_step(
                    h.cell_id[s, n, r], h.nof_prb[s, n, r],
                    h.nof_ports[s, n, r], h.phich_ext[s, n, r],
                    h.phich_res[s, n, r], h.sfn_offset[s, n, r],
                    bool(h.normal_cp[s, n, r]),
                    timestamp=self._stamp(int(n), int(pos_after[s, n, r])))
                store.track_cell(cell)
                published.append((*tag, cell) if tag else cell)
                if self.on_track:
                    self.on_track(*tag, cell)
                if self.exit_on_success:
                    self.done = True
                    return

    def _maybe_rebase(self) -> None:
        """Shift stream coordinates down before int32 pos could overflow
        (every ~2^29 samples = ~4.7 min of stream).  Safe with dispatches
        in flight: outstanding outputs carry only per-step consumed deltas,
        never absolute positions."""
        if self._base < self.REBASE_AT:
            return
        delta = self.REBASE_AT
        if delta % 256:
            raise ValueError("REBASE_AT must be a multiple of 256")
        self._base -= delta
        self._pos_lb -= delta
        self._grid -= delta
        self._dev_base -= delta
        self._anchors = [deque((end - delta, t) for end, t in q)
                         for q in self._anchors]
        self._state = self._state._replace(pos=self._state.pos - delta)

    # ---- checkpoint -----------------------------------------------------
    def _state_arrays(self) -> dict:
        """The carry as {"state_<field>": numpy array}, the checkpoint keys
        of both packages."""
        return {f"state_{k}": v
                for k, v in trig.state_to_numpy(self._state).items()}

    def _restore(self, data, bufs: list, rows: slice = slice(None)) -> None:
        """Take the carry, the stream base and the threshold from an open
        checkpoint, with `bufs` the per-stream buffered samples; `rows`
        picks this pipeline's streams from a checkpoint of more."""
        self._state = trig.state_from_numpy(
            {k[len("state_"):]: data[k][rows] for k in data.files
             if k.startswith("state_")}, self.device)
        # no dispatch outstanding after load: drained positions are exact
        self._pos_lb = np.asarray(data["state_pos"][rows]).astype(np.int64)
        self._grid = int(self._pos_lb.min())
        self._outstanding.clear()
        for q in self._anchors:     # arrival times are not checkpointed:
            q.clear()               # events after resume stamp at drain time
        self._dev = None
        self._dev_len = 0
        self._bufs = [ChunkBuffer(b) for b in bufs]
        self._base = int(data["base"])
        self.psr_threshold = float(data["psr_threshold"])
        self._any_tracking = self.tracking.reshape(self.n, -1).any(axis=1)
        self._max_score = self.tracking_score.reshape(self.n, -1) \
            .max(axis=1).astype(np.int64)


class Trigger(_StreamPipeline):
    """Streaming detector with the reference hier-block's surface.

    Feed arbitrary-size chunks of 1.92 Msps complex64 via process(); track /
    drop events flow into the attached CellStore.  Telemetry properties
    mirror the pss block query API polled by the reference's GRC demos.
    Runs on `device` ("cuda" by default; raises if CUDA is absent).

    Transport: host-to-device samples default to per-segment int16
    quantization ("i16", ~84 dB SNR; results can differ in the last bits
    from a float32 run and depend mildly on chunking via the per-segment
    scale); "i8" quarters the bytes (~36 dB, still 26 dB above the
    detection knee); "f32" is bit-exact.

    Event delivery is ASYNCHRONOUS by default (`pipeline=2`): scans are
    dispatched ahead and their outputs drained when they have arrived.
    Call flush() to force every pending event out (checkpointing does this
    implicitly), or construct with pipeline=0 for fully synchronous
    per-call semantics.  exit_on_success implies synchronous calls (the
    searcher use case wants the answer before returning).
    """

    def __init__(self, psr_threshold: float = DEFAULT_PSR_THRESHOLD,
                 exit_on_success: bool = False,
                 track_after: int = DEFAULT_TRACK_AFTER,
                 track_every: int = DEFAULT_TRACK_EVERY,
                 cellstore: Optional[CellStore] = None,
                 on_track: Optional[Callable[[Cell], None]] = None,
                 on_drop: Optional[Callable[[int], None]] = None,
                 pipeline: int = 2, transport: str = "i16",
                 cfo_search_range: int = 0, device="cuda"):
        super().__init__((), psr_threshold, track_after, track_every,
                         [cellstore if cellstore is not None
                          else CellStore()],
                         on_track, on_drop, pipeline, transport,
                         cfo_search_range, device)
        self.exit_on_success = exit_on_success

    @property
    def cellstore(self) -> CellStore:
        return self.stores[0]

    @property
    def backlog(self) -> int:
        """Samples fed but not yet scanned.  A producer pacing itself at
        real time never grows this; a faster-than-pipeline producer should
        throttle on it (the host buffer is unbounded by design: dropping
        samples is the APP's decision, not the detector's)."""
        return int(self._backlog()[0])

    def process(self, samples: np.ndarray) -> list[Cell]:
        """Consume a chunk of complex64 at 1.92 Msps; returns cells whose
        publish events drained during this call (with pipeline > 0 an event
        may surface on a LATER call; flush() forces everything out)."""
        if self.done:
            return []
        self._feed(0, samples, time.time())
        published: list[Cell] = []
        self._maybe_rebase()
        self._pump(published,
                   flush_mode=(self.pipeline == 0 or self.exit_on_success))
        return published

    def save_state(self, path: str) -> None:
        """Checkpoint the full streaming state (carry + buffered samples) so
        a long-running monitor can resume after restart.  Flushes pending
        dispatches first so the checkpoint is self-consistent.  The keys are
        the JAX package's: either package loads the other's file."""
        self.flush()
        np.savez(path, buf=self._bufs[0].to_array(), base=self._base,
                 psr_threshold=self.psr_threshold, done=self.done,
                 cfo_bin=int(self._cfo_bins[0]), **self._state_arrays())

    def load_state(self, path: str) -> None:
        with np.load(path) as data:
            self._restore(data, [data["buf"]])
            self.done = bool(data["done"])
            self._cfo_bins[:] = int(data["cfo_bin"]) \
                if "cfo_bin" in data else 0
