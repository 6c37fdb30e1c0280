"""High-level detection API: the one-shot `search`.

Port of the one-shot half of ltetrigger_tpu/models/api.py: resample to
1.92 Msps -> scan_engine in chunks -> drain track/drop events into a
CellStore.  The streaming `Trigger` is not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional

import numpy as np
import torch

from ..ltecore.constants import (DEFAULT_PSR_THRESHOLD,
                                 DEFAULT_TRACK_AFTER,
                                 DEFAULT_TRACK_EVERY,
                                 HALF_FRAME_LENGTH,
                                 MIN_PSR_THRESHOLD, SAMPLE_RATE)
from ..runtime.cellstore import Cell, CellStore, cell_from_step
from ..utils.profiling import StageTimer
from ..ops import cplx, resample
from . import trigger as trig

LOOKBACK = trig.LOOKBACK
WINDOW = trig.WINDOW


def ensure_safe_threshold(t: float) -> float:
    """Clamp to MIN_PSR_THRESHOLD (parity: downlink_trigger_c.py:10,71-73)."""
    return t if t > MIN_PSR_THRESHOLD else MIN_PSR_THRESHOLD


def resolve_device(device) -> torch.device:
    """The device to run on; raises if CUDA is asked for and absent (the
    port never continues on the CPU in its place)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but "
                           "torch.cuda.is_available() is False")
    return dev


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
    """
    if cfo_search_range > 0:
        raise NotImplementedError(
            "cfo_search_range > 0 (the integer-CFO probe) is not ported yet: "
            "see ROADMAP.md, 'Modules to port', the CFO probe")
    dev = resolve_device(device)
    psr_threshold = ensure_safe_threshold(psr_threshold)
    timer = timer if timer is not None else StageTimer()
    with timer.stage("prepare"):
        total = int(max_seconds * SAMPLE_RATE)
        buffer = _prepare_buffer(iq, sample_rate, repeat_to=total, device=dev)
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
