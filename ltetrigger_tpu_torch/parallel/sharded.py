"""Sharded detection: multi-channel scan-out and time-sharded streams.

Port of ltetrigger_tpu/parallel/sharded.py onto the process mesh of
`parallel/mesh.py` (one process per device).  The calling convention,
everywhere: EVERY RANK RUNS THE SAME CALL WITH THE SAME GLOBAL ARGUMENTS and
gets the same global result; a rank uploads and computes only its slice.

Two scaling patterns:

  1. channel_scan: C independent monitored channels, sharded over the mesh
     `ch` axis.  The channels ride as the leading batch axis of every tensor
     of the scan engine, which preserves the full streaming state-machine
     semantics per channel; the scan itself communicates nothing, and one
     all_gather at its end hands every rank the global output.

  2. time_sharded_scan: ONE stream split into D contiguous time blocks
     (mesh `t` axis), each block scanned independently after a halo exchange
     (one ring hop) hands every shard the WINDOW-sized head of its right
     neighbour, so no peak is lost at a seam.  Tracking state does not cross
     seams (each block acquires independently): the offline wide-area scan
     trade-off, documented here rather than hidden.

Seam-state design choice (deliberate): carrying TriggerState across seams
would make shard k+1 data-depend on shard k's final carry, serializing the
scan into a device-count-long sequential chain, exactly the wall-clock the
`t` axis exists to remove.  Independent acquisition costs only re-detection
latency inside each block: publishing a cell needs ONE over-threshold
half-frame with valid SSS + MIB CRC (tracking hysteresis gates telemetry
and loss events, not first publication), so any shard holding >= 1 clean
subframe-0 half-frame detects on its own, and the adversarial seam cases
are covered by halo width (tests/test_torch_parallel.py seam cases).
Streams needing continuous tracking state belong on the `ch` axis (one
stream per lane) or in the host-driven api.Trigger, both of which carry
state forever.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ltecore.constants import DEFAULT_TRACK_AFTER, DEFAULT_TRACK_EVERY
from ..models import trigger as trig
from ..ops import correlate, cplx
from ..ops.device import resolve_device
from ..utils import profiling
from . import mesh as meshmod
from .mesh import Mesh


def _rows(x, lo: int, hi: int, device) -> torch.Tensor:
    """Rows [lo, hi) of a global array, on `device`: a numpy array is cut on
    the host and only the cut is uploaded."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x[lo:hi], np.float32))
        lo, hi = 0, x.shape[0]
    return x[lo:hi].to(device)


def _gather_state(state: trig.TriggerState, mesh: Mesh) -> trig.TriggerState:
    """The [C_local, ...] carries of every rank along `ch` as one [C, ...]
    carry: all fields travel as bytes in ONE all_gather."""
    rows = state.pos.shape[0]
    flat = [getattr(state, f).contiguous().reshape(rows, -1)
            .view(torch.uint8) for f in state._fields]
    packed = meshmod.all_gather(torch.cat(flat, dim=1), mesh, "ch", dim=0)
    out, at = {}, 0
    for f, part in zip(state._fields, flat):
        t = getattr(state, f)
        col = packed[:, at:at + part.shape[1]].contiguous().view(t.dtype)
        out[f] = col.reshape((packed.shape[0],) + t.shape[1:])
        at += part.shape[1]
    return trig.TriggerState(**out)


# --------------------------------------------------------- channel scan ----
def channel_scan(buffers: cplx.Pair, n_steps: int, psr_threshold: float,
                 mesh: Mesh | None = None,
                 track_after: int = DEFAULT_TRACK_AFTER,
                 track_every: int = DEFAULT_TRACK_EVERY,
                 states=None, combine: bool = True, device="cuda"):
    """Run the scan engine over C channels, sharded over `ch`.

    buffers: pair of [C, N] float32, each padded like trigger.scan_engine
             expects (LOOKBACK zero head + WINDOW tail): tensors, scanned on
             the device they are on, or numpy arrays, uploaded to `device`
             ("cuda" by default; raises if CUDA is absent).
    mesh:    with a mesh, a collective: every rank calls it with the same
             global buffers (and states), takes rows `mesh.local_slice(C)`
             to `mesh.device`, scans them, and gets the global result.
             Ranks along `t` repeat the work of their `ch` row.
    states:  optional [C, ...] TriggerState carry from a previous call
             (fresh init per channel if None).
    returns: (final_states [C, ...], StepOutput [n_steps, C, R, ...])

    Fresh states start at the static grid origin, so the engine gets the
    grid start as a host integer and does not read it back from the device;
    with a carried state it does (one host sync, `trigger.host_syncs`).
    Each call is a call of the spans (`utils.profiling.call`: a new call
    id unless it runs inside another call) and opens the span
    "channel_scan".
    """
    c = buffers[0].shape[0]
    lo, hi = (0, c) if mesh is None else mesh.local_slice(c)
    if mesh is not None:
        dev = mesh.device
    elif isinstance(buffers[0], torch.Tensor):
        dev = buffers[0].device
    else:
        dev = resolve_device(device)
    with profiling.call(), profiling.span("channel_scan", device=dev):
        local = tuple(_rows(b, lo, hi, dev) for b in buffers)
        fresh = states is None
        if fresh:
            states = trig.init_state(batch=(hi - lo,),
                                     device=local[0].device)
        elif mesh is not None:
            states = trig.TriggerState(*(s[lo:hi].to(local[0].device)
                                         for s in states))
        states, out = trig.scan_engine(local, states, n_steps, psr_threshold,
                                       track_after, track_every,
                                       combine=combine,
                                       grid0=trig.LOOKBACK if fresh else None)
        if mesh is None:
            return states, out
        packed = meshmod.all_gather(trig.pack_output(out), mesh, "ch", dim=1)
        return _gather_state(states, mesh), trig.unpack_output_tensors(packed)


# ----------------------------------------------------- time-sharded scan ---
def halo_exchange_right(x_local: torch.Tensor, halo: int, mesh: Mesh,
                        axis: str = "t") -> torch.Tensor:
    """Append the first `halo` samples of the right neighbour's block.

    x_local [B] -> [B + halo].  The last shard receives zeros (stream end).
    A collective along `axis` (one ring hop); no communication when the
    axis has size 1."""
    n, idx = mesh.shape[axis], mesh.coords[axis]
    head = x_local[:halo]
    if n == 1:
        return torch.cat([x_local, torch.zeros_like(head)])
    # send my head to my LEFT neighbour (so I receive my right neighbour's)
    recv = meshmod.ring_recv_right(head, mesh, axis)
    if idx == n - 1:
        recv = torch.zeros_like(recv)
    return torch.cat([x_local, recv])


def time_sharded_scan(stream: cplx.Pair, mesh: Mesh, psr_threshold: float,
                      track_after: int = DEFAULT_TRACK_AFTER,
                      track_every: int = DEFAULT_TRACK_EVERY):
    """Scan one long stream with time blocks sharded over the `t` axis.

    stream: pair of [N] float32 (unpadded), numpy arrays or tensors.  N must
    divide evenly by the t-axis size; pad the tail with zeros beforehand if
    needed.  A collective: every rank calls it with the same stream, takes
    its own block to `mesh.device` and scans it; ranks along `ch` repeat the
    work of their `t` column.
    returns StepOutput stacked [t_shards, steps_per_shard, R, ...] on every
    rank.
    """
    n_t, idx = mesh.shape["t"], mesh.coords["t"]
    assert stream[0].shape[0] % n_t == 0
    block = stream[0].shape[0] // n_t
    assert block % trig.HALF_FRAME_LENGTH == 0, (
        "pad the stream so each time block is a half-frame multiple — the "
        "grid engine searches in exact 9600-sample tiles")
    halo = trig.WINDOW
    steps = block // trig.HALF_FRAME_LENGTH
    zh = torch.zeros(trig.LOOKBACK, device=mesh.device)
    zt = torch.zeros(trig.WINDOW, device=mesh.device)
    buf = tuple(torch.cat([
        zh, halo_exchange_right(
            _rows(comp, idx * block, (idx + 1) * block, mesh.device),
            halo, mesh), zt]) for comp in stream)
    # logical end: exactly the grid steps whose 9600 candidate starts lie
    # inside this block are active (active <=> grid + V2_WINDOW <= n_valid
    # <=> 9600*(k+1) <= block), so each stream position is owned by exactly
    # one shard; the halo exists so windows reaching past the seam stay
    # valid.
    n_valid = trig.LOOKBACK + block + (correlate.V2_WINDOW
                                       - trig.HALF_FRAME_LENGTH)
    _, out = trig.scan_engine(buf, trig.init_state(device=mesh.device), steps,
                              psr_threshold, track_after, track_every,
                              n_valid=n_valid, grid0=trig.LOOKBACK,
                              # candidate reads may reach into the halo:
                              # data extends past the owned span
                              data_valid=trig.LOOKBACK + block + halo)
    packed = meshmod.all_gather(trig.pack_output(out)[None], mesh, "t", dim=0)
    return trig.unpack_output_tensors(packed)
