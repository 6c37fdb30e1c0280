"""Multi-channel scan-out.

Port of `channel_scan` of ltetrigger_tpu/parallel/sharded.py, on one device:
C independent monitored channels ride as the leading batch axis of every
tensor of the scan engine, which preserves the full streaming state-machine
semantics per channel.  Sharding the channel axis over several devices
(`mesh=`) and `time_sharded_scan` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ltecore.constants import DEFAULT_TRACK_AFTER, DEFAULT_TRACK_EVERY
from ..models import trigger as trig
from ..ops import cplx
from ..ops.device import resolve_device


def channel_scan(buffers: cplx.Pair, n_steps: int, psr_threshold: float,
                 track_after: int = DEFAULT_TRACK_AFTER,
                 track_every: int = DEFAULT_TRACK_EVERY,
                 states=None, combine: bool = True, device="cuda"):
    """Run the scan engine over C channels.

    buffers: pair of [C, N] float32, each padded like trigger.scan_engine
             expects (LOOKBACK zero head + WINDOW tail): tensors, scanned on
             the device they are on, or numpy arrays, uploaded to `device`
             ("cuda" by default; raises if CUDA is absent).
    states:  optional [C, ...] TriggerState carry from a previous call
             (fresh init per channel if None).
    returns: (final_states [C, ...], StepOutput [n_steps, C, R, ...])

    Fresh states start at the static grid origin, so the engine gets the
    grid start as a host integer and does not read it back from the device;
    with a carried state it does (one host sync, `trigger.host_syncs`).
    """
    if not isinstance(buffers[0], torch.Tensor):
        dev = resolve_device(device)
        buffers = tuple(torch.from_numpy(
            np.ascontiguousarray(b, np.float32)).to(dev) for b in buffers)
    fresh = states is None
    if fresh:
        states = trig.init_state(batch=(buffers[0].shape[0],),
                                 device=buffers[0].device)
    return trig.scan_engine(buffers, states, n_steps, psr_threshold,
                            track_after, track_every, combine=combine,
                            grid0=trig.LOOKBACK if fresh else None)
