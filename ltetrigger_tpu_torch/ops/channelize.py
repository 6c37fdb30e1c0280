"""Wideband channelizer: one wide capture -> many 1.92 Msps sensing lanes.

Port of ltetrigger_tpu/ops/channelize.py.  Frequency-shift the wideband
stream to each candidate centre, low-pass + decimate, and hand the [C, N]
channel batch to the scan engine (parallel.channel_scan) or, segment by
segment, to the streaming mirror (models/wideband.WidebandTrigger).

Mixing runs on the device.  The mixer phase 2*pi*f*n needs |phase mod 1|
precision far beyond float32 at n in the tens of millions, so the phase is
decomposed:
  n = b*BLOCK + m,   phase(n) = origin[b] + ramp[m]   (each mod 1)
with the [C, n_blocks] origins and the [C, BLOCK] ramp computed mod 1 in
float64 on the host (tiny tables), and the O(C*N) work (broadcast add,
cos/sin, complex multiply, anti-alias decimation) on the device.  Per-value
phase error is <= 2^-24 cycles, orders below the channel noise floor.

The stream is processed in overlap-trimmed chunks so the decimator's filter
transients never land in the output (context = BLOCK samples each side, far
exceeding the 16*ratio filter span), and so that only one chunk's rotation
intermediates live at a time: the JAX package runs the chunks as one
`lax.scan` of a fixed shape; here they are a Python loop, and the last chunk
may be short.

Spans (`utils.profiling.span`, recorded only under a profiler): "channelize"
around `channelize`, "channelize.upload" around a numpy capture's split and
copy to the device, "channelize.mix" around the chunk loop, the three with a
CUDA event pair on a card.  `counts` counts the chunks the loop ran
("chunks", the streaming front end's included) and the bytes `channelize`
uploaded ("upload_bytes").
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from ..ltecore.constants import SAMPLE_RATE
from ..utils.profiling import span
from . import cplx, resample
from .device import resolve_device, to_device

BLOCK = 9600                 # phase-table block; also the chunk context
CHUNK_BLOCKS = 32            # blocks of payload per chunk

counts = collections.Counter()   # "chunks" run, "upload_bytes" uploaded


def shift_host(x: np.ndarray, sample_rate: float, offset_hz: float,
               start_index: int = 0) -> np.ndarray:
    """Frequency-shift a complex64 stream by -offset_hz (host, f64 phase).

    Reference implementation for tests; the scan path mixes on device."""
    f = float(offset_hz) / float(sample_rate)
    n = np.arange(start_index, start_index + x.size, dtype=np.float64)
    ph = np.mod(-f * n, 1.0)
    rot = np.exp(2j * np.pi * ph)
    return (x.astype(np.complex128) * rot).astype(np.complex64)


def _phase_tables(offsets_norm: np.ndarray, start: int, nb: int):
    """Mod-1 f64 phase decomposition -> (origins [C, nb] f32, at `start`)."""
    b = start + BLOCK * np.arange(nb, dtype=np.float64)
    return np.mod(-offsets_norm[:, None] * b[None, :], 1.0) \
        .astype(np.float32)


def _ramp_table(offsets_norm: np.ndarray) -> np.ndarray:
    """Mod-1 f64 in-block phase ramp -> [C, BLOCK] f32."""
    return np.mod(-offsets_norm[:, None]
                  * np.arange(BLOCK, dtype=np.float64)[None, :], 1.0) \
        .astype(np.float32)


def _ratio(sample_rate: float) -> int:
    ratio = sample_rate / SAMPLE_RATE
    if abs(ratio - round(ratio)) > 1e-9:
        raise ValueError("sample_rate must be an integer multiple of 1.92 MHz")
    return int(round(ratio))


def _channelize_scan(xpad: cplx.Pair, origins: torch.Tensor,
                     ramps: torch.Tensor, ratio: int, n_out: int,
                     chunk_blocks: int = CHUNK_BLOCKS) -> cplx.Pair:
    """Mix one wide segment to C centres and decimate it, chunk by chunk.

    xpad:    pair of [BLOCK + L + BLOCK] float32: the payload with one
             context block before it and at least one after it
    origins: [C, >= ceil(len(xpad) / BLOCK)] f32 mod-1 phase at the start of
             each BLOCK of xpad (`_phase_tables` at xpad[0]'s index)
    ramps:   [C, BLOCK] f32 mod-1 in-block phase ramp
    n_out:   narrow samples to produce, <= L // ratio
    returns: pair of [C, n_out]; output n sits at payload sample n * ratio

    Each chunk is chunk_blocks payload blocks plus one context block a side,
    with the context's share of the output (BLOCK // ratio samples) trimmed.
    BLOCK // ratio and the chunk's output count are exact only when the
    ratio divides 9600; any other ratio is floored silently, as in the JAX
    package.

    Also the compute core of the streaming wideband front end, which feeds
    segments whose context blocks are real stream samples instead of zero
    padding."""
    c = ramps.shape[0]
    chunk = chunk_blocks * BLOCK
    per = chunk // ratio
    trim = BLOCK // ratio
    outs = []
    n_chunks = -(-n_out // per) if n_out > 0 else 0
    counts["chunks"] += n_chunks
    for k in range(n_chunks):
        seg = cplx.index(xpad, slice(k * chunk, (k + 1) * chunk + 2 * BLOCK))
        lp = seg[0].shape[-1]
        b0 = k * chunk_blocks
        nb = -(-lp // BLOCK)
        ph = (origins[:, b0:b0 + nb, None] + ramps[:, None, :]) \
            .reshape(c, nb * BLOCK)[:, :lp]
        rot = cplx.expi((2 * math.pi) * ph)
        shifted = cplx.mul((seg[0][None, :], seg[1][None, :]), rot)
        d = resample.decimate(shifted, ratio)
        cnt = min(per, n_out - k * per)
        outs.append(cplx.index(d, (slice(None), slice(trim, trim + cnt))))
    if not outs:
        return cplx.zeros((c, 0), ramps.device)
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([o[0] for o in outs], dim=-1),
            torch.cat([o[1] for o in outs], dim=-1))


def channelize(x, sample_rate: float, center_offsets_hz,
               device="cuda") -> cplx.Pair:
    """Wideband stream -> pair of [C, N // ratio] float32 at 1.92 Msps.

    x: complex64 [N] numpy array, uploaded to `device` ("cuda" by default;
    raises if CUDA is absent), or a (re, im) pair of tensors that is already
    on a device, which then is the device used (`device` is ignored).
    center_offsets_hz: frequencies (relative to the capture centre) to
    down-convert; each becomes a channel.  sample_rate must be an integer
    multiple of 1.92 MHz.

    Only the mod-1 phase tables ([C, n_blocks] and [C, BLOCK] f32) cross
    host -> device per call besides the samples.
    """
    ratio = _ratio(sample_rate)
    offs = np.asarray(list(center_offsets_hz), dtype=np.float64) / sample_rate
    dev = x[0].device if isinstance(x, tuple) else resolve_device(device)
    with span("channelize", device=dev):
        if isinstance(x, tuple):
            xp = x
        else:
            with span("channelize.upload", device=dev):
                xp = cplx.from_numpy(np.ascontiguousarray(x), dev)
            counts["upload_bytes"] += 2 * xp[0].numel() * xp[0].element_size()
        n = int(xp[0].shape[-1])
        xpad = tuple(torch.nn.functional.pad(comp, (BLOCK, BLOCK))
                     for comp in xp)
        # block-origin phases, host f64 mod 1 (tiny): xpad[0] is sample -BLOCK
        origins = _phase_tables(offs, -BLOCK, -(-(n + 2 * BLOCK) // BLOCK))
        origins, ramps = to_device(origins, dev), to_device(_ramp_table(offs),
                                                            dev)
        with span("channelize.mix", device=dev):
            return _channelize_scan(xpad, origins, ramps, ratio, n // ratio)
