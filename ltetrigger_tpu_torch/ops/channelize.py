"""Wideband channelizer: one wide capture -> many 1.92 Msps sensing lanes.

Port of ltetrigger_tpu/ops/channelize.py.  Frequency-shift the wideband
stream to each candidate centre, low-pass + decimate, and hand the [C, N]
channel batch to the scan engine (parallel.channel_scan) or, segment by
segment, to the streaming mirror (models/wideband.WidebandTrigger).

Mixing runs on the device.  The mixer phase 2*pi*f*n needs |phase mod 1|
precision far beyond float32 at n in the tens of millions, so the phase is
decomposed:
  n = b*BLOCK + m,   phase(n) = origin[b] + ramp[m]   (each mod 1)
with the [C, n_blocks] origins and the [C, BLOCK] ramp computed mod 1 on
the host (tiny tables: the ramp in float64, the origins in integer
arithmetic for whole-Hz centres at a whole-Hz rate and in float64
otherwise), and the O(C*N) work (broadcast add, cos/sin, complex multiply,
anti-alias decimation) on the device.  Per-value phase error is <= 2^-24
cycles, orders below the channel noise floor.

The context (BLOCK samples each side, far exceeding the 16*ratio filter
span) keeps the decimator's filter transients out of the output.  On a
card the mixer and the decimator are one hand-written kernel over the whole
segment (ops/kernels/channelize.py, csrc/channelize.cu), which folds the
mixer into the taps and rotates at the narrow rate.  On the CPU the stream
is processed in overlap-trimmed chunks, so that only one chunk's rotation
intermediates live at a time: the JAX package runs the chunks as one
`lax.scan` of a fixed shape; here they are a Python loop (the kernel's
plain version), and the last chunk may be short.

A numpy capture reaches a card as it lies in memory (`upload_padded`): the
complex64 samples viewed as interleaved float32, with no host copy (any
other dtype or layout is cast to contiguous complex64 once), staged through
the device's fixed ring of pinned slabs (`device.upload_float32`, SLAB_BYTES
a slab), then split into re and im on the card straight into the padded
pair.  On the CPU the capture is split on the host (`cplx.from_numpy`) and
padded.

Spans (`utils.profiling.span`, recorded only under a profiler): "channelize"
around `channelize`, "channelize.upload" around a numpy capture's upload
(on a card the view, the ring and the split into the padded pair; on the
CPU the host split), "channelize.mix" around the mixer and decimator (the
kernel's launch, or the chunk loop), the three with a CUDA event pair on a
card.  `counts` counts the chunks the plain loop ran ("chunks", the
streaming front end's included; a card's call adds none, and one launch to
`kernels.channelize.launches`), the bytes `channelize` uploaded
("upload_bytes", 8 a sample) and the slabs the ring staged ("upload_slabs",
ceil(8 n / SLAB_BYTES) a card's call; none on the CPU).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..ltecore.constants import SAMPLE_RATE
from ..utils.profiling import span
from . import cplx
from .device import resolve_device, to_device, upload_float32
from .kernels import channelize as kchan
from .kernels.channelize import BLOCK, CHUNK_BLOCKS

SLAB_BYTES = 16 << 20   # a slab of the upload ring

# "chunks" run, "upload_bytes" uploaded, "upload_slabs" staged
counts = collections.Counter()


def shift_host(x: np.ndarray, sample_rate: float, offset_hz: float,
               start_index: int = 0) -> np.ndarray:
    """Frequency-shift a complex64 stream by -offset_hz (host, f64 phase).

    Reference implementation for tests; the scan path mixes on device."""
    f = float(offset_hz) / float(sample_rate)
    n = np.arange(start_index, start_index + x.size, dtype=np.float64)
    ph = np.mod(-f * n, 1.0)
    rot = np.exp(2j * np.pi * ph)
    return (x.astype(np.complex128) * rot).astype(np.complex64)


def _phase_tables(offsets_hz, rate: float, start: int, nb: int) \
        -> np.ndarray:
    """Block origins -> [C, nb] f32: the mod-1 phase -f n / rate of each
    centre f (Hz) at n = start + BLOCK b.  Centres of whole Hz at a whole-Hz
    rate take integer arithmetic, ((-f n) mod rate) / rate rounded once to
    f32: exact at any n, and the same wherever n mod rate is, so a stream's
    origins lose no bits as its index grows and repeat wherever its centres'
    phases do.  Other centres take f64 mod 1 (the JAX package's tables)."""
    offs = np.asarray(offsets_hz, dtype=np.float64)
    if float(rate).is_integer() and np.all(offs == np.round(offs)):
        r = int(rate)
        n = (int(start) % r + BLOCK * np.arange(nb, dtype=np.int64)) % r
        return ((-offs.astype(np.int64)[:, None] * n[None, :]) % r / r) \
            .astype(np.float32)
    n = start + BLOCK * np.arange(nb, dtype=np.float64)
    return np.mod(-(offs / rate)[:, None] * n[None, :], 1.0) \
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
    """Mix one wide segment to C centres and decimate it.

    xpad:    pair of [BLOCK + L + BLOCK] float32: the payload with one
             context block before it and at least one after it
    origins: [C, >= ceil(len(xpad) / BLOCK)] f32 mod-1 phase at the start of
             each BLOCK of xpad (`_phase_tables` at xpad[0]'s index)
    ramps:   [C, BLOCK] f32 mod-1 in-block phase ramp
    n_out:   narrow samples to produce, <= L // ratio
    returns: pair of [C, n_out]; output n sits at payload sample n * ratio

    On a CPU pair the plain chunk loop (`kernels.channelize.
    channelize_plain`, chunk_blocks payload blocks a chunk, counted in
    counts["chunks"]); on a CUDA pair the hand-written kernel, one launch
    for the whole segment (`kernels.channelize.channelize_kernel`; it takes
    the ratios that divide BLOCK and raises on any other).

    Also the compute core of the streaming wideband front end, which feeds
    segments whose context blocks are real stream samples instead of zero
    padding."""
    if xpad[0].device.type == "cpu":
        counts["chunks"] += kchan.n_chunks(n_out, ratio, chunk_blocks)
        return kchan.channelize_plain(xpad, origins, ramps, ratio, n_out,
                                      chunk_blocks)
    return kchan.channelize_kernel(xpad, origins, ramps, ratio, n_out)


def upload_padded(x: np.ndarray, device,
                  slab_bytes: int = SLAB_BYTES) -> cplx.Pair:
    """A numpy capture [n] -> the padded pair of [BLOCK + n + BLOCK] float32
    on `device` (zero context blocks a side), the values of
    `cplx.from_numpy` then a pad of BLOCK zeros a side.

    The capture crosses as interleaved float32 (8 bytes a sample): a
    C-contiguous complex64 array is viewed as it is; any other is first
    made one by one cast.  It goes through the device's ring of pinned
    slabs of `slab_bytes` (`device.upload_float32`; counted in
    counts["upload_slabs"]), then its even and odd words are copied on the
    device into the pair's re and im payload."""
    inter = np.ascontiguousarray(x, np.complex64).reshape(-1) \
        .view(np.float32)
    n = inter.size // 2
    flat = upload_float32(inter, device, slab_bytes)
    counts["upload_slabs"] += -(-inter.nbytes // slab_bytes)
    xpad = torch.empty((2, BLOCK + n + BLOCK), dtype=torch.float32,
                       device=flat.device)
    xpad[:, :BLOCK].zero_()
    xpad[:, BLOCK + n:].zero_()
    xpad[:, BLOCK:BLOCK + n].copy_(flat.view(n, 2).t())
    return xpad[0], xpad[1]


def channelize(x, sample_rate: float, center_offsets_hz,
               device="cuda") -> cplx.Pair:
    """Wideband stream -> pair of [C, N // ratio] float32 at 1.92 Msps.

    x: complex64 [N] numpy array, uploaded to `device` ("cuda" by default;
    raises if CUDA is absent), or a (re, im) pair of tensors that is already
    on a device, which then is the device used (`device` is ignored).
    center_offsets_hz: frequencies (relative to the capture centre) to
    down-convert; each becomes a channel.  sample_rate must be an integer
    multiple of 1.92 MHz.

    Besides the samples, only the mod-1 phase tables ([C, n_blocks] and
    [C, BLOCK] f32) cross host -> device per call.  A numpy capture crosses
    to a card through a fixed ring of pinned slabs and is split there
    (`upload_padded`); it is read from the caller's array on every call.
    """
    ratio = _ratio(sample_rate)
    offs_hz = np.asarray(list(center_offsets_hz), dtype=np.float64)
    offs = offs_hz / sample_rate
    dev = x[0].device if isinstance(x, tuple) else resolve_device(device)
    with span("channelize", device=dev):
        uploaded = not isinstance(x, tuple)
        if uploaded and dev.type == "cuda":
            with span("channelize.upload", device=dev):
                xpad = upload_padded(x, dev)
        else:
            if uploaded:
                with span("channelize.upload", device=dev):
                    x = cplx.from_numpy(np.ascontiguousarray(x), dev)
            xpad = tuple(torch.nn.functional.pad(comp, (BLOCK, BLOCK))
                         for comp in x)
        n = int(xpad[0].shape[-1]) - 2 * BLOCK
        if uploaded:
            counts["upload_bytes"] += 8 * n
        # block-origin phases on the host (tiny): xpad[0] is sample -BLOCK
        origins = _phase_tables(offs_hz, sample_rate, -BLOCK,
                                -(-(n + 2 * BLOCK) // BLOCK))
        origins, ramps = to_device(origins, dev), to_device(_ramp_table(offs),
                                                            dev)
        with span("channelize.mix", device=dev):
            return _channelize_scan(xpad, origins, ramps, ratio, n // ratio)
