"""Choosing the device, and host-to-device copies that do not wait for it.

`resolve_device` is the port's one rule for `device=` arguments: a card that
was asked for and is absent raises; nothing continues on the CPU in its place.

A copy from pageable host memory (`torch.from_numpy(a).to(dev)`,
`torch.tensor(list, device=dev)`) is followed by a stream synchronize, which
ends every overlap between the host and the card.  The streaming paths
therefore fill a pinned staging tensor and copy it with `non_blocking=True`.
Each call takes a fresh pinned tensor: PyTorch's caching host allocator hands
a freed pinned block out again only after the copies that read it have run.

A large array that sits in pageable memory (the channelizer's wide capture,
hundreds of MB a call) goes through `upload_float32` instead: a fixed ring of
RING_SLABS pinned slabs a device, allocated on first use and then reused,
each with the CUDA event of the last copy that read it.  The host fills one
slab while the card copies the others, so the host's copy and the card's
overlap, and the pinned memory stays at RING_SLABS slabs however large the
array is.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

RING_SLABS = 3      # pinned slabs of a device's upload ring


def resolve_device(device) -> torch.device:
    """The device to run on; raises if CUDA is asked for and absent (the
    port never continues on the CPU in its place)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but "
                           "torch.cuda.is_available() is False")
    return dev


def staging(shape, np_dtype, device) -> tuple[torch.Tensor, np.ndarray]:
    """A host tensor to fill and then copy to `device`, with its numpy view.
    For a card it is pinned, so the copy can be `non_blocking`; a pageable
    source would make the copy wait for everything queued before it."""
    dtype = torch.from_numpy(np.empty(0, np_dtype)).dtype
    t = torch.empty(tuple(shape), dtype=dtype,
                    pin_memory=torch.device(device).type == "cuda")
    return t, t.numpy()


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> tensor on `device` through a staging tensor, without
    waiting for the device."""
    t, view = staging(a.shape, a.dtype, device)
    view[...] = a
    return t.to(device, non_blocking=True)


class _SlabRing:
    """RING_SLABS host slabs of one device and slab size (pinned for a
    card), each with the event recorded after the last copy that read it."""

    def __init__(self, device: torch.device, slab_bytes: int):
        pin = device.type == "cuda"
        self.slots = [(torch.empty(slab_bytes // 4, dtype=torch.float32,
                                   pin_memory=pin),
                       torch.cuda.Event() if pin else None)
                      for _ in range(RING_SLABS)]
        self.lock = threading.Lock()


_rings: dict = {}
_rings_lock = threading.Lock()


def _ring(device: torch.device, slab_bytes: int) -> _SlabRing:
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _rings_lock:
        key = (device, slab_bytes)
        if key not in _rings:
            _rings[key] = _SlabRing(device, slab_bytes)
        return _rings[key]


def upload_float32(a: np.ndarray, device, slab_bytes: int) -> torch.Tensor:
    """A contiguous 1-D float32 numpy array -> a new tensor on `device`,
    staged through the device's ring of pinned slabs of `slab_bytes` (a
    multiple of 4).  For each slab's worth of `a`: wait for the copy that
    last read the slab, fill the slab on the host (a threaded `copy_`),
    copy it to the device with `non_blocking=True` and record the slab's
    event.  Returns when `a` has been read, before the last copies have run
    on the card; they are ordered before what the caller queues next."""
    if slab_bytes <= 0 or slab_bytes % 4:
        raise ValueError(f"slab_bytes {slab_bytes}: a positive multiple of 4")
    if a.dtype != np.float32 or a.ndim != 1 or not a.flags.c_contiguous:
        raise ValueError(f"a: {a.dtype} {a.shape}; contiguous 1-D float32")
    dev = torch.device(device)
    ring = _ring(dev, slab_bytes)
    words = slab_bytes // 4
    src = torch.from_numpy(a)
    dst = torch.empty(a.size, dtype=torch.float32, device=dev)
    with ring.lock:
        for k, lo in enumerate(range(0, a.size, words)):
            slab, event = ring.slots[k % len(ring.slots)]
            hi = min(lo + words, a.size)
            if event is not None:
                event.synchronize()
            slab[:hi - lo].copy_(src[lo:hi])
            dst[lo:hi].copy_(slab[:hi - lo], non_blocking=True)
            if event is not None:
                event.record(torch.cuda.current_stream(dev))
    return dst
