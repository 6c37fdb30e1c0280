"""Choosing the device, and host-to-device copies that do not wait for it.

`resolve_device` is the port's one rule for `device=` arguments: a card that
was asked for and is absent raises; nothing continues on the CPU in its place.

A copy from pageable host memory (`torch.from_numpy(a).to(dev)`,
`torch.tensor(list, device=dev)`) is followed by a stream synchronize, which
ends every overlap between the host and the card.  The streaming paths
therefore fill a pinned staging tensor and copy it with `non_blocking=True`.
Each call takes a fresh pinned tensor: PyTorch's caching host allocator hands
a freed pinned block out again only after the copies that read it have run.
"""

from __future__ import annotations

import numpy as np
import torch


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
