"""Scaling out over channels.  `channel_scan` runs on one device; the mesh
and the time-sharded scan of the JAX package's `parallel/` are not ported
yet."""

from .sharded import channel_scan

__all__ = ["channel_scan"]
