"""parallel: the process mesh (one process per device) and the sharded
multi-channel / multi-device scans."""

from .mesh import (Mesh, gather_events, init_distributed,  # noqa: F401
                   make_mesh)
from .sharded import (channel_scan, halo_exchange_right,  # noqa: F401
                      time_sharded_scan)

__all__ = ["Mesh", "make_mesh", "init_distributed", "channel_scan",
           "time_sharded_scan", "halo_exchange_right", "gather_events"]
