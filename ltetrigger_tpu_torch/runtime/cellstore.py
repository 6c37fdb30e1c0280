"""Thread-safe tracked-cell registry.

Host-side replacement for the reference's cellstore block
(lib/cellstore_impl.cc): `track`/`drop` message sinks become method calls fed
by the detection engine's event stream; the query API (tracking / cells /
latest_cell) is identical so GUI-probe-style polling keeps working.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class Cell:
    """The published cell record — field-for-field the reference's PMT dict
    schema (lib/mib_impl.cc:185-251, README.rst:97-104)."""
    cell_id: int
    nof_tx_ports: int
    cp_len: str                 # "Normal" | "Extended"
    nof_prb: int
    phich_len: str              # "Normal" | "Extended"
    nof_phich_resources: str    # "1/6" | "1/2" | "1" | "2"
    sfn_offset: int
    tracking_start_time: int = field(default_factory=lambda: int(time.time()))

    def to_dict(self) -> dict:
        return {
            "cell_id": self.cell_id,
            "nof_tx_ports": self.nof_tx_ports,
            "cp_len": self.cp_len,
            "nof_prb": self.nof_prb,
            "phich_len": self.phich_len,
            "nof_phich_resources": self.nof_phich_resources,
            "sfn_offset": self.sfn_offset,
            "tracking_start_time": self.tracking_start_time,
        }


PHICH_RES_STR = ("1/6", "1/2", "1", "2")


def cell_from_step(cell_id, nof_prb, nof_ports, phich_ext, phich_res,
                   sfn_offset, normal_cp, timestamp: Optional[int] = None
                   ) -> Cell:
    """Build a Cell from the trigger step's integer event fields."""
    kw = {}
    if timestamp is not None:
        kw["tracking_start_time"] = int(timestamp)
    return Cell(
        cell_id=int(cell_id),
        nof_tx_ports=int(nof_ports),
        cp_len="Normal" if normal_cp else "Extended",
        nof_prb=int(nof_prb),
        phich_len="Extended" if phich_ext else "Normal",
        nof_phich_resources=PHICH_RES_STR[int(phich_res)],
        sfn_offset=int(sfn_offset),
        **kw,
    )


class CellStore:
    """Mutex-guarded list of tracked cells (parity: cellstore_impl.cc:60-105,
    including the unbounded append the reference's '3 cells' doc overstates)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cells: list[Cell] = []

    # message-sink equivalents -------------------------------------------
    def track_cell(self, cell: Cell) -> None:
        if not isinstance(cell, Cell):
            raise TypeError("Error tracking cell: bad message format")
        with self._lock:
            self._cells.append(cell)

    def drop_cell(self, cell: Cell) -> None:
        with self._lock:
            try:
                self._cells.remove(cell)
            except ValueError:
                pass  # parity: std::list::remove of a missing item is a no-op

    def drop_cell_id(self, cell_id: int) -> None:
        """Convenience: drop the most recent record for a cell id."""
        with self._lock:
            for i in range(len(self._cells) - 1, -1, -1):
                if self._cells[i].cell_id == cell_id:
                    del self._cells[i]
                    return

    # query API ----------------------------------------------------------
    def tracking(self) -> bool:
        with self._lock:
            return bool(self._cells)

    def cells(self) -> list[Cell]:
        with self._lock:
            return list(self._cells)

    def latest_cell(self) -> Optional[Cell]:
        with self._lock:
            return self._cells[-1] if self._cells else None
