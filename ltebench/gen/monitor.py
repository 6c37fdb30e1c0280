"""Carrier loops of the live monitor cells: one loop a stream, a whole
number of 40-ms TTIs, made from the run's seed.

A mix file holds `traffic.py`'s keys and adds:

  keyed     streams whose cell is on air only for the first `keyed_on`
            share of each loop (noise alone for the rest)
  vacant    streams that carry noise alone
  keyed_on  the share of the loop a keyed stream's cell is on air

The roles fall on streams drawn from the seed; the other streams are
steady (their cell on air for the whole loop).  Each carrier offset is
rounded to a multiple of 1 / loop_seconds Hz, so that its phase runs on
across the loop's seam (at 8 streams and 2-s loops the spread offsets are
such multiples already).  A loop is the cell of `traffic.signals` (its TTI
tiled from its start, offset, unit power) times its on-air mask, plus the
noise `traffic.signals` draws for the same seed; it is made on `device`
and handed over in pageable host memory, as a source's ring buffer would.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import cells as cellmod
from . import traffic as gen
from .ltecore.constants import SAMPLE_RATE


def loop_samples(cfg: dict) -> int:
    """The samples of one loop: a whole number of TTIs and of chunks."""
    n = int(round(float(cfg["loop_seconds"]) * SAMPLE_RATE))
    if n % cellmod.TTI_LENGTH or n % int(cfg["chunk_samples"]):
        raise ValueError(f"a loop of {n} samples is not a whole number of "
                         f"40-ms TTIs and of chunks")
    return n


def draw(mix: dict, cfg: dict, seed: int) -> list:
    """One planted cell a stream (`traffic.draw_cells`), each with its
    `role`: "steady", "keyed" or "vacant" (cell id -1)."""
    n = int(cfg["streams"])
    rng = gen.rng_for(seed)
    cells = gen.draw_cells(mix, rng, n)
    order = rng.permutation(n).tolist()
    k, v = int(mix.get("keyed", 0)), int(mix.get("vacant", 0))
    roles = ["steady"] * n
    for i in order[:k]:
        roles[i] = "keyed"
    for i in order[k:k + v]:
        roles[i] = "vacant"
    step = 1.0 / float(cfg["loop_seconds"])
    out = []
    for cell, role in zip(cells, roles):
        c = dict(cell, role=role, cfo_hz=round(cell["cfo_hz"] / step) * step)
        if role == "vacant":
            c["cell_id"] = -1
        out.append(c)
    return out


def loops(cells: list, cfg: dict, mix: dict, seed: int,
          device) -> np.ndarray:
    """[streams, loop_samples] complex64 in host memory."""
    n = loop_samples(cfg)
    on = int(round(float(mix.get("keyed_on", 1.0)) * n))
    cell = gen.signals([dict(c, snr_db=math.inf) for c in cells], n, seed,
                       device)
    noise = gen.signals([dict(c, cell_id=-1) for c in cells], n, seed,
                        device)
    keyed = torch.tensor([c["role"] == "keyed" for c in cells],
                         device=device)[:, None]
    off = keyed & (torch.arange(n, device=device) >= on)[None]
    cell[off.expand_as(cell)] = 0
    cell += noise
    del noise
    return cell.cpu().numpy()
