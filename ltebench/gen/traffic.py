"""The one traffic generator: reads a mix's parameters from
`ltebench/traffic/<mix>.json` and draws, from the run's seed, the planted
cells and their impairments.  The same draws go to the port and to the
reference.

A mix file holds:

  driver       the driver under `ltebench/drivers/` that plays the mix
  cell_id      [lo, hi] drawn uniformly, inclusive
  prb          the MIB bandwidth fields drawn from
  ports        the TX port counts drawn from
  normal_cp    the cyclic prefix (true: normal)
  snr_db       [lo, hi] a channel or stream, spread evenly over the range
               and shuffled (`strata`): signal power over the noise power
               of the whole 1.92-Msps band (the definition of
               `apps/snr_sweep`)
  cfo_hz       [lo, hi] carrier offset, spread and shuffled likewise
  occupied     share of channels or streams that carry a cell (the rest
               carry noise alone)
and whatever the driver reads besides.

Every cell is one 40-ms TTI (`cells.tti`) tiled from a start drawn
uniformly within it, with an SFN base drawn as a multiple of 4.  The host
draws the parameters and synthesises the TTIs; tiling, the offset and the
noise are made on the device with a `torch.Generator` seeded from the run's
seed, in one call a batch.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from . import cells as cellmod
from .ltecore.constants import SAMPLE_RATE

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind: str, name: str) -> dict:
    """ltebench/<kind>/<name>.json as a dict."""
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def rng_for(seed: int, salt: int = 0) -> np.random.Generator:
    """The host draws' generator: any whole seed, large ones included."""
    return np.random.default_rng([int(seed) % 2 ** 64, salt])


def torch_seed(seed: int, salt: int = 0) -> int:
    """A `torch.Generator` seed from the run's seed."""
    return int(rng_for(seed, 1000 + salt).integers(0, 2 ** 62))


def strata(bounds, n: int, rng: np.random.Generator) -> np.ndarray:
    """n values spread evenly over [lo, hi] (the middle of n equal strata)
    in an order drawn from `rng`: every seed gets the same set of values,
    so that the work of a batch does not change with the seed."""
    lo, hi = bounds
    return rng.permutation(lo + (hi - lo) * (np.arange(n) + 0.5) / n)


def draw_cells(spec: dict, rng: np.random.Generator, n: int) -> list:
    """n draws of a planted cell: dicts with cell_id (-1 where the mix
    leaves a channel to noise), prb, ports, normal_cp, sfn0, snr_db,
    cfo_hz, start."""
    occupied = set(rng.choice(n, size=int(round(spec.get("occupied", 1.0)
                                                  * n)), replace=False)
                   .tolist())
    snr = strata(spec["snr_db"], n, rng)
    cfo = strata(spec["cfo_hz"], n, rng)
    out = []
    for i in range(n):
        lo, hi = spec["cell_id"]
        cell = dict(cell_id=int(rng.integers(lo, hi + 1)),
                    prb=int(rng.choice(spec["prb"])),
                    ports=int(rng.choice(spec["ports"])),
                    normal_cp=bool(spec["normal_cp"]),
                    sfn0=4 * int(rng.integers(0, 64)),
                    snr_db=float(snr[i]), cfo_hz=float(cfo[i]),
                    start=int(rng.integers(0, cellmod.TTI_LENGTH)))
        out.append(cell if i in occupied else dict(cell, cell_id=-1))
    return out


def signals(cells: list, n: int, seed: int, device,
            salt: int = 0) -> torch.Tensor:
    """[len(cells), n] complex64 on `device`: each cell's TTI tiled from its
    start, offset by its carrier offset, plus complex white noise of power
    10^(-snr/10) against the unit-power cell (noise alone where the cell id
    is -1, at the same noise power)."""
    c = len(cells)
    idx = torch.arange(n, device=device, dtype=torch.int64)
    sig = torch.zeros((c, n), dtype=torch.complex64, device=device)
    for i, cell in enumerate(cells):
        if cell["cell_id"] < 0:
            continue
        frames = torch.from_numpy(cellmod.tti(
            cell["cell_id"], cell["prb"], cell["ports"], cell["sfn0"],
            cell["normal_cp"])).to(device)
        x = frames[(idx + cell["start"]) % cellmod.TTI_LENGTH]
        if cell["cfo_hz"]:
            ph = torch.remainder(idx.to(torch.float64)
                                 * (cell["cfo_hz"] / SAMPLE_RATE), 1.0)
            ph = ph * (2 * math.pi)
            x = x * torch.complex(torch.cos(ph), torch.sin(ph)) \
                .to(torch.complex64)
        sig[i] = x
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, salt))
    noise = torch.randn((c, 2, n), generator=g, device=device)
    sigma = torch.tensor([math.sqrt(10.0 ** (-cell["snr_db"] / 10.0) / 2.0)
                          for cell in cells], device=device)[:, None, None]
    noise *= sigma
    sig += torch.complex(noise[:, 0], noise[:, 1])
    return sig


def capture_batch(cells: list, n: int, seed: int, device,
                  salt: int = 0) -> tuple:
    """The (re, im) float32 pair `channel_scan` takes: [C, LOOKBACK + n +
    WINDOW], zero head and tail, on `device`."""
    sig = signals(cells, n, seed, device, salt)
    pad = (cellmod.LOOKBACK, cellmod.WINDOW)
    return tuple(torch.nn.functional.pad(part, pad).contiguous()
                 for part in (sig.real, sig.imag))
