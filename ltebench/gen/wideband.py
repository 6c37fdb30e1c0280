"""The wide loop of the live band monitor: one wideband stream, a whole
number of 40-ms TTIs, with the band's carriers on the EARFCN raster, made
from the run's seed.

A mix file holds `band.py`'s keys; each entry of `carriers` adds its
`role`, "steady" (on air for the whole loop) or "keyed" (on air for the
first `keyed_on` share of each loop, off for the rest), and the mix adds

  keyed_on      the share of the loop a keyed carrier is on air
  keyed_snr_db  [lo, hi] of a keyed carrier's SNR (`snr_db` if absent)

The carriers' raster points, ids, ports and starts are drawn as
`band.draw_carriers` draws them for one capture.  Each carrier's SNR is
drawn uniformly from its role's range, and its carrier offset uniformly
from the multiples of 1 / loop_seconds Hz in `cfo_hz`, fresh for every
seed (one capture has too few carriers for `band.py`'s strata to spread
them).  Each carrier is `band.carrier`'s fully loaded waveform over whole
TTIs from TTI 0, rotated to start at its drawn start, so that its last TTI
runs on into its first across the loop's seam; its carrier offset and its
raster offset are multiples of 1 / loop_seconds Hz, so that its phase runs
on across the seam too.  The loop is made on `device` and handed over in
pageable host memory, as an SDR's ring buffer would.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import band as bandgen
from . import traffic as gen
from .ltecore.constants import SAMPLE_RATE


def loop_samples(cfg: dict) -> int:
    """The wide samples of one loop: a whole number of TTIs and of
    chunks."""
    n = int(round(float(cfg["loop_seconds"]) * float(cfg["sample_rate"])))
    if n % bandgen.TTI_WIDE or n % int(cfg["chunk_samples"]):
        raise ValueError(f"a loop of {n} wide samples is not a whole number "
                         f"of 40-ms TTIs and of chunks")
    return n


def draw(mix: dict, cfg: dict, seed: int) -> list:
    """The band's carriers (`band.draw_carriers`, one capture), each with
    its `role`, an SNR drawn from its role's range and a carrier offset
    drawn from the loop's frequency grid."""
    step = 1.0 / float(cfg["loop_seconds"])
    rng = gen.rng_for(seed)
    lo, hi = mix["cfo_hz"]
    grid = (math.ceil(lo / step - 1e-9), math.floor(hi / step + 1e-9))
    out = []
    for spec, c in zip(mix["carriers"],
                       bandgen.draw_carriers(mix, cfg, rng, 1)[0]):
        if abs(c["offset_hz"] / step - round(c["offset_hz"] / step)) > 1e-6:
            raise ValueError(f"raster offset {c['offset_hz']} Hz is no "
                             f"multiple of {step} Hz: the loop has a seam")
        snr = mix.get("keyed_snr_db", mix["snr_db"]) \
            if spec["role"] == "keyed" else mix["snr_db"]
        out.append(dict(c, role=spec["role"],
                        snr_db=float(rng.uniform(*snr)),
                        cfo_hz=step * int(rng.integers(grid[0],
                                                       grid[1] + 1))))
    return out


def loop(carriers: list, cfg: dict, mix: dict, seed: int,
         device) -> np.ndarray:
    """[loop_samples] complex64 in host memory: the carriers, each at its
    raster and carrier offset, scaled to its SNR and keyed by its role,
    plus the white noise floor (`band.capture`'s)."""
    n = loop_samples(cfg)
    rate = float(cfg["sample_rate"])
    ratio = int(round(rate / SAMPLE_RATE))
    on = int(round(float(mix.get("keyed_on", 1.0)) * n))
    g = torch.Generator(device=device).manual_seed(gen.torch_seed(seed))
    idx = torch.arange(n, device=device, dtype=torch.float64)
    x = torch.zeros(n, dtype=torch.complex64, device=device)
    for c in carriers:
        w = torch.roll(bandgen.carrier(dict(c, start=0), n, g, device),
                       -c["start"])
        f = (c["offset_hz"] + c["cfo_hz"]) / rate
        ph = torch.remainder(idx * f, 1.0) * (2 * math.pi)
        w *= torch.polar(torch.ones_like(ph), ph).to(torch.complex64)
        del ph
        if c["role"] == "keyed":
            w[on:] = 0
        x += math.sqrt(10.0 ** (c["snr_db"] / 10.0)) * w
        del w
    noise = torch.randn((2, n), generator=g, device=device)
    noise *= math.sqrt(ratio / 2.0)
    x += torch.complex(noise[0], noise[1])
    return np.ascontiguousarray(x.cpu().numpy())
