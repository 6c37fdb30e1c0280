"""Wide band captures: whole LTE carriers at the capture rate, placed on the
EARFCN raster of a band, under one white noise floor.

A carrier is the planted cell of `cells.tti` (one 40-ms PBCH TTI, tiled)
widened to its channel bandwidth: its centre 72 subcarriers are `tti`'s own
grid, read back by a 128-point FFT of each CP-stripped symbol, and every
other resource element inside its bandwidth carries QPSK drawn from the
seed at the power of the carrier's PSS resource elements (a fully loaded
carrier; the CRS outside the centre 72 are not modelled, since nothing of
the program reads them).  It is modulated by a 2048-point inverse FFT with
the CP lengths of 30.72 Msps (160 / 144 samples), so that the centre 72
subcarriers at 30.72 Msps are the 1.92-Msps TTI band-limited.

The band: raster point k (EARFCN first + k) lies at first_hz + k * raster_hz;
the capture is centred at center_hz.  A carrier's SNR is the power of its
centre 72 subcarriers (the unit-power TTI that `cells_cfo1k5` plants) over
the noise power of a 1.92-Msps channel; the noise is white over the whole
capture, at power `ratio` a wide sample, which is 1 in each 1.92-MHz
channel.

A mix file holds, besides `driver`:

  carriers      one entry a carrier of a capture: prb (the MIB field) and
                bandwidth_hz (the channel bandwidth, TS 36.101 Table 5.6-1)
  cell_id       [lo, hi] drawn uniformly, inclusive
  ports         the TX port counts drawn from
  normal_cp     the cyclic prefix (true: normal)
  snr_db        [lo, hi], spread over the pool's carriers (`traffic.strata`)
  cfo_hz        [lo, hi], spread likewise

Carrier positions: each capture's carriers sit at raster points drawn
uniformly from every placement in which each lies inside the band and no
two overlap.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from . import cells as cellmod
from . import traffic as gen
from .ltecore.constants import (SAMPLE_RATE, SLOT_LENGTH, SYMBOL_SZ,
                                symbol_data_offsets)

FFT = 2048
UP = FFT // SYMBOL_SZ                      # 16: 30.72 Msps over 1.92
TTI_WIDE = UP * cellmod.TTI_LENGTH         # 1228800 samples, 40 ms
SLOTS = cellmod.TTI_LENGTH // SLOT_LENGTH  # 80 slots a TTI
HALF_CENTRE = 36                           # centre subcarriers a side


def raster(cfg: dict) -> np.ndarray:
    """[K] float64: the offset from the capture's centre, Hz, of every
    raster point of the band (EARFCN earfcn[0] .. earfcn[1])."""
    k = np.arange(cfg["earfcn"][1] - cfg["earfcn"][0] + 1, dtype=np.float64)
    return cfg["first_hz"] + k * cfg["raster_hz"] - cfg["center_hz"]


def placements(cfg: dict, widths) -> list:
    """Every tuple of raster indices, one a carrier of bandwidth widths[i]
    Hz, with each carrier inside the band and no two overlapping."""
    f = raster(cfg) + cfg["center_hz"]
    lo, hi = cfg["band_hz"]
    fits = [[k for k in range(f.size)
             if f[k] - w / 2 >= lo - 1e-3 and f[k] + w / 2 <= hi + 1e-3]
            for w in widths]
    out = []
    for ks in itertools.product(*fits):
        if all(abs(f[ks[i]] - f[ks[j]]) >= (widths[i] + widths[j]) / 2 - 1e-3
               for i in range(len(ks)) for j in range(i)):
            out.append(ks)
    return out


def draw_carriers(mix: dict, cfg: dict, rng: np.random.Generator,
                  pool: int) -> list:
    """pool lists of carriers (one list a capture): dicts with the planted
    cell's fields (cell_id, prb, ports, normal_cp, sfn0, snr_db, cfo_hz)
    and earfcn_index, offset_hz, bandwidth_hz, start (a wide sample of the
    tiled TTIs, where the capture starts)."""
    spec = mix["carriers"]
    n = pool * len(spec)
    snr = gen.strata(mix["snr_db"], n, rng)
    cfo = gen.strata(mix["cfo_hz"], n, rng)
    where = placements(cfg, [c["bandwidth_hz"] for c in spec])
    offs = raster(cfg)
    out = []
    for b in range(pool):
        ks = where[int(rng.integers(0, len(where)))]
        caps = []
        for i, c in enumerate(spec):
            lo, hi = mix["cell_id"]
            j = b * len(spec) + i
            caps.append(dict(
                cell_id=int(rng.integers(lo, hi + 1)), prb=int(c["prb"]),
                ports=int(rng.choice(mix["ports"])),
                normal_cp=bool(mix["normal_cp"]),
                sfn0=4 * int(rng.integers(0, 64)),
                snr_db=float(snr[j]), cfo_hz=float(cfo[j]),
                earfcn_index=int(ks[i]), offset_hz=float(offs[ks[i]]),
                bandwidth_hz=float(c["bandwidth_hz"]),
                start=int(rng.integers(0, TTI_WIDE))))
        out.append(caps)
    return out


def centre_grid(cell: dict) -> tuple[np.ndarray, np.ndarray]:
    """The centre 72 subcarriers of every symbol of the cell's TTI, read
    from `cells.tti` by a 128-point FFT of each CP-stripped symbol:
    ([SLOTS, nsym, 72] complex128, subcarrier -36 .. -1 then 1 .. 36), and
    [SLOTS] the magnitude of the PSS resource elements of each slot's
    frame."""
    x = cellmod.tti(cell["cell_id"], cell["prb"], cell["ports"],
                    cell["sfn0"], cell["normal_cp"]).astype(np.complex128)
    offs = symbol_data_offsets(cell["normal_cp"])
    slots = x.reshape(SLOTS, SLOT_LENGTH)
    sym = np.stack([slots[:, o:o + SYMBOL_SZ] for o in offs], axis=1)
    bins = np.fft.fft(sym, axis=-1) / SYMBOL_SZ
    grid = np.concatenate([bins[..., SYMBOL_SZ - HALF_CENTRE:],
                           bins[..., 1:HALF_CENTRE + 1]], axis=-1)
    # the PSS: last symbol of slot 0 of each frame, subcarriers 5 .. 66
    pss = np.abs(grid[0::20, len(offs) - 1, 5:67]).mean(axis=-1)
    return grid, np.repeat(pss, 20)


def carrier(cell: dict, n: int, gen_: torch.Generator, device) \
        -> torch.Tensor:
    """[n] complex64 on `device`: the carrier at 30.72 Msps and 0 Hz, from
    wide sample cell["start"] of its TTI tiled, every resource element
    outside the centre 72 and inside 12 * prb subcarriers QPSK drawn from
    `gen_` (fresh in every TTI)."""
    grid, amp = centre_grid(cell)
    nsym = grid.shape[1]
    n_tti = -(-(cell["start"] + n) // TTI_WIDE)
    f = torch.zeros((n_tti, SLOTS, nsym, FFT), dtype=torch.complex64,
                    device=device)
    half = 6 * cell["prb"]
    outer = torch.cat([torch.arange(HALF_CENTRE + 1, half + 1),
                       torch.arange(FFT - half, FFT - HALF_CENTRE)]) \
        .to(device)
    quad = torch.randint(0, 4, (n_tti, SLOTS, nsym, outer.numel()),
                         generator=gen_, device=device)
    ph = (math.pi / 4) + (math.pi / 2) * quad.to(torch.float32)
    a = torch.from_numpy(amp.astype(np.float32)).to(device)[None, :, None,
                                                             None]
    f[..., outer] = torch.polar(a.expand_as(ph), ph)
    g = torch.from_numpy(grid.astype(np.complex64)).to(device)
    f[..., FFT - HALF_CENTRE:] = g[..., :HALF_CENTRE]
    f[..., 1:HALF_CENTRE + 1] = g[..., HALF_CENTRE:]
    t = torch.fft.ifft(f, dim=-1) * FFT
    out = torch.empty((n_tti, SLOTS, UP * SLOT_LENGTH), dtype=torch.complex64,
                      device=device)
    prev = 0
    for i, o in enumerate(symbol_data_offsets(cell["normal_cp"])):
        o *= UP
        out[..., o:o + FFT] = t[..., i, :]
        cp = o - prev
        out[..., o - cp:o] = t[..., i, FFT - cp:]
        prev = o + FFT
    return out.reshape(-1)[cell["start"]:cell["start"] + n]


def capture(carriers: list, n: int, sample_rate: float, seed: int, device,
            salt: int = 0) -> np.ndarray:
    """[n] complex64 in host memory: the carriers, each at its raster offset
    and carrier offset and scaled to its SNR, plus the white noise floor.
    Made on `device` with a `torch.Generator` seeded from the run's seed."""
    ratio = int(round(sample_rate / SAMPLE_RATE))
    g = torch.Generator(device=device).manual_seed(gen.torch_seed(seed, salt))
    idx = torch.arange(n, device=device, dtype=torch.float64)
    x = torch.zeros(n, dtype=torch.complex64, device=device)
    for c in carriers:
        w = carrier(c, n, g, device)
        f = (c["offset_hz"] + c["cfo_hz"]) / sample_rate
        ph = torch.remainder(idx * f, 1.0) * (2 * math.pi)
        rot = torch.polar(torch.ones_like(ph), ph).to(torch.complex64)
        x += math.sqrt(10.0 ** (c["snr_db"] / 10.0)) * w * rot
        del w, ph, rot
    noise = torch.randn((2, n), generator=g, device=device)
    noise *= math.sqrt(ratio / 2.0)
    x += torch.complex(noise[0], noise[1])
    return np.ascontiguousarray(x.cpu().numpy())


def centre_cells(carriers: list, n_centres: int, index=None) -> list:
    """The planted cell of each scanned centre, in the form the capture
    scans' check takes (`reference.check.scan_events`): the carrier at its
    own raster point, cell_id -1 at every other.  index[k]: the raster
    index of scanned centre k (default: centre k is raster point k)."""
    at = {c["earfcn_index"]: c for c in carriers}
    index = range(n_centres) if index is None else index
    return [at.get(int(k), dict(cell_id=-1)) for k in index]
