# Frozen copy of ltetrigger_tpu_torch/ltecore/synth.py (commit ce2615c) for the
# benchmark's generator and reference: later changes to the program do not
# change the yardstick.
"""LTE downlink synthesizer (host-side numpy, test/bench support).

Generates radio frames containing PSS/SSS/CRS/PBCH so the receiver can be
tested against cells the bundled captures don't cover (extended CP, 2/4 TX
ports, arbitrary cell ids, controlled SNR).  The reference has no equivalent
— its only fixtures are 4 recorded frames (SURVEY.md §4).
"""

import numpy as np

from . import coding, crs as crsmod, mib as mibmod, scrambling
from . import pss as pssmod, sss as sssmod
from .constants import (MIB_NOF_PRB, NOF_PRB_TABLE, SLOT_LENGTH, SYMBOL_SZ,
                        symbol_data_offsets)


def _ofdm_mod_slot(sym_grid: np.ndarray, normal_cp: bool = True) -> np.ndarray:
    """[nsym, 72] subcarrier grid -> 960 time samples with CP."""
    offs = symbol_data_offsets(normal_cp)
    out = np.zeros(SLOT_LENGTH, dtype=np.complex128)
    for i, o in enumerate(offs):
        F = np.zeros(SYMBOL_SZ, dtype=np.complex128)
        F[SYMBOL_SZ - 36:] = sym_grid[i][:36]
        F[1:37] = sym_grid[i][36:]
        t = np.fft.ifft(F) * SYMBOL_SZ  # keep unit subcarrier amplitude
        out[o:o + SYMBOL_SZ] = t
        cp = o - (offs[i - 1] + SYMBOL_SZ if i else 0)
        out[o - cp:o] = t[-cp:]
    return out


def _place_crs(grid, cell_id, slot_no, nof_ports, normal_cp,
               only_port=None):
    """Insert CRS pilots for the active ports into a [nsym, 72] slot grid.

    only_port selects a single port's pilots (per-port synthesis)."""
    ports = ([only_port] if only_port is not None
             else range(min(nof_ports, 4)))
    for port in ports:
        for sym in crsmod.crs_symbol_indices(port, normal_cp):
            vals = crsmod.crs_values(cell_id, slot_no, sym, normal_cp)
            k = crsmod.crs_subcarriers(cell_id, port, sym, slot_no)
            grid[sym][k] = vals


def _pbch_symbols(cell_id, nof_prb_field, sfn, quarter, nof_ports, normal_cp,
                  phich_extended=False, phich_resource_idx=2):
    """-> complex QPSK symbols for this radio frame's share of the PBCH TTI."""
    payload = mibmod.mib_pack(nof_prb_field, phich_extended,
                              phich_resource_idx, sfn)
    bits = coding.crc16_attach(payload, nof_ports)
    coded = coding.conv_encode(bits)
    e_bits = 480 if normal_cp else 432
    e = coding.rate_match(coded, 4 * e_bits)
    c = scrambling.gold_sequence(scrambling.pbch_c_init(cell_id), 4 * e_bits)
    b = (e ^ c)[e_bits * quarter: e_bits * (quarter + 1)].astype(np.float64)
    return ((1 - 2 * b[0::2]) + 1j * (1 - 2 * b[1::2])) / np.sqrt(2.0)


def synthesize_pbch_subframe(cell_id: int, nof_prb_field: int = 50,
                             sfn: int = 0, quarter: int = 0,
                             nof_ports: int = 1, normal_cp: bool = True,
                             amplitude: float = 1.0) -> np.ndarray:
    """Subframe 0 (1920 samples) with CRS + PBCH (+ PSS/SSS in slot 0)."""
    return synthesize_frame(cell_id, nof_prb_field, sfn, quarter, nof_ports,
                            normal_cp, amplitude)[:2 * SLOT_LENGTH]


def synthesize_frame_ports(cell_id: int, nof_prb_field: int = 50,
                           sfn: int = 0, quarter: int = 0,
                           nof_ports: int = 1,
                           normal_cp: bool = True,
                           pbch_scale: float = 1.0) -> np.ndarray:
    """One radio frame PER TX PORT: [nof_ports, 19200] complex, unnormalized.

    Port p carries its own CRS and its SFBC/SFBC-FSTD share of the PBCH;
    PSS/SSS ride on port 0 (the common srsLTE assumption).  Summing the rows
    models an identity channel; passing each row through its own
    `multipath_channel` models a real MIMO downlink (the physical input
    class the reference meets over the air, README.rst:12-13)."""
    assert nof_prb_field in NOF_PRB_TABLE
    n_id_2 = cell_id % 3
    n_id_1 = cell_id // 3
    nsym = 7 if normal_cp else 6
    slots = [[np.zeros((nsym, 72), dtype=np.complex128) for _ in range(20)]
             for _ in range(nof_ports)]

    for p in range(nof_ports):
        for s in range(20):
            _place_crs(slots[p][s], cell_id, s, nof_ports, normal_cp,
                       only_port=p)

    # The 62 sync subcarriers (-31..-1, +1..+31) sit at positions 5..66 of the
    # 72-wide grid (grid 0..35 = subcarriers -36..-1, grid 36..71 = +1..+36).
    sync_pos = np.arange(5, 67)

    for half, sub5 in ((0, False), (10, True)):
        # PSS: last symbol of slot 0/10; SSS: the one before.
        zc = pssmod.zadoff_chu((25, 29, 34)[n_id_2])
        slots[0][half][nsym - 1][sync_pos] = zc
        slots[0][half][nsym - 2][sync_pos] = sssmod.sss_sequence(
            n_id_1, n_id_2, sub5)

    # PBCH in slot 1, symbols 0..3
    d = _pbch_symbols(cell_id, nof_prb_field, sfn, quarter, nof_ports,
                      normal_cp)
    v_shift = cell_id % 6
    # layer-map / precode
    if nof_ports == 1:
        tx = {0: d}
    elif nof_ports == 2:
        x0, x1 = d[0::2], d[1::2]
        p0 = np.empty_like(d); p1 = np.empty_like(d)
        p0[0::2], p0[1::2] = x0, x1
        p1[0::2], p1[1::2] = -np.conj(x1), np.conj(x0)
        tx = {0: p0 / np.sqrt(2), 1: p1 / np.sqrt(2)}
    else:
        # 4-port SFBC-FSTD over groups of 4
        p = [np.zeros_like(d) for _ in range(4)]
        for g in range(0, len(d), 4):
            x0, x1, x2, x3 = d[g:g + 4]
            p[0][g], p[0][g + 1] = x0, x1
            p[2][g], p[2][g + 1] = -np.conj(x1), np.conj(x0)
            p[1][g + 2], p[1][g + 3] = x2, x3
            p[3][g + 2], p[3][g + 3] = -np.conj(x3), np.conj(x2)
        tx = {i: p[i] / np.sqrt(2) for i in range(4)}

    # pbch_scale attenuates ONLY the PBCH resource elements (sync + CRS
    # stay at nominal power): the knob that builds the PBCH-limited regime
    # where TTI soft-combining can matter — PSS tracks, single-subframe
    # MIB fails (apps/snr_sweep.py::pbch_sweep)
    from .refrx import pbch_re_indices
    re_idx = pbch_re_indices(v_shift, normal_cp)
    for port, syms in tx.items():
        for (l, k), v in zip(re_idx, syms):
            slots[port][1][l][k] += pbch_scale * v

    return np.stack([
        np.concatenate([_ofdm_mod_slot(s, normal_cp) for s in slots[p]])
        for p in range(nof_ports)])


def synthesize_frame(cell_id: int, nof_prb_field: int = 50, sfn: int = 0,
                     quarter: int = 0, nof_ports: int = 1,
                     normal_cp: bool = True,
                     amplitude: float = 1.0) -> np.ndarray:
    """One 10 ms radio frame (19200 samples) with PSS/SSS/CRS/PBCH.

    Multi-port transmission is modeled as the superposition arriving over an
    identity channel (each port's signal summed), with PBCH SFBC-precoded.
    """
    time = synthesize_frame_ports(cell_id, nof_prb_field, sfn, quarter,
                                  nof_ports, normal_cp).sum(axis=0)
    return amplitude * time / np.sqrt(np.mean(np.abs(time) ** 2) + 1e-30)


# ------------------------------------------------------- channel models ----
def multipath_channel(x: np.ndarray, taps, doppler_hz: float = 0.0,
                      fs: float = 1.92e6, phase0: float = 0.0) -> np.ndarray:
    """Pass `x` through a static (or slowly rotating) multi-tap channel.

    taps: iterable of (delay_samples, complex_gain).  Frequency selectivity
    needs multi-sample delay spread: at 1.92 Msps one sample is 520 ns, so
    e.g. taps at delays (0, 2, 5) span ~2.6 us — an ETU-class profile whose
    notches fall inside the 1.08 MHz occupied band.

    doppler_hz rotates every tap's phase at that rate (a worst-case common
    Doppler; per-tap Doppler diversity would only decorrelate faster).
    """
    y = np.zeros_like(x, dtype=np.complex128)
    for d, g in taps:
        y[d:] += g * x[: x.size - d]
    if doppler_hz:
        n = np.arange(x.size, dtype=np.float64)
        y *= np.exp(2j * np.pi * (doppler_hz * n / fs) + 1j * phase0)
    return y


def synthesize_faded_frames(cell_id: int, n_frames: int = 4,
                            nof_prb_field: int = 50, nof_ports: int = 1,
                            normal_cp: bool = True, sfn0: int = 0,
                            channels=None, doppler_hz: float = 0.0,
                            snr_db: float | None = None,
                            seed: int = 0) -> np.ndarray:
    """`n_frames` consecutive radio frames through per-port multipath.

    channels: list of `nof_ports` tap lists (see multipath_channel); default
    is a frequency-selective 3-tap profile decorrelated across ports.
    Returns complex64 [n_frames * 19200] normalized to unit signal power,
    with AWGN at `snr_db` (None = noiseless).
    """
    rng = np.random.default_rng(seed)
    if channels is None:
        channels = default_port_channels(nof_ports, seed=seed)
    frames = []
    for i in range(n_frames):
        sfn = (sfn0 + i) & 0xFF
        ports = synthesize_frame_ports(cell_id, nof_prb_field, sfn=sfn,
                                       quarter=sfn % 4, nof_ports=nof_ports,
                                       normal_cp=normal_cp)
        frames.append(ports)
    tx = np.concatenate(frames, axis=1)            # [ports, n*19200]
    rx = np.zeros(tx.shape[1], dtype=np.complex128)
    for p in range(nof_ports):
        rx += multipath_channel(tx[p], channels[p], doppler_hz=doppler_hz,
                                phase0=2 * np.pi * p / max(nof_ports, 1))
    rx /= np.sqrt(np.mean(np.abs(rx) ** 2) + 1e-30)
    if snr_db is not None:
        sigma = 10.0 ** (-snr_db / 20.0) / np.sqrt(2.0)
        rx = rx + sigma * (rng.normal(size=rx.size)
                           + 1j * rng.normal(size=rx.size))
    return rx.astype(np.complex64)


def default_port_channels(nof_ports: int, seed: int = 0):
    """Per-port frequency-selective 3-tap profiles (ETU-class delay spread),
    deterministic but decorrelated across ports."""
    rng = np.random.default_rng(1000 + seed)
    chans = []
    for _ in range(nof_ports):
        phases = np.exp(2j * np.pi * rng.random(3))
        chans.append([(0, 1.0 * phases[0]),
                      (2, 0.6 * phases[1]),
                      (5, 0.35 * phases[2])])
    return chans
