"""Planted LTE cells: one 40-ms PBCH TTI (four radio frames, quarters 0-3)
of a cell, synthesised on the host from the frozen `ltecore` copy.

`tti` gives the same four frames as `ltecore.synth.synthesize_frame(cell_id,
prb, sfn=sfn0 + q, quarter=q, nof_ports=ports)` for q = 0..3 (a test holds
them equal), built by linearity so that a batch of a few hundred cells takes
seconds, not minutes: the four frames share every CRS and sync resource
element and differ only in slot 1's PBCH, so the shared part is modulated
once and each quarter adds its own slot-1 PBCH.  The OFDM modulation is one
batched inverse FFT.  Each frame is scaled to unit power, as
`synthesize_frame` scales it.

The layout of a capture buffer (LOOKBACK zero head, WINDOW zero tail) is the
one `channel_scan` takes (chip_smoke.py `big_buffer`).
"""

from __future__ import annotations

import numpy as np

from .ltecore import crs as crsmod, pss as pssmod, sss as sssmod
from .ltecore import synth
from .ltecore.constants import (FULL_FRAME_LENGTH, HALF_FRAME_LENGTH,
                                PSS_SYMBOL_START, SLOT_LENGTH, SYMBOL_SZ,
                                symbol_data_offsets)
from .ltecore.refrx import pbch_re_indices

LOOKBACK = PSS_SYMBOL_START                      # zero history before grid 0
WINDOW = LOOKBACK + HALF_FRAME_LENGTH + SYMBOL_SZ   # zero tail (10560)
TTI_LENGTH = 4 * FULL_FRAME_LENGTH               # 76800 samples, 40 ms


def _ofdm_mod(grid: np.ndarray, normal_cp: bool) -> np.ndarray:
    """[..., nsym, 72] subcarrier grids, one slot each -> [..., 960] time
    samples with CP, as `synth._ofdm_mod_slot` builds one slot."""
    offs = symbol_data_offsets(normal_cp)
    F = np.zeros(grid.shape[:-1] + (SYMBOL_SZ,), dtype=np.complex128)
    F[..., SYMBOL_SZ - 36:] = grid[..., :36]
    F[..., 1:37] = grid[..., 36:]
    t = np.fft.ifft(F, axis=-1) * SYMBOL_SZ
    out = np.zeros(grid.shape[:-2] + (SLOT_LENGTH,), dtype=np.complex128)
    for i, o in enumerate(offs):
        out[..., o:o + SYMBOL_SZ] = t[..., i, :]
        cp = o - (offs[i - 1] + SYMBOL_SZ if i else 0)
        out[..., o - cp:o] = t[..., i, SYMBOL_SZ - cp:]
    return out


def tti(cell_id: int, prb: int, ports: int, sfn0: int,
        normal_cp: bool = True) -> np.ndarray:
    """Four radio frames of a cell, SFN sfn0 .. sfn0 + 3 (sfn0 a multiple of
    4: quarters 0-3 of one PBCH TTI) -> [76800] complex64, each frame of
    unit power."""
    nsym = 7 if normal_cp else 6
    base = np.zeros((20, nsym, 72), dtype=np.complex128)
    # CRS of every port (ports' pilots never share a resource element)
    for s in range(20):
        for p in range(ports):
            for sym in crsmod.crs_symbol_indices(p, normal_cp):
                k = crsmod.crs_subcarriers(cell_id, p, sym, s)
                base[s, sym, k] += crsmod.crs_values(cell_id, s, sym,
                                                     normal_cp)
    sync_pos = np.arange(5, 67)
    n_id_2, n_id_1 = cell_id % 3, cell_id // 3
    for half, sub5 in ((0, False), (10, True)):
        base[half, nsym - 1, sync_pos] = pssmod.zadoff_chu(
            (25, 29, 34)[n_id_2])
        base[half, nsym - 2, sync_pos] = sssmod.sss_sequence(
            n_id_1, n_id_2, sub5)
    base_t = _ofdm_mod(base, normal_cp).reshape(-1)          # [19200]

    re_idx = pbch_re_indices(cell_id % 6, normal_cp)
    ls = np.array([l for l, _ in re_idx])
    ks = np.array([k for _, k in re_idx])
    frames = []
    for q in range(4):
        d = synth._pbch_symbols(cell_id, prb, sfn0 + q, q, ports, normal_cp)
        slot1 = base[1].copy()
        slot1[ls, ks] += _precoded_sum(d, ports)
        x = base_t.copy()
        x[SLOT_LENGTH:2 * SLOT_LENGTH] = _ofdm_mod(slot1, normal_cp)
        frames.append(x / np.sqrt(np.mean(np.abs(x) ** 2) + 1e-30))
    return np.concatenate(frames).astype(np.complex64)


def _precoded_sum(d: np.ndarray, ports: int) -> np.ndarray:
    """The PBCH symbols `d` layer-mapped and precoded as synth does it,
    summed over the ports (the identity channel)."""
    if ports == 1:
        return d
    if ports == 2:
        x0, x1 = d[0::2], d[1::2]
        p0 = np.empty_like(d)
        p1 = np.empty_like(d)
        p0[0::2], p0[1::2] = x0, x1
        p1[0::2], p1[1::2] = -np.conj(x1), np.conj(x0)
        return (p0 + p1) / np.sqrt(2)
    p = [np.zeros_like(d) for _ in range(4)]
    for g in range(0, len(d), 4):
        x0, x1, x2, x3 = d[g:g + 4]
        p[0][g], p[0][g + 1] = x0, x1
        p[2][g], p[2][g + 1] = -np.conj(x1), np.conj(x0)
        p[1][g + 2], p[1][g + 3] = x2, x3
        p[3][g + 2], p[3][g + 3] = -np.conj(x3), np.conj(x2)
    return sum(p) / np.sqrt(2)
