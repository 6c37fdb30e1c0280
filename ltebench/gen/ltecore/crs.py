# Frozen copy of ltetrigger_tpu_torch/ltecore/crs.py (commit ce2615c) for the
# benchmark's generator and reference: later changes to the program do not
# change the yardstick.
"""Cell-specific reference signals (CRS), 3GPP 36.211 6.10.1.

Host-side reference implementation (numpy) used by golden tests and the PBCH
synthesizer.  The channel estimator (ops/pbch.py) reproduces these
values on device from the precomputed Gold generator matrices because cell_id
is a device value at decode time.

Replaces the srsLTE chest_dl CRS generation used inside srslte_ue_mib_decode
(reference lib/mib_impl.cc:162).
"""

import numpy as np

from .constants import MIB_NOF_PRB
from .scrambling import crs_c_init, gold_sequence

N_RB_MAX = 110


def crs_values(cell_id: int, slot: int, symbol: int, normal_cp: bool = True,
               nof_prb: int = MIB_NOF_PRB) -> np.ndarray:
    """[2*nof_prb] complex pilot values for (slot, symbol), centered allocation."""
    c = gold_sequence(crs_c_init(cell_id, slot, symbol, normal_cp), 4 * N_RB_MAX)
    m = np.arange(2 * nof_prb) + (N_RB_MAX - nof_prb)
    re = 1.0 - 2.0 * c[2 * m].astype(np.float64)
    im = 1.0 - 2.0 * c[2 * m + 1].astype(np.float64)
    return (re + 1j * im) / np.sqrt(2.0)


def crs_v(port: int, symbol: int, slot: int) -> int:
    """Frequency shift v for (antenna port, symbol-in-slot)."""
    if port == 0:
        return 0 if symbol == 0 else 3
    if port == 1:
        return 3 if symbol == 0 else 0
    if port == 2:
        return 3 * (slot % 2)
    if port == 3:
        return 3 + 3 * (slot % 2)
    raise ValueError(port)


def crs_subcarriers(cell_id: int, port: int, symbol: int, slot: int,
                    nof_prb: int = MIB_NOF_PRB) -> np.ndarray:
    """[2*nof_prb] subcarrier indices (0 .. 12*nof_prb) carrying CRS."""
    v = crs_v(port, symbol, slot)
    v_shift = cell_id % 6
    k0 = (v + v_shift) % 6
    return k0 + 6 * np.arange(2 * nof_prb)


def crs_symbol_indices(port: int, normal_cp: bool = True):
    """Symbols-in-slot carrying CRS for a port (normal CP)."""
    if port in (0, 1):
        return (0, 4) if normal_cp else (0, 3)
    return (1,)
