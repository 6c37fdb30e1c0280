# Frozen copy of ltetrigger_tpu_torch/ltecore/mib.py (commit ce2615c) for the
# benchmark's generator and reference: later changes to the program do not
# change the yardstick.
"""MIB payload packing/unpacking (3GPP 36.331 MasterInformationBlock).

Replaces srslte_pbch_mib_unpack / srslte_pbch_mib_pack (called by the
reference at lib/mib_impl.cc:168).  Field order, MSB first:
  [0:3]  dl-Bandwidth index -> nof_prb in {6,15,25,50,75,100}
  [3]    phich-Duration (0 = Normal, 1 = Extended)
  [4:6]  phich-Resource (0..3 -> 1/6, 1/2, 1, 2)
  [6:14] 8 MSBs of the system frame number
  [14:24] spare

Reference quirk kept for parity (SURVEY §2.5): the published "sfn_offset" is
the unpacked 8-bit SFN field << 2 (srsLTE overwrites the decode-quarter offset
with it, lib/mib_impl.cc:168-170).
"""

import numpy as np

from .constants import NOF_PRB_TABLE

PHICH_RESOURCES_STR = ("1/6", "1/2", "1", "2")


def mib_pack(nof_prb: int, phich_extended: bool, phich_resource_idx: int,
             sfn: int) -> np.ndarray:
    """Build the 24-bit MIB payload (host-side; used by tests/synthesis)."""
    bw = NOF_PRB_TABLE.index(nof_prb)
    bits = np.zeros(24, dtype=np.uint8)
    bits[0:3] = [(bw >> (2 - i)) & 1 for i in range(3)]
    bits[3] = 1 if phich_extended else 0
    bits[4:6] = [(phich_resource_idx >> (1 - i)) & 1 for i in range(2)]
    f = (sfn >> 2) & 0xFF
    bits[6:14] = [(f >> (7 - i)) & 1 for i in range(8)]
    return bits


def mib_unpack(bits) -> dict:
    """24 bits -> dict of decoded MIB fields (host-side numpy)."""
    bits = np.asarray(bits).astype(np.int64)
    bw = (bits[0] << 2) | (bits[1] << 1) | bits[2]
    res = (bits[4] << 1) | bits[5]
    f = 0
    for i in range(8):
        f = (f << 1) | int(bits[6 + i])
    return {
        "nof_prb": int(NOF_PRB_TABLE[bw]) if bw < 6 else -1,
        "phich_len": "Extended" if bits[3] else "Normal",
        "nof_phich_resources": PHICH_RESOURCES_STR[res],
        "sfn_offset": int(f) << 2,
    }
