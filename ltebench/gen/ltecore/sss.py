# Frozen copy of ltetrigger_tpu_torch/ltecore/sss.py (commit ce2615c) for the
# benchmark's generator and reference: later changes to the program do not
# change the yardstick.
"""Secondary Synchronization Signal (SSS) sequences and lookup tables.

First-party implementation of 3GPP 36.211 6.11.2 (the math srsLTE hides behind
srslte_sss_* — reference lib/sss_impl.cc:112-124 only calls into it).  Exports
numpy constant tables shaped for the device: the m0/m1 detection becomes
two [31]x[31,31] matmuls against cyclic-shift banks (see ops/sync.py).

Conventions:
  - subframe 0: d(2n) = s0^{m0} c0,  d(2n+1) = s1^{m1} c1 z1^{m0}
  - subframe 5: same with m0 <-> m1 swapped.
"""

import functools

import numpy as np

from .constants import N_ID_1_COUNT, N_ID_2_COUNT


def _mseq(taps) -> np.ndarray:
    """Length-31 binary m-sequence x(i+5) = sum(taps) mod 2, x = [0,0,0,0,1]."""
    x = np.zeros(31, dtype=np.int64)
    x[4] = 1
    for i in range(26):
        x[i + 5] = sum(x[i + t] for t in taps) % 2
    return x


@functools.lru_cache(maxsize=None)
def base_sequences():
    """(s_tilde, c_tilde, z_tilde) as +-1 valued length-31 arrays."""
    s = 1 - 2 * _mseq((0, 2))        # x(i+5) = x(i+2) + x(i)
    c = 1 - 2 * _mseq((0, 3))        # x(i+5) = x(i+3) + x(i)
    z = 1 - 2 * _mseq((0, 1, 2, 4))  # x(i+5) = x(i+4)+x(i+2)+x(i+1)+x(i)
    return s.astype(np.float64), c.astype(np.float64), z.astype(np.float64)


def m0m1_from_nid1(n_id_1: int):
    """(m0, m1) pair for N_id_1 (36.211 table 6.11.2.1-1 closed form)."""
    qp = n_id_1 // 30
    q = (n_id_1 + qp * (qp + 1) // 2) // 30
    mp = n_id_1 + q * (q + 1) // 2
    m0 = mp % 31
    m1 = (m0 + mp // 31 + 1) % 31
    return m0, m1


@functools.lru_cache(maxsize=None)
def nid1_table() -> np.ndarray:
    """[31, 31] int32: (m0, m1) -> N_id_1, or -1 for invalid pairs.

    Only subframe-0 ordered pairs are present; a swapped hit means the
    half-frame is aligned to subframe 5 (reference behavior: srslte_sss_N_id_1
    fails and the half-frame goes untagged, lib/sss_impl.cc:118-120).
    """
    t = np.full((31, 31), -1, dtype=np.int32)
    for nid1 in range(N_ID_1_COUNT):
        m0, m1 = m0m1_from_nid1(nid1)
        t[m0, m1] = nid1
    return t


@functools.lru_cache(maxsize=None)
def shift_bank() -> np.ndarray:
    """[31, 31] float32 S with S[m, n] = s_tilde((n + m) mod 31).

    corr(m) = sum_n y(n) * S[m, n]  ==  y @ S.T : one small matmul per stage.
    """
    s, _, _ = base_sequences()
    idx = (np.arange(31)[None, :] + np.arange(31)[:, None]) % 31
    return s[idx].astype(np.float32)


@functools.lru_cache(maxsize=None)
def c_scramble() -> np.ndarray:
    """[3, 2, 31] float32: c0 (index 0) and c1 (index 1) per N_id_2."""
    _, c, _ = base_sequences()
    out = np.empty((N_ID_2_COUNT, 2, 31), dtype=np.float32)
    n = np.arange(31)
    for nid2 in range(N_ID_2_COUNT):
        out[nid2, 0] = c[(n + nid2) % 31]
        out[nid2, 1] = c[(n + nid2 + 3) % 31]
    return out


@functools.lru_cache(maxsize=None)
def z_bank() -> np.ndarray:
    """[8, 31] float32: z1^{m}(n) = z_tilde((n + m mod 8) mod 31), row = m mod 8."""
    _, _, z = base_sequences()
    n = np.arange(31)
    return np.stack([z[(n + m) % 31] for m in range(8)]).astype(np.float32)


def sss_sequence(n_id_1: int, n_id_2: int, subframe5: bool) -> np.ndarray:
    """Full length-62 +-1 SSS sequence (for synthesis / golden tests)."""
    s, c, z = base_sequences()
    m0, m1 = m0m1_from_nid1(n_id_1)
    if subframe5:
        m0, m1 = m1, m0
    n = np.arange(31)
    c0 = c[(n + n_id_2) % 31]
    c1 = c[(n + n_id_2 + 3) % 31]
    s0 = s[(n + m0) % 31]
    s1 = s[(n + m1) % 31]
    z1m0 = z[(n + (m0 % 8)) % 31]
    d = np.empty(62)
    d[0::2] = s0 * c0
    d[1::2] = s1 * c1 * z1m0
    return d
