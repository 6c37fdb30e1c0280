"""CP detection and SSS decoding.

Port of ltetrigger_tpu/ops/sync.py: both CP hypotheses are scored, the SSS
symbol is demodulated by a [62, 128] DFT matmul, and the m0/m1 search is a
matmul against static cyclic-shift banks, summed noncoherently over 3
sub-segments (srsLTE's m0m1_partial default).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ltecore import sss as sssmod
from ..ltecore.constants import (CP_EXT, CP_NORM, SLOT_LENGTH,
                                 SYMBOL_SZ)
from . import cplx, dft

SSS_SECTIONS = 3


@functools.lru_cache(maxsize=None)
def _section_banks(sections: int) -> np.ndarray:
    """[31, sections * 31] float32: column s*31+m holds section s of the
    m-th cyclic shift of s_tilde (zeros outside the section)."""
    S = sssmod.shift_bank()                      # [31(m), 31(k)]
    bank = np.zeros((31, sections * 31), dtype=np.float32)
    bounds = np.linspace(0, 31, sections + 1).astype(int)
    for s in range(sections):
        lo, hi = bounds[s], bounds[s + 1]
        bank[lo:hi, s * 31:(s + 1) * 31] = S.T[lo:hi]
    return bank


@functools.lru_cache(maxsize=None)
def _tables(device: str):
    def t(a):
        return torch.from_numpy(np.asarray(a)).to(device)
    return (t(_section_banks(SSS_SECTIONS).astype(np.float32)),
            t(sssmod.c_scramble().astype(np.float32)),
            t(sssmod.z_bank().astype(np.float32)),
            t(sssmod.nid1_table().astype(np.int64)))


def _partial_corr_metric(y: cplx.Pair, bank: torch.Tensor,
                         sections: int) -> torch.Tensor:
    """[..., 31] noncoherent sum over sections of |segment correlation|^2."""
    power = cplx.abs2(cplx.matmul_pair_real(y, bank))
    return torch.sum(power.reshape(power.shape[:-1] + (sections, 31)),
                     dim=-2)


def detect_cp(aligned: cplx.Pair, end: int = SLOT_LENGTH) -> torch.Tensor:
    """bool (True = Normal CP) from the 2 symbols preceding the PSS.

    aligned: pair of [..., >=end] float32 whose index `end` is the slot
    boundary (PSS data at [end-128, end)).
    """
    def score(cp: int):
        shape = aligned[0].shape[:-1]
        num = cplx.zeros(shape, device=aligned[0].device)
        den = torch.full(shape, 1e-30, device=aligned[0].device)
        pos = end - SYMBOL_SZ
        for _ in range(2):
            pos -= SYMBOL_SZ + cp
            c = cplx.index(aligned, (..., slice(pos - cp, pos)))
            t = cplx.index(aligned,
                           (..., slice(pos + SYMBOL_SZ - cp, pos + SYMBOL_SZ)))
            num = cplx.add(num, cplx.dot_conj_sum(c, t))
            den = den + 0.5 * (torch.sum(cplx.abs2(c), dim=-1)
                               + torch.sum(cplx.abs2(t), dim=-1))
        return torch.sqrt(cplx.abs2(num)) / den

    return score(CP_NORM) >= score(CP_EXT)


def sss_decode(aligned: cplx.Pair, n_id_2: torch.Tensor,
               normal_cp: torch.Tensor, sections: int = SSS_SECTIONS,
               end: int = SLOT_LENGTH):
    """SSS -> (n_id_1 [...] int32, -1 invalid; subframe5 [...] bool).

    aligned:   pair of [..., >=end] slot-0 samples (index `end` = slot end)
    n_id_2:    [...] integer root index per batch element (broadcast)
    normal_cp: [...] bool (selects the SSS symbol position)
    """
    assert sections == SSS_SECTIONS
    bank, cs, zb, tab = _tables(str(aligned[0].device))
    idx_norm = end - 2 * SYMBOL_SZ - CP_NORM
    idx_ext = end - 2 * SYMBOL_SZ - CP_EXT
    sym_n = cplx.index(aligned, (..., slice(idx_norm, idx_norm + SYMBOL_SZ)))
    sym_e = cplx.index(aligned, (..., slice(idx_ext, idx_ext + SYMBOL_SZ)))
    sym = cplx.where(normal_cp[..., None], sym_n, sym_e)

    y = dft.dft_sync(sym)                         # pair of [..., 62]
    n_id_2 = n_id_2.to(torch.int64)
    c0 = cs[n_id_2, 0]                            # [..., 31]
    c1 = cs[n_id_2, 1]
    even = cplx.index(y, (..., slice(0, None, 2)))
    odd = cplx.index(y, (..., slice(1, None, 2)))

    ce = cplx.scale(even, c0)                     # descramble (real +-1)
    m0 = torch.argmax(_partial_corr_metric(ce, bank, sections), dim=-1)
    z = zb[m0 % 8]
    co = cplx.scale(odd, c1 * z)
    m1 = torch.argmax(_partial_corr_metric(co, bank, sections), dim=-1)

    direct = tab[m0, m1]
    swapped = tab[m1, m0]
    n_id_1 = torch.where(direct >= 0, direct, swapped).to(torch.int32)
    subframe5 = (direct < 0) & (swapped >= 0)
    return n_id_1, subframe5
