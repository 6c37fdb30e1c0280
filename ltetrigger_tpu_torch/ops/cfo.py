"""Carrier-frequency-offset estimation and correction.

Port of ltetrigger_tpu/ops/cfo.py: the estimate is the phase between the
two half-symbol correlations of the received PSS against the local replica,
in subcarrier-spacing units; correction is one cos/sin phase-ramp multiply.
"""

from __future__ import annotations

import functools
import math

import torch

from ..ltecore import pss as pssmod
from ..ltecore.constants import SYMBOL_SZ
from . import cplx, dft


@functools.lru_cache(maxsize=None)
def replica_pairs():
    """[3, 128] float32 (re, im) of the unit-energy time replicas (numpy)."""
    return cplx.const(pssmod.pss_time())


@functools.lru_cache(maxsize=None)
def chest_replicas():
    """[3, 62] float32 (re, im) frequency-domain PSS replicas (numpy)."""
    return cplx.const(pssmod.pss_freq_occupied())


@functools.lru_cache(maxsize=None)
def on_device(which: str, device: str) -> cplx.Pair:
    """`replica_pairs` ("time") or `chest_replicas` ("freq") as tensors on
    `device`, copied there once: a copy from pageable host memory waits for
    all work queued on the device."""
    pair = replica_pairs() if which == "time" else chest_replicas()
    return tuple(torch.from_numpy(a).to(device) for a in pair)


def cfo_estimate(pss_symbol: cplx.Pair, replica: cplx.Pair) -> torch.Tensor:
    """CFO in subcarrier-spacing units from a received 128-sample PSS symbol.

    pss_symbol: pair of [..., 128]; replica: pair of [..., 128] (broadcast)
    returns: [...] float32; unambiguous range (-1, 1) subcarriers.
    """
    h = SYMBOL_SZ // 2
    y0 = cplx.dot_conj_sum(cplx.index(pss_symbol, (..., slice(None, h))),
                           cplx.index(replica, (..., slice(None, h))))
    y1 = cplx.dot_conj_sum(cplx.index(pss_symbol, (..., slice(h, None))),
                           cplx.index(replica, (..., slice(h, None))))
    prod = cplx.mul(cplx.conj(y0), y1)               # conj(y0) * y1
    return (cplx.angle(prod) / math.pi).to(torch.float32)


def cfo_correct(x: cplx.Pair, freq) -> cplx.Pair:
    """Multiply by exp(2j*pi*freq*n); freq in cycles/sample (a float or a
    tensor of x's leading shape).

    Matches srslte_cfo_correct's convention: the caller passes
    freq = -mean_cfo / 128 to remove a +mean_cfo (subcarrier units) offset.
    """
    freq = torch.as_tensor(freq, dtype=torch.float32, device=x[0].device)
    return cfo_rotate(x, freq, 0)


def pss_chest(pss_symbol: cplx.Pair, n_id_2) -> cplx.Pair:
    """LS channel estimate over the 62 PSS subcarriers: the received symbol's
    spectrum times the conjugate replica of root `n_id_2` (an integer, or an
    integer tensor of the symbol's leading shape).  The grid engine computes
    the same estimate in pass C and surfaces it as
    `Trigger.channel_estimate`.

    pss_symbol: pair of [..., 128] -> pair of [..., 62]."""
    rep = cplx.index(on_device("freq", str(pss_symbol[0].device)), n_id_2)
    return cplx.mul_conj(dft.dft_sync(pss_symbol), rep)


def cfo_rotate(x: cplx.Pair, freq: torch.Tensor, offset: int) -> cplx.Pair:
    """Multiply by exp(2j*pi*freq*(offset + n)), freq in cycles/sample: the
    correction for a segment whose sample 0 sits `offset` samples into the
    frame the frequency ramp is anchored to."""
    n = offset + torch.arange(x[0].shape[-1], dtype=torch.float32,
                              device=x[0].device)
    theta = 2 * math.pi * freq[..., None] * n
    return cplx.mul(x, cplx.expi(theta))
