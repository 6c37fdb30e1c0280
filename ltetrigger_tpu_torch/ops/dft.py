"""128-point DFT as matmuls against selected DFT rows.

Port of ltetrigger_tpu/ops/dft.py.  Only the 62 sync subcarriers or the 72
PBCH subcarriers are ever needed, so "FFT + select" is one [62|72, 128]
matmul.  Float32 matmuls on CUDA must not run in TF32
(torch.backends.cuda.matmul.allow_tf32 = False, PyTorch's default, which
the engine's entry points set).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ltecore import pss as pssmod
from ..ltecore.constants import SYMBOL_SZ
from . import cplx


@functools.lru_cache(maxsize=None)
def dft_matrix(n: int = SYMBOL_SZ):
    """Full [n, n] DFT matrix as a float32 (re, im) pair of numpy arrays."""
    k = np.arange(n)
    W = np.exp(-2j * np.pi * np.outer(k, k) / n)
    return cplx.const(W)


@functools.lru_cache(maxsize=None)
def dft_sync62():
    """[62, 128]: DFT rows for the sync-signal subcarriers, in sequence
    order (-31..-1, +1..+31)."""
    re, im = dft_matrix()
    bins = pssmod.subcarrier_bins()
    return re[bins], im[bins]


@functools.lru_cache(maxsize=None)
def dft_pbch72():
    """[72, 128]: DFT rows for the 6-PRB grid (subcarriers -36..-1,
    +1..+36)."""
    re, im = dft_matrix()
    bins = np.concatenate([np.arange(SYMBOL_SZ - 36, SYMBOL_SZ),
                           np.arange(1, 37)])
    return re[bins], im[bins]


@functools.lru_cache(maxsize=None)
def _on(which: str, device: str):
    re, im = dft_sync62() if which == "sync" else dft_pbch72()
    return torch.from_numpy(re).to(device), torch.from_numpy(im).to(device)


def dft_sync(x: cplx.Pair) -> cplx.Pair:
    """[..., 128] time pair -> [..., 62] sync subcarriers."""
    re, im = _on("sync", str(x[0].device))
    return cplx.matmul_real_pair(re, im, x)


def dft_grid(x: cplx.Pair) -> cplx.Pair:
    """[..., 128] time pair -> [..., 72] PBCH-grid subcarriers."""
    re, im = _on("grid", str(x[0].device))
    return cplx.matmul_real_pair(re, im, x)
