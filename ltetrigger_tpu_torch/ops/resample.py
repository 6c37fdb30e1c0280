"""Resampling to the 1.92 Msps sensing rate.

Port of ltetrigger_tpu/ops/resample.py: integer decimation as a strided
conv1d, rational up/down resampling as a polyphase gather + contraction.
The taps are rebuilt here from `ltecore.refrx.design_lowpass` (numpy).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ltecore.refrx import design_lowpass
from . import cplx


@functools.lru_cache(maxsize=None)
def _taps(ratio: int, taps_per_phase: int = 16) -> np.ndarray:
    return design_lowpass(ratio, taps_per_phase).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rational_taps(up: int, down: int, taps_per_phase: int = 16) -> np.ndarray:
    """Anti-alias/anti-image filter for up/down rational resampling:
    windowed sinc at cutoff min(1/up, 1/down) of the upsampled rate,
    gain `up` (to compensate zero-stuffing energy loss)."""
    n = taps_per_phase * max(up, down)
    t = np.arange(n) - (n - 1) / 2
    cutoff = 1.0 / max(up, down)
    h = np.sinc(t * cutoff) * cutoff * np.hamming(n)
    return (up * h / h.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _taps_on(ratio: int, device: str) -> torch.Tensor:
    """The decimator's taps on `device`, uploaded once: a copy from pageable
    memory per call would make a streaming caller wait for the stream."""
    return torch.from_numpy(_taps(ratio)).to(device)


@functools.lru_cache(maxsize=None)
def _rational_taps_on(up: int, down: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_rational_taps(up, down)).to(device)


def rational_resample(x: cplx.Pair, up: int, down: int) -> cplx.Pair:
    """Rational-rate conversion by up/down (polyphase).

    Output n uses ntp = ceil(nt/up) taps of one filter branch:
      y[n] = sum_j h[k0 + up*j] * x[base + j],
      k0 = (lead - n*down) % up, base = (n*down - lead + k0) // up.
    """
    g = math.gcd(up, down)
    up //= g
    down //= g
    if up == 1:
        return decimate(x, down) if down > 1 else x

    dev = x[0].device
    h = _rational_taps_on(up, down, str(dev))
    nt = h.shape[0]
    lead = (nt - 1) // 2
    n_in = x[0].shape[-1]
    n_out = (n_in * up) // down
    batch_shape = x[0].shape[:-1]
    ntp = -(-nt // up)                           # taps per polyphase branch

    xr = torch.stack([x[0].reshape(-1, n_in), x[1].reshape(-1, n_in)], dim=1)
    pad = ntp + 2
    xr = torch.nn.functional.pad(xr, (pad, pad))

    ns = torch.arange(n_out, device=dev)
    k0 = torch.remainder(lead - ns * down, up)
    base = torch.div(ns * down - lead + k0, up, rounding_mode="floor")
    j = torch.arange(ntp, device=dev)
    tap_idx = k0[:, None] + up * j[None, :]      # [n_out, ntp]
    w = torch.where(tap_idx < nt, h[torch.clamp(tap_idx, max=nt - 1)], 0.0)
    src = torch.clamp(base[:, None] + j[None, :] + pad, 0, xr.shape[-1] - 1)
    gathered = xr[:, :, src]                     # [B, 2, n_out, ntp]
    y = torch.einsum("bcnk,nk->bcn", gathered, w)
    out_shape = batch_shape + (n_out,)
    return (y[:, 0].reshape(out_shape), y[:, 1].reshape(out_shape))


def decimate(x: cplx.Pair, ratio: int) -> cplx.Pair:
    """pair of [..., N] -> pair of [..., ceil(N / ratio)].

    Filter center-aligned (group delay compensated), output sample n taken
    from filtered sample n * ratio.  conv1d correlates (no kernel flip);
    with the symmetric filter this is the convolution iff the pad is
    mirrored.  cuDNN would run a float32 conv in TF32, so it is disabled
    here.
    """
    if ratio == 1:
        return x
    h = _taps_on(ratio, str(x[0].device))
    nt = h.shape[0]
    lead = (nt - 1) // 2
    batch_shape = x[0].shape[:-1]
    n = x[0].shape[-1]

    xr = torch.stack([x[0].reshape(-1, n), x[1].reshape(-1, n)], dim=1)
    xr = torch.nn.functional.pad(xr, (nt - 1 - lead, lead))
    k = h.reshape(1, 1, nt).expand(2, 1, nt)     # same filter per channel
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = torch.nn.functional.conv1d(xr, k, stride=ratio, groups=2)
    out_n = y.shape[-1]
    return (y[:, 0].reshape(batch_shape + (out_n,)),
            y[:, 1].reshape(batch_shape + (out_n,)))
