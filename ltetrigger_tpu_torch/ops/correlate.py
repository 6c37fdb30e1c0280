"""PSS matched filtering: blocked-Toeplitz weights, window power, peak/PSR.

Port of ltetrigger_tpu/ops/correlate.py.  The weight banks are rebuilt here
in numpy from `ltecore` (byte-identical to the JAX package's, which the
tests check).  Split a window into non-overlapping 128-sample blocks X[j];
for output positions p in block j

    c[128 j + p] = X[j] @ WL[:, p] + X[j+1] @ WU[:, p]

with banded-triangular weights WL[q, p] = w[q - p] (q >= p) and
WU[q, p] = w[q + 128 - p] (q < p), stacked over {3 roots} x {re/im out} x
{re/im in}.  The grid engine's pass A runs the same correlation as one
K=512 matmul against `_toeplitz_weights_fat`, through the hand-written
CUDA kernel in ops/kernels/matched_filter.py.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..ltecore import pss as pssmod
from ..ltecore.constants import HALF_FRAME_LENGTH, SYMBOL_SZ
from . import cplx

SEARCH_LEN = HALF_FRAME_LENGTH                   # 9600 candidate starts
WINDOW_LEN = HALF_FRAME_LENGTH + SYMBOL_SZ - 1   # samples the filter reads
N_ROOTS = 3
NBLK = HALF_FRAME_LENGTH // SYMBOL_SZ            # 75
V2_WINDOW = HALF_FRAME_LENGTH + SYMBOL_SZ        # 9728 samples read


@functools.lru_cache(maxsize=None)
def _kernel() -> np.ndarray:
    """[6, 2, 128] float32 conv kernel for all three roots: out 2t (re of
    root t) = [rr_t, ri_t], out 2t + 1 (im of root t) = [-ri_t, rr_t]."""
    rr, ri = cplx.const(pssmod.pss_time())       # each [3, 128]
    k = np.zeros((2 * N_ROOTS, 2, SYMBOL_SZ), dtype=np.float32)
    for t in range(N_ROOTS):
        k[2 * t, 0] = rr[t]
        k[2 * t, 1] = ri[t]
        k[2 * t + 1, 0] = -ri[t]
        k[2 * t + 1, 1] = rr[t]
    return k


@functools.lru_cache(maxsize=None)
def _kernel_on(device: str) -> torch.Tensor:
    return torch.from_numpy(_kernel()).to(device)


def pss_correlate_power(window: cplx.Pair) -> torch.Tensor:
    """|corr|^2 for all 3 roots over windows, as ONE dense [2-in, 6-out,
    128-wide] real convolution (c[n] = sum_k x[n + k] conj(r[k])).  It never
    touches the Toeplitz weights, so it cross-checks the matched-filter
    kernel and its plain version independently.

    window: pair of [..., >= WINDOW_LEN] float32
    returns: [..., 3, SEARCH_LEN] float32
    """
    wr, wi = window
    batch = wr.shape[:-1]
    x = torch.stack([wr[..., :WINDOW_LEN], wi[..., :WINDOW_LEN]], dim=-2)
    y = torch.nn.functional.conv1d(x.reshape(-1, 2, WINDOW_LEN),
                                   _kernel_on(str(wr.device)))  # [B, 6, 9600]
    y = y.reshape(batch + (N_ROOTS, 2, SEARCH_LEN))
    return y[..., 0, :] ** 2 + y[..., 1, :] ** 2


@functools.lru_cache(maxsize=None)
def _toeplitz_weights(cfo_bin: float = 0):
    """(WL, WU): [256, 768] float32 each.

    Contraction axis: [x_re block (128), x_im block (128)].
    Output axis: [root, comp, p] flattened as root * 256 + comp * 128 + p
    with comp 0 = re, 1 = im.

    cfo_bin != 0 builds the bank for replicas shifted by that many
    subcarrier spacings (replica_b[n] = rep[n] * exp(2j*pi*b*n/128)); the
    integer-CFO probe uses half-integer bins.
    """
    reps = pssmod.pss_time()                     # [3, 128] complex
    if cfo_bin:
        n = np.arange(SYMBOL_SZ)
        reps = reps * np.exp(2j * np.pi * cfo_bin * n / SYMBOL_SZ)
    rr, ri = cplx.const(reps)                    # [3, 128]
    WL = np.zeros((2, 128, N_ROOTS, 2, 128), dtype=np.float32)
    WU = np.zeros((2, 128, N_ROOTS, 2, 128), dtype=np.float32)
    q = np.arange(128)
    for t in range(N_ROOTS):
        for p in range(128):
            lo = q >= p            # tap index k = q - p in [0, 128)
            hi = q < p             # tap index k = q + 128 - p
            # re(c) = x_re*w_re + x_im*w_im ; im(c) = x_im*w_re - x_re*w_im
            WL[0, lo, t, 0, p] = rr[t][q[lo] - p]
            WL[1, lo, t, 0, p] = ri[t][q[lo] - p]
            WL[0, lo, t, 1, p] = -ri[t][q[lo] - p]
            WL[1, lo, t, 1, p] = rr[t][q[lo] - p]
            WU[0, hi, t, 0, p] = rr[t][q[hi] + 128 - p]
            WU[1, hi, t, 0, p] = ri[t][q[hi] + 128 - p]
            WU[0, hi, t, 1, p] = -ri[t][q[hi] + 128 - p]
            WU[1, hi, t, 1, p] = rr[t][q[hi] + 128 - p]
    return (WL.reshape(256, N_ROOTS * 256),
            WU.reshape(256, N_ROOTS * 256))


@functools.lru_cache(maxsize=None)
def _toeplitz_weights_fat(cfo_bin: float = 0):
    """[512, 768] float32: the grid engine's one-matmul weight bank (of the
    replicas shifted by `cfo_bin` subcarriers, as in `_toeplitz_weights`).

    Contraction axis: [x0_re | x0_im | x1_re | x1_im] (x1 = x0 shifted one
    128-block).  Output axis COMP-MAJOR: [comp, root, p], so the power is
    the square-sum of two contiguous 384-column halves."""
    WL, WU = _toeplitz_weights(cfo_bin)

    def cm(W):
        W5 = W.reshape(2, SYMBOL_SZ, N_ROOTS, 2, SYMBOL_SZ)
        return np.ascontiguousarray(
            np.moveaxis(W5, 3, 2).reshape(256, 768))
    return np.concatenate([cm(WL), cm(WU)], axis=0)


@functools.lru_cache(maxsize=None)
def weights_fat(device: str, cfo_bin: float = 0) -> torch.Tensor:
    """`_toeplitz_weights_fat` as a float32 tensor on `device` (cached)."""
    return torch.from_numpy(_toeplitz_weights_fat(cfo_bin)).to(device)


@functools.lru_cache(maxsize=None)
def _weights_lu(device: str, bins: tuple = (0,)) \
        -> tuple[torch.Tensor, torch.Tensor]:
    """(WL, WU) of every bin in `bins` side by side: [256, len(bins) * 768]."""
    WL, WU = (np.concatenate([_toeplitz_weights(b)[i] for b in bins], axis=1)
              for i in (0, 1))
    return torch.from_numpy(WL).to(device), torch.from_numpy(WU).to(device)


def _window_blocks(window: cplx.Pair):
    """(x0, x1): the window's 75 blocks [re | im] and the same one block
    later, [..., 75, 256] each."""
    wr, wi = window
    batch = wr.shape[:-1]
    return tuple(torch.cat(
        [wr[..., a:a + HALF_FRAME_LENGTH].reshape(batch + (NBLK, SYMBOL_SZ)),
         wi[..., a:a + HALF_FRAME_LENGTH].reshape(batch + (NBLK, SYMBOL_SZ))],
        dim=-1) for a in (0, SYMBOL_SZ))


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (nearest even) and back to float32.

    `jnp.dot(bf16, bf16, preferred_element_type=float32)` multiplies the
    rounded inputs and accumulates in float32; `torch.matmul` on bf16
    tensors would round its OUTPUT to bf16 as well, so the plain versions
    round the inputs and run a float32 matmul instead."""
    return x.to(torch.bfloat16).to(torch.float32)


def pss_correlate_power_v2(window: cplx.Pair,
                           matmul_dtype=torch.float32) -> torch.Tensor:
    """|corr|^2 for all 3 roots over windows, via blocked-Toeplitz matmuls.

    The plain PyTorch version of the matched-filter kernel's window entry
    (ops/kernels/matched_filter.pss_correlate_power).

    window: pair of [..., >= V2_WINDOW] float32
    matmul_dtype: torch.float32, or torch.bfloat16 for bf16 inputs with
        float32 accumulation
    returns: [..., 3, SEARCH_LEN] float32
    """
    return pss_correlate_power_cfo_bins(window, (0,), matmul_dtype)[..., 0,
                                                                   :, :]


def pss_correlate_power_cfo_bins(window: cplx.Pair,
                                 bins=(-2, -1, 0, 1, 2),
                                 matmul_dtype=torch.bfloat16) -> torch.Tensor:
    """Correlation power against replica banks shifted by `bins` subcarrier
    spacings: every bin is more output channels of the same two matmuls.
    Finds cells whose carrier offset exceeds the matched filter's tolerance
    (~0.3 subcarrier).

    The plain PyTorch version of ops/kernels/matched_filter.
    pss_correlate_power_cfo_bins, which runs one kernel launch per bin.

    window: pair of [..., >= V2_WINDOW] float32
    returns: [..., len(bins), 3, SEARCH_LEN] float32
    """
    batch = window[0].shape[:-1]
    x0, x1 = _window_blocks(window)                  # [..., 75, 256]
    WL, WU = _weights_lu(str(window[0].device), tuple(bins))
    if matmul_dtype == torch.bfloat16:
        x0, x1, WL, WU = (round_bf16(a) for a in (x0, x1, WL, WU))
    c = x0 @ WL + x1 @ WU                            # [..., 75, bins * 768]
    c = c.reshape(batch + (NBLK, len(bins), N_ROOTS, 2, SYMBOL_SZ))
    power = c[..., 0, :] ** 2 + c[..., 1, :] ** 2    # [.., 75, bins, 3, 128]
    return power.movedim(-4, -2).reshape(batch + (len(bins), N_ROOTS,
                                                  SEARCH_LEN))


def _kernel_power(window: cplx.Pair, matmul_dtype) -> torch.Tensor:
    """The window contract through the hand-written matched-filter kernel
    (CUDA tensors; its plain version, `pss_correlate_power_v2`, on CPU
    tensors), for any leading shape."""
    from .kernels import matched_filter
    wr, wi = window
    batch = wr.shape[:-1]
    flat = tuple(c.reshape(-1, c.shape[-1]).contiguous() for c in window)
    power = matched_filter.pss_correlate_power(flat, matmul_dtype)
    return power.reshape(batch + power.shape[1:])


def pss_correlate_power_fast(window: cplx.Pair) -> torch.Tensor:
    """The blocked-Toeplitz correlation with bf16 matmul inputs (f32
    accumulation): on a card the matched-filter kernel's tensor-core body.
    Keeps every f32 peak position (tests/test_torch_standalone_ops.py).

    window: pair of [..., >= V2_WINDOW] float32
    returns: [..., 3, SEARCH_LEN] float32
    """
    return _kernel_power(window, torch.bfloat16)


# LTETRIGGER_CORRELATOR, read at import as in the JAX package: the grid
# engine's pass A always runs the blocked-Toeplitz form and takes the
# variable as a PRECISION switch ("fast" = bf16 inputs, the default; anything
# else = f32).  The conv form ("v1") stays the independent cross-check behind
# these standalone entry points.
_IMPLS = {"fast": pss_correlate_power_fast,
          "v2": functools.partial(_kernel_power, matmul_dtype=torch.float32),
          "v1": pss_correlate_power}
default_power = _IMPLS[os.environ.get("LTETRIGGER_CORRELATOR", "fast")]


def peak_and_psr(power: torch.Tensor, lobe_limit: int = 64):
    """Peak position and peak-to-sidelobe ratio (power domain).

    Walk down the main lobe on each side until the first rise (bounded by
    lobe_limit); the sidelobe is the max outside the lobe.  The last (first)
    element's right (left) neighbour is itself, so it never rises.

    power: [..., SEARCH_LEN] float32
    returns: (peak_pos int32 [...], psr float32 [...])
    """
    n = power.shape[-1]
    peak = torch.argmax(power, dim=-1)
    pk_val = torch.take_along_dim(power, peak[..., None], dim=-1)[..., 0]

    idx = torch.arange(n, device=power.device)
    rel = idx - peak[..., None]

    shifted = torch.cat([power[..., 1:], power[..., -1:]], dim=-1)
    rise = shifted > power
    right_edge = torch.where((rel >= 1) & (rel <= lobe_limit) & rise,
                             rel, lobe_limit).amin(dim=-1)
    shiftedl = torch.cat([power[..., :1], power[..., :-1]], dim=-1)
    risel = shiftedl > power
    left_edge = torch.where((-rel >= 1) & (-rel <= lobe_limit) & risel,
                            -rel, lobe_limit).amin(dim=-1)

    in_lobe = (rel >= -left_edge[..., None]) & (rel <= right_edge[..., None])
    side = torch.where(in_lobe, 0.0, power).amax(dim=-1)
    psr = pk_val / torch.clamp(side, min=1e-30)
    return peak.to(torch.int32), psr.to(torch.float32)


def peak_and_psr_blocked(power: torch.Tensor, lobe_limit: int = 64):
    """peak_and_psr on BLOCK-structured power [..., 75, R, 128] — the
    layout pass A produces.

    Two full passes: per-block max/argmax, then the peak's 3-block
    neighbourhood by index (every lobe element is within +-64 of the peak);
    the out-of-neighbourhood sidelobe comes from the per-block maxima.
    Identical to the flat version, including first-occurrence argmax ties
    and the duplicate-self rise at the stream's ends.

    returns: (peak_pos int32 [..., R] in [0, 9600), psr float32 [..., R])
    """
    nb, nm = power.shape[-3], power.shape[-1]        # 75, 128
    assert lobe_limit <= nm // 2
    dev = power.device
    in_max = power.amax(dim=-1)                      # [.., 75, R]
    in_arg = torch.argmax(power, dim=-1)
    blk = torch.argmax(in_max.movedim(-2, -1), dim=-1)        # [.., R]
    m = torch.take_along_dim(in_arg.movedim(-2, -1), blk[..., None],
                             dim=-1)[..., 0]
    peak = blk * nm + m
    pk_val = in_max.amax(dim=-2)                     # [.., R]

    nb0 = torch.clamp(blk - 1, 0, nb - 3)
    rows = nb0[..., None, None] + torch.arange(3, device=dev)[:, None]
    hood = torch.take_along_dim(power.movedim(-3, -2), rows, dim=-2)
    hood = hood.reshape(hood.shape[:-2] + (3 * nm,))     # [.., R, 384]
    absi = nb0[..., None] * nm + torch.arange(3 * nm, device=dev)
    rel = absi - peak[..., None]

    # the hood's far ends only matter where they are the stream's ends,
    # where the element's neighbour is itself (interior hood ends sit at
    # |rel| >= 128 > lobe_limit)
    shifted = torch.cat([hood[..., 1:], hood[..., -1:]], dim=-1)
    rise = shifted > hood
    right_edge = torch.where((rel >= 1) & (rel <= lobe_limit) & rise,
                             rel, lobe_limit).amin(dim=-1)
    shiftedl = torch.cat([hood[..., :1], hood[..., :-1]], dim=-1)
    risel = shiftedl > hood
    left_edge = torch.where((-rel >= 1) & (-rel <= lobe_limit) & risel,
                            -rel, lobe_limit).amin(dim=-1)
    in_lobe = (rel >= -left_edge[..., None]) & (rel <= right_edge[..., None])
    side_in = torch.where(in_lobe, 0.0, hood).amax(dim=-1)
    bidx = torch.arange(nb, device=dev)
    out_blk = (bidx[:, None] < nb0[..., None, :]) \
        | (bidx[:, None] > nb0[..., None, :] + 2)       # [.., 75, R]
    side_out = torch.where(out_blk, in_max, 0.0).amax(dim=-2)
    psr = pk_val / torch.clamp(torch.maximum(side_in, side_out), min=1e-30)
    return peak.to(torch.int32), psr.to(torch.float32)
