"""Plain reference of the wideband channelizer, in PyTorch float64.

Written from the observable contract (ltetrigger_tpu_torch/ops/channelize.py
module docstring, ops/resample.decimate): it imports nothing of the program
and takes nothing the program made.

Lane c of a capture x [N] at `ratio` x 1.92 Msps is x mixed down by the
centre's offset f_c and low-pass filtered, one output each `ratio` samples:

    z_c[w]    = x[w] exp(-2 pi i (f_c w / rate mod 1)),  0 <= w < N
    lane_c[n] = sum_j h[j] z_c[ratio n - L + j],  0 <= n < N // ratio

with the phase taken mod 1 in float64, z zero outside the capture, h the
Hamming-windowed sinc of `design_lowpass(ratio, 16)` (16 * ratio taps) and
L = 8 * ratio, the filter's centre (the alignment of `refrx.decimate`:
filtered sample ratio * n is output n).  The sum runs in polyphase form:
with Z[m, p] = z[ratio m + p] and H[p, q] = h[ratio q + p],
lane[n] = sum_q (Z H)[n + q - 8, q], in float64, in blocks of centres and
of output samples so that it fits on the card.

`pass_a_inputs` hands the lanes on to pass A's reference
(`reference.passab`) in the precision the configuration states, bf16.  The
program's float32 lanes differ from these by ~1e-6 relative, so a sample
near a midpoint between two bf16 values rounds to the one in the program
and to the other here, ~0.4 % apart, and one such sample moves a 128-tap
correlation's power by up to ~7e-4.  A sample whose program value lies
within `tie_rel` of the lane's rms of the exact value is therefore a tie
where the two round apart: either rounding is sound, and the reference
takes the program's (as `passab` takes the program's side of a ratio at
the threshold).  Ties are counted.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..gen.ltecore.constants import SAMPLE_RATE
from ..gen.ltecore.refrx import design_lowpass

TAPS_PER_PHASE = 16


def lanes(x: torch.Tensor, sample_rate: float, offsets_hz, n_out: int,
          centres_at_once: int = 16, outs_at_once: int = 1 << 18) \
        -> torch.Tensor:
    """x [N] complex (any precision) on the device to compute on ->
    [C, n_out] complex128: the lane of each centre offset, n_out <= N //
    ratio."""
    ratio = int(round(sample_rate / SAMPLE_RATE))
    dev = x.device
    h = torch.from_numpy(design_lowpass(ratio, TAPS_PER_PHASE)).to(dev)
    hmat = h.reshape(TAPS_PER_PHASE, ratio).T.to(torch.complex128)  # [p, q]
    lead = (TAPS_PER_PHASE // 2) * ratio
    x = x.to(torch.complex128)
    n = x.numel()
    offs = torch.tensor([float(f) / sample_rate for f in offsets_hz],
                        dtype=torch.float64, device=dev)
    out = torch.empty((offs.numel(), n_out), dtype=torch.complex128,
                      device=dev)
    for n0 in range(0, n_out, outs_at_once):
        nb = min(outs_at_once, n_out - n0)
        w0 = ratio * n0 - lead
        length = ratio * (nb + TAPS_PER_PHASE)
        seg = torch.zeros(length, dtype=torch.complex128, device=dev)
        a, b = max(w0, 0), min(w0 + length, n)
        seg[a - w0:b - w0] = x[a:b]
        w = torch.arange(w0, w0 + length, dtype=torch.float64, device=dev)
        for c0 in range(0, offs.numel(), centres_at_once):
            f = offs[c0:c0 + centres_at_once, None]
            ph = torch.remainder(-f * w[None, :], 1.0) * (2 * math.pi)
            z = seg[None, :] * torch.polar(torch.ones_like(ph), ph)
            y = z.reshape(z.shape[0], nb + TAPS_PER_PHASE, ratio) @ hmat
            acc = y[:, 0:nb, 0].clone()
            for q in range(1, TAPS_PER_PHASE):
                acc += y[:, q:q + nb, q]
            out[c0:c0 + centres_at_once, n0:n0 + nb] = acc
    return out


def rel_err(got: tuple, ref: torch.Tensor) -> np.ndarray:
    """[C] float64: ||got_c - ref_c||_2 / ||ref_c||_2 of each lane, got a
    (re, im) pair of [C', >= n] tensors, ref [C, n] complex128; a lane that
    got lacks (c >= C') reads 1."""
    n = ref.shape[-1]
    errs = []
    for c in range(ref.shape[0]):
        if c >= got[0].shape[0]:
            errs.append(1.0)
            continue
        g = torch.complex(got[0][c, :n].to(ref.device, torch.float64),
                          got[1][c, :n].to(ref.device, torch.float64))
        errs.append(float(torch.linalg.vector_norm(g - ref[c])
                          / torch.clamp(torch.linalg.vector_norm(ref[c]),
                                        min=1e-300)))
    return np.asarray(errs)


def pass_a_inputs(ref: torch.Tensor, got, n: int, tie_rel: float,
                  lanes_at_once: int = 16) -> tuple[tuple, int]:
    """((re, im) [C, n] float32 holding bf16 values, ties): the first n
    samples of each reference lane [C, >= n] complex128 rounded to bf16,
    the program's rounding taken at ties.  got: the program's (re, im)
    pair [C', >= n] float32, or None; lanes it lacks have no ties."""
    c, dev = ref.shape[0], ref.device
    out = [torch.empty((c, n), dtype=torch.float32, device=dev)
           for _ in range(2)]
    have = 0 if got is None else got[0].shape[0]
    ties = 0
    for c0 in range(0, c, lanes_at_once):
        c1 = min(c0 + lanes_at_once, c)
        r = ref[c0:c1, :n]
        eps = tie_rel * r.abs().square().mean(dim=-1, keepdim=True).sqrt()
        h = max(0, min(c1, have) - c0)
        for k, exact in enumerate((r.real, r.imag)):
            own = exact.to(torch.bfloat16)
            if h:
                p = got[k][c0:c0 + h, :n].to(dev)
                pb = p.to(torch.bfloat16)
                take = ((p.double() - exact[:h]).abs() <= eps[:h]) \
                    & (pb != own[:h])
                ties += int(take.sum())
                own[:h] = torch.where(take, pb, own[:h])
            out[k][c0:c1] = own.float()
    return tuple(out), ties
