"""Plain reference of the trigger's passes A and B, in PyTorch float64.

Written from the observable contract (ltetrigger_tpu_torch/models/trigger.py
module docstring, the srsLTE semantics it keeps): it imports nothing of the
program and takes nothing the program made.

Pass A: the PSS matched-filter power of every grid step, c[p] = sum_k
x[p + k] conj(r[k]) over the 128-sample unit-energy replica r of each root,
power |c|^2, for the 9600 candidate starts of each half-frame step.  The
samples and the replica are first rounded to the precision the
configuration states for pass A (`round_to`); the sums run in float64 (an
FFT correlation), so the reference follows the stated precision's inputs
and not any order of accumulation.

Pass B: per lane (channel or stream, root) the recurrence over steps: the
exponential average of the power on search steps (every step until
tracking, then every `track_every`-th), the peak and its peak-to-sidelobe
ratio (walk down the main lobe on each side to the first rise, at most 64
bins; the sidelobe is the largest power outside the lobe), the hysteresis
score, tracking after `track_after` steps over the threshold, a loss when a
scoring lane falls under it; the average is cleared on a crossing and on a
loss.

A step whose ratio lies within `tie_rel` of the threshold is a tie: either
side of it is sound, and the reference takes the side the program took
there (`port_over`), so that one tie does not set the two trajectories
apart for the rest of the run.  Ties are counted.
"""

from __future__ import annotations

import torch

from ..gen.ltecore import pss as pssmod
from ..gen.ltecore.constants import (HALF_FRAME_LENGTH, PSR_EMA_ALPHA,
                                     SYMBOL_SZ)

LOBE = 64


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """float32 values -> float64 after rounding to `precision`: "float32"
    (none), "bfloat16" (round to nearest even), "fp8_e4m3" (scaled to the
    type's range by the tensor's largest magnitude, rounded, scaled back,
    as fp8 inference quantises a tensor)."""
    x = x.to(torch.float32)
    if precision == "float32":
        return x.to(torch.float64)
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float64)
    if precision == "fp8_e4m3":
        scale = 240.0 / torch.clamp(x.abs().amax(), min=1e-30)
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float64) / scale
    raise ValueError(f"unknown precision {precision!r}")


def replicas(precision: str, device) -> torch.Tensor:
    """[3, 128] complex128: the PSS replicas, float32 values rounded to
    `precision`."""
    r = torch.from_numpy(pssmod.pss_time()).to(torch.complex64)
    return torch.complex(round_to(r.real, precision),
                         round_to(r.imag, precision)).to(device)


def correlation_power(re: torch.Tensor, im: torch.Tensor, grid0: int,
                      n_steps: int, precision: str,
                      lanes_at_once: int = 16) -> torch.Tensor:
    """Pass A of lanes re/im [L, N] float32 (reads past N are zeros):
    [L, n_steps, 3, 9600] float64, step t's candidate p at sample grid0 +
    9600 t + p."""
    lanes, n = re.shape
    span = n_steps * HALF_FRAME_LENGTH
    need = grid0 + span + SYMBOL_SZ
    size = 1 << max(need - 1, 1).bit_length()
    rep = replicas(precision, re.device)
    rf = torch.fft.fft(rep, n=size)                       # [3, size]
    out = torch.empty((lanes, n_steps, 3, HALF_FRAME_LENGTH),
                      dtype=torch.float64, device=re.device)
    for lo in range(0, lanes, lanes_at_once):
        hi = min(lo + lanes_at_once, lanes)
        x = torch.complex(round_to(re[lo:hi, :need], precision),
                          round_to(im[lo:hi, :need], precision))
        xf = torch.fft.fft(x, n=size)                     # [l, size]
        c = torch.fft.ifft(xf[:, None, :] * rf.conj()[None], dim=-1)
        p = c[..., grid0:grid0 + span].abs().square()     # [l, 3, span]
        out[lo:hi] = p.reshape(hi - lo, 3, n_steps, HALF_FRAME_LENGTH) \
            .permute(0, 2, 1, 3)
    return out


def peak_and_psr(power: torch.Tensor):
    """power [..., 9600] -> (peak [...] int64, psr [...] float64)."""
    n = power.shape[-1]
    peak = torch.argmax(power, dim=-1)
    pk = torch.take_along_dim(power, peak[..., None], dim=-1)[..., 0]
    rel = torch.arange(n, device=power.device) - peak[..., None]
    nxt = torch.cat([power[..., 1:], power[..., -1:]], dim=-1)
    prv = torch.cat([power[..., :1], power[..., :-1]], dim=-1)
    big = torch.full_like(peak, LOBE)
    right = torch.where((rel >= 1) & (rel <= LOBE) & (nxt > power), rel,
                        LOBE).amin(dim=-1)
    left = torch.where((-rel >= 1) & (-rel <= LOBE) & (prv > power), -rel,
                       LOBE).amin(dim=-1)
    right, left = torch.minimum(right, big), torch.minimum(left, big)
    lobe = (rel >= -left[..., None]) & (rel <= right[..., None])
    side = torch.where(lobe, 0.0, power).amax(dim=-1)
    return peak, pk / torch.clamp(side, min=1e-30)


def pass_b(power_at, n_steps: int, lanes: tuple, device, threshold: float,
           track_after: int, track_every: int, port_over=None,
           tie_rel: float = 0.0) -> dict:
    """The recurrence over `n_steps` from a fresh state.

    power_at(t) -> [*lanes, 3, 9600] float64, step t's pass-A power.
    port_over: optional [n_steps, *lanes, 3] bool, where the program's
    ratio was over the threshold (its score > 0), taken at ties.
    returns psr, score, tracking [n_steps, *lanes, 3]; the last peak
    [*lanes, 3]; ties [n_steps, *lanes, 3] bool."""
    shape = tuple(lanes) + (3,)
    f64 = dict(dtype=torch.float64, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    ema = torch.zeros(shape + (HALF_FRAME_LENGTH,), **f64)
    score = torch.zeros(shape, **i64)
    timer = torch.zeros(shape, **i64)
    tracking = torch.zeros(shape, dtype=torch.bool, device=device)
    psr = torch.zeros(shape, **f64)
    peak = torch.zeros(shape, **i64)
    rows = {k: [] for k in ("psr", "score", "tracking", "ties")}
    for t in range(n_steps):
        search = (~tracking) | (timer == 0)
        timer = torch.where(search, track_every, timer - 1)
        ema = torch.where(search[..., None],
                          PSR_EMA_ALPHA * power_at(t)
                          + (1 - PSR_EMA_ALPHA) * ema, ema)
        pk_new, psr_new = peak_and_psr(ema)
        psr = torch.where(search, psr_new, psr)
        peak = torch.where(search, pk_new, peak)
        over = psr > threshold
        tie = torch.zeros_like(over)
        if port_over is not None:
            near = (psr - threshold).abs() <= tie_rel * threshold
            tie = near & (port_over[t] != over)
            over = torch.where(near, port_over[t], over)
        score_inc = torch.clamp(score + 1, max=track_after)
        crossing = over & (~tracking) & (score_inc == track_after)
        lost = (~over) & (score > 0)
        score = torch.where(over, score_inc, 0)
        tracking = over & (tracking | crossing)
        ema = torch.where((crossing | lost)[..., None], 0.0, ema)
        timer = torch.where(lost, 0, timer)
        for k, v in (("psr", psr), ("score", score), ("tracking", tracking),
                     ("ties", tie)):
            rows[k].append(v)
    out = {k: torch.stack(v) for k, v in rows.items()}
    out["peak"] = peak
    return out
