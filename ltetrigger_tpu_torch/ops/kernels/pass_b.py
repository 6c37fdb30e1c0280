"""Pass B of the grid engine: the PSS tracking recurrence over one group of
half-frame steps, as the hand-written CUDA kernel and its plain PyTorch
version.

Replaces the JAX package's device loop of pass B: the `lax.scan` of
`_step_core` (ltetrigger_tpu/models/trigger.py:292, scans :422-424) with
`correlate.peak_and_psr_blocked` (ltetrigger_tpu/ops/correlate.py:291).
The CUDA source is ltetrigger_tpu_torch/csrc/pass_b.cu; its header gives
the design and the bound.

  scan_group(state, power, grid0, n_active, psr_threshold, track_after,
             track_every) -> (state, rows)
      power [*B, g, 75, 3, 128] float32 is pass A's output for the g steps
      of a group whose first step's grid start is `grid0`; the first
      `n_active` steps are active (a host integer: active steps are a
      prefix), the rest repeat the state with emit, lost and consumed zero.
      rows are the seven per-step tensors (peak, psr, score, tracking,
      emit, lost, consumed), each [g, *B, 3].

On a CPU tensor `scan_group` runs `scan_group_plain` (one `_step_core` per
step, ~45 small ops); on a CUDA tensor it launches the kernel or raises.
`launches` counts kernel launches.  The kernel writes a new state; it
updates nothing in place.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ...ltecore.constants import (HALF_FRAME_LENGTH, MOVING_AVG_SZ,
                                  PSR_EMA_ALPHA, SYMBOL_SZ)
from .. import correlate
from . import build

R = correlate.N_ROOTS
launches = 0          # kernel launches
_fn = None

THREADS = 320         # pass_b.cu: a block per (channel, root)
BLOCKS_PER_SM = 3     # its __launch_bounds__


# ------------------------------------------------------------ plain version
def ring_push(ring, count, value):
    """ring[.., count % 200] = value (the telemetry rings' push)."""
    idx = torch.remainder(count, MOVING_AVG_SZ)[..., None]
    slots = torch.arange(MOVING_AVG_SZ, device=ring.device)
    return torch.where(slots == idx, value[..., None], ring)


def _step_core(state, power, grid: int, psr_threshold: float,
               track_after: int, track_every: int):
    """One active half-frame step (trailing [R]; power [..., 75, R, 128]).

    Returns (next state, per-step outputs as a dict of [.., R] tensors)."""
    search = (~state.tracking) | (state.timer == 0)
    timer = torch.where(search, track_every, state.timer - 1)

    s4 = search[..., None, :, None]
    ema = torch.where(s4, PSR_EMA_ALPHA * power
                      + (1 - PSR_EMA_ALPHA) * state.ema, state.ema)
    peak_new, psr_new = correlate.peak_and_psr_blocked(ema)
    psr = torch.where(search, psr_new, state.psr)
    peak = torch.where(search, peak_new, state.peak)

    psr_ring = torch.where(search[..., None],
                           ring_push(state.psr_ring, state.psr_count, psr),
                           state.psr_ring)
    psr_count = state.psr_count + search.to(torch.int32)

    # --- hysteresis scoring (reference incr_score / reset_score) ---
    over = psr > psr_threshold
    score_inc = torch.clamp(state.score + 1, max=track_after)
    crossing = over & (~state.tracking) & (score_inc == track_after)
    lost = (~over) & (state.score > 0)

    score = torch.where(over, score_inc, 0)
    tracking = over & (state.tracking | crossing)
    ema = torch.where((crossing | lost)[..., None, :, None], 0.0, ema)
    timer = torch.where(lost, 0, timer)
    psr_ring = torch.where(lost[..., None], 0.0, psr_ring)
    psr_count = torch.where(lost, 0, psr_count)
    psr_max = torch.maximum(state.psr_max, psr)
    emit = over | lost

    nxt = state._replace(
        pos=torch.full_like(state.pos, grid + HALF_FRAME_LENGTH),
        ema=ema, score=score, timer=timer, tracking=tracking, psr=psr,
        peak=peak, psr_max=psr_max, psr_ring=psr_ring, psr_count=psr_count)
    out = {"emit": emit, "lost": emit & lost,
           "consumed": torch.full_like(score, HALF_FRAME_LENGTH)}
    return nxt, out


def idle_rows(state, g: int) -> tuple:
    """The rows of g inactive steps: the state's peak, psr, score and
    tracking repeated, emit, lost and consumed zero; each [g, *B, 3]."""
    zero_b = torch.zeros_like(state.tracking)
    zero_i = torch.zeros_like(state.score)
    return tuple(x.expand((g,) + x.shape) for x in (
        state.peak, state.psr, state.score, state.tracking, zero_b, zero_b,
        zero_i))


def scan_group_plain(state, power: torch.Tensor, grid0: int, n_active: int,
                     psr_threshold: float, track_after: int,
                     track_every: int):
    """Plain PyTorch pass B over one group: `_step_core` for each active
    step, the state repeated for the rest.  returns (state, rows)."""
    nbatch = state.score.ndim - 1
    g = power.shape[nbatch]
    zero_b = torch.zeros_like(state.tracking)
    zero_i = torch.zeros_like(state.score)
    rows = []
    for ti in range(g):
        if ti < n_active:
            p_t = power.select(nbatch, ti)
            state, o = _step_core(state, p_t, grid0 + ti * HALF_FRAME_LENGTH,
                                  psr_threshold, track_after, track_every)
        else:
            o = {"emit": zero_b, "lost": zero_b, "consumed": zero_i}
        rows.append((state.peak, state.psr, state.score, state.tracking,
                     o["emit"], o["lost"], o["consumed"]))
    return state, tuple(torch.stack(c) for c in zip(*rows))


# ----------------------------------------------------------------- kernel --
_PTR = ctypes.c_void_p
_FIELDS = ("ema", "score", "timer", "tracking", "psr", "peak", "psr_max",
           "psr_ring", "psr_count")
_ROWS = ("peak", "psr", "score", "tracking", "emit", "lost", "consumed")


class _Args(ctypes.Structure):
    """pass_b.cu's PassBArgs, field for field."""
    _fields_ = ([(f, _PTR) for f in _FIELDS]
                + [(f + "_out", _PTR) for f in _FIELDS]
                + [("power", _PTR)]
                + [("row_" + f, _PTR) for f in _ROWS]
                + [(f, ctypes.c_int32) for f in ("B", "g", "n_active",
                                                  "track_after",
                                                  "track_every")]
                + [(f, ctypes.c_float) for f in ("thresh", "alpha",
                                                  "beta")])


def launch_plan(b: int, sms: int = 132) -> dict:
    """The kernel's launch for b channels (3 b lanes): one block of 320
    threads per (channel, root), no cluster; static shared memory a block
    (one step's power staged, 9600 floats; the 131-bin window; the PSR
    ring; the ten warps' maxima; three mbarriers); blocks resident a SM as
    __launch_bounds__ asks; waves over `sms` SMs."""
    blocks = R * b
    warps = THREADS // 32
    smem = 4 * (correlate.NBLK * SYMBOL_SZ + 132 + MOVING_AVG_SZ
                + 3 * warps) + 8 * 3
    return dict(blocks=blocks, threads=THREADS, cluster=1, smem_bytes=smem,
                blocks_per_sm=BLOCKS_PER_SM,
                waves=math.ceil(blocks / (BLOCKS_PER_SM * sms)))


def kernel_info() -> dict:
    """The compiled kernel on the current card: registers a thread, local
    (spill) bytes a thread, static shared memory a block, and blocks
    resident a SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return build.kernel_info("pb_kernel_info")


def bind(lib: ctypes.CDLL):
    """`lib`'s pb_scan_group with its argument types declared: the port's
    library, or a variant of it that `build.build` made."""
    fn = lib.pb_scan_group
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _load():
    global _fn
    if _fn is None:
        _fn = bind(build.library())
    return _fn


_DTYPES = {"ema": torch.float32, "score": torch.int32, "timer": torch.int32,
           "tracking": torch.bool, "psr": torch.float32, "peak": torch.int32,
           "psr_max": torch.float32, "psr_ring": torch.float32,
           "psr_count": torch.int32}
_ROW_DTYPES = (torch.int32, torch.float32, torch.int32, torch.bool,
               torch.bool, torch.bool, torch.int32)


def scan_group_kernel(state, power: torch.Tensor, grid0: int,
                      n_active: int, psr_threshold: float, track_after: int,
                      track_every: int):
    """Run the kernel (CUDA tensors only; plain version:
    `scan_group_plain`).  returns (state, rows)."""
    global launches
    dev = power.device
    if dev.type != "cuda":
        raise ValueError(f"pass-B kernel needs CUDA tensors, got {dev}")
    batch = state.score.shape[:-1]
    nbatch = len(batch)
    if power.dtype != torch.float32 or power.ndim != nbatch + 4 \
            or power.shape[:nbatch] != batch \
            or power.shape[nbatch + 1:] != (correlate.NBLK, R, SYMBOL_SZ):
        raise ValueError(f"power must be float32 {tuple(batch)} + (g, 75, 3, "
                         f"128), got {power.dtype} {tuple(power.shape)}")
    g = power.shape[nbatch]
    if not 0 <= n_active <= g:
        raise ValueError(f"n_active {n_active} outside [0, {g}]")
    nb = int(np.prod(batch, dtype=np.int64))
    ins = {}
    for f, dt in _DTYPES.items():
        x = getattr(state, f)
        if x.device != dev or x.dtype != dt:
            raise ValueError(f"state.{f}: {x.dtype} on {x.device}, the "
                             f"kernel takes {dt} on {dev}")
        ins[f] = x.contiguous()
    power = power.contiguous()
    if power.data_ptr() % 16:         # the kernel's tensor map needs it
        power = power.clone()
    outs = {f: torch.empty_like(x) for f, x in ins.items()}
    rows = tuple(torch.empty((g,) + tuple(batch) + (R,), dtype=dt, device=dev)
                 for dt in _ROW_DTYPES)
    args = _Args(
        *(ins[f].data_ptr() for f in _FIELDS),
        *(outs[f].data_ptr() for f in _FIELDS),
        power.data_ptr(), *(x.data_ptr() for x in rows),
        nb, g, n_active, track_after, track_every,
        float(np.float32(psr_threshold)), float(np.float32(PSR_EMA_ALPHA)),
        float(np.float32(1 - PSR_EMA_ALPHA)))
    fn = _load()
    rc = fn(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "pb_scan_group")
    launches += 1
    pos = state.pos if n_active == 0 else torch.full_like(
        state.pos, grid0 + n_active * HALF_FRAME_LENGTH)
    return state._replace(pos=pos, **outs), rows


# ------------------------------------------------------------ entry point --
def scan_group(state, power: torch.Tensor, grid0: int, n_active: int,
               psr_threshold: float, track_after: int, track_every: int):
    """Pass B over one group (see the module docstring): the plain version
    on a CPU tensor, the kernel on a CUDA one."""
    if power.device.type == "cpu":
        return scan_group_plain(state, power, grid0, n_active,
                                psr_threshold, track_after, track_every)
    return scan_group_kernel(state, power, grid0, n_active, psr_threshold,
                             track_after, track_every)
