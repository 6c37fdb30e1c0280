"""Pass C's front end (slot-0 read, CFO estimate and ring, rotation, PSS
channel estimate, CP, SSS and MIB capture selection) as hand-written CUDA
kernels around the CFO-ring kernel, and its plain PyTorch version.

Replaces no Pallas kernel: the JAX package's `_mib_postpass` is jnp
(ltetrigger_tpu/models/trigger.py).  The CUDA source is
ltetrigger_tpu_torch/csrc/pass_c_front.cu; its header gives the design and
the bound.

  front(state0, raw, buffer, data_valid, k) -> Front
      state0: the dispatch's TriggerState at entry (its cfo_ring,
      cfo_count, published, mib_cell, pending_fresh and chest are read);
      raw: pass B's RawStepOutput [S, .., R]; buffer: pair of [.., N]
      float32, read as zero outside [0, N); data_valid: the logical end of
      data (a candidate whose slot-1 read would cross it is deferred); k:
      the MIB capture slots.

Front's fields are what pass C's decode and event assembly read: the CFO
ring after the dispatch (`ring`, `count`), each step's ring mean
(`cfo_mean`) and rotation (`freq`, cycles a sample), the PSS LS channel
estimate of the last pushed step (`chest`), each step's CP and cell id,
the capture selection (`want_cap` [S, .., R], each step's slot `at` [..,
R, S] with k for none, `cnt`, `pending_fresh`, `overflow` [.., R]) and the
candidates in their slots (`cand_*`, `valid` [.., R, k]; 0 past `cnt`).

On a CPU tensor `front` runs `front_plain` (the chain of ~400 small
PyTorch ops that pass C ran before the kernels); on a CUDA tensor it
launches `front_estimate`, the CFO-ring kernel (ops/kernels/cfo_ring.py)
and `front_decide` or raises.  `launches` counts `front` calls on a card
(three kernel launches each).  The kernels take every step's decision from
float32 sums in another order than the plain version's, so a decision
whose two scores lie within float32 rounding may go the other way.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ...ltecore import sss as sssmod
from ...ltecore.constants import (PSS_SYMBOL_START, SLOT_LENGTH,
                                  SYMBOL_SZ)
from ...utils.profiling import span
from .. import cfo as cfo_ops
from .. import cplx, dft, sync
from . import build, cfo_ring

launches = 0          # front() calls on a card: three kernel launches each
_fns = {}

R = 3                                   # N_id_2 hypotheses
LOOKBACK = PSS_SYMBOL_START             # 832 samples of history before grid0
SEG = 512                               # slot-0 tail gathered per step
SEG_OFF = SLOT_LENGTH - SEG
NBINS = 62                              # sync subcarriers
BIN_PITCH = 64                          # pass_c_front.cu: the DFT table's row
WARPS = 8                               # front_decide: warps a block
TILE = 32                               # steps a tile (a warp's lanes)
ESTIMATE_WARPS = 8                      # front_estimate: lane-steps a block


class Front(NamedTuple):
    """What pass C's front end hands its decode and event assembly."""
    ring: torch.Tensor          # [.., R, 200] f32 — CFO ring after S steps
    count: torch.Tensor         # [.., R] int32
    cfo_mean: torch.Tensor      # [S, .., R] f32 — ring mean after each step
    freq: torch.Tensor          # [S, .., R] f32 — rotation, cycles/sample
    chest: torch.Tensor         # [.., R, 62, 2] f32
    normal_cp: torch.Tensor     # [S, .., R] bool
    cell_id: torch.Tensor       # [S, .., R] int32
    want_cap: torch.Tensor      # [S, .., R] bool
    at: torch.Tensor            # [.., R, S] int64 — slot, k for none
    cnt: torch.Tensor           # [.., R] int64 — slots filled
    pending_fresh: torch.Tensor  # [.., R] bool
    overflow: torch.Tensor      # [.., R] int32 — captures deferred
    cand_cell: torch.Tensor     # [.., R, k] int32
    cand_cp: torch.Tensor       # [.., R, k] bool
    cand_fresh: torch.Tensor    # [.., R, k] bool
    cand_start: torch.Tensor    # [.., R, k] int64 — slot-1 start
    cand_freq: torch.Tensor     # [.., R, k] f32
    valid: torch.Tensor         # [.., R, k] bool


def read(comp: torch.Tensor, starts: torch.Tensor, length: int,
         lead: int = 0) -> torch.Tensor:
    """Contiguous reads comp[*B, starts + [0, length)] for starts
    [*B, ...] -> [*B, ..., length]; positions outside [0, N) read as zero
    (the JAX engine's zero pad).  `lead` counts leading dims of `starts`
    that come before the batch dims: they are moved behind it."""
    nb = comp.ndim - 1
    st = starts.to(torch.int64)
    if lead:
        st = st.movedim(tuple(range(lead)), tuple(range(nb, nb + lead)))
    n = comp.shape[-1]
    idx = st[..., None] + torch.arange(length, device=comp.device)
    ok = (idx >= 0) & (idx < n)
    flat = torch.clamp(idx, 0, n - 1).reshape(comp.shape[:-1] + (-1,))
    out = torch.where(ok, torch.gather(comp, -1, flat).reshape(idx.shape),
                      0.0)
    if lead:
        out = out.movedim(tuple(range(nb, nb + lead)), tuple(range(lead)))
    return out


# ------------------------------------------------------------ plain version
def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=0).values


def _capture_chain(state0, raw, sss_valid, sub5, cell_id, gatherable,
                   k: int):
    """Per-step capture selection (reference mib tag gating + in-scan
    published_live reacquisition).  All inputs [S, .., R].
    Returns (want_cap, slot, fresh, cnt, pending_fresh_final, overflow)."""
    tagged = raw.emit & (~raw.lost) & sss_valid

    # published_live: starts at `published`, cleared by any in-chunk loss
    not_lost_cum = torch.cumprod(1 - raw.lost.to(torch.int32), dim=0)
    p_live_after = state0.published[None] & (not_lost_cum > 0)
    p_live_before = torch.cat(
        [state0.published[None].expand_as(p_live_after[:1]),
         p_live_after[:-1]], dim=0)
    # the step's own loss clears the gate before capture gating
    p_gate = p_live_before & (~raw.lost)

    want_any = tagged & (~p_gate) & (~sub5)
    eligible = want_any & gatherable
    elig_i = eligible.to(torch.int32)
    cum_excl = torch.cumsum(elig_i, dim=0) - elig_i
    want_cap = eligible & (cum_excl < k)
    slot = torch.where(want_cap, cum_excl, -1)
    overflow = (want_any & (~want_cap)).sum(dim=0, dtype=torch.int32)
    cnt = want_cap.to(torch.int32).sum(dim=0)

    # (pending_fresh, mib_cell) chain in closed form: a capture sets the
    # cell and clears pf, a loss sets pf (never both in one step)
    s = want_cap.shape[0]
    tt = torch.arange(s, device=cell_id.device).reshape(
        (s,) + (1,) * (want_cap.ndim - 1))
    last_cap = _cummax(torch.where(want_cap, tt, -1))
    last_lost = _cummax(torch.where(raw.lost, tt, -1))
    neg1 = torch.full_like(last_cap[:1], -1)
    last_cap_x = torch.cat([neg1, last_cap[:-1]], dim=0)
    last_lost_x = torch.cat([neg1, last_lost[:-1]], dim=0)
    cell_at = torch.take_along_dim(cell_id, torch.clamp(last_cap_x, min=0),
                                   dim=0)
    cell_before = torch.where(last_cap_x >= 0, cell_at,
                              state0.mib_cell[None])
    pf_before = torch.where((last_cap_x < 0) & (last_lost_x < 0),
                            state0.pending_fresh[None],
                            last_lost_x > last_cap_x)
    fresh = pf_before | (cell_id != cell_before)
    pf_f = torch.where((last_cap[-1] < 0) & (last_lost[-1] < 0),
                       state0.pending_fresh, last_lost[-1] > last_cap[-1])
    return want_cap, slot, fresh, cnt, pf_f, overflow


def front_plain(state0, raw, buffer: cplx.Pair, data_valid: int,
                k: int) -> Front:
    """The front end as PyTorch ops, batched over the step axis (see the
    module docstring)."""
    s = raw.psr.shape[0]
    dev = raw.psr.device
    batch = state0.cfo_count.shape[:-1]
    shape = raw.psr.shape
    with span("pass_c.sync"):
        # -- slot-0 tail of each step: buf[grid + peak - 384 : +SEG] --
        gridx = raw.grid.to(torch.int64).reshape(
            (s,) + (1,) * (len(batch) + 1))
        st0 = gridx + raw.peak - LOOKBACK  # slot-0 start [S, .., R]
        seg = (read(buffer[0], st0 + SEG_OFF, SEG, lead=1),
               read(buffer[1], st0 + SEG_OFF, SEG, lead=1))

        # ---- CFO estimate (on the PSS symbol) + ring recurrence --
        reps = cfo_ops.on_device("time", str(dev))
        pss_sym = cplx.index(seg, (..., slice(SEG - SYMBOL_SZ, SEG)))
        est = cfo_ops.cfo_estimate(pss_sym, reps)       # [S, .., R]
        push = raw.emit & raw.tracking
        ring_f, count_f, cfo_mean = cfo_ring.ring_scan(
            state0.cfo_ring, state0.cfo_count, est, push, raw.lost)

        # ---- rotate, CP detect, SSS ----
        freq = torch.where(raw.tracking, -cfo_mean / SYMBOL_SZ, 0.0)
        sf = cfo_ops.cfo_rotate(seg, freq, SEG_OFF)

        # ---- PSS LS channel estimate of the last tracked step ----
        tt_c = torch.arange(s, device=dev).reshape(
            (s,) + (1,) * (push.ndim - 1))
        last_push = torch.where(push, tt_c, -1).amax(dim=0)  # [..R]
        lp = torch.clamp(last_push, min=0)[None, ..., None]
        sym = tuple(torch.take_along_dim(
            comp[..., SEG - SYMBOL_SZ:], lp, dim=0)[0] for comp in sf)
        chv = cplx.mul_conj(dft.dft_sync(sym),
                            cfo_ops.on_device("freq", str(dev)))
        chest_f = torch.where((last_push >= 0)[..., None, None],
                              torch.stack(chv, dim=-1), state0.chest)

        normal_cp = sync.detect_cp(sf, end=SEG)
        nid2 = torch.arange(R, device=dev)
        n_id_1, sub5 = sync.sss_decode(sf, nid2, normal_cp, end=SEG)
        sss_valid = n_id_1 >= 0
        cell_id = (3 * torch.clamp(n_id_1, min=0) + nid2).to(torch.int32)

    with span("pass_c.capture"):
        # ---- capture selection ----
        gatherable = st0 + 2 * SLOT_LENGTH <= data_valid
        want_cap, slot, fresh, cnt, pf_f, overflow = _capture_chain(
            state0, raw, sss_valid, sub5, cell_id, gatherable, k)
        # each step's slot, step axis last [.., R, S]; a step that
        # captures nothing writes to a spare slot k, dropped after
        at = torch.where(want_cap, slot, k).movedim(0, -1)

        def scatter(v):             # [S, .., R] -> [.., R, K]
            v = v.expand(shape).movedim(0, -1)
            spare = v.new_zeros(v.shape[:-1] + (k + 1,))
            return spare.scatter_(-1, at, v)[..., :k]

        return Front(
            ring=ring_f, count=count_f, cfo_mean=cfo_mean, freq=freq,
            chest=chest_f, normal_cp=normal_cp, cell_id=cell_id,
            want_cap=want_cap, at=at, cnt=cnt, pending_fresh=pf_f,
            overflow=overflow, cand_cell=scatter(cell_id),
            cand_cp=scatter(normal_cp), cand_fresh=scatter(fresh),
            cand_start=scatter(st0 + SLOT_LENGTH), cand_freq=scatter(freq),
            valid=torch.arange(k, device=dev) < cnt[..., None])


# ----------------------------------------------------------------- kernel --
@functools.lru_cache(maxsize=None)
def tables() -> np.ndarray:
    """The kernels' constants as one float32 array, in pass_c_front.cu's
    layout: the 62 sync rows of the 128-point DFT as [128, 64] (re, im)
    pairs (`dft.dft_sync62`, bin-minor, two zero bins of padding); the SSS
    scrambling codes c0 / c1 [3, 2, 31], z [8, 31], the cyclic-shift bank
    [31, 31] and the (m0, m1) -> N_id_1 table [31, 31] (`ltecore.sss`, the
    ids as exact floats); then, read from device memory alone, the PSS
    frequency replicas [3, 62] re then im (`cfo.chest_replicas`) and time
    replicas [3, 128] re then im (`cfo.replica_pairs`)."""
    re, im = dft.dft_sync62()                            # [62, 128]
    w = np.zeros((SYMBOL_SZ, BIN_PITCH, 2), np.float32)
    w[:, :NBINS, 0] = re.T
    w[:, :NBINS, 1] = im.T
    fre, fim = cfo_ops.chest_replicas()
    tre, tim = cfo_ops.replica_pairs()
    parts = [w, sssmod.c_scramble(), sssmod.z_bank(), sssmod.shift_bank(),
             sssmod.nid1_table(), fre, fim, tre, tim]
    return np.concatenate([np.asarray(p, np.float32).reshape(-1)
                           for p in parts])


@functools.lru_cache(maxsize=None)
def _tables_on(device: str) -> torch.Tensor:
    """`tables()` on `device`, copied there once (a copy from pageable host
    memory waits for all work queued on the device)."""
    return torch.from_numpy(tables()).to(device)


def launch_plan(lanes: int, steps: int, sms: int = 132) -> dict:
    """The two launches for `lanes` lanes x `steps` steps: front_estimate,
    a warp a lane-step, 8 a block; front_decide, a block of 8 warps a lane
    (steps in tiles of 32, 4 a warp, the capture chain of a tile by one
    warp's ballots), its dynamic shared memory the DFT and SSS tables and
    a 512-sample buffer a warp, 2 blocks resident a SM; waves over `sms`
    SMs."""
    n_tab = SYMBOL_SZ * BIN_PITCH * 2 + 3 * 2 * 31 + 8 * 31 + 2 * 31 * 31
    smem = 4 * n_tab + WARPS * SEG * 8 + 2 * TILE * 12 + 16
    est_blocks = -(-lanes * steps // ESTIMATE_WARPS)
    return dict(estimate_blocks=est_blocks,
                estimate_threads=32 * ESTIMATE_WARPS,
                blocks=lanes, threads=32 * WARPS, cluster=1,
                smem_bytes=smem, blocks_per_sm=2,
                waves=math.ceil(lanes / (2 * sms)))


def kernel_info() -> dict:
    """front_decide on the current card: registers a thread, local (spill)
    bytes a thread, shared memory a block (static and dynamic), and blocks
    resident a SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return build.kernel_info("front_kernel_info")


def _load(name: str, n_ptr_in: int, ints: list, n_ptr_out: int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.library(), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr_in + ints
                       + [ctypes.c_void_p] * (n_ptr_out + 1))
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def front_kernel(state0, raw, buffer: cplx.Pair, data_valid: int,
                 k: int) -> Front:
    """Run the kernels (CUDA tensors only; plain version: `front_plain`):
    front_estimate, the CFO ring, front_decide."""
    global launches
    dev = raw.peak.device
    if dev.type != "cuda":
        raise ValueError(f"pass C front-end kernels need CUDA tensors, got "
                         f"{dev}")
    s = raw.peak.shape[0]
    lead = tuple(raw.peak.shape[1:])
    n = buffer[0].shape[-1]
    for what, x, dt, shp in (
            ("grid", raw.grid, torch.int32, (s,)),
            ("peak", raw.peak, torch.int32, (s,) + lead),
            ("emit", raw.emit, torch.bool, (s,) + lead),
            ("tracking", raw.tracking, torch.bool, (s,) + lead),
            ("lost", raw.lost, torch.bool, (s,) + lead),
            ("buffer re", buffer[0], torch.float32, lead[:-1] + (n,)),
            ("buffer im", buffer[1], torch.float32, lead[:-1] + (n,)),
            ("published", state0.published, torch.bool, lead),
            ("mib_cell", state0.mib_cell, torch.int32, lead),
            ("pending_fresh", state0.pending_fresh, torch.bool, lead),
            ("chest", state0.chest, torch.float32, lead + (NBINS, 2))):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shp:
            raise ValueError(f"{what}: {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}, the kernels take {dt} {shp} on "
                             f"{dev}")
    if lead[-1] != R or k < 1:
        raise ValueError(f"lanes {lead}, k {k}: the kernels take [.., 3] "
                         f"lanes and k >= 1")
    lanes = math.prod(lead)
    re, im = (c.reshape(-1, n).contiguous() for c in buffer)
    grid, peak, emit, tracking, lost = (x.contiguous() for x in (
        raw.grid, raw.peak, raw.emit, raw.tracking, raw.lost))
    published, mib_cell, pf0, chest0 = (x.contiguous() for x in (
        state0.published, state0.mib_cell, state0.pending_fresh,
        state0.chest))
    tab = _tables_on(str(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def empty(shp, dt):
        return torch.empty(shp, dtype=dt, device=dev)

    with span("pass_c.sync"):
        est = empty((s,) + lead, torch.float32)
        push = empty((s,) + lead, torch.bool)
        fn = _load("front_estimate", 7,
                   [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int], 2)
        build.check(fn(re.data_ptr(), im.data_ptr(), grid.data_ptr(),
                       peak.data_ptr(), emit.data_ptr(), tracking.data_ptr(),
                       tab.data_ptr(), n, lanes, s, est.data_ptr(),
                       push.data_ptr(), stream), "front_estimate")
        ring_f, count_f, mean = cfo_ring.ring_scan_kernel(
            state0.cfo_ring, state0.cfo_count, est, push, lost)

    with span("pass_c.capture"):
        out = Front(
            ring=ring_f, count=count_f, cfo_mean=mean,
            freq=empty((s,) + lead, torch.float32),
            chest=empty(lead + (NBINS, 2), torch.float32),
            normal_cp=empty((s,) + lead, torch.bool),
            cell_id=empty((s,) + lead, torch.int32),
            want_cap=empty((s,) + lead, torch.bool),
            at=empty(lead + (s,), torch.int64),
            cnt=empty(lead, torch.int64),
            pending_fresh=empty(lead, torch.bool),
            overflow=empty(lead, torch.int32),
            cand_cell=empty(lead + (k,), torch.int32),
            cand_cp=empty(lead + (k,), torch.bool),
            cand_fresh=empty(lead + (k,), torch.bool),
            cand_start=empty(lead + (k,), torch.int64),
            cand_freq=empty(lead + (k,), torch.float32),
            valid=empty(lead + (k,), torch.bool))
        fn = _load("front_decide", 13,
                   [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_longlong], len(Front._fields) - 3)
        build.check(fn(re.data_ptr(), im.data_ptr(), grid.data_ptr(),
                       peak.data_ptr(), emit.data_ptr(), tracking.data_ptr(),
                       lost.data_ptr(), mean.data_ptr(), published.data_ptr(),
                       mib_cell.data_ptr(), pf0.data_ptr(),
                       chest0.data_ptr(), tab.data_ptr(), n, lanes, s, k,
                       int(data_valid),
                       *(getattr(out, f).data_ptr()
                         for f in Front._fields[3:]), stream),
                    "front_decide")
    launches += 1
    return out


# ------------------------------------------------------------ entry point --
def front(state0, raw, buffer: cplx.Pair, data_valid: int, k: int) -> Front:
    """Pass C's front end (see the module docstring): the plain version on
    a CPU tensor, the kernels on a CUDA one."""
    if raw.peak.device.type == "cpu":
        return front_plain(state0, raw, buffer, data_valid, k)
    return front_kernel(state0, raw, buffer, data_valid, k)
