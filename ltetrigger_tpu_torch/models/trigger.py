"""The downlink trigger: PSS tracking state machine + SSS + MIB, in three
passes.  Port of ltetrigger_tpu/models/trigger.py (its module docstring
gives the design); this module keeps the names, the state layout and the
observable contract, in PyTorch's idiom.

  pass A  grid correlation: the stream is searched on a fixed grid (step t's
          9600 candidate positions start at grid0 + 9600 t), so the matched
          filter for g steps at once is one blocked-Toeplitz product, run by
          the hand-written CUDA kernel (ops/kernels/matched_filter.py).
  pass B  the sequential state machine, a Python loop over half-frame steps:
          EMA'd correlation power, peak/PSR, hysteresis score/timer/tracking,
          PSR telemetry ring.
  pass C  batched over the step axis: slot-0 tail extraction, CFO estimate
          and ring, CP detect, SSS, MIB capture selection, then one batched
          PBCH + Viterbi decode of the captured candidates with the 40 ms TTI
          soft-combining accumulator, and the track/drop event assembly.

Sample extraction is plain indexing: the JAX package's dense one-hot
extraction exists only because TPU gathers are slow.  The engine reads the
buffer as if it were zero-extended past its end, as the JAX engine pads it.

Host syncs (each waits for the card and reads a value; `host_syncs` counts
them by name):
  * "grid": scan_pass reads the grid start from `state.pos`, unless the
    caller passes it as `grid0` (the streaming classes do);
  * "emit", "capture": _mib_postpass gates on `any step emitted` and `any
    candidate captured`;
  * "cp": _decode_candidates picks the CP pipeline from the candidates' CPs
    (two reads);
  * "probe": the streaming classes (models/api.py) read the CFO probe's
    best bin.

All three N_id_2 hypotheses are a trailing [R] axis; channels are leading
batch axes of the buffer and of every state field.
"""

from __future__ import annotations

import collections
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from ..ltecore.constants import (DEFAULT_TRACK_AFTER,
                                 DEFAULT_TRACK_EVERY,
                                 HALF_FRAME_LENGTH,
                                 MOVING_AVG_SZ, PSR_EMA_ALPHA,
                                 PSS_SYMBOL_START, SLOT_LENGTH,
                                 SYMBOL_SZ)
from ..ops import cfo as cfo_ops
from ..ops import correlate, cplx, dft, pbch, sync
from ..ops.kernels import matched_filter

R = 3                                   # N_id_2 hypotheses
LOOKBACK = PSS_SYMBOL_START             # 832 samples of history before grid0
WINDOW = LOOKBACK + correlate.V2_WINDOW                # 10560
K_CANDIDATES = 16                       # MIB candidate slots (long dispatches)
K_STEP_CAP = 32                         # up to here: one capture slot a step
# max batch*g steps per pass-A group (bounds the power tensor to about
# GROUP_BUDGET * 115 KB); a larger budget gives pass B fewer, larger groups
GROUP_BUDGET = int(os.environ.get("LTETRIGGER_GROUP_BUDGET", "4096"))
SEG = 512                               # slot-0 tail gathered per step
SEG_OFF = SLOT_LENGTH - SEG
# pass C reads up to this far past the last grid step; the JAX engine pads
# its buffer by n_steps * 9600 + this many zeros
_PAD_TAIL = 640

host_syncs = collections.Counter()      # host reads of device values, by name


class TriggerState(NamedTuple):
    """Carry across dispatches (trailing [R] per channel); the JAX
    package's TriggerState field for field."""
    pos: torch.Tensor          # [R] int32 — next grid position (all equal)
    ema: torch.Tensor          # [75, R, 128] f32 — EMA'd correlation power
    score: torch.Tensor        # [R] int32
    timer: torch.Tensor        # [R] int32
    tracking: torch.Tensor     # [R] bool
    psr: torch.Tensor          # [R] f32 — last PSR (reused when not searching)
    peak: torch.Tensor         # [R] int32 — last peak bin in [0, 9600)
    psr_max: torch.Tensor      # [R] f32
    psr_ring: torch.Tensor     # [R, 200] f32
    psr_count: torch.Tensor    # [R] int32
    cfo_ring: torch.Tensor     # [R, 200] f32
    cfo_count: torch.Tensor    # [R] int32
    published: torch.Tensor    # [R] bool
    pub_cell_id: torch.Tensor  # [R] int32
    llr_acc: torch.Tensor      # [R, 12, 120] f32 — PBCH TTI soft-combine acc
    mib_n: torch.Tensor        # [R] int32 — subframe-0 attempts combined
    mib_cell: torch.Tensor     # [R] int32 — cell id of the last MIB capture
    pending_fresh: torch.Tensor  # [R] bool — loss seen since last capture
    cap_overflow: torch.Tensor   # [R] int32 — captures deferred
    chest: torch.Tensor        # [R, 62, 2] f32 — PSS LS channel estimate


class RawStepOutput(NamedTuple):
    """Per-step observables of pass B (pre-SSS/MIB), stacked [S, ...]."""
    grid: torch.Tensor         # [S] int32 — the step's grid start
    active: torch.Tensor       # [S] bool
    peak: torch.Tensor         # [S, .., R] int32
    psr: torch.Tensor          # [S, .., R] f32
    score: torch.Tensor        # [S, .., R] int32
    tracking: torch.Tensor     # [S, .., R] bool
    emit: torch.Tensor         # [S, .., R] bool — active & (over | lost)
    lost: torch.Tensor         # [S, .., R] bool — active & tracking lost
    consumed: torch.Tensor     # [S, .., R] int32


class StepOutput(NamedTuple):
    """Per-step, per-root observables (events + telemetry): the public
    contract of scan_engine."""
    track_event: torch.Tensor  # bool — publish this cell
    drop_event: torch.Tensor   # bool — retract published cell
    drop_cell_id: torch.Tensor  # int32 — the previously published cell id
    cell_id: torch.Tensor      # int32
    nof_prb: torch.Tensor      # int32
    nof_ports: torch.Tensor    # int32
    phich_ext: torch.Tensor    # int32
    phich_res: torch.Tensor    # int32
    sfn_offset: torch.Tensor   # int32
    normal_cp: torch.Tensor    # bool
    psr: torch.Tensor          # f32
    score: torch.Tensor        # int32
    tracking: torch.Tensor     # bool
    cfo_mean: torch.Tensor     # f32
    consumed: torch.Tensor     # int32


_STATE_SHAPES = {
    "pos": ((R,), torch.int32), "ema": ((75, R, SYMBOL_SZ), torch.float32),
    "score": ((R,), torch.int32), "timer": ((R,), torch.int32),
    "tracking": ((R,), torch.bool), "psr": ((R,), torch.float32),
    "peak": ((R,), torch.int32), "psr_max": ((R,), torch.float32),
    "psr_ring": ((R, MOVING_AVG_SZ), torch.float32),
    "psr_count": ((R,), torch.int32),
    "cfo_ring": ((R, MOVING_AVG_SZ), torch.float32),
    "cfo_count": ((R,), torch.int32), "published": ((R,), torch.bool),
    "pub_cell_id": ((R,), torch.int32),
    "llr_acc": ((R, 12, 120), torch.float32), "mib_n": ((R,), torch.int32),
    "mib_cell": ((R,), torch.int32), "pending_fresh": ((R,), torch.bool),
    "cap_overflow": ((R,), torch.int32), "chest": ((R, 62, 2), torch.float32),
}
_STATE_FILL = {"pos": LOOKBACK, "peak": LOOKBACK, "mib_cell": -1,
               "pending_fresh": True}


def init_state(start_pos: int = LOOKBACK, batch: tuple = (),
               device="cpu") -> TriggerState:
    """Fresh carry for `batch` channels (leading dims) on `device`."""
    fill = dict(_STATE_FILL, pos=start_pos)
    return TriggerState(**{
        f: torch.full(tuple(batch) + shape, fill.get(f, 0), dtype=dt,
                      device=device)
        for f, (shape, dt) in _STATE_SHAPES.items()})


def state_from_numpy(d: dict, device="cpu") -> TriggerState:
    """The JAX package's TriggerState as numpy arrays ({field: array}) ->
    the port's TriggerState on `device`.  A missing `chest` (checkpoints
    older than the channel-estimate telemetry) reads as zeros."""
    d = dict(d)
    batch = np.asarray(d["pos"]).shape[:-1]
    d.setdefault("chest", np.zeros(batch + _STATE_SHAPES["chest"][0],
                                   np.float32))
    return TriggerState(**{
        f: torch.tensor(np.asarray(d[f]), dtype=dt, device=device)
        for f, (_, dt) in _STATE_SHAPES.items()})


def state_to_numpy(state: TriggerState) -> dict:
    """The port's TriggerState -> {field: numpy array} (host copy)."""
    return {f: getattr(state, f).cpu().numpy() for f in TriggerState._fields}


def _ring_mean(ring, count):
    n = torch.clamp(count, max=MOVING_AVG_SZ)
    return torch.where(n > 0, ring.sum(dim=-1) / torch.clamp(n, min=1), 0.0)


def _ring_push(ring, count, value):
    idx = torch.remainder(count, MOVING_AVG_SZ)[..., None]
    slots = torch.arange(MOVING_AVG_SZ, device=ring.device)
    return torch.where(slots == idx, value[..., None], ring)


def _read(comp: torch.Tensor, starts: torch.Tensor, length: int,
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


# ======================================================================
# pass A — grid correlation
# ======================================================================
def _pass_a_dtype():
    """LTETRIGGER_CORRELATOR, as in the JAX package: unset or "fast" (the
    shipped default) = bf16 matmul inputs with f32 accumulation; anything
    else = f32."""
    impl = os.environ.get("LTETRIGGER_CORRELATOR", "fast")
    return torch.bfloat16 if impl == "fast" else torch.float32


def _group_power(buffer: cplx.Pair, lo: int, g: int) -> torch.Tensor:
    """Correlation power for g consecutive grid steps starting at `lo`:
    [..., g, 75, 3, 128] float32 in pass A's block layout (power[..., t, b,
    r, m] is root r's power at stream position lo + 9600 t + 128 b + m),
    through the matched-filter kernel."""
    return matched_filter.group_power(buffer[0], buffer[1], lo, g,
                                      _pass_a_dtype())


def _pick_group(n_steps: int, batch: int) -> int:
    limit = max(1, min(GROUP_BUDGET // max(batch, 1), 32, n_steps))
    for g in range(limit, 0, -1):
        if n_steps % g == 0:
            return g
    return 1


# ======================================================================
# pass B — the sequential state machine
# ======================================================================
def _step_core(state: TriggerState, power, grid: int, psr_threshold: float,
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
                           _ring_push(state.psr_ring, state.psr_count, psr),
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


def scan_pass(buffer: cplx.Pair, state: TriggerState, n_steps: int,
              psr_threshold: float,
              track_after: int = DEFAULT_TRACK_AFTER,
              track_every: int = DEFAULT_TRACK_EVERY,
              n_valid: int | None = None, grid0: int | None = None):
    """Passes A+B: correlate and scan `n_steps` half-frame steps.

    buffer: pair of [..., N] float32 holding >= LOOKBACK samples (or zeros)
        before the grid start; reads past N are zeros.
    state: TriggerState with leading batch dims matching `buffer`'s; all
        pos entries equal (the grid is shared).
    n_valid: logical end of data (default N); a step is active when its
        correlator window [grid, grid + 9728) fits inside it.
    grid0: the caller's promise that every `state.pos` entry equals this
        host integer; without it the grid start is read back from the
        device, which waits for all work queued before this call.
    returns: (final_state, RawStepOutput stacked [n_steps, ...]).
    """
    n = buffer[0].shape[-1]
    if n_valid is None:
        n_valid = n
    batch = math.prod(buffer[0].shape[:-1]) or 1
    g = _pick_group(n_steps, batch)
    nbatch = buffer[0].ndim - 1
    if grid0 is None:
        host_syncs["grid"] += 1
        grid0 = int(state.pos.reshape(-1)[0])
    thresh = float(np.float32(psr_threshold))

    zero_b = torch.zeros_like(state.tracking)
    zero_i = torch.zeros_like(state.score)
    rows = []
    for gi in range(n_steps // g):
        lo = grid0 + gi * g * HALF_FRAME_LENGTH
        if lo + correlate.V2_WINDOW > n_valid:
            power = None            # no active step in this group
        else:
            power = _group_power(buffer, lo, g)      # [.., g, 75, R, 128]
        for ti in range(g):
            grid = lo + ti * HALF_FRAME_LENGTH
            active = grid + correlate.V2_WINDOW <= n_valid
            if active:
                p_t = power.select(nbatch, ti)
                state, o = _step_core(state, p_t, grid, thresh,
                                      track_after, track_every)
            else:
                o = {"emit": zero_b, "lost": zero_b, "consumed": zero_i}
            rows.append((state.peak, state.psr, state.score, state.tracking,
                         o["emit"], o["lost"], o["consumed"]))
    # the grid of every step from host integers: no copy to the device
    steps = torch.arange(n_steps, dtype=torch.int32, device=buffer[0].device)
    grids = grid0 + HALF_FRAME_LENGTH * steps
    raw = RawStepOutput(
        grid=grids, active=grids + correlate.V2_WINDOW <= n_valid,
        **{f: torch.stack(c) for f, c in
           zip(RawStepOutput._fields[2:], zip(*rows))})
    return state, raw


# ======================================================================
# pass C — batched SSS / capture / MIB decode / event assembly
# ======================================================================
def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=0).values


def _ring_series(ring0, count0, est, push, lost):
    """Closed-form telemetry-ring recurrence over the step axis (exact
    parity with per-step reset-then-push semantics; one dispatch pushes at
    most n_steps <= MOVING_AVG_SZ values, so two in-dispatch pushes never
    collide on a ring slot).

    ring0 [.., R, 200], count0 [.., R]; est/push/lost [S, .., R].
    returns (ring_final, count_final, mean_per_step [S, .., R]).
    """
    s = est.shape[0]
    assert s <= MOVING_AVG_SZ
    tt = torch.arange(s, device=est.device).reshape((s,) + (1,) *
                                                    (est.ndim - 1))
    last_reset = _cummax(torch.where(lost, tt, -1))              # incl.
    pcum = torch.cumsum(push.to(torch.int32), dim=0)             # incl.
    pcum_at_reset = torch.take_along_dim(
        pcum, torch.clamp(last_reset, min=0), dim=0)
    # lost steps never push, so pcum at the reset index equals the pushes
    # strictly before it
    seg_pushes = torch.where(last_reset >= 0, pcum - pcum_at_reset, pcum)
    count_after = seg_pushes + torch.where(last_reset >= 0, 0, count0[None])
    count_before = count_after - push.to(torch.int32)
    slot = torch.remainder(count_before, MOVING_AVG_SZ).to(torch.int64)
    evict = (last_reset < 0) & (count_before >= MOVING_AVG_SZ)
    ring0_at = torch.take_along_dim(ring0[None], slot[..., None],
                                    dim=-1)[..., 0]
    contrib = torch.where(push, est - torch.where(evict, ring0_at, 0.0), 0.0)
    ccum = torch.cumsum(contrib, dim=0)
    ccum_at_reset = torch.take_along_dim(
        ccum, torch.clamp(last_reset, min=0), dim=0)
    sum0 = ring0.sum(dim=-1)
    sum_after = torch.where(last_reset >= 0, ccum - ccum_at_reset,
                            ccum + sum0[None])
    n_eff = torch.clamp(count_after, max=MOVING_AVG_SZ)
    mean = torch.where(n_eff > 0, sum_after / torch.clamp(n_eff, min=1), 0.0)

    final_reset = last_reset[-1]
    live = push & (tt > final_reset)
    onehot = (slot[..., None] == torch.arange(MOVING_AVG_SZ,
                                              device=est.device)) \
        & live[..., None]
    pushed_any = onehot.any(dim=0)
    pushed_val = torch.sum(onehot.to(torch.float32) * est[..., None], dim=0)
    base = torch.where((final_reset >= 0)[..., None], 0.0, ring0)
    ring_f = torch.where(pushed_any, pushed_val, base)
    return ring_f, count_after[-1].to(torch.int32), mean


def _capture_chain(state0: TriggerState, raw: RawStepOutput, sss_valid,
                   sub5, cell_id, gatherable, k: int):
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


def _decode_candidates(state0: TriggerState, buffer: cplx.Pair,
                       cand_start, cand_freq, cand_cell, cand_cp, cand_fresh,
                       valid, combine: bool):
    """Batched PBCH + Viterbi over the captured candidates.

    cand_* : [..., R, K]; returns per-candidate verdicts [..., R, K] and the
    updated TTI accumulator carry."""
    k = cand_cell.shape[-1]
    batch = cand_cell.shape[:-2]

    # slot-1 extraction + capture-time CFO rotation (slot-1 sample n had
    # aligned index 960 + n)
    slot1 = (_read(buffer[0], cand_start, SLOT_LENGTH),
             _read(buffer[1], cand_start, SLOT_LENGTH))  # [.., R, K, 960]
    slot1 = cfo_ops.cfo_rotate(slot1, cand_freq, SLOT_LENGTH)

    # one CP pipeline when every valid candidate agrees (host sync), both
    # otherwise
    host_syncs["cp"] += 2
    all_norm = bool(torch.all(cand_cp | ~valid))
    all_ext = bool(torch.all((~cand_cp) | ~valid))
    if all_norm or all_ext:
        contrib = pbch.pbch_quarter_llrs_slot1(slot1, cand_cell, all_norm)
    else:
        both = pbch.quarter_llrs_both_cp(slot1, cand_cell)  # [.., 2, 3,4,120]
        contrib = torch.where(cand_cp[..., None, None, None],
                              both[..., 1, :, :, :], both[..., 0, :, :, :])

    # TTI soft-combining chain over the K slots: 4 TTI-phase hypotheses,
    # phase h restarts its accumulator at quarter 0; a restart (loss or
    # cell-id change) clears every phase
    acc = state0.llr_acc.reshape(batch + (R, 3, 4, 120))
    n, cell = state0.mib_n, state0.mib_cell
    ar4 = torch.arange(4, device=acc.device)
    accs, qs = [], []
    for j in range(k):
        c_k = contrib[..., j, :, :, :]
        fresh_k, cell_k, valid_k = (cand_fresh[..., j], cand_cell[..., j],
                                    valid[..., j])
        if not combine:
            fresh_k = torch.ones_like(fresh_k)
        restart = fresh_k | (cell_k != cell)
        n_k = torch.where(restart, 0, n)
        q = torch.remainder(n_k[..., None] + ar4, 4)          # [.., R, 4]
        sel = torch.take_along_dim(c_k, q[..., None, :, None], dim=-2)
        acc_base = torch.where(restart[..., None, None, None], 0.0, acc)
        acc_new = torch.where((q == 0)[..., None, :, None], sel,
                              acc_base + sel)
        acc = torch.where(valid_k[..., None, None, None], acc_new, acc)
        n = torch.where(valid_k, n_k + 1, n)
        cell = torch.where(valid_k, cell_k, cell)
        accs.append(acc)
        qs.append(q)

    accs = torch.stack(accs, dim=-4)                    # [.., R, K, 3, 4, 120]
    qs = torch.stack(qs, dim=-2)                        # [.., R, K, 4]
    # hypothesis index port * 4 + phase reports quarter qs[.., phase]
    res = pbch.search_and_unpack(accs.reshape(batch + (R, k, 12, 120)),
                                 qs.tile((1,) * (qs.ndim - 1) + (3,)))
    found = res["found"] & valid
    return (found, res["nof_prb"], res["nof_ports"], res["phich_ext"],
            res["phich_res"], res["sfn_offset"], acc, n, cell)


def _mib_postpass(state0: TriggerState, final: TriggerState,
                  raw: RawStepOutput, buffer: cplx.Pair, data_valid: int,
                  k: int | None = None, combine: bool = True,
                  do_extract: bool | None = None,
                  do_decode: bool | None = None):
    """Pass C.  Returns (final_state, StepOutput stacked [n_steps, ...]).

    data_valid: logical end of DATA; a candidate whose slot-1 read would
    cross it is deferred (counted in cap_overflow), never read misaligned.
    k: MIB capture slots (default: one per step up to K_STEP_CAP, then
    K_CANDIDATES).
    do_extract / do_decode: host bools that replace the gates `any step
    emitted` / `any candidate captured` and their host reads ("emit",
    "capture"); None keeps the gate.  The attribution tool times pass C with
    and without the decode this way (examples/bench_attrib_torch.py).
    """
    s = raw.psr.shape[0]
    if k is None:
        k = s if s <= K_STEP_CAP else K_CANDIDATES
    dev = raw.psr.device
    batch = final.score.shape[:-1]
    shape = raw.psr.shape
    zero_i = torch.zeros(shape, dtype=torch.int32, device=dev)
    zero_b = torch.zeros(shape, dtype=torch.bool, device=dev)

    if do_extract is None:
        host_syncs["emit"] += 1
        do_extract = bool(raw.emit.any())
    if not do_extract:                  # nothing emitted
        mean0 = _ring_mean(state0.cfo_ring, state0.cfo_count)
        mid_final = final
        track_event, lost_e = zero_b, zero_b
        nof_prb = nof_ports = phich_ext = phich_res = sfn_offset = zero_i
        cell_id_o, normal_cp_o = zero_i, zero_b
        cfo_mean = mean0[None].expand(shape)
    else:
        # ---- slot-0 tail of every step: buf[grid + peak - 384 : +SEG] ----
        gridx = raw.grid.to(torch.int64).reshape((s,) + (1,) * (len(batch)
                                                                + 1))
        st0 = gridx + raw.peak - LOOKBACK      # slot-0 start [S, .., R]
        seg = (_read(buffer[0], st0 + SEG_OFF, SEG, lead=1),
               _read(buffer[1], st0 + SEG_OFF, SEG, lead=1))

        # ---- CFO estimate (on the PSS symbol) + ring recurrence ----
        reps = cfo_ops.on_device("time", str(dev))
        pss_sym = cplx.index(seg, (..., slice(SEG - SYMBOL_SZ, SEG)))
        est = cfo_ops.cfo_estimate(pss_sym, reps)       # [S, .., R]
        push = raw.emit & raw.tracking
        if s <= MOVING_AVG_SZ:
            ring_f, count_f, cfo_mean = _ring_series(
                state0.cfo_ring, state0.cfo_count, est, push, raw.lost)
        else:           # dispatches longer than the ring: sequential
            ring, count, means = state0.cfo_ring, state0.cfo_count, []
            for t in range(s):
                ring = torch.where(raw.lost[t][..., None], 0.0, ring)
                count = torch.where(raw.lost[t], 0, count)
                ring = torch.where(push[t][..., None],
                                   _ring_push(ring, count, est[t]), ring)
                count = count + push[t].to(torch.int32)
                means.append(_ring_mean(ring, count))
            ring_f, count_f, cfo_mean = ring, count, torch.stack(means)

        # ---- rotate, CP detect, SSS ----
        freq = torch.where(raw.tracking, -cfo_mean / SYMBOL_SZ, 0.0)
        sf = cfo_ops.cfo_rotate(seg, freq, SEG_OFF)

        # ---- PSS LS channel estimate of the last tracked step ----
        tt_c = torch.arange(s, device=dev).reshape((s,) + (1,) *
                                                   (push.ndim - 1))
        last_push = torch.where(push, tt_c, -1).amax(dim=0)   # [.., R]
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

        # ---- capture selection ----
        gatherable = st0 + 2 * SLOT_LENGTH <= data_valid
        want_cap, slot, fresh, cnt, pf_f, overflow = _capture_chain(
            state0, raw, sss_valid, sub5, cell_id, gatherable, k)
        onehot = (slot[..., None] == torch.arange(k, device=dev)) \
            & want_cap[..., None]                       # [S, .., R, K]

        def scatter(v):
            return torch.where(onehot, v[..., None], 0).sum(dim=0)

        cand_cell = scatter(cell_id).to(torch.int32)
        cand_cp = scatter(normal_cp.to(torch.int32)) > 0
        cand_fresh = scatter(fresh.to(torch.int32)) > 0
        cand_start = scatter(st0 + SLOT_LENGTH)
        cand_freq = scatter(freq)
        valid = torch.arange(k, device=dev) < cnt[..., None]

        if do_decode is None:
            host_syncs["capture"] += 1
            do_decode = bool(cnt.sum() > 0)
        if do_decode:                   # any candidate captured
            (found, prb_rk, ports_rk, pext_rk, pres_rk, sfn_rk,
             acc_f, n_f, cell_f) = _decode_candidates(
                state0, buffer, cand_start, cand_freq, cand_cell, cand_cp,
                cand_fresh, valid, combine)
        else:
            zi = torch.zeros(batch + (R, k), dtype=torch.int32, device=dev)
            found = torch.zeros(batch + (R, k), dtype=torch.bool, device=dev)
            prb_rk = ports_rk = pext_rk = pres_rk = sfn_rk = zi
            acc_f = state0.llr_acc
            n_f, cell_f = state0.mib_n, state0.mib_cell

        # ---- publish once per epoch (epoch = cumulative fresh count) ----
        fresh_eff = cand_fresh & valid
        e = torch.cumsum(fresh_eff.to(torch.int32), dim=-1)     # [.., R, K]
        same_ep = e[..., :, None] == e[..., None, :]
        ks = torch.arange(k, device=dev)
        j_lt_k = ks[None, :] < ks[:, None]                      # [K(k), K(j)]
        prior = torch.any(same_ep & j_lt_k & found[..., None, :], dim=-1)
        is_pub = found & ~prior & ~(state0.published[..., None] & (e == 0))

        # ---- map candidate verdicts back to step space ----
        track_event = torch.any(onehot & is_pub[None], dim=-1)  # [S, .., R]

        def fld(a):
            x = torch.where(onehot, a[None], 0).sum(dim=-1)
            return torch.where(track_event, x, 0).to(torch.int32)

        mid_final = final._replace(
            cfo_ring=ring_f, cfo_count=count_f,
            llr_acc=acc_f.reshape(batch + (R, 12, 120)),
            mib_n=n_f, mib_cell=cell_f, pending_fresh=pf_f,
            cap_overflow=state0.cap_overflow + overflow, chest=chest_f)
        lost_e = raw.lost
        nof_prb, nof_ports, phich_ext, phich_res, sfn_offset = (
            fld(prb_rk), fld(ports_rk), fld(pext_rk), fld(pres_rk),
            fld(sfn_rk))
        cell_id_o = cell_id
        normal_cp_o = normal_cp.expand(shape)

    # ---- published/drop state machine over steps ----
    # p[s] = (p[s-1] & ~lost[s]) | track[s]: the latest of the last track
    # and the last loss decides (a track wins a tie)
    t, l = track_event, lost_e
    tt = torch.arange(s, device=dev).reshape((s,) + (1,) * (t.ndim - 1))
    last_t = _cummax(torch.where(t, tt, -1))
    last_l = _cummax(torch.where(l, tt, -1))
    p0 = state0.published[None]
    p_incl = torch.where((last_t < 0) & (last_l < 0), p0, last_t >= last_l)
    p_before = torch.cat([p0.expand_as(p_incl[:1]), p_incl[:-1]], dim=0)
    drop_event = l & p_before
    id0 = state0.pub_cell_id[None]
    id_incl = torch.where(
        last_t >= 0,
        torch.take_along_dim(cell_id_o, torch.clamp(last_t, min=0), dim=0),
        id0)
    id_before = torch.cat([id0.expand_as(id_incl[:1]), id_incl[:-1]], dim=0)

    final_state = mid_final._replace(published=p_incl[-1],
                                     pub_cell_id=id_incl[-1])
    out = StepOutput(
        track_event=track_event, drop_event=drop_event,
        drop_cell_id=id_before, cell_id=cell_id_o, nof_prb=nof_prb,
        nof_ports=nof_ports, phich_ext=phich_ext, phich_res=phich_res,
        sfn_offset=sfn_offset, normal_cp=normal_cp_o, psr=raw.psr,
        score=raw.score, tracking=raw.tracking, cfo_mean=cfo_mean,
        consumed=raw.consumed)
    return final_state, out


_BOOL_FIELDS = ("track_event", "drop_event", "normal_cp", "tracking")
_F32_FIELDS = ("psr", "cfo_mean")


def pack_output(out: StepOutput) -> torch.Tensor:
    """StepOutput -> ONE [n_steps, ..., 15] float32 tensor, so the host
    drain is one device-to-host copy.  Every field fits exactly in f32
    (ids <= 503, sfn_offset <= 1020, bools)."""
    return torch.stack([getattr(out, f).to(torch.float32)
                        for f in StepOutput._fields], dim=-1)


def unpack_output(arr) -> StepOutput:
    """Inverse of pack_output, into host numpy arrays."""
    a = arr.cpu().numpy() if isinstance(arr, torch.Tensor) \
        else np.asarray(arr)
    kw = {}
    for i, f in enumerate(StepOutput._fields):
        col = a[..., i]
        if f in _BOOL_FIELDS:
            kw[f] = col > 0.5
        elif f in _F32_FIELDS:
            kw[f] = col.astype(np.float32)
        else:
            kw[f] = col.astype(np.int32)
    return StepOutput(**kw)


def unpack_output_tensors(packed: torch.Tensor) -> StepOutput:
    """Inverse of pack_output, as tensors on the packed tensor's device with
    the fields' own types (exact: see pack_output)."""
    kw = {}
    for i, f in enumerate(StepOutput._fields):
        col = packed[..., i]
        if f in _BOOL_FIELDS:
            kw[f] = col > 0.5
        elif f in _F32_FIELDS:
            kw[f] = col
        else:
            kw[f] = col.to(torch.int32)
    return StepOutput(**kw)


def scan_engine(buffer: cplx.Pair, state: TriggerState, n_steps: int,
                psr_threshold: float,
                track_after: int = DEFAULT_TRACK_AFTER,
                track_every: int = DEFAULT_TRACK_EVERY,
                n_valid: int | None = None, combine: bool = True,
                data_valid: int | None = None, grid0: int | None = None):
    """Scan `n_steps` half-frame steps over a stream buffer, then
    batch-decode the captured MIB candidates.

    buffer: pair of [..., N] float32 (leading dims = channels), read as if
    zero-extended by n_steps * 9600 + 640 samples (the JAX engine's pad).
    n_valid bounds step OWNERSHIP (which grid steps run); data_valid bounds
    readable DATA for candidate reads (defaults to n_valid).  Both default
    to the zero-extended length, as in the JAX engine.  grid0: see scan_pass.
    returns: (final_state, StepOutput stacked [n_steps, ...])
    """
    torch.backends.cuda.matmul.allow_tf32 = False   # DFT/SSS in full f32
    if n_valid is None:
        n_valid = buffer[0].shape[-1] + n_steps * HALF_FRAME_LENGTH \
            + _PAD_TAIL
    final, raw = scan_pass(buffer, state, n_steps, psr_threshold,
                           track_after, track_every, n_valid=n_valid,
                           grid0=grid0)
    if data_valid is None:
        data_valid = n_valid
    return _mib_postpass(state, final, raw, buffer, data_valid=data_valid,
                         combine=combine)
