"""The downlink trigger: PSS tracking state machine + SSS + MIB, in three
passes.  Port of ltetrigger_tpu/models/trigger.py (its module docstring
gives the design); this module keeps the names, the state layout and the
observable contract, in PyTorch's idiom.

  pass A  grid correlation: the stream is searched on a fixed grid (step t's
          9600 candidate positions start at grid0 + 9600 t), so the matched
          filter for g steps at once is one blocked-Toeplitz product, run by
          the hand-written CUDA kernel (ops/kernels/matched_filter.py).
  pass B  the sequential state machine over the steps of each group:
          EMA'd correlation power, peak/PSR, hysteresis score/timer/tracking,
          PSR telemetry ring; one launch of the hand-written CUDA kernel per
          group (ops/kernels/pass_b.py).
  pass C  batched over the step axis: the front end, slot-0 tail
          extraction, CFO estimate and ring, rotation, PSS channel
          estimate, CP detect, SSS and MIB capture selection (on a card
          the hand-written CUDA kernels ops/kernels/pass_c_front.py, two
          launches around one of ops/kernels/cfo_ring.py, at any dispatch
          length), then one batched PBCH + Viterbi decode of
          the captured candidates with the 40 ms TTI soft-combining
          accumulator (one launch each of the hand-written CUDA kernels
          ops/kernels/tti_chain.py and ops/kernels/viterbi.py), and the
          track/drop event assembly.

Sample extraction, the scatter into the capture slots and the map back to
steps are plain indexing: the JAX package's dense one-hots exist only
because TPU gathers are slow.  The engine reads the buffer as if it were
zero-extended past its end, as the JAX engine pads it.

Host syncs (each waits for the card and reads a value; `host_syncs` counts
them by name, and each read is the span "wait.<name>"):
  * "grid": scan_pass reads the grid start from `state.pos`, unless the
    caller passes it as `grid0` (the streaming classes do);
  * "emit", "capture": _mib_postpass gates on `any step emitted` and `any
    candidate captured`;
  * "cp": _decode_candidates picks the CP pipeline from the candidates' CPs
    (two reads);
  * "probe": the streaming classes (models/api.py) read the CFO probe's
    best bin.

Spans (utils/profiling.span; recorded only while a torch.profiler runs):
"scan_pass" (passes A+B) with "pass_a" / "pass_b" a group; "pass_c" with
"pass_c.sync" (slot-0 extraction, CFO, CP, SSS), "pass_c.capture",
"pass_c.decode" and "pass_c.events"; the waits above; "readback.pack",
"readback.copy" and "readback.unpack" in pack_output / unpack_output,
whose "wait.drain" (a stream synchronize made only while tracing, counted
in no `host_syncs`) parts the card's drain from the copy.  unpack_output
splits its input into its fields where it lies ("readback.copy": a CUDA
input's split on the card and one copy to pinned host memory; a CPU
tensor's or a numpy array's split on the host) and reads them back as
numpy views of that one buffer ("readback.unpack").  `readback_paths`
counts the calls by the path they took ("device" / "host").

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
                                 MOVING_AVG_SZ, SLOT_LENGTH,
                                 SYMBOL_SZ)
from ..ops import cfo as cfo_ops
from ..ops import correlate, cplx, pbch
from ..ops.device import resolve_device
from ..ops.kernels import matched_filter, pass_b, pass_c_front, tti_chain
from ..ops.kernels.cfo_ring import ring_mean as _ring_mean
# the slot-0 geometry and the zero-padded read live with pass C's front end
from ..ops.kernels.pass_c_front import LOOKBACK, SEG, SEG_OFF  # noqa: F401
from ..ops.kernels.pass_c_front import read as _read
from ..utils.profiling import span, tracing

R = 3                                   # N_id_2 hypotheses
WINDOW = LOOKBACK + correlate.V2_WINDOW                # 10560
K_CANDIDATES = 16                       # MIB candidate slots (long dispatches)
K_STEP_CAP = 32                         # up to here: one capture slot a step
# max batch*g steps per pass-A group (bounds the power tensor to about
# GROUP_BUDGET * 115 KB); a larger budget gives pass B fewer, larger groups
GROUP_BUDGET = int(os.environ.get("LTETRIGGER_GROUP_BUDGET", "4096"))
# pass C reads up to this far past the last grid step; the JAX engine pads
# its buffer by n_steps * 9600 + this many zeros
_PAD_TAIL = 640

host_syncs = collections.Counter()      # host reads of device values, by name
readback_paths = collections.Counter()  # unpack_output calls: device / host


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
               device="cuda") -> TriggerState:
    """Fresh carry for `batch` channels (leading dims) on `device` (the
    card unless the caller asks for the CPU; raises without one)."""
    device = resolve_device(device)
    fill = dict(_STATE_FILL, pos=start_pos)
    return TriggerState(**{
        f: torch.full(tuple(batch) + shape, fill.get(f, 0), dtype=dt,
                      device=device)
        for f, (shape, dt) in _STATE_SHAPES.items()})


def state_from_numpy(d: dict, device="cuda") -> TriggerState:
    """The JAX package's TriggerState as numpy arrays ({field: array}) ->
    the port's TriggerState on `device` (the card unless the caller asks
    for the CPU; raises without one).  A missing `chest` (checkpoints older
    than the channel-estimate telemetry) reads as zeros."""
    device = resolve_device(device)
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
# passes A+B — pass B, the sequential state machine, in ops/kernels/pass_b.py
# ======================================================================
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
    with span("scan_pass", device=buffer[0].device):
        n = buffer[0].shape[-1]
        if n_valid is None:
            n_valid = n
        batch = math.prod(buffer[0].shape[:-1]) or 1
        g = _pick_group(n_steps, batch)
        if grid0 is None:
            host_syncs["grid"] += 1
            with span("wait.grid"):
                grid0 = int(state.pos.reshape(-1)[0])
        thresh = float(np.float32(psr_threshold))

        groups = []
        for gi in range(n_steps // g):
            lo = grid0 + gi * g * HALF_FRAME_LENGTH
            # active steps (grid + 9728 <= n_valid) are a prefix of the group
            n_active = min(g, max(0, (n_valid - correlate.V2_WINDOW - lo)
                                  // HALF_FRAME_LENGTH + 1))
            if n_active == 0:       # no active step: no pass A, no launch
                groups.append(pass_b.idle_rows(state, g))
                continue
            with span("pass_a"):
                power = _group_power(buffer, lo, g)  # [.., g, 75, R, 128]
            with span("pass_b"):
                state, rows = pass_b.scan_group(state, power, lo, n_active,
                                                thresh, track_after,
                                                track_every)
            groups.append(rows)
        # the grid of every step from host integers: no copy to the device
        steps = torch.arange(n_steps, dtype=torch.int32,
                             device=buffer[0].device)
        grids = grid0 + HALF_FRAME_LENGTH * steps
        raw = RawStepOutput(
            grid=grids, active=grids + correlate.V2_WINDOW <= n_valid,
            **{f: c[0] if len(c) == 1 else torch.cat(c) for f, c in
               zip(RawStepOutput._fields[2:], zip(*groups))})
        return state, raw


# ======================================================================
# pass C — batched SSS / capture / MIB decode / event assembly
# ======================================================================
def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=0).values


def _decode_candidates(state0: TriggerState, buffer: cplx.Pair,
                       cand_start, cand_freq, cand_cell, cand_cp, cand_fresh,
                       valid, combine: bool):
    """Batched PBCH + Viterbi over the captured candidates.

    cand_* : [..., R, K]; returns per-candidate verdicts [..., R, K] and the
    updated TTI accumulator carry."""
    with span("pass_c.decode"):
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
        with span("wait.cp"):
            all_norm = bool(torch.all(cand_cp | ~valid))
        with span("wait.cp"):
            all_ext = bool(torch.all((~cand_cp) | ~valid))
        if all_norm or all_ext:
            contrib = pbch.pbch_quarter_llrs_slot1(slot1, cand_cell, all_norm)
        else:
            # [.., 2, 3, 4, 120]
            both = pbch.quarter_llrs_both_cp(slot1, cand_cell)
            contrib = torch.where(cand_cp[..., None, None, None],
                                  both[..., 1, :, :, :], both[..., 0, :, :, :])

        # TTI soft-combining chain over the K slots: 4 TTI-phase hypotheses,
        # phase h restarts its accumulator at quarter 0; a restart (loss or
        # cell-id change) clears every phase (ops/kernels/tti_chain.py)
        accs, qs, acc, n, cell = tti_chain.tti_chain(
            state0.llr_acc.reshape(batch + (R, 3, 4, 120)), state0.mib_n,
            state0.mib_cell, contrib, cand_fresh, cand_cell, valid, combine)
        # accs [.., R, K, 3, 4, 120], qs [.., R, K, 4]: hypothesis index
        # port * 4 + phase reports quarter qs[.., phase]
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
    with span("pass_c", device=dev):
        batch = final.score.shape[:-1]
        shape = raw.psr.shape
        zero_i = torch.zeros(shape, dtype=torch.int32, device=dev)
        zero_b = torch.zeros(shape, dtype=torch.bool, device=dev)

        if do_extract is None:
            host_syncs["emit"] += 1
            with span("wait.emit"):
                do_extract = bool(raw.emit.any())
        if not do_extract:                  # nothing emitted
            mean0 = _ring_mean(state0.cfo_ring, state0.cfo_count)
            mid_final = final
            track_event, lost_e = zero_b, zero_b
            nof_prb = nof_ports = phich_ext = phich_res = sfn_offset = zero_i
            cell_id_o, normal_cp_o = zero_i, zero_b
            cfo_mean = mean0[None].expand(shape)
        else:
            # slot-0 read, CFO estimate and ring, rotation, channel
            # estimate, CP, SSS and capture selection (spans "pass_c.sync"
            # and "pass_c.capture"): ops/kernels/pass_c_front.py
            fr = pass_c_front.front(state0, raw, buffer, data_valid, k)

            if do_decode is None:
                host_syncs["capture"] += 1
                with span("wait.capture"):
                    do_decode = bool(fr.cnt.sum() > 0)
            if do_decode:                   # any candidate captured
                (found, prb_rk, ports_rk, pext_rk, pres_rk, sfn_rk,
                 acc_f, n_f, cell_f) = _decode_candidates(
                    state0, buffer, fr.cand_start, fr.cand_freq,
                    fr.cand_cell, fr.cand_cp, fr.cand_fresh, fr.valid,
                    combine)
            else:
                zi = torch.zeros(batch + (R, k), dtype=torch.int32,
                                 device=dev)
                found = torch.zeros(batch + (R, k), dtype=torch.bool,
                                    device=dev)
                prb_rk = ports_rk = pext_rk = pres_rk = sfn_rk = zi
                acc_f = state0.llr_acc
                n_f, cell_f = state0.mib_n, state0.mib_cell

        with span("pass_c.events"):
            if do_extract:
                # ---- publish once per epoch (cumulative fresh count) ----
                fresh_eff = fr.cand_fresh & fr.valid
                e = torch.cumsum(fresh_eff.to(torch.int32), dim=-1)
                same_ep = e[..., :, None] == e[..., None, :]  # [.., R, K, K]
                ks = torch.arange(k, device=dev)
                j_lt_k = ks[None, :] < ks[:, None]            # [K(k), K(j)]
                prior = torch.any(same_ep & j_lt_k & found[..., None, :],
                                  dim=-1)
                is_pub = found & ~prior & ~(state0.published[..., None]
                                            & (e == 0))

                # ---- map candidate verdicts back to step space ----
                taken = torch.clamp(fr.at, max=k - 1)

                def gather(a):              # [.., R, K] -> [S, .., R]
                    return torch.gather(a, -1, taken).movedim(-1, 0)

                track_event = fr.want_cap & gather(is_pub)

                def fld(a):
                    return torch.where(track_event, gather(a), 0).to(
                        torch.int32)

                mid_final = final._replace(
                    cfo_ring=fr.ring, cfo_count=fr.count,
                    llr_acc=acc_f.reshape(batch + (R, 12, 120)),
                    mib_n=n_f, mib_cell=cell_f,
                    pending_fresh=fr.pending_fresh,
                    cap_overflow=state0.cap_overflow + fr.overflow,
                    chest=fr.chest)
                lost_e = raw.lost
                nof_prb, nof_ports, phich_ext, phich_res, sfn_offset = (
                    fld(prb_rk), fld(ports_rk), fld(pext_rk), fld(pres_rk),
                    fld(sfn_rk))
                cell_id_o = fr.cell_id
                normal_cp_o = fr.normal_cp
                cfo_mean = fr.cfo_mean

            # ---- published/drop state machine over steps ----
            # p[s] = (p[s-1] & ~lost[s]) | track[s]: the latest of the last
            # track and the last loss decides (a track wins a tie)
            t, l = track_event, lost_e
            tt = torch.arange(s, device=dev).reshape((s,) + (1,) *
                                                     (t.ndim - 1))
            last_t = _cummax(torch.where(t, tt, -1))
            last_l = _cummax(torch.where(l, tt, -1))
            p0 = state0.published[None]
            p_incl = torch.where((last_t < 0) & (last_l < 0), p0,
                                 last_t >= last_l)
            p_before = torch.cat([p0.expand_as(p_incl[:1]), p_incl[:-1]],
                                 dim=0)
            drop_event = l & p_before
            id0 = state0.pub_cell_id[None]
            id_incl = torch.where(
                last_t >= 0,
                torch.take_along_dim(cell_id_o, torch.clamp(last_t, min=0),
                                     dim=0),
                id0)
            id_before = torch.cat([id0.expand_as(id_incl[:1]), id_incl[:-1]],
                                  dim=0)

            final_state = mid_final._replace(published=p_incl[-1],
                                             pub_cell_id=id_incl[-1])
            out = StepOutput(
                track_event=track_event, drop_event=drop_event,
                drop_cell_id=id_before, cell_id=cell_id_o, nof_prb=nof_prb,
                nof_ports=nof_ports, phich_ext=phich_ext,
                phich_res=phich_res, sfn_offset=sfn_offset,
                normal_cp=normal_cp_o, psr=raw.psr, score=raw.score,
                tracking=raw.tracking, cfo_mean=cfo_mean,
                consumed=raw.consumed)
        return final_state, out


_BOOL_FIELDS = ("track_event", "drop_event", "normal_cp", "tracking")
_F32_FIELDS = ("psr", "cfo_mean")


def pack_output(out: StepOutput) -> torch.Tensor:
    """StepOutput -> ONE [n_steps, ..., 15] float32 tensor, so the host
    drain is one device-to-host copy.  Every field fits exactly in f32
    (ids <= 503, sfn_offset <= 1020, bools)."""
    with span("readback.pack"):
        return torch.stack([getattr(out, f).to(torch.float32)
                            for f in StepOutput._fields], dim=-1)


def unpack_output(arr) -> StepOutput:
    """Inverse of pack_output, into host numpy arrays (int32, float32 and
    bool fields, each of the packed output's leading shape), the fields'
    types as unpack_output_tensors sets them.

    The fields are split with `split_fields` where the packed output lies
    ("readback.copy": a CUDA tensor on the card, then one copy into pinned
    host memory; a CPU tensor or a numpy array on the host) and read as
    numpy views of that one buffer (`field_views`, "readback.unpack"),
    which the result alone owns, so no later call changes it.
    `readback_paths` counts the calls by path, "device" (a CUDA tensor) or
    "host"."""
    packed = torch.as_tensor(arr)
    on_card = packed.is_cuda
    readback_paths["device" if on_card else "host"] += 1
    if on_card and tracing():
        with span("wait.drain"):
            torch.cuda.current_stream(packed.device).synchronize()
    with span("readback.copy"):
        buf = split_fields(packed)
        if on_card:
            buf = torch.empty(buf.shape, dtype=torch.uint8,
                              pin_memory=True).copy_(buf)
    with span("readback.unpack"):
        return field_views(buf.numpy(), packed.shape[:-1])


# field order of split_fields' buffer: the 4-byte fields, then the bools
_WORD_FIELDS = tuple(f for f in StepOutput._fields if f not in _BOOL_FIELDS)


def split_fields(packed: torch.Tensor) -> torch.Tensor:
    """pack_output's [..., 15] float32 -> one contiguous uint8 buffer on its
    device, field-major: the eleven 4-byte fields as int32 rows (psr and
    cfo_mean bit for bit), then the four bool fields as uint8 rows, each
    as unpack_output_tensors gives it.  `field_views` reads it back."""
    t = unpack_output_tensors(packed)
    words = torch.stack([getattr(t, f).view(torch.int32)
                         for f in _WORD_FIELDS])
    flags = torch.stack([getattr(t, f) for f in _BOOL_FIELDS])
    return torch.cat([words.reshape(-1).view(torch.uint8),
                      flags.reshape(-1).view(torch.uint8)])


def field_views(buf: np.ndarray, shape) -> StepOutput:
    """split_fields' buffer (as a host uint8 array) -> StepOutput of numpy
    views of it, each of `shape` (the packed output's leading shape)."""
    shape = tuple(shape)
    nw = 4 * math.prod(shape) * len(_WORD_FIELDS)
    kw = dict(zip(_WORD_FIELDS, buf[:nw].view(np.int32).reshape(
        (len(_WORD_FIELDS),) + shape)))
    kw.update(zip(_BOOL_FIELDS, buf[nw:].view(np.bool_).reshape(
        (len(_BOOL_FIELDS),) + shape)))
    for f in _F32_FIELDS:
        kw[f] = kw[f].view(np.float32)
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
