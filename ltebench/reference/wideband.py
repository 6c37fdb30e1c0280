"""Plain reference of the live band monitor, and the comparison that decides
its cell's `correct`.

Written from the observable contract (ltetrigger_tpu_torch/models/
wideband.py module docstring: one wide stream channelized, with the mixer's
phase at absolute wide indices and real stream samples as the decimator's
context, into the streaming pipeline's mirror); it imports nothing of the
program and takes nothing the program made besides its outputs (the
`on_output` hook's, kept by `reference.monitor.Record`), its last peak and
the lanes its mirror held, read after the window.

The stream as fed: wide sample w >= 0 is loop[w mod N], and there is
nothing before wide sample 0 (zeros).  The lane of each centre is
`reference.band.lanes`' float64 channelizer of that stream, and narrow
stream position n is lane sample n (LOOKBACK zeros of history before 0, as
in `reference.monitor`).  The raster and carrier offsets are multiples of
1 / loop_seconds Hz, so the mixer's phase is periodic with the loop too,
and lane[n + P] = lane[n] (P = N / ratio) wherever the decimator's span
lies inside the stream, n >= 8: the first loop is taken linearly, from
zeros, and the periodic part circularly, from the same lanes
(`stream_lanes`: one loop and a half-frame and a symbol more).  Pass A's
power of step t >= 1 is then that of step (t - 1) mod (P / 9600) + 1.

The lanes go to pass A's reference in bf16, the precision the
configuration states, with `reference.band.pass_a_inputs`' tie rule: where
the program's own value of a sample is known (the reads of its mirror,
folded onto the loop by `fold`), a sample within `chan_rel_err`'s limit of
the lane's rms that rounds apart takes the program's rounding.  One
rounding apart, ~0.4 % of one sample, moves a noise lane's ratio by up to
~1e-3 and can move the edge of its main lobe, so the driver reads the
mirror until the reads hold every sample of the loop.  The program's lanes
at one loop position agree from loop to loop, to the last bit, where its
uploads started on the absolute block grid (fed in 10-ms chunks that each
dispatch takes up); the warm-up's first upload and its deep dispatches'
remainders start off it, so the first steps, up to the end of a read made
in the warm-up (`early`), take the program's values from that read
(`_early_steps`).
Then `passab`'s pass B runs over every whole lane from a fresh state, over
every step the program's outputs cover, so that how the pipeline cut the
stream into dispatches, and carried its state across them, does not enter.
Lanes are taken in blocks, so that the power of a block's loop fits on the
card.

Numbers (`check`; each {"value", "limit"}):
  psr_rel_gap     the widest |psr - psr_ref| / psr_ref of any step, centre
                  and root
  state_mismatch  steps x centres x roots whose score or tracking flag
                  differs, plus outputs that skip or repeat a step, or
                  whose centres and roots did not advance together (exact)
  peak_mismatch   roots tracking at the last step whose last peak differs
                  (exact)
  wrong_events    anything published at a centre that is not a carrier's
                  raster point, published cells whose root, id, CP or MIB
                  fields (PRB, ports, PHICH, SFN) differ from the planted
                  carrier's, retractions of another cell or where the
                  reference's tracking does not end (exact)
  missed          carriers the reference tracks on their raster point at
                  some step and the program never published there (exact)
  chan_rel_err    the largest relative L2 error, over the centres, of the
                  lanes the program's mirror held (read after the window,
                  folded onto the loop) against the reference's
"""

from __future__ import annotations

import numpy as np
import torch

from ..gen.ltecore.constants import (HALF_FRAME_LENGTH, SAMPLE_RATE,
                                     SYMBOL_SZ)
from . import band as refband, check as refcheck, passab

TAPS_HALF = refband.TAPS_PER_PHASE // 2     # narrow samples of the filter's
                                            # half span: lanes periodic past


def _num(value, limit) -> dict:
    return {"value": float(value), "limit": float(limit)}


def stream_lanes(loop: torch.Tensor, sample_rate: float,
                 offsets_hz) -> torch.Tensor:
    """loop [N] complex on the device to compute on -> [C, N / ratio +
    9600 + 128] complex128: narrow stream positions 0 .. of the looped wide
    stream's lane at each centre offset (zeros before wide sample 0)."""
    ratio = int(round(sample_rate / SAMPLE_RATE))
    n_out = loop.numel() // ratio + HALF_FRAME_LENGTH + SYMBOL_SZ
    extra = ratio * (HALF_FRAME_LENGTH + SYMBOL_SZ
                     + refband.TAPS_PER_PHASE)
    reps = -(-extra // loop.numel())
    x = torch.cat([loop] + [loop] * reps)[:loop.numel() + extra]
    return refband.lanes(x, sample_rate, offsets_hz, n_out)


def loop_index(pos: torch.Tensor, period: int) -> torch.Tensor:
    """Stream positions -> the index of `stream_lanes` that holds the same
    sample: n itself in the first loop, else (n - 8) mod P + 8."""
    return torch.where(pos < period + TAPS_HALF, pos,
                       torch.remainder(pos - TAPS_HALF, period) + TAPS_HALF)


def step_power_at(power: torch.Tensor, first=None):
    """power [C, P / 9600 + 1, 3, 9600] of steps 0 .. P / 9600, and first
    [C, K, 3, 9600] of steps 0 .. K - 1 or None -> the function of step t
    that pass B reads: first's for t < K, else power's."""
    period = power.shape[1] - 1
    k1 = 0 if first is None else first.shape[1]
    return lambda t: first[:, t] if t < k1 else \
        power[:, 0 if t == 0 else (t - 1) % period + 1]


def fold(have, resident, period: int):
    """The lanes a read of the program's mirror holds, put where
    `stream_lanes` holds the same samples: have is None or the (re, im)
    pair [C, period + 9600 + 128] float32 so far, NaN where no read held
    the sample; resident (first, re, im [C, L]) the read.  Returns the pair
    with the read's samples written in (the first loop's index and, below
    9728, the next loop's too; of a read longer than the loop, its last
    loop), and the number of its samples that an earlier read held
    otherwise (0 where the lanes repeat with the loop)."""
    first, re, im = resident
    if re.shape[-1] > period:
        first, re, im = (int(first) + re.shape[-1] - period,
                         re[:, -period:], im[:, -period:])
    if have is None:
        have = tuple(torch.full((re.shape[0], period + HALF_FRAME_LENGTH
                                 + SYMBOL_SZ), float("nan"),
                                dtype=torch.float32, device=re.device)
                     for _ in range(2))
    pos = torch.arange(int(first), int(first) + re.shape[-1],
                       device=re.device)
    keep = pos >= 0
    idx = loop_index(pos[keep], period)
    low = idx >= TAPS_HALF
    nxt = idx[low] + period
    fit = nxt < have[0].shape[1]
    differ = 0
    for h, part in zip(have, (re, im)):
        own = part[:, keep]
        old = h[:, idx]
        differ += int(((old != own) & ~old.isnan()).sum())
        h[:, idx] = own
        h[:, nxt[fit]] = own[:, low][:, fit]
    return have, differ


def covered(have, period: int) -> bool:
    """Whether the folded reads hold every sample of the loop's periodic
    part."""
    return have is not None and not bool(
        have[0][0, TAPS_HALF:TAPS_HALF + period].isnan().any())


def early_count(early, k: int) -> int:
    """The number of first steps (of k) whose samples all lie in the early
    read (first, re, im [C, L]): none where it starts past position 0."""
    if early is None or int(early[0]) > 0:
        return 0
    end = int(early[0]) + early[1].shape[-1]
    return min(max((end - SYMBOL_SZ) // HALF_FRAME_LENGTH, 0), k)


def _early_steps(lanes, early, c0: int, c1: int, period: int, k: int,
                 tie_rel: float, precision: str):
    """Pass A of the first steps from the program's own lanes at their
    stream positions: early (first, re, im [C, L]) is a read of the mirror
    made before it slid past position 0, when the samples the warm-up
    uploaded off the loop's grid (the first upload, a deep dispatch's
    remainder) were still in it.  -> (power [c1 - c0, K, 3, 9600] of steps
    0 .. K - 1 (`early_count`) or None, the largest relative L2 error of
    the read's lanes, the ties taken)."""
    e0, ere, eim = early
    k1 = early_count(early, k)
    if k1 == 0:
        return None, 0.0, 0
    n1 = k1 * HALF_FRAME_LENGTH + SYMBOL_SZ
    dev = lanes.device
    ref = lanes[:, loop_index(torch.arange(n1, device=dev), period)]
    got = tuple(part[c0:c1, -int(e0):n1 - int(e0)].to(dev)
                for part in (ere, eim))
    err = float(refband.rel_err(got, ref).max())
    (re, im), rt = refband.pass_a_inputs(ref, got, n1, tie_rel)
    del ref, got
    return passab.correlation_power(re, im, 0, k1, precision), err, rt


def count_off_grid(early, have, period: int) -> int:
    """Samples of the early read (see `_early_steps`) that the reads after
    the window, folded onto the loop, hold otherwise: those the warm-up cut
    off the loop's grid."""
    if early is None or have is None:
        return 0
    e0, ere, eim = early
    pos = torch.arange(max(int(e0), 0), int(e0) + ere.shape[-1])
    idx = loop_index(pos, period).to(have[0].device)
    n = 0
    for h, part in zip(have, (ere, eim)):
        own = part[:, pos - int(e0)].to(h.device)
        old = h[:, idx]
        n += int(((old != own) & ~old.isnan()).sum())
    return n


def check(rec, loop: np.ndarray, cells: list, offsets_hz, cfg: dict,
          limits: dict, device, peak=None, program_lanes=None, early=None,
          centres_at_once: int = 34) -> tuple[dict, dict]:
    """(checks, info): every step `rec` (a `reference.monitor.Record`)
    holds against the reference of the loop as fed.

    cells[c]: the planted cell of centre c (`gen.band.centre_cells`: the
    carrier at its own raster point, cell_id -1 elsewhere); offsets_hz[c]
    its offset from the stream's centre; peak [C, 3]: the program's last
    peak (None: not compared); program_lanes: the reads of the program's
    mirror folded onto the loop (`fold`), or None (then no `chan_rel_err`
    and no ties taken); early: a read of the mirror in the warm-up, from
    before position 0 (`_early_steps`), or None."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rate = float(cfg["sample_rate"])
    ratio = int(round(rate / SAMPLE_RATE))
    tie = float(limits["psr_rel_gap"])
    got = rec.arrays()
    k = len(got["steps"])
    faults = rec.faults + int((got["steps"] != np.arange(k)).any())
    period = loop.size // ratio
    steps = period // HALF_FRAME_LENGTH
    x = torch.from_numpy(np.ascontiguousarray(loop)).to(device)
    n_c = len(cells)
    known = None
    if program_lanes is not None:
        known = ~program_lanes[0][0].isnan()
    gap = mism = ties = round_ties = 0
    err = 0.0
    widest = None
    trk = np.zeros((k, n_c, 3), dtype=bool)
    ref_peak = np.zeros((n_c, 3), dtype=np.int64)
    for c0 in range(0, n_c, centres_at_once):
        c1 = min(c0 + centres_at_once, n_c)
        lanes = stream_lanes(x, rate, offsets_hz[c0:c1])
        have = None
        if known is not None:
            have = tuple(part[c0:c1].to(device) for part in program_lanes)
            err = max(err, float(refband.rel_err(
                tuple(h[:, known] for h in have), lanes[:, known]).max()))
        (re, im), rt = refband.pass_a_inputs(lanes, have, lanes.shape[1],
                                             float(limits["chan_rel_err"]))
        round_ties += rt
        del have
        first = None
        if early is not None:
            first, e_err, rt = _early_steps(
                lanes, early, c0, c1, period, k,
                float(limits["chan_rel_err"]), cfg["precision"]["pass_a"])
            err, round_ties = max(err, e_err), round_ties + rt
        del lanes
        power = passab.correlation_power(re, im, 0, steps + 1,
                                         cfg["precision"]["pass_a"])
        del re, im
        over = torch.from_numpy(got["score"][:, c0:c1] > 0).to(device)
        ref = passab.pass_b(step_power_at(power, first), k, (c1 - c0,),
                            device, float(cfg["psr_threshold"]),
                            int(cfg["track_after"]),
                            int(cfg["track_every"]), port_over=over,
                            tie_rel=tie)
        del power, first
        g, m = refcheck.pass_ab_numbers(got["psr"][:, c0:c1],
                                        got["score"][:, c0:c1],
                                        got["tracking"][:, c0:c1], ref)
        if g > gap:
            rp = ref["psr"].cpu().numpy()
            t, c, r = np.unravel_index(np.argmax(
                np.abs(got["psr"][:, c0:c1] - rp) / np.maximum(rp, 1e-30)),
                rp.shape)
            widest = dict(step=int(t), centre=c0 + int(c), root=int(r),
                          psr=float(got["psr"][t, c0 + c, r]),
                          psr_ref=float(rp[t, c, r]))
        gap, mism = max(gap, g), mism + m
        ties += int(ref["ties"].sum())
        trk[:, c0:c1] = ref["tracking"].cpu().numpy()
        ref_peak[c0:c1] = ref["peak"].cpu().numpy()
        del ref
    del x
    peak_bad = 0
    if peak is not None and k:
        peak_bad = int(((np.asarray(peak) != ref_peak) & trk[-1]).sum())
    wrong = retractions = 0
    pub = set()
    for e in rec.events:
        cell, n, r, s = cells[e["stream"]], e["stream"], e["root"], e["step"]
        if e["kind"] == "track":
            pub.add((n, r))
            wrong += not refcheck.truth_ok(
                cell, r, e["cell_id"], e["nof_prb"], e["nof_ports"],
                e["phich_ext"], e["phich_res"], e["sfn_offset"],
                e["normal_cp"])
        else:
            retractions += 1
            ends = 0 < s < k and trk[s - 1, n, r] and not trk[s, n, r]
            wrong += not (cell["cell_id"] >= 0
                          and r == cell["cell_id"] % 3
                          and e["cell_id"] == cell["cell_id"] and ends)
    missed = undue = tracked = 0
    for n, cell in enumerate(cells):
        if cell["cell_id"] < 0:
            tracked += bool(trk[:, n].any())
            continue
        r = cell["cell_id"] % 3
        due = bool(trk[:, n, r].any())
        missed += due and (n, r) not in pub
        undue += not due
    checks = {"psr_rel_gap": _num(gap, limits["psr_rel_gap"]),
              "state_mismatch": _num(mism + faults,
                                     limits["state_mismatch"]),
              "peak_mismatch": _num(peak_bad, limits["peak_mismatch"]),
              "wrong_events": _num(wrong, limits["wrong_events"]),
              "missed": _num(missed, limits["missed"]),
              "chan_rel_err": _num(err, limits["chan_rel_err"])}
    info = dict(steps_compared=k, grid_faults=faults, ties=ties,
                undue=undue, round_ties=round_ties,
                published=sum(e["kind"] == "track" for e in rec.events),
                retractions=retractions, tracked_elsewhere=tracked,
                widest_psr_gap=widest,
                program_samples=0 if known is None
                else int(known.sum()),
                early_steps=early_count(early, k),
                early_off_grid=count_off_grid(early, program_lanes, period))
    return checks, info
