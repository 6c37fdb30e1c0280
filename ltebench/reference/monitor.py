"""Plain reference of a live monitor's streams, and the comparison that
decides the monitor cells' `correct`.

A stream as the streaming pipeline scans it: stream position 0 is its
first sample, LOOKBACK zeros of history lie before it, and half-frame step
t's candidate p sits at stream position 9600 t + p, the grid of the batch
scan (`passab`, grid0 = LOOKBACK in a padded buffer).  The reference runs
`passab`'s float64 passes A and B over each whole fed stream: pass B from
a fresh state over every step the program's outputs cover, so that how the
pipeline cut the stream into dispatches, and carried its state across
them, does not enter.  The fed streams are loops, so step t's pass-A power
is that of step t mod (loop / 9600): it is computed once a loop position,
in blocks of steps, on the loops' device.

`Record` is the program's side: the `on_output` hook's numpy arrays,
kept step by step.  It imports nothing of the program and takes nothing
the program made besides those outputs (and the final peak).

Numbers (`check`; each {"value", "limit"}):
  psr_rel_gap     the widest |psr - psr_ref| / psr_ref of any step, stream
                  and root
  state_mismatch  steps x streams x roots whose score or tracking flag
                  differs, plus outputs that skip or repeat a step, or
                  whose streams and roots did not advance together (exact)
  peak_mismatch   roots tracking at the last step whose last peak differs
                  (exact)
  wrong_events    published cells whose stream carries no cell, or whose
                  root, id, CP or MIB fields (PRB, ports, PHICH, SFN)
                  differ from the planted cell's; retractions of another
                  cell or where the reference's tracking does not end
                  (exact)
  missed          streams whose cell the reference tracks at some step and
                  the program never published (exact)
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..gen.ltecore.constants import HALF_FRAME_LENGTH, SYMBOL_SZ
from . import check as refcheck, passab

FIELDS = ("cell_id", "nof_prb", "nof_ports", "phich_ext", "phich_res",
          "sfn_offset", "normal_cp")


def _num(value, limit) -> dict:
    return {"value": float(value), "limit": float(limit)}


class Record:
    """The `on_output` hook's side: called with each drained dispatch's
    StepOutput of numpy arrays [S, N, R] and the drained positions before
    it [N, R].  Keeps, for each active step (consumed > 0), its step index
    and its psr, score and tracking rows; every track and drop event with
    its fields; the harvest's time (`time.perf_counter`) and active steps.
    `faults` counts outputs that do not follow the one before on the grid,
    or whose streams and roots did not advance together."""

    def __init__(self):
        self.steps, self.psr, self.score, self.tracking = [], [], [], []
        self.events = []            # dicts: kind, step, stream, root, ...
        self.harvests = []          # (perf_counter, active steps, rows)
        self.next_step = 0
        self.faults = 0

    def __call__(self, host, pos_before) -> None:
        cons = np.asarray(host.consumed).reshape(host.consumed.shape[0], -1)
        full = (cons == HALF_FRAME_LENGTH).all(axis=1)
        n_act = int(np.argmin(full)) if not full.all() else len(full)
        pos = np.asarray(pos_before).reshape(-1)
        k0 = int(pos[0]) // HALF_FRAME_LENGTH
        if ((pos != pos[0]).any() or pos[0] % HALF_FRAME_LENGTH
                or k0 != self.next_step or cons[n_act:].any()):
            self.faults += 1
        self.next_step = k0 + n_act
        self.steps.append(np.arange(k0, k0 + n_act))
        for name in ("psr", "score", "tracking"):
            getattr(self, name).append(
                np.array(getattr(host, name)[:n_act]))
        for kind in ("track", "drop"):
            ev = np.asarray(getattr(host, f"{kind}_event"))
            for s, n, r in zip(*np.nonzero(ev)):
                e = dict(kind=kind, step=k0 + int(s), stream=int(n),
                         root=int(r))
                if kind == "track":
                    e.update({f: int(getattr(host, f)[s, n, r])
                              for f in FIELDS})
                else:
                    e["cell_id"] = int(host.drop_cell_id[s, n, r])
                self.events.append(e)
        self.harvests.append((time.perf_counter(), n_act,
                              int(host.consumed.shape[0])))

    def arrays(self) -> dict:
        """steps [K], psr / score / tracking [K, N, R]."""
        return {k: np.concatenate(getattr(self, k))
                for k in ("steps", "psr", "score", "tracking")}


def loop_power(loops: torch.Tensor, precision: str,
               steps_at_once: int = 50) -> torch.Tensor:
    """Pass A of every step of looped streams: loops [N, L] complex64 (L a
    multiple of 9600) -> [N, L / 9600, 3, 9600] float64, step t's candidate
    p at stream position 9600 t + p, the stream being the loop repeated."""
    n, length = loops.shape
    period = length // HALF_FRAME_LENGTH
    ext = torch.cat([loops, loops[:, :SYMBOL_SZ]], dim=-1)
    out = torch.empty((n, period, 3, HALF_FRAME_LENGTH), dtype=torch.float64,
                      device=loops.device)
    for t0 in range(0, period, steps_at_once):
        t1 = min(t0 + steps_at_once, period)
        seg = ext[:, t0 * HALF_FRAME_LENGTH:t1 * HALF_FRAME_LENGTH
                  + SYMBOL_SZ]
        out[:, t0:t1] = passab.correlation_power(
            seg.real.contiguous(), seg.imag.contiguous(), 0, t1 - t0,
            precision)
    return out


def reference(loops: torch.Tensor, n_steps: int, cfg: dict,
              port_over=None, tie_rel: float = 0.0) -> dict:
    """`passab.pass_b` over steps 0 .. n_steps - 1 of every looped stream,
    from a fresh state: psr, score, tracking [n_steps, N, 3], the last
    peak [N, 3], ties."""
    power = loop_power(loops, cfg["precision"]["pass_a"])
    period = power.shape[1]
    return passab.pass_b(
        lambda t: power[:, t % period], n_steps, (loops.shape[0],),
        loops.device, float(cfg["psr_threshold"]), int(cfg["track_after"]),
        int(cfg["track_every"]), port_over=port_over, tie_rel=tie_rel)


def check(rec: Record, loops: np.ndarray, cells: list, cfg: dict,
          limits: dict, device, peak=None) -> tuple[dict, dict]:
    """(checks, info): every step `rec` holds against the reference of the
    loops as fed; `peak` [N, 3], the program's last peak after its last
    harvested step (None: not compared)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tie = float(limits["psr_rel_gap"])
    got = rec.arrays()
    k = len(got["steps"])
    faults = rec.faults + int((got["steps"] != np.arange(k)).any())
    x = torch.from_numpy(np.ascontiguousarray(loops)).to(device)
    ref = reference(x, k, cfg,
                    port_over=torch.from_numpy(got["score"] > 0).to(device),
                    tie_rel=tie)
    del x
    gap, mism = refcheck.pass_ab_numbers(got["psr"], got["score"],
                                         got["tracking"], ref)
    trk = ref["tracking"].cpu().numpy()
    peak_bad = 0
    if peak is not None and k:
        peak_bad = int(((np.asarray(peak) != ref["peak"].cpu().numpy())
                        & trk[-1]).sum())
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
    missed = undue = 0
    for n, cell in enumerate(cells):
        if cell["cell_id"] < 0:
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
              "missed": _num(missed, limits["missed"])}
    info = dict(steps_compared=k, grid_faults=faults,
                ties=int(ref["ties"].sum()), undue=undue,
                published=sum(e["kind"] == "track" for e in rec.events),
                retractions=retractions)
    return checks, info
