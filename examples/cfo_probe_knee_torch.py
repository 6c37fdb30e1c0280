#!/usr/bin/env python
"""Detection of a cell one subcarrier off through the SNR knee, with the
streaming integer-CFO probe on (`cfo_search_range=4`): how often a
`Trigger` publishes the cell, with and without a lead-in of noise before
the cell comes up.

Each trial is `--lead` seconds of noise alone, then `--seconds` of cell 200
(50 PRB field, unit power, +2 half-subcarriers) in the same noise, at the
SNR of the point, fed in 19200-sample calls, f32 transport.  A trial counts
as a detection when a `track` event carries cell 200.  The noise is drawn
with numpy from `--seed` and the trial's index, so every tree sees the same
samples.  `--tree DIR` imports `ltetrigger_tpu_torch` from another checkout
(to compare two versions of the probe on the same streams).

    python examples/cfo_probe_knee_torch.py [--device cpu] [--trials 8] \\
        [--snrs=-14,-12,-10,-8,-6] [--leads 0,0.2] [--tree DIR] [--floor N]

Prints one JSON line per (lead, SNR): the detections over the trials, the
mean delay from the cell's onset to its first track (s), and the final
rotations (half-subcarriers) of the trials.  With `--floor N` it prints
instead the quantiles of one probe's statistic, its best bin's PSR over 4
half-frame windows, on N draws of noise alone and, per SNR, of the cell at
a random position in that noise (with the share of draws whose best bin is
the cell's, +2): where `PROBE_MIN_PSR` lies between the two.
"""

import argparse
import json
import os
import sys

import numpy as np

CELL_ID, SUBCARRIERS, RATE = 200, 1.0, 1.92e6


def stream(synth, snr_db: float, lead_s: float, seconds: float,
           seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_frames = int(round(seconds * 100))
    cell = np.tile(synth.synthesize_frame(CELL_ID, nof_prb_field=50),
                   n_frames)
    n = np.arange(cell.size, dtype=np.float64)
    cell = cell * np.exp(2j * np.pi * SUBCARRIERS / 128.0 * n)
    x = np.concatenate([np.zeros(int(round(lead_s * RATE))), cell])
    sigma = 10.0 ** (-snr_db / 20.0)
    x = x + sigma * (rng.normal(size=x.size)
                     + 1j * rng.normal(size=x.size)) / np.sqrt(2.0)
    return x.astype(np.complex64)


def trial(api, x: np.ndarray, lead: int, device: str) -> tuple:
    """(first track of CELL_ID in samples after the onset or None, the
    final rotation)."""
    fed, tracks = [0], []
    t = api.Trigger(psr_threshold=4, transport="f32", cfo_search_range=4,
                    device=device,
                    on_track=lambda c: tracks.append(
                        (fed[0] - t.backlog, c.cell_id)))
    for i in range(0, x.size, 19200):
        fed[0] += x[i:i + 19200].size
        t.process(x[i:i + 19200])
    t.flush()
    hits = [p for p, cid in tracks if cid == CELL_ID]
    return (hits[0] - lead if hits else None), int(t._cfo_bins[0])


def floor(api, synth, n: int, snrs, device: str, seed: int) -> list:
    """`--floor`: the probe statistic's quantiles, one JSON line a point."""
    import torch

    rng = np.random.default_rng(seed)
    frame = stream(synth, np.inf, 0.0, 0.04, seed)      # 4 frames, no noise
    width = 3 * 9600 + api.V2_WINDOW
    rows = []
    for snr in [None] + list(snrs):
        best, right = [], 0
        for _ in range(n):
            s = int(rng.integers(0, 19200))
            x = np.zeros(width) if snr is None else frame[s:s + width]
            sigma = 1.0 if snr is None else 10.0 ** (-snr / 20.0)
            x = x + sigma * (rng.normal(size=width)
                             + 1j * rng.normal(size=width)) / np.sqrt(2.0)
            wins = np.stack([x[k * 9600:k * 9600 + api.V2_WINDOW]
                             for k in range(4)])
            b, per_bin = api._best_bin(
                tuple(torch.tensor(c, dtype=torch.float32, device=device)
                      for c in (wins.real, wins.imag)), 4)
            best.append(float(per_bin.max()))
            right += int(b) == 2
        q = np.percentile(best, [10, 50, 90, 99, 99.9])
        row = dict(snr_db=snr, draws=n, best_psr_q10_50_90_99_999=q.tolist(),
                   best_psr_max=max(best), right_bin=right / n)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--trials", type=int, default=8)
    p.add_argument("--snrs", default="-14,-12,-10,-8,-6")
    p.add_argument("--leads", default="0,0.2")
    p.add_argument("--seconds", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tree", default=None)
    p.add_argument("--floor", type=int, default=0)
    a = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.tree) if a.tree else
                    os.path.dirname(os.path.dirname(os.path.abspath(
                        __file__))))
    from ltetrigger_tpu_torch.ltecore import synth
    from ltetrigger_tpu_torch.models import api

    if a.floor:
        return floor(api, synth, a.floor, [float(v) for v in
                                           a.snrs.split(",")], a.device,
                     a.seed)
    rows = []
    for lead_s in (float(v) for v in a.leads.split(",")):
        lead = int(round(lead_s * RATE))
        for snr in (float(v) for v in a.snrs.split(",")):
            got = [trial(api, stream(synth, snr, lead_s, a.seconds,
                                     a.seed * 1000 + k), lead, a.device)
                   for k in range(a.trials)]
            delays = [d / RATE for d, _ in got if d is not None]
            row = dict(lead_s=lead_s, snr_db=snr, detected=len(delays),
                       trials=a.trials,
                       mean_delay_s=(float(np.mean(delays)) if delays
                                     else None),
                       rotations=[b for _, b in got])
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
