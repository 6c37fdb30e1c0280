#!/usr/bin/env python
"""Wideband LTE scan: find every cell in a wide capture in one device pass.

The PyTorch port of ltetrigger_tpu/apps/wideband_scan.py, with the same
records and flags, plus `--device` (default cuda): channelize the capture to
a grid of candidate centres, then run the full trigger pipeline over all
channels at once (`scan_band`), and build a record a centre from the
scan's output (`scan_records`).

CLI:
    python -m ltetrigger_tpu_torch.apps.wideband_scan capture.iq -s 30.72M \\
        --centers -10M,0,10M [--seconds 0.5] [--threshold 4] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..ltecore.constants import (DEFAULT_TRACK_AFTER, DEFAULT_TRACK_EVERY,
                                 SAMPLE_RATE)


def scan_band(iq: np.ndarray, sample_rate: float, centers,
              seconds: float = 0.5, psr_threshold: float = 4.0,
              track_after: int = DEFAULT_TRACK_AFTER,
              track_every: int = DEFAULT_TRACK_EVERY, device="cuda",
              mesh=None):
    """Channelize a wide capture to `centers` and scan every channel at
    once: -> (lanes, states, host).

    iq: complex64 numpy capture at `sample_rate` (an integer multiple of
    1.92 Msps), uploaded to `device` ("cuda" by default; raises if CUDA is
    absent) and looped if shorter than `seconds`.  lanes: the channelized
    pair of [C, N // ratio] float32 at 1.92 Msps; states: the final
    TriggerState [C, ...]; host: the scan's StepOutput read back to numpy,
    [steps, C, R] each.  With a `parallel.Mesh` every rank calls it with the
    same capture, channelizes on `mesh.device` and scans its share of the
    centres (`channel_scan(mesh=)`); states and host are global.  One call
    of the spans (`utils.profiling.call`): the channelizer's, the scan's
    and the readback's spans carry its id."""
    import torch

    from ..models import api, trigger as trig
    from ..ops import channelize as chan
    from ..parallel import channel_scan
    from ..utils import profiling

    dev = api.resolve_device(device if mesh is None else mesh.device)
    total = int(seconds * SAMPLE_RATE)
    need_wide = int(seconds * sample_rate)
    if iq.size < need_wide:
        reps = -(-need_wide // iq.size)
        iq = np.tile(iq, reps)[:need_wide]

    with profiling.call():
        lanes = chan.channelize(iq, sample_rate, list(centers),
                                device=dev)               # [C, Nd]
        buffers = tuple(torch.nn.functional.pad(
            comp[:, :total], (trig.LOOKBACK, trig.WINDOW)) for comp in lanes)
        n_steps = total // trig.HALF_FRAME_LENGTH
        states, out = channel_scan(buffers, n_steps,
                                   api.ensure_safe_threshold(psr_threshold),
                                   mesh=mesh, track_after=track_after,
                                   track_every=track_every)
        del buffers
        # every field to the host once, in one copy: [steps, C, R] each
        host = trig.unpack_output(trig.pack_output(out))
    return lanes, states, host


def scan_records(host, centers) -> list[dict]:
    """The records of a scan's host output (`scan_band`'s third part): one
    {center_offset_hz, detected, cell fields...} a centre, from its first
    publication."""
    from ..runtime.cellstore import PHICH_RES_STR

    results = []
    for ci, off in enumerate(centers):
        ev = host.track_event[:, ci, :]
        rec = {"center_offset_hz": float(off), "detected": bool(ev.any())}
        if rec["detected"]:
            s, r = np.argwhere(ev)[0]
            rec.update({
                "cell_id": int(host.cell_id[s, ci, r]),
                "nof_prb": int(host.nof_prb[s, ci, r]),
                "nof_tx_ports": int(host.nof_ports[s, ci, r]),
                "cp_len": "Normal" if host.normal_cp[s, ci, r]
                          else "Extended",
                "phich_len": "Extended" if host.phich_ext[s, ci, r]
                             else "Normal",
                "nof_phich_resources":
                    PHICH_RES_STR[int(host.phich_res[s, ci, r])],
                "psr": float(host.psr[s, ci, r]),
            })
        results.append(rec)
    return results


def wideband_scan(iq: np.ndarray, sample_rate: float, center_offsets_hz,
                  seconds: float = 0.5, psr_threshold: float = 4.0,
                  device="cuda", mesh=None) -> list[dict]:
    """-> list of {center_offset_hz, detected, cell fields...} per channel:
    `scan_band`, then `scan_records`.  Runs on `device` ("cuda" by default;
    raises if CUDA is absent).  With a `parallel.Mesh` every rank calls it
    with the same capture, channelizes on `mesh.device`, scans its share of
    the centres (`channel_scan(mesh=)`) and returns every centre's record."""
    centers = list(center_offsets_hz)
    _, _, host = scan_band(iq, sample_rate, centers, seconds=seconds,
                           psr_threshold=psr_threshold, device=device,
                           mesh=mesh)
    return scan_records(host, centers)


def _centers(spec: str):
    from ..utils.eng_notation import str_to_num
    return [str_to_num(tok) for tok in spec.split(",") if tok.strip()]


def main(argv=None) -> int:
    from .cell_search_file import eng_float, filetype

    p = argparse.ArgumentParser(prog="wideband_scan")
    p.add_argument("filename", type=filetype)
    p.add_argument("-s", "--sample-rate", type=eng_float, required=True)
    p.add_argument("--centers", type=_centers, required=True,
                   help="comma-separated offsets from capture center, "
                        "eng notation (e.g. -10M,0,10M)")
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--threshold", type=eng_float, default=4)
    p.add_argument("--device", default="cuda",
                   help="torch device to scan on [default=%(default)s]")
    args = p.parse_args(argv)

    iq = np.fromfile(args.filename, dtype=np.complex64)
    out = wideband_scan(iq, args.sample_rate, args.centers,
                        seconds=args.seconds, psr_threshold=args.threshold,
                        device=args.device)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
