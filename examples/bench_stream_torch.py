#!/usr/bin/env python
"""Streaming diagnosis of the PyTorch port: the wall clock of
`Trigger.process` by stage.

The port's counterpart of examples/bench_stream.py, with its arguments, the
STREAM_PASSES variable and its JSON keys.  The stream (cell 123, 6 PRB, 1.92
Msps, unit power, from the port's `ltecore.synth`; `--capture PATH` reads a
complex64 capture instead) is fed in `chunk_halfframes`-half-frame chunks
(the live-SDR shape), `STREAM_PASSES` times on one trigger (the first pass
pays the first use of the card), flushed after every pass.  Each pass
prints the StageTimer split (prep = host buffer work and the upload, scan =
the dispatch, drain = the device-to-host copy of the events); the last line
per transport says whether cell 123 was found (`detections_ok`).

    python examples/bench_stream_torch.py [seconds] [chunk_halfframes] \\
        [transports] [--multi N] [--device cuda] [--capture PATH]

--multi N: N concurrent streams through ONE MultiTrigger (every stream gets
the same signal; chunks fed to all streams together).  Reports the total
and per-stream samples/s: per stream >= 1.92e6 means every stream keeps up
with a live source.  `--device` defaults to cuda and raises where there is
no card.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from bench_sweep_torch import CELL_ID, fence, frame_iq  # noqa: E402
from ltetrigger_tpu_torch.ltecore.constants import (HALF_FRAME_LENGTH,  # noqa: E402
                                                    SAMPLE_RATE)
from ltetrigger_tpu_torch.models.api import Trigger  # noqa: E402
from ltetrigger_tpu_torch.models.multi import MultiTrigger  # noqa: E402
from ltetrigger_tpu_torch.ops.device import resolve_device  # noqa: E402


def _signal(seconds: float, iq: np.ndarray) -> np.ndarray:
    total = int(seconds * SAMPLE_RATE)
    return np.tile(iq, -(-total // iq.size))[:total]


def multi_main(n_streams: int, seconds: float, chunk_hf: int, transports,
               passes: int, device="cuda", iq=None) -> list:
    """One MultiTrigger of `n_streams` per transport; returns the summary
    record of each."""
    dev = resolve_device(device)
    sig = _signal(seconds, frame_iq() if iq is None else iq)
    total, chunk = sig.size, chunk_hf * HALF_FRAME_LENGTH
    out = []
    for transport in transports:
        trg = MultiTrigger(n_streams, psr_threshold=4.0, transport=transport,
                           device=dev)
        best = 0.0
        for p in range(passes):
            trg.timer.reset()
            t0 = time.perf_counter()
            fed = 0
            for i in range(0, total, chunk):
                trg.process_all([sig[i:i + chunk]] * n_streams)
                fed += min(chunk, total - i) * n_streams
            trg.flush()
            fence(dev)
            dt = time.perf_counter() - t0
            best = max(best, fed / dt)
            print(json.dumps({
                "streams": n_streams, "transport": transport, "pass": p,
                "sps_total": fed / dt, "sps_per_stream": fed / dt / n_streams,
                "wall_s": dt, "stages": trg.timer.summary()}), flush=True)
        ok = all(st.latest_cell() is not None
                 and st.latest_cell().cell_id == CELL_ID for st in trg.stores)
        rec = {"streams": n_streams, "transport": transport,
               "best_sps_total": best, "best_sps_per_stream": best / n_streams,
               "realtime_per_stream": best / n_streams / SAMPLE_RATE,
               "detections_ok": ok}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def single_main(seconds: float, chunk_hf: int, transports, passes: int,
                device="cuda", iq=None) -> list:
    """One Trigger per transport; returns the summary record of each."""
    dev = resolve_device(device)
    sig = _signal(seconds, frame_iq() if iq is None else iq)
    total, chunk = sig.size, chunk_hf * HALF_FRAME_LENGTH
    out = []
    for transport in transports:
        trg = Trigger(psr_threshold=4.0, transport=transport, device=dev)
        best = 0.0
        for p in range(passes):
            trg.timer.reset()
            t0 = time.perf_counter()
            fed = 0
            for i in range(0, total, chunk):
                trg.process(sig[i:i + chunk])
                fed += min(chunk, total - i)
            trg.flush()
            fence(dev)
            dt = time.perf_counter() - t0
            best = max(best, fed / dt)
            print(json.dumps({
                "transport": transport, "pass": p, "sps": fed / dt,
                "wall_s": dt, "stages": trg.timer.summary()}), flush=True)
        ok = any(c.cell_id == CELL_ID for c in trg.cellstore.cells())
        rec = {"transport": transport, "best_sps": best, "detections_ok": ok}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("seconds", type=float, nargs="?", default=0.5)
    p.add_argument("chunk_halfframes", type=int, nargs="?", default=4)
    p.add_argument("transports", nargs="?", default="f32,i16,i8")
    p.add_argument("--multi", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--capture", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    torch.ones(8, device=dev).sum().item()          # the first device sync
    passes = int(os.environ.get("STREAM_PASSES", "5"))
    transports = args.transports.split(",")
    iq = frame_iq(args.capture)
    if args.multi is not None:
        return multi_main(args.multi, args.seconds, args.chunk_halfframes,
                          transports, passes, dev, iq)
    return single_main(args.seconds, args.chunk_halfframes, transports,
                       passes, dev, iq)


if __name__ == "__main__":
    main()
