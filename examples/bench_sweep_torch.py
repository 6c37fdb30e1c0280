#!/usr/bin/env python
"""Channel-count sweep of one `channel_scan` dispatch, on the PyTorch port.

The port's counterpart of examples/bench_sweep.py: the same protocol (the
buffer resident on the device, n_steps half-frame steps a dispatch, every
timed call fenced by a device synchronize, detections checked in the run),
at several channel counts in one process, one JSON line per operating point
and a final summary line, with the same keys.  `compile_s` is the first
call's seconds (the port compiles nothing ahead; the first call pays the
kernel's build, the allocator and cuBLAS's first use).

The stream is cell 123 (6 PRB, 1.92 Msps, unit power) from the port's own
`ltecore.synth`, looped; `--capture PATH` reads a complex64 capture of that
cell instead.  That is the one difference from the JAX tool, which reads the
capture.

    python examples/bench_sweep_torch.py [C ...] [--device cuda] \\
        [--capture PATH]          (default C: 32 64 128 256 512 1024)

Env: SWEEP_STEPS (100), SWEEP_ITERS (3), SWEEP_SECONDS (0.55).  `--device`
defaults to cuda and raises where there is no card.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ltetrigger_tpu_torch.ltecore import synth  # noqa: E402
from ltetrigger_tpu_torch.ltecore.constants import (HALF_FRAME_LENGTH,  # noqa: E402
                                                    SAMPLE_RATE)
from ltetrigger_tpu_torch.models import trigger as trig  # noqa: E402
from ltetrigger_tpu_torch.ops.device import resolve_device  # noqa: E402
from ltetrigger_tpu_torch.parallel import channel_scan  # noqa: E402

CELL_ID = 123


def frame_iq(capture: str | None = None) -> np.ndarray:
    """The stream the example tools loop: the 6-PRB cell-123 frame at 1.92
    Msps from `ltecore.synth`, or the complex64 file `capture`; scaled to
    unit power as the JAX tools scale the capture."""
    if capture:
        iq = np.fromfile(capture, dtype=np.complex64)
    else:
        iq = synth.synthesize_frame(CELL_ID, nof_prb_field=6)
    return (iq / np.sqrt(np.mean(np.abs(iq) ** 2))).astype(np.complex64)


def fence(dev: torch.device) -> None:
    """Wait for the device's queued work (the timing fence)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def make_buffer(channels: int, seconds: float, device,
                iq: np.ndarray | None = None):
    """[C, LOOKBACK + seconds * 1.92e6 + WINDOW] pair on `device`: one padded
    row of the looped stream is built there and copied to every channel on
    the device (the host uploads one frame, never C rows)."""
    dev = resolve_device(device)
    iq = frame_iq() if iq is None else iq
    total = int(seconds * SAMPLE_RATE)
    out = []
    for part in (iq.real, iq.imag):
        one = torch.from_numpy(np.ascontiguousarray(part, np.float32)).to(dev)
        row = one.repeat(-(-total // one.shape[0]))[:total]
        row = torch.nn.functional.pad(row, (trig.LOOKBACK, trig.WINDOW))
        out.append(row.expand(channels, -1).contiguous())
    return tuple(out)


def run_point(channels: int, n_steps: int, seconds: float, iters: int,
              device="cuda", iq: np.ndarray | None = None) -> dict:
    """One operating point: the first call, then the best of `iters`
    fenced `channel_scan` calls; prints and returns the record."""
    dev = resolve_device(device)
    buf = make_buffer(channels, seconds, dev, iq)
    fence(dev)
    t0 = time.perf_counter()
    channel_scan(buf, n_steps, 4.0)
    fence(dev)
    first_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        _, out = channel_scan(buf, n_steps, 4.0)
        fence(dev)
        best = min(best, time.perf_counter() - t0)
    tracked = out.track_event.cpu().numpy()
    cids = out.cell_id.cpu().numpy()
    ok = bool(tracked.any()) and bool((cids[tracked] == CELL_ID).all())
    sps = channels * n_steps * HALF_FRAME_LENGTH / best
    rec = {"channels": channels, "n_steps": n_steps,
           "ms_per_dispatch": best * 1e3,
           "ms_per_step": best * 1e3 / n_steps,
           "sps": sps, "msps": sps / 1e6,
           "compile_s": first_s, "detections_ok": ok}
    print(json.dumps(rec), flush=True)
    del buf, out
    return rec


def capped(channels: int, seconds: float, n_steps: int) -> tuple:
    """(seconds, steps) of a point: the buffer is kept under ~6 GB,
    C * (seconds * 1.92e6 + 13.5k) * 8 bytes, by halving the seconds."""
    sec = seconds
    while channels * (sec * SAMPLE_RATE + 13500) * 8 > 6e9 and sec > 0.15:
        sec = round(sec / 2, 3)
    steps = min(n_steps, max(10, int(sec * SAMPLE_RATE) // HALF_FRAME_LENGTH))
    return sec, steps


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("channels", type=int, nargs="*",
                   default=[32, 64, 128, 256, 512, 1024])
    p.add_argument("--device", default="cuda")
    p.add_argument("--capture", default=None,
                   help="complex64 capture of cell 123 at 1.92 Msps "
                        "[default: the synthetic frame]")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    n_steps = int(os.environ.get("SWEEP_STEPS", "100"))
    iters = int(os.environ.get("SWEEP_ITERS", "3"))
    seconds = float(os.environ.get("SWEEP_SECONDS", "0.55"))
    iq = frame_iq(args.capture)
    t0 = time.perf_counter()
    torch.ones(8, device=dev).sum().item()          # the first device sync
    print(json.dumps({"first_d2h_stall_s": time.perf_counter() - t0,
                      "device": device_name(dev)}), flush=True)
    results = []
    for c in args.channels:
        sec, steps = capped(c, seconds, n_steps)
        results.append(run_point(c, steps, sec, iters, dev, iq))
    best = max(results, key=lambda r: r["sps"])
    print(json.dumps({"best": best}), flush=True)
    return results


if __name__ == "__main__":
    main()
