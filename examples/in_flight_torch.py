#!/usr/bin/env python
"""How often a streaming call returns with a dispatch still in flight.

`process()` pumps every dispatch its samples allow and harvests every
output that has arrived before it returns.  An output still in flight when
it returns is what a `backlog` gate between calls can wait for (the paced
monitors of chip_smoke.py, phases 9d and 20 (b)): `backlog` counts the
samples of a dispatch in flight until its output is harvested.

The tool feeds `--seconds` of a synthetic cell (cell 125, 50 PRB field,
1.92 Msps, weak noise) through a `Trigger` (i8, pipeline=2) in 38400- and
in 307200-sample calls, and 8 such streams (other cells) through a
`MultiTrigger(8)` (i4, pipeline=2) in 38400-sample calls, as fast as it
can, and counts the calls that returned with an output in flight, with the
backlog after each call.  It does so first in this process alone, then in
`--procs` processes started together on the same card, which they share
as the ranks of chip_smoke.py phase 20 do.

    python examples/in_flight_torch.py [--device cuda] [--procs 4] \\
        [--seconds 4]

Prints one JSON line per process ("alone", then "shared r/N"), with the
device's name.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from ltetrigger_tpu_torch.ltecore import synth  # noqa: E402
from ltetrigger_tpu_torch.models import api  # noqa: E402
from ltetrigger_tpu_torch.models.multi import MultiTrigger  # noqa: E402
from ltetrigger_tpu_torch.ops.device import resolve_device  # noqa: E402

CELLS8 = ((10, 6), (41, 15), (72, 25), (103, 50), (134, 75), (165, 100),
          (196, 25), (227, 50))


def stream(cell_id: int, prb: int, seconds: float, seed: int) -> np.ndarray:
    x = np.tile(synth.synthesize_frame(cell_id, nof_prb_field=prb),
                int(round(seconds * 100)))
    rng = np.random.default_rng(seed)
    x = x + 0.05 * (rng.normal(size=x.size) + 1j * rng.normal(size=x.size))
    return x.astype(np.complex64)


def count(t, calls) -> dict:
    """Every call of `calls` through the trigger `t`, then flush(): the
    calls, those that returned with an output in flight, and the largest
    stream's backlog after each call (median, max; samples)."""
    in_flight, backlog = 0, []
    for call in calls:
        call()
        in_flight += bool(t._outstanding)
        backlog.append(int(np.max(t.backlog)))
    t.flush()
    return {"calls": len(backlog), "in_flight": in_flight,
            "backlog_median": float(np.median(backlog)),
            "backlog_max": max(backlog)}


def measure(device, seconds: float) -> dict:
    out = {}
    one = stream(125, 50, seconds, seed=3)
    for chunk in (38400, 307200):
        t = api.Trigger(psr_threshold=4, transport="i8", pipeline=2,
                        device=device)
        out[f"Trigger {chunk}"] = count(t, [
            lambda i=i: t.process(one[i:i + chunk])
            for i in range(0, one.size - chunk + 1, chunk)])
    sigs = np.stack([stream(cid, prb, seconds, seed=20 + k)
                     for k, (cid, prb) in enumerate(CELLS8)])
    m = MultiTrigger(len(CELLS8), psr_threshold=4, transport="i4",
                     pipeline=2, device=device)
    out["MultiTrigger(8) 38400"] = count(m, [
        lambda i=i: m.process_all(list(sigs[:, i:i + 38400]))
        for i in range(0, sigs.shape[1] - 38400 + 1, 38400)])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--procs", type=int, default=4,
                    help="processes that share the card after the run "
                         "alone (0: none)")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--role", default="alone", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)       # a card asked for and absent
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"process": args.role, "device": name,
                      **measure(dev, args.seconds)}), flush=True)
    if args.role != "alone" or not args.procs:
        return
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--device", args.device, "--seconds",
         str(args.seconds), "--procs", "0", "--role",
         f"shared {r}/{args.procs}"]) for r in range(args.procs)]
    codes = [p.wait(timeout=900) for p in procs]
    if any(codes):
        raise SystemExit(f"the sharing processes exited with {codes}")


if __name__ == "__main__":
    main()
