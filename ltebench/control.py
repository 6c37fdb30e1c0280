"""The control of a cell's check: the plain reference put in the program's
place, computed one precision below what the configuration states for pass
A (`--precision`, fp8 e4m3 for bf16), and held to the same comparison as
the program (`reference.check`).  Its numbers have to come out as not
correct; the smallest of them over three seeds or more is the upper reading
a limit is set under.  It needs no program and no window.

    python3 ltebench/control.py --workload scan512_cfo1k5 --seeds 1,2,3
                                [--precision fp8_e4m3]

Pool batch 0 of each seed, at the cell's size.  Prints one JSON line a
seed and a last line with the smallest reading of each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(workload: str, seed: int, precision: str, device,
                    overrides: dict | None = None) -> dict:
    """psr_rel_gap and state_mismatch of the control against the
    reference, for one seed."""
    import torch

    from ltebench import run
    from ltebench.gen import traffic as gen
    from ltebench.gen.cells import LOOKBACK
    from ltebench.reference import check, passab

    bench = run.load_benchmark()
    _, cfg, mix = run.resolve(bench, workload)
    for part, extra in (overrides or {}).items():
        {"config": cfg, "traffic": mix}[part].update(extra)
    thr = float(cfg["psr_threshold"])
    ta, te = int(cfg["track_after"]), int(cfg["track_every"])
    stated = cfg["precision"]["pass_a"]
    rng = gen.rng_for(seed)
    c, steps = int(cfg["channels"]), int(cfg["steps"])
    cells = gen.draw_cells(mix, rng, c)
    re, im = gen.capture_batch(cells, steps * 9600, seed, device, 0)
    powers = [passab.correlation_power(re, im, LOOKBACK, steps, p)
              for p in (stated, precision)]
    at = [lambda t, p=p: p[:, t] for p in powers]
    lanes, k = (c,), steps
    ctl = passab.pass_b(at[1], k, lanes, device, thr, ta, te)
    ref = passab.pass_b(at[0], k, lanes, device, thr, ta, te,
                        port_over=ctl["score"] > 0, tie_rel=0.0)
    gap, mism = check.pass_ab_numbers(ctl["psr"].cpu().numpy(),
                                      ctl["score"].cpu().numpy(),
                                      ctl["tracking"].cpu().numpy(), ref)
    return {"seed": seed, "psr_rel_gap": gap, "state_mismatch": mism}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", default="fp8_e4m3")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    import torch
    rows = [control_numbers(args.workload, int(s), args.precision,
                            torch.device(args.device))
            for s in args.seeds.split(",")]
    for r in rows:
        print(json.dumps(r))
    print(json.dumps({k: min(r[k] for r in rows)
                      for k in ("psr_rel_gap", "state_mismatch")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
