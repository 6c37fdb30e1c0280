"""The control of the live band monitor's check: the cell's timed path run
with the wide stream rounded to bf16 before the channelizer (the precision
below the float32 that the configuration states for it), held to the same
comparison as the program (`drivers/wideband.check`; the reference reads
the stream as made).  Its `correct` has to come out false; the smallest
reading of each number over three seeds or more is the upper reading its
limit is set under.  It needs the program and, at the cell's size, a card.

    python3 ltebench/control_wideband.py --workload band12_live_cfo1k5
                                         --seeds 1,2,3 [--seconds 4]

Prints one JSON line a seed (`correct` and every check) and a last line
with the smallest `chan_rel_err` and `psr_rel_gap`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(workload: str, seed: int, seconds: float, device,
                    overrides: dict | None = None) -> dict:
    """The control's run of the cell for one seed: correct and the checks'
    values."""
    from ltebench import run

    r = run.run_cell(run.load_benchmark(), workload, seed, seconds, False,
                     device=device, overrides=overrides,
                     fault="bf16_stream")
    return dict(seed=seed, correct=r["correct"],
                **{k: c["value"] for k, c in r["checks"].items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="band12_live_cfo1k5")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    from ltebench import run
    run.set_cache_dirs()
    rows = [control_numbers(args.workload, int(s), args.seconds, args.device)
            for s in args.seeds.split(",")]
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"chan_rel_err": min(r["chan_rel_err"] for r in rows),
                      "psr_rel_gap": min(r["psr_rel_gap"] for r in rows),
                      "correct": any(r["correct"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
