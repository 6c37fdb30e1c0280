"""The control of the monitor cells' check: the cell's timed path run with
the streams carried to the card in a lower precision than the f32 the
configuration states, the i8 transport (each stream's new samples scaled
to its peak and rounded to 8-bit integers, ~36 dB), and held to the same
comparison as the program (`drivers/monitor.check`; the reference reads
the loops as made).  Its `correct` has to come out false, by
`psr_rel_gap` over its limit at least; the smallest `psr_rel_gap` over
three seeds or more is the upper reading the limit is set under.  It needs
the program and, at the cell's size, a card.

    python3 ltebench/control_monitor.py --workload monitor8_replay
                                        --seeds 1,2,3 [--seconds 4]

Prints one JSON line a seed (`correct` and every check) and a last line
with the smallest `psr_rel_gap`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSPORT = "i8"


def control_numbers(workload: str, seed: int, seconds: float, device,
                    overrides: dict | None = None) -> dict:
    """The control's run of the cell for one seed: correct and the checks'
    values."""
    from ltebench import run

    over = {k: dict(v) for k, v in (overrides or {}).items()}
    over.setdefault("config", {})["transport"] = TRANSPORT
    r = run.run_cell(run.load_benchmark(), workload, seed, seconds, False,
                     device=device, overrides=over)
    return dict(seed=seed, correct=r["correct"],
                **{k: c["value"] for k, c in r["checks"].items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="monitor8_replay")
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
        print(json.dumps(r))
    print(json.dumps({"psr_rel_gap": min(r["psr_rel_gap"] for r in rows),
                      "correct": any(r["correct"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
