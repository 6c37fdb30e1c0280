#!/usr/bin/env python3
"""Pass C's two device loops end to end, tree against tree, on one card.

For each tree named, in the order named (a tree named twice runs twice):

  * the decoding C=128 x 100 dispatch of chip_smoke.py phase 5
    (`scan_engine` on its 128-channel buffer, every channel carrying a
    cell): ms best of 5 (host clock around synchronised calls) and the host
    waits by name;
  * a 2-s `wideband_scan` of chip_smoke.py phase 11b's band (30.72 Msps,
    cells 101 / 202 / 303 at three of 16 centres; one dispatch of 16
    channels x 400 steps): wall ms best of 3, and the centres detected;
    then its two parts alone, best of 3 each: the channelizer from the
    host capture (upload included) and `channel_scan` of its 16 rows.

Then, last because torch.profiler may slow what follows in the process,
each tree's device kernels and copies (and device ms) for one call of
each, under torch.profiler.

    python3 examples/pass_c_loops_torch.py --tree DIR [--tree DIR ...]

e.g. `--tree .parent_tree --tree . --tree . --tree .parent_tree` after
`git archive <commit> ltetrigger_tpu_torch | tar -x -C .parent_tree`.  Each
tree's ltetrigger_tpu_torch is copied into a temporary directory and
imported there as a package of its own (tree<i>_ltetrigger_tpu_torch), so
its own engine runs and its own build.py builds its own csrc; the inputs
are made once, with the first tree's modules.  Prints one JSON line a run
and a profiler line a tree, then the card's name and power limit.  Needs a
CUDA card (exits 2 without one).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402  (its buffer and band builders)

RATE16 = 30.72e6
CENTERS16 = [(k - 7.5) * 1.92e6 for k in range(16)]
PLANTED = {2: (101, 25), 7: (202, 50), 13: (303, 100)}


def load_tree(tree: pathlib.Path, i: int, tmp: pathlib.Path) -> dict:
    """tree/ltetrigger_tpu_torch imported from a copy in `tmp` as
    tree<i>_ltetrigger_tpu_torch, its kernels built: its modules."""
    name = f"tree{i}_ltetrigger_tpu_torch"
    pkg = tmp / name
    shutil.copytree(tree / "ltetrigger_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    mods = {m: importlib.import_module(f"{name}.{m}") for m in
            ("models.trigger", "apps.wideband_scan", "ltecore.synth",
             "ops.kernels.build", "ops.channelize", "parallel")}
    t0 = time.perf_counter()
    mods["ops.kernels.build"].library()
    mods["build_s"] = time.perf_counter() - t0
    return mods


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    type=pathlib.Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pass_c_loops_torch: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="pass_c_trees_"))
    trees = {}
    for t in args.tree:
        key = str(t.resolve())
        if key not in trees:
            trees[key] = load_tree(t.resolve(), len(trees), tmp)
    first = next(iter(trees.values()))
    trig0, synth = first["models.trigger"], first["ltecore.synth"]
    big, _ = smoke.big_buffer(dev, synth, trig0)
    band2 = smoke.make_band(dev, synth, RATE16,
                            [(CENTERS16[k], cid, prb, 0.0)
                             for k, (cid, prb) in PLANTED.items()],
                            2.0, seed=53)

    def calls(mods):
        trig, wscan = mods["models.trigger"], mods["apps.wideband_scan"]

        def dispatch():
            return trig.scan_engine(
                big, trig.init_state(batch=(smoke.C_BIG,), device=dev),
                smoke.STEPS_BIG, 4.0)

        def scan2():
            return wscan.wideband_scan(band2, RATE16, CENTERS16,
                                       seconds=2.0, device="cuda")
        return trig, dispatch, scan2

    def timed(fn, reps):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return ts, res

    for run, t in enumerate(args.tree):
        mods = trees[str(t.resolve())]
        trig, dispatch, scan2 = calls(mods)
        dispatch()
        scan2()                                           # warm-ups
        trig.host_syncs.clear()
        d_ms, _ = timed(dispatch, 5)
        syncs = {k: v // 5 for k, v in trig.host_syncs.items()}
        s_ms, recs = timed(scan2, 3)
        detected = {k: r["cell_id"] for k, r in enumerate(recs)
                    if r["detected"]}
        assert detected == {k: c for k, (c, _) in PLANTED.items()}, detected
        # the scan's two parts, as wideband_scan runs them
        c_ms, chans = timed(lambda: mods["ops.channelize"].channelize(
            band2, RATE16, CENTERS16, device=dev), 3)
        n2 = int(2.0 * 1.92e6)
        rows = tuple(torch.nn.functional.pad(
            comp[:, :n2], (trig.LOOKBACK, trig.WINDOW)) for comp in chans)
        del chans
        p_ms, _ = timed(lambda: mods["parallel"].channel_scan(
            rows, n2 // trig.HALF_FRAME_LENGTH, 4.0), 3)
        del rows
        print(json.dumps({
            "tree": str(t), "run": run, "build_s": mods["build_s"],
            "dispatch_ms": d_ms, "dispatch_best_ms": min(d_ms),
            "dispatch_host_syncs": syncs, "scan2_wall_ms": s_ms,
            "scan2_best_ms": min(s_ms), "scan2_detected": detected,
            "scan2_channelize_ms": c_ms, "scan2_channel_scan_ms": p_ms,
            "card": smi}), flush=True)

    for key, mods in trees.items():
        _, dispatch, scan2 = calls(mods)
        d_ev, d_dev = smoke.device_events(dispatch)
        s_ev, s_dev = smoke.device_events(scan2)
        print(json.dumps({
            "tree": key, "dispatch_device_events": d_ev,
            "dispatch_device_ms": d_dev, "scan2_device_events": s_ev,
            "scan2_device_ms": s_dev, "card": smi}), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
