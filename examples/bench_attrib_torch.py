#!/usr/bin/env python
"""The attribution tool for the PyTorch port's grid engine: the port's
counterpart of examples/bench_attrib.py, with its five subcommands, flags
and JSON keys.

Every timed region is fenced by a device synchronize; the buffer and the
inputs are resident on the device; a warm-up call comes first; best of N.
Each record also carries `device_ms`: CUDA events recorded just before the
region's first operation and after its last, over the same best call, i.e.
the span the card spent from the region's first kernel to its last (it
equals the host's ms where the host's launches are the bottleneck and is
shorter where the host waited for the card).  On the CPU it is null.  A
`passes` rung also carries `launches_by_kernel`: every hand kernel's
launches ("mf", "pb", "tti", "vit", "ring", "chan"; "front" counts pass
C's front-end calls) over the rung's calls, warm-up included (all 0 on the
CPU, where the plain versions run).

Subcommands:
  passes  [--channels C] [--steps S]
      The pass ladder of one dispatch: pass A alone (`_group_power` over the
      groups), passes A+B (`scan_pass` with the grid start as a host
      integer), A+B+C without the decode and with it (`_mib_postpass` with
      `do_decode` False / True).  The differences localise the cost.
  sweep   [--channel-list 128,512,1024] [--steps S]
      `passes` over a channel list.
  groups  [--channels C] [--budgets 2048,4096,8192,16384] [--steps S]
      GROUP_BUDGET sensitivity: `passes` in a subprocess per budget with
      LTETRIGGER_GROUP_BUDGET set.
  decode  [--channels C]
      Pass C's decode stages at the engine's shapes (C x K_CANDIDATES x R
      candidates): the PBCH front end under both CPs, the codeword search
      (Viterbi + CRC + unpack), the raw wrap-around Viterbi (on a card its
      hand-written kernel, as the engine runs it).
  micro   [--channels C] [--steps S]
      Pass C's small stages: slot-0 segment reads at random and at the
      engine's starts (`trigger._read`), the CFO rotation, the ring
      recurrence (`ring_scan`, where the JAX tool's row times its closed
      form `ring_series`).  The JAX tool's `extract_taa` / `extract_dense`
      rows time TPU workarounds the port does not have (its extraction is
      plain indexing), so they are left out.

Every subcommand takes `--device` (default cuda; raises where there is no
card) and `--capture PATH` (a complex64 capture of cell 123 at 1.92 Msps;
the default is the port's synthetic frame of that cell).

    python examples/bench_attrib_torch.py passes --channels 128
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from bench_sweep_torch import fence, frame_iq, make_buffer  # noqa: E402
from ltetrigger_tpu_torch.models import trigger as trig  # noqa: E402
from ltetrigger_tpu_torch.ops.device import resolve_device  # noqa: E402
from ltetrigger_tpu_torch.ops.kernels import launch_counts  # noqa: E402

R = trig.R


def timeit(fn, dev: torch.device, iters: int = 3) -> tuple:
    """(best host seconds, device ms of that call or None, the last call's
    result) over `iters` fenced calls of `fn` after one warm-up call."""
    fn()
    fence(dev)
    cuda = dev.type == "cuda"
    best, best_dev = float("inf"), None
    for _ in range(iters):
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        res = fn()
        if cuda:
            ev[1].record()
        fence(dev)
        t = time.perf_counter() - t0
        if t < best:
            best = t
            best_dev = ev[0].elapsed_time(ev[1]) if cuda else None
    return best, best_dev, res


def emit(**kw):
    print(json.dumps(kw), flush=True)


def _setup(args) -> torch.device:
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False   # as scan_engine sets it
    return dev


# ---------------------------------------------------------------- passes --
def cmd_passes(args) -> tuple:
    """The four rungs; returns (records, the ABC_decode rung's StepOutput)."""
    dev = _setup(args)
    C, S = args.channels, args.steps
    buf = make_buffer(C, 0.55, dev, frame_iq(args.capture))
    sts = trig.init_state(batch=(C,), device=dev)
    g = trig._pick_group(S, C)
    # the step and data bounds scan_engine gives a buffer by default
    n_valid = buf[0].shape[-1] + S * trig.HALF_FRAME_LENGTH + trig._PAD_TAIL
    emit(config={"channels": C, "steps": S, "group": g,
                 "group_budget": trig.GROUP_BUDGET})

    def pass_a():
        for gi in range(S // g):
            trig._group_power(buf, trig.LOOKBACK
                              + gi * g * trig.HALF_FRAME_LENGTH, g)

    def ab():
        return trig.scan_pass(buf, sts, S, 4.0, n_valid=n_valid,
                              grid0=trig.LOOKBACK)

    def full_fn(decode):
        def full():
            f, raw = ab()
            return trig._mib_postpass(sts, f, raw, buf, n_valid,
                                      do_decode=decode)
        return full

    rows = []
    for name, fn in [("pass_A_only", pass_a), ("passes_AB", ab),
                     ("ABC_nodecode", full_fn(False)),
                     ("ABC_decode", full_fn(True))]:
        n0 = launch_counts()
        t, dms, res = timeit(fn, dev)
        n = {k: v - n0[k] for k, v in launch_counts().items()}
        rec = dict(variant=name, ms_per_dispatch=t * 1e3,
                   ms_per_step=t * 1e3 / S,
                   msps=C * S * trig.HALF_FRAME_LENGTH / t / 1e6,
                   device_ms=dms, launches_by_kernel=n)
        emit(**rec)
        rows.append(rec)
    return rows, res[1]


def cmd_sweep(args) -> list:
    rows = []
    for c in args.channel_list:
        args.channels = c
        rows.append(cmd_passes(args)[0])
    return rows


def cmd_groups(args) -> list:
    """`passes` in a subprocess per budget; returns [(budget, the child's
    JSON records)].  A child that fails raises."""
    here = os.path.abspath(__file__)
    got = []
    for b in args.budgets:
        env = dict(os.environ, LTETRIGGER_GROUP_BUDGET=str(b))
        emit(group_budget=b)
        cmd = [sys.executable, here, "passes", "--channels",
               str(args.channels), "--steps", str(args.steps), "--device",
               args.device]
        if args.capture:
            cmd += ["--capture", args.capture]
        done = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              check=False)
        sys.stdout.write(done.stdout)
        sys.stdout.flush()
        if done.returncode != 0:
            raise RuntimeError(f"passes under budget {b} exited with "
                               f"{done.returncode}: {done.stderr[-2000:]}")
        got.append((b, [json.loads(x) for x in done.stdout.splitlines()]))
    return got


# ---------------------------------------------------------------- decode --
def cmd_decode(args) -> list:
    from ltetrigger_tpu_torch.ops import pbch
    from ltetrigger_tpu_torch.ops.kernels.viterbi import viterbi_decode_wa

    dev = _setup(args)
    C, K = args.channels, trig.K_CANDIDATES
    rng = np.random.default_rng(0)

    def on(a):
        return torch.from_numpy(a).to(dev)

    b = C * K * R
    slot1 = (on(rng.normal(size=(b, 960)).astype(np.float32)),
             on(rng.normal(size=(b, 960)).astype(np.float32)))
    cells = on(rng.integers(0, 504, size=(b,)).astype(np.int32))
    llrs = on(rng.normal(size=(b, 12, 120)).astype(np.float32))
    qof = (torch.arange(12, dtype=torch.int32, device=dev) % 4).repeat(b, 1)
    r = on(rng.normal(size=(b * 12, 40, 3)).astype(np.float32))
    rows = []
    for stage, batch, fn in (
            ("pbch_front_both_cp", b,
             lambda: pbch.quarter_llrs_both_cp(slot1, cells)),
            ("search_and_unpack", b,
             lambda: pbch.search_and_unpack(llrs, qof)),
            ("viterbi_wa", b * 12, lambda: viterbi_decode_wa(r))):
        t, dms, _ = timeit(fn, dev)
        rec = dict(stage=stage, batch=batch, ms=t * 1e3, device_ms=dms)
        emit(**rec)
        rows.append(rec)
    return rows


# ----------------------------------------------------------------- micro --
def cmd_micro(args) -> list:
    from ltetrigger_tpu_torch.ops import cfo as cfo_ops
    from ltetrigger_tpu_torch.ops.kernels import cfo_ring

    dev = _setup(args)
    C, S = args.channels, args.steps
    rng = np.random.default_rng(0)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def read(b, st):
        return tuple(trig._read(comp, st, trig.SEG, lead=1) for comp in b)

    n = 1_100_000
    buf = (on(rng.normal(size=(C, n)).astype(np.float32)),
           on(rng.normal(size=(C, n)).astype(np.float32)))
    starts = on(rng.integers(0, n - 2000, size=(S, C, R)).astype(np.int32))
    # the slot-0 reads at the engine's own geometry (clustered per-step
    # starts, not the uniform-random ones above)
    n_eng = trig.LOOKBACK + S * 9600 + trig.WINDOW
    ebuf = (on(rng.normal(size=(C, n_eng)).astype(np.float32)),
            on(rng.normal(size=(C, n_eng)).astype(np.float32)))
    peak = on(rng.integers(0, 9600, size=(S, C, R)).astype(np.int32))
    grid = trig.LOOKBACK + 9600 * torch.arange(S, dtype=torch.int32,
                                               device=dev)
    est_start = grid.reshape(S, 1, 1) + peak - trig.LOOKBACK + trig.SEG_OFF
    seg = (on(rng.normal(size=(S, C, R, trig.SEG)).astype(np.float32)),
           on(rng.normal(size=(S, C, R, trig.SEG)).astype(np.float32)))
    freq = on(rng.normal(size=(S, C, R)).astype(np.float32) * 0.01)
    est = on(rng.normal(size=(S, C, R)).astype(np.float32))
    push = on(rng.random((S, C, R)) < 0.5)
    lost = on(rng.random((S, C, R)) < 0.05)
    ring0 = torch.zeros((C, R, 200), device=dev)
    cnt0 = torch.zeros((C, R), dtype=torch.int32, device=dev)
    rows = []
    for op, fn in (
            ("gather_seg", lambda: read(buf, starts)),
            ("extract_gather", lambda: read(ebuf, est_start)),
            ("cfo_rotate", lambda: cfo_ops.cfo_rotate(seg, freq,
                                                      trig.SEG_OFF)),
            ("ring_scan", lambda: cfo_ring.ring_scan(ring0, cnt0, est,
                                                     push, lost))):
        t, dms, _ = timeit(fn, dev)
        rec = dict(op=op, ms=t * 1e3, device_ms=dms)
        emit(**rec)
        rows.append(rec)
    return rows


COMMANDS = {"passes": cmd_passes, "sweep": cmd_sweep, "groups": cmd_groups,
            "decode": cmd_decode, "micro": cmd_micro}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in COMMANDS:
        p = sub.add_parser(name)
        p.add_argument("--channels", type=int, default=128)
        p.add_argument("--steps", type=int, default=100)
        p.add_argument("--device", default="cuda")
        p.add_argument("--capture", default=None)
        if name == "sweep":
            p.add_argument("--channel-list", type=lambda s: [
                int(x) for x in s.split(",")], default=[128, 512, 1024])
        if name == "groups":
            p.add_argument("--budgets", type=lambda s: [
                int(x) for x in s.split(",")],
                default=[2048, 4096, 8192, 16384])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    dev = resolve_device(args.device)
    torch.ones(8, device=dev).sum().item()          # the first device sync
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    main()
