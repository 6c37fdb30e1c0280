#!/usr/bin/env python
"""Where a launch and a step of the pass-B kernel go, on the card.

The port's kernels are built with -DPB_STAMPS (`build.build`'s route, into
a temporary directory), so that thread 0 of block 0 (channel 0, root 0)
records %globaltimer at six points of every step and thread 0 of every
block at its entry, the end of its prologue, the end of its step loop and
the end of its carry-out.  One group of `--steps` half-frame steps runs
over `--batch` channels from a fresh state on seeded power: unit
exponential noise with a strong peak in every channel's root 0 for the
first `--strong` steps (acquisition, then tracking with track_after 4 and
track_every 3), noise after (loss).  The wrapper call is captured once in
a CUDA graph and replayed, so that the launch's device time (CUDA events)
holds no host work; the stamps are those of the last replay.

    python examples/pass_b_stamps_torch.py [--batch B] [--steps G]
        [--strong S] [--device cuda]

Prints one line a step of block 0, nanoseconds: for a searched step the
wait for its power and the pass over it, the block reduction and barrier 1,
the window and barrier 2, the lobe walk and psr, the hysteresis, then the
rest of the loop up to the next step; an unsearched step as one span.  The
last lines give the medians; block 0's loop from its first stamp to its
last; every block's prologue, step loop and carry-out (median and worst),
the spread of the blocks' entries, the kernel's span on the card (first
entry to last carry-out) against the replayed launch's device time, and
the card's name and power limit.  Needs a card and nvcc.
"""

import argparse
import ctypes
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from ltetrigger_tpu_torch.models import trigger as trig  # noqa: E402
from ltetrigger_tpu_torch.ops.device import resolve_device  # noqa: E402
from ltetrigger_tpu_torch.ops.kernels import build, pass_b  # noqa: E402

PHASES = ("wait+pass", "barrier 1", "window+barrier 2", "walk+psr",
          "hysteresis", "to next step")
STAMP_STEPS = 4096


STAMP_BLOCKS = 4096
BLOCK_SPANS = ("prologue", "step loop", "carry-out")


def stamped_library(out: pathlib.Path) -> ctypes.CDLL:
    """The port's kernels with -DPB_STAMPS, built into `out` and loaded."""
    path, _ = build.build(out_dir=out, extra_flags=("-DPB_STAMPS",))
    dll = ctypes.CDLL(str(path))
    dll.pb_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    dll.pb_read_stamps.restype = ctypes.c_int
    return dll


def seeded_power(batch: int, steps: int, strong: int, dev) -> torch.Tensor:
    """[batch, steps, 75, 3, 128] float32: noise, a peak with a short lobe
    at bin 4000 of root 0 during the first `strong` steps."""
    rng = np.random.default_rng(0)
    p = rng.exponential(size=(batch, steps, 3, 9600)).astype(np.float32)
    for d, v in enumerate((60.0, 36.0, 21.6, 13.0)):
        p[:, :strong, 0, 4000 - d] = v
        p[:, :strong, 0, 4000 + d] = v
    blk = p.reshape(batch, steps, 3, 75, 128).transpose(0, 1, 3, 2, 4)
    return torch.from_numpy(np.ascontiguousarray(blk)).to(dev)


def phases(stamps: np.ndarray, steps: int) -> list:
    """[(step, searched, [ns a phase])] from the [steps, 6] stamps."""
    rows = []
    for t in range(steps):
        s = stamps[t].astype(np.int64)
        nxt = int(stamps[t + 1, 0]) - int(s[5]) if t + 1 < steps else -1
        if s[1]:
            rows.append((t, True, [int(s[i + 1] - s[i]) for i in range(5)]
                         + [nxt]))
        else:
            rows.append((t, False, [int(s[5] - s[0]), nxt]))
    return rows


def block_spans(blocks: np.ndarray) -> dict:
    """The [n, 4] stamps of n blocks (entry, prologue done, loop done,
    carry-out done) as ns: each block's three spans [n, 3], the spread of
    the entries, and the kernel's span from the first entry to the last
    carry-out."""
    b = blocks.astype(np.int64)
    return dict(spans=np.diff(b, axis=1),
                entry_spread=int(b[:, 0].max() - b[:, 0].min()),
                span=int(b[:, 3].max() - b[:, 0].min()))


def replay(fn, iters: int = 10) -> float:
    """`fn` captured once in a CUDA graph (after two warm-ups on a side
    stream) and replayed `iters` times: mean device ms a replay (CUDA
    events)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    cg = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cg):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        cg.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--strong", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("the stamps come from the kernel: --device cuda")
    if not 0 < args.steps <= STAMP_STEPS:
        raise SystemExit(f"--steps must lie in 1..{STAMP_STEPS}")
    power = seeded_power(args.batch, args.steps, args.strong, dev)
    state = trig.init_state(batch=(args.batch,), device=dev)

    def run():
        return pass_b.scan_group_kernel(state, power, trig.LOOKBACK,
                                        args.steps, 4.0, 4, 3)

    n_blocks = 3 * args.batch
    with tempfile.TemporaryDirectory() as tmp:
        dll = stamped_library(pathlib.Path(tmp))
        own = pass_b._fn
        pass_b._fn = pass_b.bind(dll)
        try:
            launch_ms = replay(run)     # the last replay's stamps are read
            stamps = np.zeros((STAMP_STEPS, 6), np.uint64)
            blocks = np.zeros((STAMP_BLOCKS, 4), np.uint64)
            build.check(dll.pb_read_stamps(stamps.ctypes.data,
                                           blocks.ctypes.data),
                        "pb_read_stamps")
        finally:
            pass_b._fn = own

    rows = phases(stamps, args.steps)
    for t, searched, ns in rows:
        names = PHASES if searched else ("unsearched", "to next step")
        print(f"step {t:4d}: " + ", ".join(
            f"{n} {v}" for n, v in zip(names, ns) if v >= 0))
    hit = np.array([ns for _, s, ns in rows if s and ns[-1] >= 0])
    miss = np.array([ns for _, s, ns in rows if not s and ns[-1] >= 0])
    if len(hit):
        print(f"searched steps ({len(hit)}), median ns: " + ", ".join(
            f"{n} {int(v)}" for n, v in zip(PHASES, np.median(hit, 0)))
            + f"; total {int(np.median(hit.sum(1)))}")
    if len(miss):
        print(f"unsearched steps ({len(miss)}), median ns: "
              f"{int(np.median(miss.sum(1)))}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    card = smi[0] if smi else "?"
    loop = int(stamps[args.steps - 1, 5]) - int(stamps[0, 0])
    print(f"B={args.batch} g={args.steps}: block 0's loop {loop} ns from "
          f"its first stamp to its last [{card}]")
    bs = block_spans(blocks[:min(n_blocks, STAMP_BLOCKS)])
    print(f"blocks ({len(bs['spans'])}), ns, median (worst): " + ", ".join(
        f"{n} {int(np.median(v))} ({int(v.max())})"
        for n, v in zip(BLOCK_SPANS, bs["spans"].T))
        + "; block 0: " + ", ".join(
            f"{n} {int(v)}" for n, v in zip(BLOCK_SPANS, bs["spans"][0]))
        + f"; entries spread over {bs['entry_spread']}")
    print(f"launch: {launch_ms * 1e6:.0f} ns of device time a replayed "
          f"wrapper call (CUDA events, 10 replays; the pass-B kernel and "
          f"the wrapper's one fill of pos); the kernel's span {bs['span']} "
          f"ns from the first block's entry to the last carry-out; "
          f"{launch_ms * 1e6 - bs['span']:.0f} ns outside it [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
